"""The analytic roofline model of the port on the H100's terms: parameter
counts (``params.py``), FLOP, HBM and collective counts per cell priced
on a chip record (``costmodel.py``), the hypothesis loop and its three
climbs (``hillclimb.py``), the report table (``report.py``) and the
EXPERIMENTS.md assembler (``experiments_md.py``). Pure arithmetic on the
configurations: nothing here allocates a tensor."""

"""Hand-written CUDA kernels of the port; built by ``_build.py``.

``LAUNCHES`` counts kernel launches by kernel name, across the four
wrappers, one for each TPU kernel of the JAX package (``hyper_step``,
``flash_attention``, ``rglru_scan``, ``rwkv6_scan``): a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that
its path went through the kernels. The CPU path (plain versions) never
counts.
"""
import collections

LAUNCHES: collections.Counter = collections.Counter()

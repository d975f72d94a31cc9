"""Hand-written CUDA kernels of the port; built by ``_build.py``.

``LAUNCHES`` counts kernel launches by kernel name, across the six
wrappers: one for each TPU kernel of the JAX package (``hyper_step``,
``flash_attention``, ``rglru_scan``, ``rwkv6_scan``) and one for each
scan's gradient (``rglru_scan_backward``, ``rwkv6_scan_backward``, which
the reference leaves to XLA's reverse of a plain scan): a wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its path went through the kernels. The CPU path (plain versions)
never counts.

``WORKSPACE`` maps an operator of the port (``torch.ops.repro_torch.*``,
by its overload packet, as ``torch.utils.flop_counter.flop_registry``
does) whose implementation holds buffers that neither its inputs nor its
outputs show to a function of its arguments that gives their bytes; the
dry run (``launch/dryrun.py``) adds them to the live bytes at that op.
"""
import collections
from typing import Callable, Dict

LAUNCHES: collections.Counter = collections.Counter()
WORKSPACE: Dict[object, Callable[..., int]] = {}

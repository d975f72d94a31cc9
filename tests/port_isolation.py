"""What every port test file (``tests/test_torch_*.py``) shares: one
module-scoped autouse fixture, imported by name into each file, that
runs the file with torch at one intra-op thread and leaves the process
as the file found it for the reference's tests that follow it on the
same worker.

- **Threads.** The suite runs six xdist workers on an 8-core machine, and
  torch's default of one intra-op thread a core made the workers' pools
  fight over the cores: six copies of ``test_torch_scheduler.py`` side by
  side took ~2.5 times as long as with one thread each
  (``tools/parallel_copies.py``). The count is set when a port file
  starts and restored when it ends; no JAX or XLA setting is touched.
- **The reference's trace counters.** The port's parity tests drive the
  reference's fused integrator, whose jitted ``fused_rk_update``
  (``repro/kernels/hyper_step/ops.py``) counts its traces in
  ``TRACE_COUNTS``. A reference test that asserts a replay traces a
  ``(shape, seg)`` cell exactly once fails when a port file on the same
  worker has already traced that cell into JAX's caches. A port file
  that moved the counters clears JAX's caches when it ends, so the
  reference's tests start from caches without the port's cells.
"""
import jax
import pytest
import torch

from repro.kernels.hyper_step.ops import TRACE_COUNTS

TORCH_THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def port_module_isolation():
    threads = torch.get_num_threads()
    traces = dict(TRACE_COUNTS)
    torch.set_num_threads(TORCH_THREADS)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        if dict(TRACE_COUNTS) != traces:
            jax.clear_caches()

"""PyTorch + CUDA port of the hypersolver serving stack (``src/repro``).

The JAX package is the reference; this package keeps its module layout
and names, so ``repro/<path>`` has its counterpart at
``repro_torch/<path>``. It imports ``torch`` and numpy only — never
``jax`` and nothing of ``repro.*`` (``tests/test_torch_imports.py``).

Devices are explicit: every entry point takes a ``device`` and runs on
``cuda`` unless the caller passes ``device="cpu"``. Asking for ``cuda``
on a machine without it raises; nothing carries on silently on the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DEFAULT_DEVICE = "cuda"


def pin_cuda_numerics() -> None:
    """Make float32 matmuls on the card run in full float32 and reduce
    low-precision GEMMs in float32, matching the reference's
    ``preferred_element_type=jnp.float32`` contract: TF32 off for
    matmuls and cuDNN, no reduced-precision bf16/fp16 reductions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``cuda``. Raises RuntimeError when a CUDA device is asked for and
    none is available — there is no CPU fallback. Resolving a CUDA
    device also pins the float32 matmul numerics (``pin_cuda_numerics``)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")
        pin_cuda_numerics()
    return dev

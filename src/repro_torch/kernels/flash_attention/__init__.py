"""Blocked attention with an online softmax: CUDA kernel (csrc/), wrapper (ops.py), plain version (ref.py)."""

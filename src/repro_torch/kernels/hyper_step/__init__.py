"""Fused hypersolver update: CUDA kernel (csrc/), wrapper (ops.py), plain version (ref.py)."""

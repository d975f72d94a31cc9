"""RG-LRU linear recurrence scan: CUDA kernel (csrc/), wrapper (ops.py), plain version (ref.py)."""

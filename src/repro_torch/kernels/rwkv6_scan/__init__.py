"""WKV6 recurrence (RWKV-6 time mix): CUDA kernel (csrc/), wrapper (ops.py), plain version (ref.py)."""

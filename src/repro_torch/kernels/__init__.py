"""Hand-written CUDA kernels of the port; built by ``_build.py``."""

"""Hand-written CUDA kernels for Hopper (``*/csrc/``) beside their plain
PyTorch versions (``*/ref.py``).  Each op launches its kernel for CUDA
tensors and runs the plain version for CPU tensors."""

"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers."""

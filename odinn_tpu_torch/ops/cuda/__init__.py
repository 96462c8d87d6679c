"""The hand-written CUDA kernels: their ctypes wrappers, plain PyTorch versions and build."""

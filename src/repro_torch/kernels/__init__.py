"""Hand-written CUDA kernels of the serving path, each with its plain
PyTorch version beside it (used for CPU tensors and as the kernel's check).
"""

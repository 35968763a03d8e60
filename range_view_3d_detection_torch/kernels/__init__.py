"""Hand-written Hopper kernels (``csrc/*.cu``) and their plain twins.

Each wrapper takes its plain PyTorch twin only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.
"""

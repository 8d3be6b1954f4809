"""Graph-mixing kernels (paper eq. 3 + eq. 4): ``ops`` is the public
surface; ``mixing``/``fused`` hold the kernel wrappers, ``ref`` the plain
PyTorch versions the wrappers use for CPU tensors."""

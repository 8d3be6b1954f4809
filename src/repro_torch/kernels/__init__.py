"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``,
built and loaded by ``_build``) with their plain PyTorch versions."""

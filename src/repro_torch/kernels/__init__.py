"""Hand-written Hopper kernels (CUDA C++ under ``repro_torch/csrc``), each
beside the plain PyTorch version of the same function."""

"""Hand-written Hopper kernels (CUDA C++ in ``repro_torch/csrc``) with their
plain PyTorch twins.  Nothing is compiled at import time."""

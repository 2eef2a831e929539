"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Nothing here builds or loads CUDA code at import time."""

"""Hand-written Hopper kernels (CUDA C++, built by ``build.py``) with their
plain PyTorch versions and autograd wrappers."""

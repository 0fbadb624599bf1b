"""Hand-written Hopper kernels (CUDA C++, ``csrc/``) with their plain
PyTorch versions and wrappers.  Importing builds nothing (``_build``)."""

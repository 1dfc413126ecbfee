"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``): ``gradnorm`` (CUDA C++, ``csrc/gradnorm.cu``)."""

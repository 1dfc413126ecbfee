"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``): ``gradnorm`` (``csrc/gradnorm.cu``) and
``flash_attention`` (``csrc/flash_attention.cu``), both CUDA C++ built
by ``nvcc`` (the shared build helper) at first use."""

"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``): ``gradnorm`` (``csrc/gradnorm.cu``),
``flash_attention`` (``csrc/flash_attention.cu``) and ``lru_scan``
(``csrc/lru_scan.cu``), all CUDA C++ built by ``nvcc`` (the shared
build helper) at first use."""

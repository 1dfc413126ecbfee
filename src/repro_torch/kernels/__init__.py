"""Hand-written Hopper kernels of the port (counterpart of
``repro.kernels``): ``gradnorm`` (``csrc/gradnorm.cu``),
``flash_attention`` (bf16 on the tensor cores in
``csrc/flash_attention_sm90.cu``, fp32 in ``csrc/flash_attention.cu``)
and ``lru_scan`` (``csrc/lru_scan.cu``), all CUDA C++ built by ``nvcc``
(the shared build helper) at first use."""

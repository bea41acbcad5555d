"""Hand-written Hopper kernels replacing the reference's Pallas kernels.

  flash_attention/  prefill: ``flash_prefill`` (csrc/flash_attention.cu)
  paged_attention/  decode: ``paged_decode`` and ``paged_append``
                    (csrc/paged_attention.cu)
  rwkv6/            the WKV6 recurrence: ``wkv6`` (csrc/wkv6.cu)
  mamba_scan/       the selective-SSM scan: ``mamba_scan``
                    (csrc/mamba_scan.cu)

Each wrapper sends a CPU tensor to its plain PyTorch version (the CPU
path and the oracle) and launches its kernel on a CUDA tensor, counting
launches in an integer attribute ``launches``.  ``build`` compiles the
CUDA sources with nvcc on first use.
"""

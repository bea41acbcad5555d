"""PyTorch/CUDA port of the SAGA reproduction (``repro``, JAX/Pallas).

The framework-free modules (configs, core, cluster, workflow, obs and the
serving runtime) are verbatim copies of the reference with ``repro``
renamed to ``repro_torch`` in their imports; ``tests/test_torch_lockstep.py``
holds them in lockstep.  The substrate is rewritten in PyTorch: the model
(``models``), the paged KV pool and the engine (``serving.kvcache``,
``serving.engine``), and the Pallas kernels as hand-written Hopper kernels
(``kernels``, sources in ``csrc``).  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

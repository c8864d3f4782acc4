"""PyTorch/CUDA port of the AKPC packed-cache replayer (``repro`` is the JAX reference).

Imports ``torch`` and ``numpy`` only, never ``jax`` and nothing of
``repro``.  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

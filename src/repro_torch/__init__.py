"""PyTorch / CUDA port of the JAX package ``repro``: two-level serving decode
(qwen3-8b through ``TieredKVCache``) with hand-written Hopper kernels, and
dense training through the two-level store (``launch.train``).

The package imports torch, numpy and the standard library only — never
``jax`` and nothing of ``repro`` — and keeps the JAX package's module names
and public layouts so each function has an obvious counterpart.
"""

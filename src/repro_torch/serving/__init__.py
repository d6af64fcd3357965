"""Serving layer of the PyTorch port: the two-level KV cache."""

from repro_torch.serving.kv_offload import TieredKVCache, TieredKVStats

__all__ = ["TieredKVCache", "TieredKVStats"]

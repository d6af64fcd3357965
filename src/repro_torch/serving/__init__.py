"""Serving layer of the PyTorch port: the two-level KV cache and its
store-backed third level."""

from repro_torch.serving.kv_offload import SharedPageRegistry, TieredKVCache, TieredKVStats

__all__ = ["SharedPageRegistry", "TieredKVCache", "TieredKVStats"]

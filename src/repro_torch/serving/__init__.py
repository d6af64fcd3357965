"""Serving layer of the PyTorch port: the two-level KV cache with its
store-backed third level, and the multi-session scheduler over it."""

from repro_torch.serving.kv_offload import SharedPageRegistry, SlidingKVRing, TieredKVCache, TieredKVStats
from repro_torch.serving.scheduler import Session, SessionKVBatch, SessionScheduler, SessionState

__all__ = [
    "Session",
    "SessionKVBatch",
    "SessionScheduler",
    "SessionState",
    "SharedPageRegistry",
    "SlidingKVRing",
    "TieredKVCache",
    "TieredKVStats",
]

"""Optimizers and distributed-optimization transforms of the port."""

from repro_torch.optim.adamw import AdamW, apply_updates, clip_by_global_norm, cosine_warmup
from repro_torch.optim.compression import topk_compress_with_ef

__all__ = ["AdamW", "apply_updates", "clip_by_global_norm", "cosine_warmup", "topk_compress_with_ef"]

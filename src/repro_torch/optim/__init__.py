"""Optimizers of the port (the top-k compression transform of the JAX
package is not ported)."""

from repro_torch.optim.adamw import AdamW, apply_updates, clip_by_global_norm, cosine_warmup, global_norm

__all__ = ["AdamW", "apply_updates", "clip_by_global_norm", "cosine_warmup", "global_norm"]

"""Settings that only the port's architectures have.

``ArchConfig`` mirrors the JAX package's field by field (a test holds the
two equal), so an architecture that only the port runs keeps its extra
settings in this frozen subclass.  Code reads them through ``setting``,
which gives every other config the value that leaves its path unchanged.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    # Cohere's parallel block: x + Attn(LN x) + FFN(LN x) off one pre-norm.
    parallel_block: bool = False
    # RoPE on the full-attention layers of a model that mixes window and
    # full layers; False is Command A's "global NoPE".
    rope_on_global: bool = True
    # The expert share of expert parallelism: this device holds the routed
    # experts [experts_lo, experts_lo + experts_held) of every MoE layer
    # (0 = all of them, with the capacity-bounded dispatch).
    experts_held: int = 0
    experts_lo: int = 0


DEFAULTS = {f.name: f.default for f in dataclasses.fields(PortArchConfig) if f.name not in
            {g.name for g in dataclasses.fields(ArchConfig)}}


def setting(cfg: ArchConfig, name: str):
    """``cfg``'s port-only setting ``name``, or its default for a config
    that has none (every architecture the JAX package also has)."""
    return getattr(cfg, name, DEFAULTS[name])

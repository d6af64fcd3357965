"""Unified architecture config covering all 10 assigned families.

The port's own copy of ``repro/configs/base.py``: ``repro_torch`` imports
nothing of the JAX package, so the dataclasses are duplicated here and a
test holds the two equal field by field.

Each ``configs/<arch>.py`` exports ``config()`` (the exact published
shape) and ``reduced()`` (a tiny same-family variant for CPU smoke
tests).  The registry in ``configs/__init__.py`` maps ``--arch <id>``
to these constructors.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_ff: int
    n_shared: int = 0  # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_type: Literal["softmax", "sigmoid"] = "softmax"
    normalize_gates: bool = True
    first_k_dense: int = 0  # DeepSeek-V3: first k layers use a dense FFN


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:
    """State-space / recurrent block configuration."""

    kind: Literal["rglru", "xlstm"]
    # rglru (Griffin/RecurrentGemma): pattern = (recurrent, recurrent, attn)
    lru_width: int = 0  # 0 -> d_model
    conv_width: int = 4  # temporal conv in the recurrent block
    attn_every: int = 3  # 1 local-attn block per `attn_every` blocks
    # xlstm: alternate sLSTM / mLSTM blocks
    slstm_every: int = 2  # 1 sLSTM per `slstm_every` blocks (rest mLSTM)
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper) extras; the conv/audio frontend is a stub —
    ``input_specs`` provides precomputed frame embeddings."""

    n_encoder_layers: int = 32
    n_frames: int = 1500  # 30 s of audio after the conv frontend
    frame_dim: int = 1280  # encoder d_model == frame embedding dim


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """Vision-language (InternVL) extras; the ViT frontend is a stub —
    ``input_specs`` provides precomputed patch embeddings."""

    n_patches: int = 256
    patch_dim: int = 1024  # InternViT-300M output width


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # attention
    attn_type: Literal["gqa", "mla", "none"] = "gqa"
    qk_norm: bool = False
    window: int = 0  # sliding-window size; 0 = full attention
    global_every: int = 0  # gemma3: 1 global layer per `global_every` layers
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    mla: MLAConfig | None = None
    # mixtures / recurrence / multimodality
    moe: MoEConfig | None = None
    recurrent: RecurrentConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # misc
    mlp_type: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    post_norms: bool = False  # gemma-style post-attn/post-mlp norms
    tie_embeddings: bool = True
    use_bias: bool = False
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)
    mtp: bool = False  # DeepSeek multi-token prediction module
    max_seq_len: int = 131_072
    norm_eps: float = 1e-6
    # execution
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    attn_impl: Literal["xla", "flash"] = "xla"
    remat: Literal["none", "full", "dots"] = "full"
    scan_layers: bool = True
    seq_parallel: bool = False  # shard the residual seq dim over 'model'
    # (Megatron-SP: turns per-layer activation all-reduces into
    # reduce-scatter/all-gather pairs — §Perf iteration 5)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md §4)."""
        if self.recurrent is not None:
            return True
        return self.window > 0  # sliding-window attention

    def param_count(self) -> int:
        """Analytic parameter count (dense matmul weights + embeddings)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.attn_type == "mla" and self.mla is not None:
            m = self.mla
            qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk_head
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.n_heads * m.v_head_dim * d
        elif self.attn_type == "gqa":
            per_layer += d * self.n_heads * hd  # q
            per_layer += 2 * d * self.n_kv_heads * hd  # k, v
            per_layer += self.n_heads * hd * d  # o
        if self.moe is not None:
            gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += d * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * gates * d * self.moe.expert_ff
            per_layer += self.moe.n_shared * gates * d * self.moe.expert_ff
        elif self.d_ff > 0:
            gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += gates * d * self.d_ff
        if self.recurrent is not None and self.recurrent.kind == "rglru":
            w = self.recurrent.lru_width or d
            per_layer += 2 * d * w + w * d + 2 * w  # gates + in/out proj + lambda
        n += L * per_layer
        if self.encdec is not None:
            # encoder self-attn + mlp per encoder layer (dense MHA)
            enc = self.encdec.n_encoder_layers * (
                4 * d * self.n_heads * hd + 2 * d * self.d_ff
            )
            # decoder cross-attention adds another attention block per layer
            n += enc + L * 4 * d * self.n_heads * hd
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top-k routed only)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        gates = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        all_expert = self.n_layers * self.moe.n_experts * gates * self.d_model * self.moe.expert_ff
        active_expert = self.n_layers * self.moe.top_k * gates * self.d_model * self.moe.expert_ff
        return full - all_expert + active_expert


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assignment matrix."""

    name: Literal["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[ShapeCell]:
    """The assignment's applicability rule (DESIGN.md §4)."""
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.is_sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return cells

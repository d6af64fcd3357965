"""Grok-1 314B — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

Assignment row: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8e top-2.  d_ff is the per-expert intermediate (all layers MoE).
Grok-1 applies tanh soft-capping (30.0) to attention logits.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab=131_072,
        attn_type="gqa",
        attn_logit_softcap=30.0,
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=32768, n_shared=0),
        tie_embeddings=True,
        embed_scale=True,
        rope_theta=10_000.0,
        max_seq_len=8_192 * 16,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b-reduced",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        attn_type="gqa",
        attn_logit_softcap=30.0,
        # capacity_factor = E/k: zero drops -> exact decode consistency tests.
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=128, capacity_factor=2.0),
        tie_embeddings=True,
        embed_scale=True,
        max_seq_len=512,
        remat="none",
    )

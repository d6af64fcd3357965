"""Gemma3 1B — 5:1 local:global attention, 512-token window, MQA
[hf:google/gemma-3-1b-pt; unverified].

Assignment row: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
head_dim=256; qk-norm; GeGLU; pre+post norms; scaled embeddings.
26 layers = 4 scanned (5 local + 1 global) periods + 2 unrolled locals.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab=262_144,
        attn_type="gqa",
        qk_norm=True,
        window=512,
        global_every=6,
        mlp_type="geglu",
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        max_seq_len=131_072,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b-reduced",
        family="dense",
        n_layers=8,  # one full 6-layer period + 2 suffix locals
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        attn_type="gqa",
        qk_norm=True,
        window=16,
        global_every=6,
        mlp_type="geglu",
        post_norms=True,
        embed_scale=True,
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

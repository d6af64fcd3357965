"""RecurrentGemma 9B — Griffin: RG-LRU + local attention, 2 recurrent :
1 attention [arXiv:2402.19427; unverified].

Assignment row: 38L d_model=4096 16H (GQA kv=1 -> MQA) d_ff=12288
vocab=256000.  Pattern [rec, rec, local-attn] -> 12 scanned periods + 2
unrolled recurrent layers; 2048-token attention window; O(1) recurrent
state -> runs the long_500k shape (window KV pages stay 2048).
"""

from repro_torch.configs.base import ArchConfig, RecurrentConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256_000,
        attn_type="gqa",
        window=2048,
        recurrent=RecurrentConfig(kind="rglru", lru_width=4096, conv_width=4, attn_every=3),
        mlp_type="geglu",
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=10_000.0,
        max_seq_len=1_048_576,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b-reduced",
        family="hybrid",
        n_layers=6,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        attn_type="gqa",
        window=16,
        recurrent=RecurrentConfig(kind="rglru", lru_width=64, conv_width=4, attn_every=3),
        mlp_type="geglu",
        embed_scale=True,
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

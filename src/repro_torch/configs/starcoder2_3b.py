"""StarCoder2 3B — dense GQA + RoPE, biased projections, plain-GELU MLP
[arXiv:2402.19173; hf].

Assignment row: 30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_ff=12288,
        vocab=49_152,
        attn_type="gqa",
        mlp_type="gelu",
        norm_type="layernorm",
        use_bias=True,
        tie_embeddings=True,
        rope_theta=100_000.0,
        max_seq_len=16_384 * 8,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-3b-reduced",
        family="dense",
        n_layers=4,
        d_model=96,
        n_heads=8,
        n_kv_heads=2,
        d_ff=192,
        vocab=512,
        attn_type="gqa",
        mlp_type="gelu",
        norm_type="layernorm",
        use_bias=True,
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

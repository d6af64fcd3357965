"""Command-R 35B — dense GQA, no biases [hf:CohereForAI/c4ai-command-r-v01;
unverified].

Assignment row: 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
Cohere's parallel attention/FFN block layout is folded into the standard
sequential residual form here (same FLOPs; noted in DESIGN.md §6).
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="command-r-35b",
        family="dense",
        n_layers=40,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22528,
        vocab=256_000,
        attn_type="gqa",
        norm_type="layernorm",
        use_bias=False,
        tie_embeddings=True,
        rope_theta=8_000_000.0,
        max_seq_len=131_072,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="command-r-35b-reduced",
        family="dense",
        n_layers=4,
        d_model=96,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab=512,
        attn_type="gqa",
        norm_type="layernorm",
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

"""Qwen3 8B — dense GQA with qk-norm [hf:Qwen/Qwen3-8B; hf].

Assignment row: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
head_dim is 128 (fixed, not d_model/n_heads).
"""

from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab=151_936,
        attn_type="gqa",
        qk_norm=True,
        tie_embeddings=False,
        rope_theta=1_000_000.0,
        max_seq_len=131_072,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b-reduced",
        family="dense",
        n_layers=4,
        d_model=96,
        n_heads=8,
        n_kv_heads=4,
        head_dim=16,
        d_ff=192,
        vocab=512,
        attn_type="gqa",
        qk_norm=True,
        tie_embeddings=False,
        max_seq_len=512,
        remat="none",
    )

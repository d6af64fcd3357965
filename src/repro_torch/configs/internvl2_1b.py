"""InternVL2 1B — InternViT-300M (stub) + Qwen2-0.5B LM backbone
[arXiv:2404.16821; hf].

Assignment row: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
The ViT frontend is a STUB — ``input_specs`` supplies precomputed patch
embeddings (B, 256, 1024), projected and prepended to the token stream.
Qwen2 details: attention q/k/v biases, RMSNorm, SwiGLU, tied embeddings.
14 heads do NOT divide the 16-way model axis: the shard-if-divisible rule
replicates the head axis and shards d_ff (4864 = 16 x 304) instead.
"""

from repro_torch.configs.base import ArchConfig, VLMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151_655,
        attn_type="gqa",
        vlm=VLMConfig(n_patches=256, patch_dim=1024),
        use_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        max_seq_len=32_768 * 2,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b-reduced",
        family="vlm",
        n_layers=3,
        d_model=56,  # 14-head-like non-divisibility kept: 4 heads of 14
        n_heads=4,
        n_kv_heads=2,
        d_ff=112,
        vocab=512,
        attn_type="gqa",
        vlm=VLMConfig(n_patches=8, patch_dim=32),
        use_bias=True,
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

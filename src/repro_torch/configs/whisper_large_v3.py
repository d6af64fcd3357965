"""Whisper large-v3 — encoder-decoder audio transformer [arXiv:2212.04356;
unverified].

Assignment row: 32L d_model=1280 20H (kv=20 -> MHA) d_ff=5120 vocab=51866.
32 encoder + 32 decoder layers (the published model); the conv/mel
frontend is a STUB — ``input_specs`` supplies precomputed frame
embeddings (B, 1500, 1280).  LayerNorm, plain-GELU MLP, biases, learned
decoder positions, no RoPE.  max_seq_len sized for the decode_32k cell
(the published 448-token decoder context is a fine-tuning choice, not an
architectural limit).
"""

from repro_torch.configs.base import ArchConfig, EncDecConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3",
        family="audio",
        n_layers=32,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51_866,
        attn_type="gqa",
        encdec=EncDecConfig(n_encoder_layers=32, n_frames=1500, frame_dim=1280),
        mlp_type="gelu",
        norm_type="layernorm",
        use_bias=True,
        tie_embeddings=True,
        max_seq_len=32_768 + 8,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3-reduced",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        attn_type="gqa",
        encdec=EncDecConfig(n_encoder_layers=2, n_frames=16, frame_dim=64),
        mlp_type="gelu",
        norm_type="layernorm",
        use_bias=True,
        tie_embeddings=True,
        max_seq_len=128,
        remat="none",
    )

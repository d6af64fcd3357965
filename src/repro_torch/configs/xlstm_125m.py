"""xLSTM 125M — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

Assignment row: 12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: the
blocks carry their own projections (mLSTM pf=2; sLSTM pf=4/3 FFN).
1 sLSTM per 4 blocks (xLSTM[3:1] flavor): [m,m,m,s] x 3 scanned periods.
O(1) recurrent state -> runs the long_500k shape.
"""

from repro_torch.configs.base import ArchConfig, RecurrentConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50_304,
        attn_type="none",
        recurrent=RecurrentConfig(
            kind="xlstm",
            slstm_every=4,
            mlstm_proj_factor=2.0,
            slstm_proj_factor=4.0 / 3.0,
        ),
        norm_type="layernorm",
        tie_embeddings=True,
        max_seq_len=1_048_576,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="xlstm-125m-reduced",
        family="ssm",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=512,
        attn_type="none",
        recurrent=RecurrentConfig(kind="xlstm", slstm_every=4),
        norm_type="layernorm",
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
    )

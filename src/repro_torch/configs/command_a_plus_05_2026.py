"""Command A+ 05-2026 (``cohere2_moe``, 218B-A25B) — window and global
layers mixed, 128 sigmoid-routed experts with 4 shared ones, Cohere's
parallel block [hf:CohereLabs/command-a-plus-05-2026, config.json].

32 layers, d_model 4096, 128 query and 8 kv heads of 128.  ``layer_types``
repeats three ``sliding_attention`` layers (window 4096, RoPE theta 50000)
and one ``full_attention`` layer, which applies no position encoding
("global NoPE").  Every layer is an MoE layer (``first_k_dense_replace``
0): 128 routed experts of width 4096 (``intermediate_size``, read as one
expert's width), the top 8 of the sigmoid scores with their gates
normalised over the 8, and 4 shared experts whose outputs are averaged.
LayerNorm at eps 1e-5, no attention bias, a tied 262144-row table,
``logit_scale`` 1.  The vision tower is not modelled: prompts are text.

Only the port has this architecture (``configs.PORT_ARCH_IDS``); its own
settings are ``PortArchConfig``'s.  ``config()`` holds all 128 experts;
a deployment's device holds a share (``experts_held`` from ``experts_lo``).
"""

from repro_torch.configs.base import MoEConfig
from repro_torch.configs.port import PortArchConfig


def config() -> PortArchConfig:
    return PortArchConfig(
        name="command-a-plus-05-2026",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=128,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4096,
        vocab=262_144,
        attn_type="gqa",
        window=4096,
        global_every=4,
        rope_theta=50_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, expert_ff=4096, n_shared=4, router_type="sigmoid",
                      normalize_gates=True),
        norm_type="layernorm",
        norm_eps=1e-5,
        use_bias=False,
        tie_embeddings=True,
        max_seq_len=200_000,
        parallel_block=True,
        rope_on_global=False,
        experts_held=128,
    )


def reduced() -> PortArchConfig:
    return PortArchConfig(
        name="command-a-plus-05-2026-reduced",
        family="moe",
        n_layers=4,  # one period: three window layers, then a global one
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab=512,
        attn_type="gqa",
        window=16,  # shorter than the tests' prompts: the rings wrap
        global_every=4,
        rope_theta=50_000.0,
        moe=MoEConfig(n_experts=8, top_k=3, expert_ff=32, n_shared=2, router_type="sigmoid", normalize_gates=True),
        norm_type="layernorm",
        norm_eps=1e-5,
        tie_embeddings=True,
        max_seq_len=512,
        remat="none",
        parallel_block=True,
        rope_on_global=False,
        experts_held=4,  # a device's share: experts 4..7 of 8
        experts_lo=4,
    )

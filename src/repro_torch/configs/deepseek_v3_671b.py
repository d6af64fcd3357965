"""DeepSeek-V3 671B — MLA + 256-expert top-8 MoE + MTP [arXiv:2412.19437; hf].

Assignment row: 61L d_model=7168 128H (GQA kv=128) d_ff=2048 vocab=129280,
MoE 256e top-8.  The listed d_ff=2048 is the *routed-expert* intermediate
size; the first-3 dense layers and the shared expert use the published
18432 dense intermediate.  kv=128 in the row reflects MLA's full-head
effective KV; the cache itself stores the 512-dim latent + 64-dim rope key.
"""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,  # dense-layer / shared-expert intermediate
        vocab=129_280,
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            n_experts=256,
            top_k=8,
            expert_ff=2048,
            n_shared=1,
            router_type="sigmoid",
            normalize_gates=True,
            first_k_dense=3,
        ),
        mtp=True,
        tie_embeddings=False,
        rope_theta=10_000.0,
        max_seq_len=131_072,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b-reduced",
        family="moe",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        attn_type="mla",
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        # capacity_factor = E/k: zero token drops, so decode == full forward
        # exactly in the consistency tests (full config keeps 1.25).
        moe=MoEConfig(n_experts=8, top_k=2, expert_ff=32, n_shared=1, router_type="sigmoid", first_k_dense=1, capacity_factor=4.0),
        mtp=True,
        tie_embeddings=False,
        max_seq_len=512,
        remat="none",
    )

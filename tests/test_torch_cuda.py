"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda``: they skip on a machine without a card.  This file imports
no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: fp32 rtol = atol =
2e-5, bf16 2e-2 (the kernels keep fp32 probabilities where the plain
versions round them to the input dtype).
"""

import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# (hot_len, cold_len, newest): hot 16 slots, cold capacity 64
TIERED_CASES = [(16, 40, 15), (0, 40, 7), (12, 0, 11), (16, 32, 5), (9, 48, 3), (16, 64, 0), (0, 0, 0)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and launch the CUDA kernels")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(cuda_device, dtype):
    """The CUDA kernels against their plain versions on the card, at small
    shapes that cover the edge cases (ragged tiles, ring wrap, empty tiers)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' einsums in full fp32
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    before = ops.launches()
    for s, t, window in ((50, 50, 0), (24, 64, 0), (96, 96, 16)):
        q, k, v = rnd(2, 8, s, 32), rnd(2, 2, t, 32), rnd(2, 2, t, 32)
        got = ops.flash_attention(q, k, v, window=window)
        torch.testing.assert_close(got, tref.attention_ref(q, k, v, window=window), **TOL[dtype])
    for hot_len, cold_len, newest in TIERED_CASES:
        q, hk, hv, ck, cv = rnd(2, 8, 1, 32), rnd(2, 2, 16, 32), rnd(2, 2, 16, 32), rnd(2, 2, 64, 32), rnd(2, 2, 64, 32)
        got = ops.tiered_decode_attention(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        torch.testing.assert_close(got, want, **TOL[dtype])
    torch.cuda.synchronize()
    after = ops.launches()
    assert after["flash_attention"] - before["flash_attention"] == 3
    assert after["tiered_decode"] - before["tiered_decode"] == len(TIERED_CASES)


@pytest.mark.cuda
def test_cuda_tiered_serve_matches_plain(cuda_device):
    """Reduced qwen3 (D=16, 2 query heads per kv head) in fp32 on the card:
    greedy tokens through both kernels equal tokens through the plain
    versions, and every layer launched each kernel."""
    import dataclasses

    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import tiered_serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    kern_cfg = dataclasses.replace(base, attn_impl="flash")
    plain_cfg = dataclasses.replace(base, attn_impl="xla")
    model = make_model(kern_cfg)
    params = init_params(model, seed=0, device=cuda_device)
    prompts = torch.randint(0, base.vocab, (2, 40), device=cuda_device,
                            generator=torch.Generator(device=cuda_device).manual_seed(0))
    ops.reset_launches()
    kern, *_ = tiered_serve_loop(model, kern_cfg, params, prompts, 12, 16, 8, torch.float32, "kernel")
    assert ops.launches() == {"tiered_decode": base.n_layers * 12, "flash_attention": base.n_layers}
    plain, *_ = tiered_serve_loop(make_model(plain_cfg), plain_cfg, params, prompts, 12, 16, 8,
                                  torch.float32, "plain")
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)

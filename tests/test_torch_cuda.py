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
from repro_torch.kernels.flash_attention import flash_path
from repro_torch.kernels.tiered_decode import tiered_decode_attention_fwd

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# mLSTM in fp32: tests/test_kernels.py's 2e-4 (the chunkwise sums run in
# another order than the sequential scan's).
MLSTM_TOL = {"float32": dict(rtol=2e-4, atol=2e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
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
    before, paths_before = ops.launches(), ops.flash_path_launches()
    # (B, H, KV, S, T, D, window): ragged, T > S, window, fully masked rows
    # (T < S: rows 0-15 see no key and give the mean of v), and D = 256 MQA.
    flash_cases = [(2, 8, 2, 50, 50, 32, 0), (2, 8, 2, 24, 64, 32, 0), (2, 8, 2, 96, 96, 32, 16),
                   (1, 2, 2, 40, 24, 32, 0), (1, 16, 1, 80, 80, 256, 48)]
    for b, h, kv, s, t, d, window in flash_cases:
        q, k, v = rnd(b, h, s, d), rnd(b, kv, t, d), rnd(b, kv, t, d)
        got = ops.flash_attention(q, k, v, window=window)
        torch.testing.assert_close(got, tref.attention_ref(q, k, v, window=window), **TOL[dtype])
    for hot_len, cold_len, newest in TIERED_CASES:
        q, hk, hv, ck, cv = rnd(2, 8, 1, 32), rnd(2, 2, 16, 32), rnd(2, 2, 16, 32), rnd(2, 2, 64, 32), rnd(2, 2, 64, 32)
        got = ops.tiered_decode_attention(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        torch.testing.assert_close(got, want, **TOL[dtype])
    torch.cuda.synchronize()
    after = ops.launches()
    assert after["flash_attention"] - before["flash_attention"] == len(flash_cases)
    assert after["tiered_decode"] - before["tiered_decode"] == len(TIERED_CASES)
    paths = ops.flash_path_launches()
    on_tc = sum(flash_path(dt, c[5]) == "tensor_core" for c in flash_cases)
    assert paths["tensor_core"] - paths_before["tensor_core"] == on_tc == (1 if dtype == "bfloat16" else 0)
    assert paths["cuda_core"] - paths_before["cuda_core"] == len(flash_cases) - on_tc


# (B, H, KV, S, T, window, softcap, causal): S and T not multiples of the
# 128-row query tile or the 64/128-key tile; GQA 4; MQA with T > S; window;
# softcap 30 and a strong softcap 2; rows without a key (T < S: rows
# 0..122 see none and give the mean of v); non-causal.
TC_FLASH_CASES = [(2, 8, 2, 200, 200, 0, 0.0, True), (1, 4, 1, 100, 300, 0, 0.0, True),
                  (1, 4, 2, 300, 300, 70, 0.0, True), (1, 4, 4, 150, 150, 0, 30.0, True),
                  (1, 4, 4, 150, 150, 0, 2.0, True), (1, 2, 2, 200, 77, 0, 0.0, True),
                  (1, 2, 1, 130, 190, 0, 0.0, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_cuda_flash_tensor_core_matches_plain(cuda_device, d):
    """bf16 at D = 64, 128, 256 takes the wgmma kernel: every masking rule,
    ragged edges and the mean-of-v rows against ``ref.attention_ref``, and
    the tensor-core path's own launch count beside the op's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)
    assert flash_path(torch.bfloat16, d) == "tensor_core"
    ops.reset_launches()
    for b, h, kv, s, t, window, cap, causal in TC_FLASH_CASES:
        q, k, v = rnd(b, h, s, d), rnd(b, kv, t, d), rnd(b, kv, t, d)
        kw = dict(causal=causal, window=window, logit_softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        torch.testing.assert_close(got, tref.attention_ref(q, k, v, **kw), **TOL["bfloat16"])
    torch.cuda.synchronize()
    assert ops.launches()["flash_attention"] == len(TC_FLASH_CASES)
    assert ops.flash_path_launches() == {"tensor_core": len(TC_FLASH_CASES), "cuda_core": 0}


# (hot_len, cold_len, newest, n_split) over hot 16 slots and cold capacity
# 64: splits of a few keys; 8 splits of 5 keys (three splits see no key);
# one split per key; no key at all over 4 splits.
SPLIT_CASES = [(16, 40, 15, 4), (0, 40, 7, 3), (12, 0, 11, 5), (9, 48, 3, 7), (16, 64, 0, 2),
               (3, 2, 1, 8), (4, 1, 2, 5), (0, 0, 0, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiered_split_matches_plain(cuda_device, dtype):
    """The split tiered kernel against ``ref.tiered_ring_attention_ref`` at
    forced split counts (empty splits, the all-empty case), and at the split
    count the planner picks for this card over a 1088-key history."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    for hot_len, cold_len, newest, n_split in SPLIT_CASES:
        q, hk, hv, ck, cv = rnd(2, 8, 1, 32), rnd(2, 2, 16, 32), rnd(2, 2, 16, 32), rnd(2, 2, 64, 32), rnd(2, 2, 64, 32)
        got = tiered_decode_attention_fwd(q, hk, hv, ck, cv, hot_len, cold_len, newest, n_split=n_split)
        want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        torch.testing.assert_close(got, want, **TOL[dtype])
    q, hk, hv, ck, cv = rnd(2, 8, 1, 128), rnd(2, 2, 256, 128), rnd(2, 2, 256, 128), rnd(2, 2, 1024, 128), rnd(2, 2, 1024, 128)
    before = ops.launches()["tiered_decode"]
    got = ops.tiered_decode_attention(q, hk, hv, ck, cv, 192, 896, 63)
    torch.testing.assert_close(got, tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, 192, 896, 63), **TOL[dtype])
    torch.cuda.synchronize()
    assert ops.launches()["tiered_decode"] - before == 1  # two CUDA launches, one op


# (H, KV, D): every group G = H / KV from 1 to 16 and every head dim, among
# them the GQA layers of the repository's configs: starcoder2_3b (24/2, 128),
# grok_1_314b (48/8, 128), internvl2_1b (14/2, 64), gemma3_1b (4/1, 256),
# recurrentgemma_9b (16/1, 256), and odd groups with a padded head tile.
GROUP_SHAPES = [(1, 1, 16), (2, 1, 32), (3, 1, 64), (8, 2, 128), (5, 1, 128), (12, 2, 64), (14, 2, 64),
                (7, 1, 256), (8, 1, 32), (9, 1, 128), (20, 2, 16), (11, 1, 64), (24, 2, 128), (48, 8, 128),
                (13, 1, 32), (28, 2, 256), (15, 1, 64), (16, 1, 256), (4, 1, 256), (6, 1, 256)]
# (hot_len, cold_len, newest, n_split or None for the planner's) over hot 16
# slots and cold capacity 64: both tiers and a wrapped ring, no key, hot
# only, cold only, and splits with no key.
GROUP_CASES = [(16, 40, 15, None), (0, 0, 0, None), (12, 0, 11, None), (0, 40, 7, None), (16, 64, 5, 3),
               (3, 2, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiered_every_group_and_head_dim(cuda_device, dtype):
    """The tiered kernel at every group from 1 to 16 and every head dim up
    to 256 against ``ref.tiered_ring_attention_ref``, at the edge cases."""
    from repro_torch.kernels.tiered_decode import GROUPS, HEAD_DIMS

    assert sorted({h // kv for h, kv, _ in GROUP_SHAPES}) == list(GROUPS)
    assert {d for *_, d in GROUP_SHAPES} == set(HEAD_DIMS)
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    for h, kv, d in GROUP_SHAPES:
        q, hk, hv, ck, cv = rnd(2, h, 1, d), rnd(2, kv, 16, d), rnd(2, kv, 16, d), rnd(2, kv, 64, d), rnd(2, kv, 64, d)
        for hot_len, cold_len, newest, n_split in GROUP_CASES:
            got = tiered_decode_attention_fwd(q, hk, hv, ck, cv, hot_len, cold_len, newest, n_split=n_split)
            want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
            torch.testing.assert_close(got, want, **TOL[dtype], msg=lambda m: f"H={h} KV={kv} D={d} "
                                       f"lens={(hot_len, cold_len, newest, n_split)}: {m}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tiered_rejects_unbuilt_shapes(cuda_device):
    """A group above 16 or a head dim not built raises; nothing falls back."""
    z = lambda *s: torch.zeros(s, device=cuda_device)
    for h, kv, d in [(17, 1, 64), (34, 2, 64), (4, 1, 48), (4, 1, 512)]:
        with pytest.raises(ValueError, match="built for"):
            ops.tiered_decode_attention(z(1, h, 1, d), z(1, kv, 8, d), z(1, kv, 8, d), z(1, kv, 8, d),
                                        z(1, kv, 8, d), 4, 4, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiered_cache_evict_resume_round_trip(cuda_device, dtype, tmp_path):
    """A cache on the card parked in the store and resumed: its pinned host
    tier and device ring come back bit-identical, and the tiered kernel
    gives what it gives on a twin that was never parked."""
    from repro_torch.core import TwoLevelStore
    from repro_torch.serving import TieredKVCache

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(6)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    with TwoLevelStore(str(tmp_path / "pfs"), mem_capacity_bytes=16 * 2**20) as store:
        c = TieredKVCache(2, 2, 128, window=32, max_len=256, dtype=dt, page=16, device=cuda_device, store=store)
        twin = TieredKVCache(2, 2, 128, window=32, max_len=256, dtype=dt, page=16, device=cuda_device)
        for _ in range(150):
            k, v = rnd(2, 2, 128), rnd(2, 2, 128)
            c.append(k, v)
            twin.append(k, v)
        q = rnd(2, 8, 1, 128)
        assert torch.equal(c.attend(q), twin.attend(q))
        assert c.evict_to_store() == 150 and c.device_bytes() == c.host_bytes() == 0
        assert c.resume_from_store() == 150
        twin.flush_host()
        assert c.cold_k.is_pinned() and c.hot_k.is_cuda
        for name in ("cold_k", "cold_v", "hot_k", "hot_v"):
            assert torch.equal(getattr(c, name), getattr(twin, name)), name
        before = ops.launches()["tiered_decode"]
        assert torch.equal(c.attend(q), twin.attend(q))
        torch.cuda.synchronize()
        assert ops.launches()["tiered_decode"] - before == 2
        c.close()


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
    assert ops.launches() == {"tiered_decode": base.n_layers * 12, "flash_attention": base.n_layers,
                              "rglru": 0, "mlstm": 0}
    plain, *_ = tiered_serve_loop(make_model(plain_cfg), plain_cfg, params, prompts, 12, 16, 8,
                                  torch.float32, "plain")
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_matches_plain(cuda_device, dtype):
    """The RG-LRU kernel against ``ref.rglru_ref``: one step, ragged S and
    W (not multiples of the unroll or the block), and a wide W."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    before = ops.launches()["rglru"]
    shapes = [(1, 1, 64), (2, 300, 50), (2, 37, 130), (1, 64, 1024)]
    for b, s, w in shapes:
        a = (0.5 + 0.5 * torch.rand((b, s, w), generator=g, device=cuda_device)).to(dt)
        x = torch.randn((b, s, w), generator=g, device=cuda_device).to(dt)
        torch.testing.assert_close(ops.rglru_scan(a, x), tref.rglru_ref(a, x), **TOL[dtype])
    torch.cuda.synchronize()
    assert ops.launches()["rglru"] - before == len(shapes)


def _mlstm_inputs(g, b, h, s, d, dt, device):
    rnd = lambda *shape: torch.randn(shape, generator=g, device=device)
    q, k, v = rnd(b, h, s, d).to(dt), (rnd(b, h, s, d) / d**0.5).to(dt), rnd(b, h, s, d).to(dt)
    i_pre = (0.5 * rnd(b, h, s)).to(dt)
    f_log = torch.nn.functional.logsigmoid(rnd(b, h, s) + 2.0).to(dt)
    return q, k, v, i_pre, f_log


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 384])
def test_cuda_mlstm_matches_plain(cuda_device, dtype, d):
    """The chunkwise mLSTM kernel against ``ref.mlstm_ref``: h and the
    carry-out, from the empty history (None, and an m = -inf carry-in), over
    a ragged S, and from a non-zero carry-in (the carry-out of a first
    segment), which must continue the sequence."""
    dt = getattr(torch, dtype)
    tol = MLSTM_TOL[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(2)
    b, h, s1, s2 = 2, 2, 70, 45
    q, k, v, ip, fl = _mlstm_inputs(g, b, h, s1 + s2, d, dt, cuda_device)
    first = lambda t: t[:, :, :s1].contiguous()
    second = lambda t: t[:, :, s1:].contiguous()
    want_h, want_carry = tref.mlstm_ref(q, k, v, ip, fl)
    fresh = (torch.zeros((b, h, d, d), device=cuda_device), torch.zeros((b, h, d), device=cuda_device),
             torch.full((b, h), float("-inf"), device=cuda_device))
    h1, carry1 = ops.mlstm_chunkwise(*map(first, (q, k, v, ip, fl)))
    h1_inf, carry1_inf = ops.mlstm_chunkwise(*map(first, (q, k, v, ip, fl)), fresh)
    h2, carry2 = ops.mlstm_chunkwise(*map(second, (q, k, v, ip, fl)), carry1)
    torch.cuda.synchronize()
    torch.testing.assert_close(h1_inf, h1, rtol=0, atol=0)
    for got, want in zip(carry1_inf, carry1):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat([h1, h2], dim=2), want_h, **tol)
    for got, want in zip(carry2, want_carry):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_cuda_recurrent_serve_matches_plain(cuda_device, arch):
    """Reduced recurrent models in fp32 on the card: greedy tokens through
    the kernels (attn_impl "flash") equal tokens through the plain versions
    ("xla"), and every recurrent layer launched its kernel once in prefill."""
    import dataclasses

    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.serve import serve_loop

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_reduced(arch), dtype="float32")
    kinds = [spec.mixer for spec in make_model(base).prefix]
    ops.reset_launches()
    kern, *_ = serve_loop(dataclasses.replace(base, attn_impl="flash"), 2, 40, 8, device=cuda_device)
    launches = ops.launches()
    assert launches["rglru"] == kinds.count("rglru") and launches["mlstm"] == kinds.count("mlstm")
    assert launches["flash_attention"] == kinds.count("gqa")
    plain, *_ = serve_loop(dataclasses.replace(base, attn_impl="xla"), 2, 40, 8, device=cuda_device)
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)

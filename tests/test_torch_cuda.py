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
    """A group above 16 or a head dim above the largest built one raises;
    nothing falls back."""
    z = lambda *s: torch.zeros(s, device=cuda_device)
    for h, kv, d in [(17, 1, 64), (34, 2, 64), (4, 1, 384), (4, 1, 512)]:
        with pytest.raises(ValueError, match="built for"):
            ops.tiered_decode_attention(z(1, h, 1, d), z(1, kv, 8, d), z(1, kv, 8, d), z(1, kv, 8, d),
                                        z(1, kv, 8, d), 4, 4, 3)


# (B, H, KV, S, T, window, softcap) at the reduced command_r_35b and
# starcoder2_3b head dim D = 12, which no kernel is built for: ragged, T > S,
# a window, rows without a key (T < S: the mean of v) and softcap 30.
D12_FLASH_CASES = [(2, 8, 2, 50, 50, 0, 0.0), (2, 8, 2, 24, 64, 0, 0.0), (2, 8, 2, 96, 96, 16, 0.0),
                   (1, 2, 2, 40, 24, 0, 0.0), (1, 8, 2, 70, 70, 0, 30.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_at_head_dim_12(cuda_device, dtype):
    """Both launchers at D = 12 (zero-padded to the built 16, scale
    1/sqrt(12)) against their plain versions: flash at the edge cases above,
    the tiered batch entry at the planner's and at forced split counts, and
    the per-row entry; one launch an op, on the kernels only."""
    from repro_torch.kernels.tiered_decode import tiered_decode_rows_fwd

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(12)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    ops.reset_launches()
    for b, h, kv, s, t, window, cap in D12_FLASH_CASES:
        q, k, v = rnd(b, h, s, 12), rnd(b, kv, t, 12), rnd(b, kv, t, 12)
        kw = dict(window=window, logit_softcap=cap)
        got = ops.flash_attention(q, k, v, **kw)
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got, tref.attention_ref(q, k, v, **kw), **TOL[dtype])
    q, hk, hv, ck, cv = rnd(2, 8, 1, 12), rnd(2, 2, 16, 12), rnd(2, 2, 16, 12), rnd(2, 2, 64, 12), rnd(2, 2, 64, 12)
    for hot_len, cold_len, newest in TIERED_CASES:
        want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        torch.testing.assert_close(ops.tiered_decode_attention(q, hk, hv, ck, cv, hot_len, cold_len, newest), want,
                                   **TOL[dtype])
    for hot_len, cold_len, newest, n_split in SPLIT_CASES:
        want = tref.tiered_ring_attention_ref(q, hk, hv, ck, cv, hot_len, cold_len, newest)
        got = tiered_decode_attention_fwd(q, hk, hv, ck, cv, hot_len, cold_len, newest, n_split=n_split)
        torch.testing.assert_close(got, want, **TOL[dtype])
    args = _rows(g, ROWS_CASES, 8, 2, 12, dt, cuda_device)
    want = tref.tiered_rows_attention_ref(*args)
    torch.testing.assert_close(ops.tiered_decode_rows_attention(*args), want, **TOL[dtype])
    torch.testing.assert_close(tiered_decode_rows_fwd(*args, n_split=5), want, **TOL[dtype])
    torch.cuda.synchronize()
    assert ops.launches() == {"tiered_decode": len(TIERED_CASES), "flash_attention": len(D12_FLASH_CASES),
                              "rglru": 0, "mlstm": 0}
    assert ops.tiered_decode_rows_attention.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_softcap_at_grok_group(cuda_device, dtype):
    """grok-1's prefill attention cut in batch and length: G = 6 (48 query
    heads over 8 kv heads), D = 128, softcap 30, causal over ragged tiles and
    with T > S; bf16 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(13)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    ops.reset_launches()
    for s, t in ((300, 300), (130, 260)):
        q, k, v = rnd(1, 48, s, 128), rnd(1, 8, t, 128), rnd(1, 8, t, 128)
        got = ops.flash_attention(q, k, v, logit_softcap=30.0)
        torch.testing.assert_close(got, tref.attention_ref(q, k, v, logit_softcap=30.0), **TOL[dtype])
    torch.cuda.synchronize()
    assert ops.flash_path_launches() == ({"tensor_core": 2, "cuda_core": 0} if dtype == "bfloat16"
                                         else {"tensor_core": 0, "cuda_core": 2})


# (B, H, KV, S): whisper-large-v3's decoder prefill (MHA, 20 heads of 64,
# prompt 224 = 128 + 96: a partial last tile) and internvl2-1b's (14 over 2
# kv heads, G = 7, 256 patches + 768 tokens).
D64_SERVE_SHAPES = [(4, 20, 20, 224), (4, 14, 2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", D64_SERVE_SHAPES, ids=["whisper", "internvl2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_at_d64_serve_shapes(cuda_device, dtype, shape):
    """Causal flash at the two D = 64 prefill shapes of the encoder-decoder
    and VLM serve paths against ``ref.attention_ref``; bf16 on the tensor
    cores, fp32 on the CUDA cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    b, h, kv, s = shape
    g = torch.Generator(device=cuda_device).manual_seed(17)
    q, k, v = (torch.randn(dims, generator=g, device=cuda_device).to(dt)
               for dims in ((b, h, s, 64), (b, kv, s, 64), (b, kv, s, 64)))
    ops.reset_launches()
    got = ops.flash_attention(q, k, v)
    torch.testing.assert_close(got, tref.attention_ref(q, k, v), **TOL[dtype])
    assert ops.flash_path_launches() == ({"tensor_core": 1, "cuda_core": 0} if dtype == "bfloat16"
                                         else {"tensor_core": 0, "cuda_core": 1})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "grok_1_314b"])
def test_cuda_moe_matches_cpu_with_drops(cuda_device, arch):
    """moe_apply on the card against the CPU in fp32 (TF32 off) at a
    capacity factor of 0.5, where assignments are dropped: the same sorted
    assignments and kept mask, outputs within 1e-5 relative to their
    largest (the reference's fan-in init over the expert axis makes grok's
    outputs reach ~250, where fp32 itself is off by ~1e-4), the aux loss
    within 1e-6, and two card runs equal bit for bit (no atomics)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.nn import layers as L
    from repro_torch.nn.module import init_with_axes
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params, _ = init_with_axes(lambda s: L.moe_init(s, "ffn", cfg), 0, device="cpu")
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator().manual_seed(0))
    on_card = tree_map(lambda t: t.to(cuda_device), params["ffn"])
    want_route = L.moe_route(params["ffn"], x.reshape(1, -1, cfg.d_model), cfg)  # one dispatch group
    got_route = L.moe_route(on_card, x.to(cuda_device).reshape(1, -1, cfg.d_model), cfg)
    assert torch.equal(got_route.order.cpu(), want_route.order)
    assert torch.equal(got_route.keep.cpu(), want_route.keep) and not bool(want_route.keep.all())
    want, want_aux = L.moe_apply(params["ffn"], x, cfg)
    got, aux = L.moe_apply(on_card, x.to(cuda_device), cfg)
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel < 1e-5, rel
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, L.moe_apply(on_card, x.to(cuda_device), cfg)[0])


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
@pytest.mark.parametrize("with_store", [False, True], ids=["no_store", "store"])
def test_cuda_tiered_cache_copies_host_tier_directly(cuda_device, tmp_path, with_store):
    """A bf16 cache on the card against the same cache on the CPU: a
    prefill-sized block, then decode appends across two page boundaries.
    The flushes and stages copy the pinned host tier by direct DMA (no
    pageable memcpy in the trace) without a host wait where no store reads
    it; the host tier, the staged pages, the store's page blobs and the
    tiered kernel's output are bit-identical to the CPU cache's."""
    from repro_torch.core import TwoLevelStore
    from repro_torch.serving import TieredKVCache

    dt = torch.bfloat16
    b, kv, d, page = 2, 8, 128, 32
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(dt)
    prompt = (rnd(b, kv, 200, d), rnd(b, kv, 200, d))
    tokens = [(rnd(b, kv, d), rnd(b, kv, d)) for _ in range(70)]  # pages end at 224 and 256
    q = rnd(b, 8 * kv, 1, d)
    with TwoLevelStore(str(tmp_path / "pfs"), mem_capacity_bytes=64 * 2**20) as store:
        kw = dict(window=64, max_len=512, dtype=dt, page=page, store=store if with_store else None)
        c = TieredKVCache(b, kv, d, device=cuda_device, name="card", **kw)
        on_cpu = TieredKVCache(b, kv, d, device="cpu", name="cpu", **kw)
        assert c._host_event is not None and on_cpu._host_event is None
        on_cpu.append_block(*(x.cpu() for x in prompt))
        on_cpu.stage_cold()
        for k, v in tokens:
            on_cpu.append(k.cpu(), v.cpu())
            on_cpu.stage_cold()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            c.append_block(*prompt)
            c.stage_cold()
            for k, v in tokens:
                c.append(k, v)
                c.stage_cold()
            torch.cuda.synchronize()
        copies = [e.name() for e in prof.profiler.kineto_results.events() if e.name().startswith("Memcpy")]
        assert any("Pinned" in n for n in copies), copies
        assert not [n for n in copies if "Pageable" in n]
        runs = 2 * b * kv
        assert c.stats.dma_copies > 0 and c.stats.dma_copies % runs == 0
        if with_store:
            assert c.stats.host_waits > 0
            for p in range(270 // page):
                assert store.get(f"serving/kv/card/page_{p:06d}") == store.get(f"serving/kv/cpu/page_{p:06d}")
        else:
            assert c.stats.host_waits == 0
        got = c.attend(q)
        want = ops.tiered_decode_attention(q, on_cpu.hot_k.to(cuda_device), on_cpu.hot_v.to(cuda_device),
                                           on_cpu._cold_k_dev.to(cuda_device), on_cpu._cold_v_dev.to(cuda_device),
                                           on_cpu.hot_len, on_cpu.cold_len, on_cpu.ring_newest)
        assert torch.equal(got, want)
        for name in ("hot_k", "hot_v", "_cold_k_dev", "_cold_v_dev"):
            assert torch.equal(getattr(c, name).cpu(), getattr(on_cpu, name)), name
        for x, y in zip(c.host_views(), on_cpu.host_views()):
            assert x.shape == (b, kv, 270, d) and torch.equal(x, y)
        c.close()
        on_cpu.close()


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


# Rows of the per-row entry over a ring of 16: (staging capacity C_i,
# hot_len, cold_len, newest) — both tiers, hot only, cold only, a wrapped
# ring over a full cold buffer, no key, and a long row of 1088 keys.
ROWS_CASES = [(64, 16, 40, 15), (32, 12, 0, 11), (128, 0, 96, 7), (16, 16, 16, 5), (64, 0, 0, 0),
              (1024, 16, 1024, 3)]
ROWS_SHAPES = [(4, 4, 64), (8, 8, 128), (12, 2, 128), (24, 2, 256), (32, 8, 128), (16, 4, 256)]


def _rows(g, rows, h, kv, d, dt, device, w=16):
    rnd = lambda *s: torch.randn(s, generator=g, device=device).to(dt)
    q = rnd(len(rows), h, 1, d)
    hot_k, hot_v = [rnd(1, kv, w, d) for _ in rows], [rnd(1, kv, w, d) for _ in rows]
    cold_k, cold_v = [rnd(1, kv, c, d) for c, *_ in rows], [rnd(1, kv, c, d) for c, *_ in rows]
    return q, hot_k, hot_v, cold_k, cold_v, [r[1:] for r in rows]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiered_rows_matches_plain(cuda_device, dtype):
    """The per-row entry against ``ref.tiered_rows_attention_ref``: rows of
    mixed lengths and staging capacities, each its own allocation, at groups
    1, 4, 6 and 12 and head dims 64, 128 and 256, at the planned and at
    forced split counts (splits with no key)."""
    from repro_torch.kernels.tiered_decode import tiered_decode_rows_fwd

    assert {h // kv for h, kv, _ in ROWS_SHAPES} >= {1, 4, 6, 12} and {d for *_, d in ROWS_SHAPES} == {64, 128, 256}
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(7)
    before = ops.tiered_decode_rows_attention.launches
    for h, kv, d in ROWS_SHAPES:
        args = _rows(g, ROWS_CASES, h, kv, d, dt, cuda_device)
        want = tref.tiered_rows_attention_ref(*args)
        torch.testing.assert_close(ops.tiered_decode_rows_attention(*args), want, **TOL[dtype])
        for n_split in (1, 5, 17):
            torch.testing.assert_close(tiered_decode_rows_fwd(*args, n_split=n_split), want, **TOL[dtype],
                                       msg=lambda m: f"H={h} KV={kv} D={d} n_split={n_split}: {m}")
        assert not want[4].any()
    torch.cuda.synchronize()
    assert ops.tiered_decode_rows_attention.launches - before == len(ROWS_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_tiered_one_row_matches_batch_entry(cuda_device, dtype):
    """A one-row table gives what the batch entry gives on the same row, at
    the same split count (the same arithmetic in the same order)."""
    from repro_torch.kernels.tiered_decode import tiered_decode_rows_fwd

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(8)
    for c, hot_len, cold_len, newest in ROWS_CASES:
        q, hk, hv, ck, cv, lens = _rows(g, [(c, hot_len, cold_len, newest)], 32, 8, 128, dt, cuda_device)
        for n_split in (1, 4):
            got = tiered_decode_rows_fwd(q, hk, hv, ck, cv, lens, n_split=n_split)
            single = tiered_decode_attention_fwd(q, hk[0], hv[0], ck[0], cv[0], hot_len, cold_len, newest,
                                                 n_split=n_split)
            torch.testing.assert_close(got, single, **TOL[dtype])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_tiered_rows_refuses_bad_tables(cuda_device):
    """Rows on the card of mixed W, KV, D or dtype, lengths past a row's
    capacity, a row off contiguity, or more rows than the table holds,
    raise; nothing falls back."""
    from repro_torch.kernels.tiered_decode import MAX_ROWS

    g = torch.Generator(device=cuda_device).manual_seed(9)
    rows = [(64, 16, 40, 15), (32, 12, 0, 11)]
    fresh = lambda: list(_rows(g, rows, 8, 2, 64, torch.float32, cuda_device))
    bad = fresh()
    bad[1][1] = bad[1][1][:, :, :8].contiguous()  # W 8 beside W 16
    with pytest.raises(ValueError, match="every row"):
        ops.tiered_decode_rows_attention(*bad)
    bad = fresh()
    bad[3][1] = bad[3][1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        ops.tiered_decode_rows_attention(*bad)
    bad = fresh()
    bad[5] = [(16, 40, 15), (12, 33, 11)]  # cold_len 33 past C = 32
    with pytest.raises(ValueError, match="out of range"):
        ops.tiered_decode_rows_attention(*bad)
    bad = fresh()
    bad[2][0] = torch.randn(1, 2, 64, 16, device=cuda_device).transpose(2, 3)  # (1, 2, 16, 64), strided
    with pytest.raises(ValueError, match="contiguous"):
        ops.tiered_decode_rows_attention(*bad)
    many = _rows(g, [(16, 4, 0, 3)] * (MAX_ROWS + 1), 8, 2, 64, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="rows"):
        ops.tiered_decode_rows_attention(*many)


@pytest.mark.cuda
def test_cuda_sessions_match_plain(cuda_device):
    """Reduced qwen3 in fp32 on the card: sessions at different lengths
    decoded together through the per-row kernel give the tokens of the plain
    versions, with one per-row launch a layer a decode step and no
    single-row tiered launch."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.serve import init_params
    from repro_torch.serving import SessionScheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    params = init_params(make_model(base), seed=0, device=cuda_device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab, 30 + 7 * i).astype(np.int32) for i in range(4)]
    tokens = {}
    for impl, attn_impl in (("kernel", "flash"), ("plain", "xla")):
        cfg = dataclasses.replace(base, attn_impl=attn_impl)
        sched = SessionScheduler(make_model(cfg), cfg, params, window=16, page=8, max_batch=4, dtype=torch.float32,
                                 device=cuda_device, impl=impl)
        sids = [sched.submit(p, 10) for p in prompts]
        ops.reset_launches()
        dispatches = 0
        while sched._queue or sched._live():
            dispatches += sched.step()["batch"] > 0
        if impl == "kernel":
            assert ops.tiered_decode_rows_attention.launches == base.n_layers * dispatches
            assert ops.launches()["tiered_decode"] == 0
        tokens[impl] = [sched.session_tokens(s) for s in sids]
        sched.close()
    assert tokens["kernel"] == tokens["plain"]


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
@pytest.mark.parametrize("d", [32, 64, 128, 256, 384])
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_mlstm_waves_and_short_sequences(cuda_device, dtype):
    """The mLSTM kernel against ``ref.mlstm_ref`` (h and the carry-out) where
    the value-tile plan and the chunking reach their edges: B*H = 40 at
    D = 384 (more blocks than one wave), B*H = 1 (the narrow tile), S = 5
    (shorter than one chunk), S = 64 (whole chunks only), and a carry-in;
    each launch takes the tile the plan picks, and both D = 384 tiles run."""
    from repro_torch.kernels.mlstm import mlstm_chunkwise_fwd, plan_tile_v

    dt = getattr(torch, dtype)
    tol = MLSTM_TOL[dtype]
    g = torch.Generator(device=cuda_device).manual_seed(4)
    sms = ops.sm_count(cuda_device)
    cases = [(8, 5, 70, 384, False), (1, 1, 77, 384, False), (2, 2, 5, 384, False),
             (2, 2, 64, 384, False), (2, 3, 64, 128, True)]
    ops.reset_launches()
    tiles = []
    for b, h, s, d, with_carry in cases:
        q, k, v, ip, fl = _mlstm_inputs(g, b, h, s, d, dt, cuda_device)
        state = None
        if with_carry:
            _, state = tref.mlstm_ref(*_mlstm_inputs(g, b, h, 40, d, dt, cuda_device))
        got_h, got_carry = ops.mlstm_chunkwise(q, k, v, ip, fl, state)
        want_h, want_carry = tref.mlstm_ref(q, k, v, ip, fl, state)
        torch.cuda.synchronize()
        tv = plan_tile_v(d, b * h, sms)
        assert mlstm_chunkwise_fwd.last_grid == (tv, d // tv * b * h)
        tiles.append(tv)
        where = f"B*H {b * h}, S {s}, D {d}, TV {tv}"
        torch.testing.assert_close(got_h, want_h, **tol, msg=lambda m: f"h at {where}: {m}")
        for name, got, want in zip("Cnm", got_carry, want_carry):
            torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name} at {where}: {m}")
    assert ops.launches()["mlstm"] == len(cases)
    assert {tv for tv, (*_, d, _) in zip(tiles, cases) if d == 384} == {32, 48}
    assert sum(r["launches"] for r in ops.mlstm_grid_launches()) == len(cases)


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


def _grad_inputs(device):
    g = torch.Generator(device=device).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=device).requires_grad_()
    return {
        "flash_attention": lambda: ops.flash_attention(rnd(1, 2, 16, 32), rnd(1, 2, 16, 32), rnd(1, 2, 16, 32)),
        "tiered_decode": lambda: ops.tiered_decode_attention(rnd(1, 2, 1, 32), rnd(1, 2, 8, 32), rnd(1, 2, 8, 32),
                                                             rnd(1, 2, 16, 32), rnd(1, 2, 16, 32), 8, 16),
        "tiered_decode_rows": lambda: ops.tiered_decode_rows_attention(
            rnd(1, 2, 1, 32), [rnd(1, 2, 8, 32)], [rnd(1, 2, 8, 32)], [rnd(1, 2, 16, 32)], [rnd(1, 2, 16, 32)],
            torch.tensor([[8, 16, 7]], dtype=torch.int32)),
        "rglru": lambda: ops.rglru_scan(torch.rand(1, 16, 32, device=device), rnd(1, 16, 32)),
        "mlstm": lambda: ops.mlstm_chunkwise(rnd(1, 1, 16, 32), rnd(1, 1, 16, 32), rnd(1, 1, 16, 32),
                                             rnd(1, 1, 16), rnd(1, 1, 16)),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["flash_attention", "tiered_decode", "tiered_decode_rows", "rglru", "mlstm"])
def test_cuda_ops_refuse_inputs_that_require_grad(cuda_device, op):
    """A kernel has no backward: on CUDA inputs that require grad the op
    raises before launching, instead of returning a detached result."""
    before = (ops.launches(), ops.tiered_decode_rows_attention.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        _grad_inputs(cuda_device)[op]()
    assert (ops.launches(), ops.tiered_decode_rows_attention.launches) == before


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """One train step of reduced starcoder2 (fp32, TF32 off) on the card
    against the port's CPU step from the same params and batch: the loss,
    grad norm and every gradient within 2e-5; each updated parameter within
    the 2 * lr an Adam first step can move a value whose gradient is near
    zero, and the count and step advanced."""
    import dataclasses

    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.steps import init_state, make_loss_fn, make_train_step
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("starcoder2_3b"), dtype="float32")
    model, opt = make_model(cfg), AdamW(learning_rate=1e-3)
    cpu, _ = init_state(model, cfg, opt, seed=0, device="cpu")
    gpu = tree.tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 33)))
    batch = lambda dev: {"inputs": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    grads = {}
    for name, state, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, cuda_device)):
        params = tree.tree_map(lambda p: p.detach().requires_grad_(), state["params"])
        make_loss_fn(model, cfg)(params, batch(dev))[0].backward()
        grads[name] = [p.grad for p in tree.leaves(params)]
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-5, atol=2e-5 * float(b.abs().max()))
    step = make_train_step(model, cfg, opt)
    new_cpu, m_cpu = step(cpu, batch("cpu"))
    new_gpu, m_gpu = step(gpu, batch(cuda_device))
    for key in ("loss", "ce", "grad_norm", "lr"):
        torch.testing.assert_close(m_gpu[key].cpu(), m_cpu[key], rtol=2e-5, atol=0)
    for a, b in zip(tree.leaves(new_gpu["params"]), tree.leaves(new_cpu["params"])):
        assert float((a.cpu() - b).abs().max()) <= 2.0 * 1e-3 * (1 + 1e-3)
    assert int(new_gpu["step"]) == int(new_gpu["opt"]["count"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma_9b", "xlstm_125m"])
def test_cuda_recurrent_train_step_matches_cpu(cuda_device, arch):
    """The gradients of a reduced recurrent arch (fp32, TF32 off,
    ``remat="full"``) on the card against the port's CPU gradients from the
    same params and batch: the plain scans under autograd, recomputed by
    the rematerialised periods, with no kernel launched; the loss within
    2e-5 and every gradient within 2e-5 of the leaf's largest (1e-9
    absolute for leaves of rounding noise, as sLSTM's input-gate bias)."""
    import dataclasses

    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.steps import init_state, make_loss_fn
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32", remat="full")
    model = make_model(cfg)
    cpu, _ = init_state(model, cfg, AdamW(learning_rate=1e-3), seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 33)))
    before = ops.launches()
    out = {}
    for dev in ("cpu", "cuda"):
        params = tree.tree_map(lambda p: p.detach().to(dev).requires_grad_(), cpu["params"])
        loss, _ = make_loss_fn(model, cfg)(params, {"inputs": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)})
        loss.backward()
        out[dev] = (loss.detach().cpu(), [(tree.keystr(k), p.grad.cpu()) for k, p in tree.flatten_with_path(params)])
    assert ops.launches() == before
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=2e-5, atol=0)
    for (name, a), (_, b) in zip(out["cuda"][1], out["cpu"][1]):
        apart, scale = float((a - b).abs().max()), float(b.abs().max())
        assert apart <= 2e-5 * scale + 1e-9, (name, apart, scale)


@pytest.mark.cuda
def test_cuda_recurrent_blocks_take_plain_scans_under_grad(cuda_device):
    """With ``attn_impl="flash"`` the RG-LRU and mLSTM blocks launch their
    kernels under no_grad (serving) and take the plain scans under grad
    (training): no launch, and the gradient reaches the block's input."""
    import dataclasses

    from repro_torch.configs import get_reduced, make_model
    from repro_torch.nn import recurrent as R
    from repro_torch.nn.module import init_with_axes

    for arch, block, op in (("recurrentgemma_9b", R.rglru_block_apply, "rglru"),
                            ("xlstm_125m", R.mlstm_block_apply, "mlstm")):
        cfg = dataclasses.replace(get_reduced(arch), dtype="float32", attn_impl="flash")
        p = init_with_axes(make_model(cfg).init, 0, device=cuda_device)[0]["prefix_0"]["mixer"]
        x = torch.randn(2, 40, cfg.d_model, device=cuda_device, requires_grad=True)
        before = ops.launches()[op]
        y, _ = block(p, x, cfg)
        y.sum().backward()
        assert ops.launches()[op] == before and x.grad is not None and bool(x.grad.abs().sum() > 0)
        with torch.no_grad():
            y_kernel, _ = block(p, x, cfg)
        assert ops.launches()[op] == before + 1
        torch.testing.assert_close(y_kernel, y.detach(), rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_compression_matches_cpu(cuda_device):
    """Top-k compression with error feedback on the card equals the CPU's
    bit for bit over 3 rounds (ties at the threshold and an all-zero leaf
    included): the k-th value is exact, so the masks are the same."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.optim import topk_compress_with_ef

    rng = np.random.default_rng(1)
    ef = {"cpu": None, "cuda": None}
    for _ in range(3):
        ties = (rng.normal(size=(64, 32)) * 0.01).astype(np.float32)
        ties.flat[rng.permutation(ties.size)[:50]] = 2.0
        grads = {"w": torch.from_numpy(rng.normal(size=(512, 256)).astype(np.float32)), "ties": torch.from_numpy(ties),
                 "zero": torch.zeros(9, 7), "b": torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))}
        outs = {}
        for dev in ("cpu", "cuda"):
            sent, ef[dev], stats = topk_compress_with_ef(tree.tree_map(lambda t: t.to(dev), grads), ef[dev], 0.01)
            outs[dev] = (tree.leaves(sent), tree.leaves(ef[dev]), stats)
        assert outs["cuda"][2] == outs["cpu"][2]
        for a, b in zip(outs["cuda"][0] + outs["cuda"][1], outs["cpu"][0] + outs["cpu"][1]):
            assert a.is_cuda and torch.equal(a.cpu(), b)


@pytest.fixture()
def card_mesh(cuda_device, tmp_path):
    """A one-rank NCCL process group and a 1 x 1 ("data", "model") mesh on
    the card, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import _mk

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'pg'}", rank=0, world_size=1)
    try:
        yield _mk((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cuda_mesh_train_step_matches_plain(card_mesh):
    """Reduced starcoder2 in fp32: two steps of ``make_sharded_train_step`` on
    DTensor state over a world-size-1 NCCL mesh equal two plain steps on the
    card from the same state, loss and every state leaf to the bit."""
    import dataclasses

    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch import steps as S
    from repro_torch.optim.adamw import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("starcoder2_3b"), dtype="float32")
    model, opt = make_model(cfg), AdamW(learning_rate=1e-3)
    state, axes = S.init_state(model, cfg, opt, seed=0, device="cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (4, 33))).cuda()
    batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    sh = S.state_shardings(state, axes, card_mesh)
    dstate = S.shard_state(tree.tree_map(torch.clone, state), sh)
    dbatch = S.shard_state(batch, S.batch_shardings(batch, card_mesh))
    plain, sharded = S.make_train_step(model, cfg, opt), S.make_sharded_train_step(model, cfg, opt, sh)
    for _ in range(2):
        state, m = plain(state, batch)
        dstate, dm = sharded(dstate, dbatch)
        assert torch.equal(dm["loss"], m["loss"])
    for (path, a), (_, b) in zip(tree.flatten_with_path(dstate), tree.flatten_with_path(state)):
        assert torch.equal(a.full_tensor(), b), path


@pytest.mark.cuda
def test_cuda_restore_sharded_onto_card_mesh(card_mesh, tmp_path):
    """A checkpoint of reduced qwen3's params (bf16 matrices, fp32 head)
    restores onto the card's mesh from a meta template: DTensor leaves on
    the card, each equal to the saved one, and greedy tokens served from
    their local tensors equal those served from the originals."""
    import numpy as np

    from repro_torch import tree
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.core import TwoLevelStore
    from repro_torch.launch import steps as S
    from repro_torch.launch.serve import init_params
    from repro_torch.nn.layers import cdtype
    from repro_torch.nn.module import init_with_axes, matrix_cast
    from repro_torch.runtime import CheckpointManager

    cfg = get_reduced("qwen3_8b")
    model = make_model(cfg)
    params = init_params(model, seed=0, device="cuda")
    template, axes = init_with_axes(model.init, 0, device="meta", cast=matrix_cast(cdtype(cfg), ("head",)))
    with TwoLevelStore(str(tmp_path / "store"), mem_capacity_bytes=8 * 2**20, block_bytes=2**20) as st:
        cm = CheckpointManager(st, tag="p")
        cm.save(3, params)
        step, got = cm.restore_sharded(template, S.state_shardings({"params": template}, axes, card_mesh)["params"])
    assert step == 3
    for (path, a), (_, b) in zip(tree.flatten_with_path(got), tree.flatten_with_path(params)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, path
        assert torch.equal(a.full_tensor(), b), path
    local = tree.tree_map(lambda x: x.to_local(), got)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24))).cuda()
    out = [S.tiered_serve_loop(model, cfg, p, prompts, 8, window=8, page=4)[0] for p in (local, params)]
    assert torch.equal(out[0], out[1])


def _share_cfg(d: int, f: int, experts: int, held: int, lo: int, top_k: int):
    """An expert share's config at a kernel test's widths (its MoE fields only matter)."""
    import dataclasses

    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import MoEConfig

    base = get_reduced("command_a_plus_05_2026")
    return dataclasses.replace(base, d_model=d, experts_held=held, experts_lo=lo,
                               moe=MoEConfig(n_experts=experts, top_k=top_k, expert_ff=f, n_shared=0,
                                             router_type="sigmoid"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens,skew", [(16, False), (700, False), (300, True)], ids=["decode", "prefill", "skewed"])
def test_cuda_moe_grouped_matches_plain(cuda_device, dtype, tokens, skew):
    """The grouped expert product against its plain twin: the rows that
    ``route_share`` lays out for 8 held experts of 32 (tiles of 16 at
    decode, 128 at a prefill; a skewed router sends most rows to one held
    expert, several tiles long), at widths the column and depth blocks do
    not divide (d 192, f 96), in fp32 and bf16; one launch counted."""
    from repro_torch.kernels import ref
    from repro_torch.nn import layers as L

    dt = getattr(torch, dtype)
    cfg = _share_cfg(192, 96, 32, 8, 8, 4)
    g = torch.Generator(device="cpu").manual_seed(0)
    x = torch.randn(tokens, 192, generator=g).to(dt)
    router = torch.randn(192, 32, generator=g) / 14
    if skew:
        router[:, 9] += 1.0  # held expert 1 of the share wins most tokens
    w = [torch.randn(8, *shape, generator=g).div(shape[0] ** 0.5).to(dt) for shape in ((192, 96), (192, 96), (96, 192))]
    r = L.route_share({"router": router}, x.float(), cfg, L.moe_tile(tokens, cfg))
    want = ref.moe_grouped_ref(x, *w, r.rows, r.tile_expert, r.gate, 4)
    dev = lambda t: t.to(cuda_device)
    before = ops.moe_grouped_ffn.launches
    got = ops.moe_grouped_ffn(dev(x), *map(dev, w), dev(r.rows), dev(r.tile_expert), dev(r.gate), 4).cpu()
    assert ops.moe_grouped_ffn.launches - before == 1
    used = r.rows < tokens * 4
    assert int(used.sum()) == int(r.held) > 0
    torch.testing.assert_close(got[used], want[used], **TOL[dtype])
    assert torch.all(got[(r.rows == tokens * 4) & (r.tile_expert.repeat_interleave(r.rows.shape[0] // r.tile_expert.shape[0]) < 8)] == 0)


@pytest.mark.cuda
def test_cuda_cmda_sessions_match_cpu(cuda_device):
    """Reduced Command A+ in fp32: sessions at different lengths, one
    shorter than the tiered ring and two past the sliding window, served
    through ``SessionScheduler`` on the card (flash prefill, the per-row
    kernel over tiered caches and sliding rings, the grouped expert
    product) give the CPU's plain tokens, with one rows launch a layer a
    decode dispatch and no assignment dropped."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_reduced, make_model
    from repro_torch.nn import layers as L
    from repro_torch.nn.module import init_with_axes
    from repro_torch.serving import SessionScheduler
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    base = dataclasses.replace(get_reduced("command_a_plus_05_2026"), dtype="float32")
    params, _ = init_with_axes(make_model(base).init, 0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, base.vocab, n).astype(np.int32) for n in (5, 23, 41)]
    tokens = {}
    for device, impl, attn_impl in ((cuda_device, "kernel", "flash"), (torch.device("cpu"), "plain", "xla")):
        cfg = dataclasses.replace(base, attn_impl=attn_impl)
        sched = SessionScheduler(make_model(cfg), cfg, tree_map(lambda t: t.to(device), params), window=8, page=4, max_batch=3, dtype=torch.float32,
                                 device=device, impl=impl, admit_per_step=3)
        sids = [sched.submit(q, 9) for q in prompts]
        ops.reset_launches()
        L.reset_moe_counts()
        dispatches = 0
        while sched._queue or sched._live():
            dispatches += sched.step()["batch"] > 0
        if device.type == "cuda":
            assert ops.tiered_decode_rows_attention.launches == base.n_layers * dispatches
            assert ops.moe_grouped_ffn.launches == base.n_layers * (dispatches + len(prompts))
            counts = L.moe_counts()
            assert counts["dropped"] == 0 and 0 < counts["held"] < counts["routed"]
        tokens[device.type] = [sched.session_tokens(s) for s in sids]
        sched.close()
    assert tokens["cuda"] == tokens["cpu"]

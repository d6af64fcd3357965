"""The port's two-level serving path on the CPU: ``TieredKVCache`` (ports of
the non-store tests of ``tests/test_kv_offload.py``) and the whole slice —
``tiered_serve_loop`` tokens equal to the JAX package's on the same
parameters and prompts, and to the port's own dense decode.

Cache tolerances are those of ``tests/test_kv_offload.py`` (fp32, 2e-4 /
3e-4 against plain attention over the full history); tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.launch.steps import tiered_serve_loop as jax_tiered_serve_loop
from repro.nn.module import init_with_axes as jax_init
import repro_torch.configs as tcfgs
from repro_torch.kernels import ref
from repro_torch.launch.steps import (
    make_prefill_step,
    make_serve_step,
    tiered_cache_stats,
    tiered_serve_loop,
)
from repro_torch.nn.module import params_from_jax
from repro_torch.serving import TieredKVCache

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

B, KV, H, D, W = 2, 2, 4, 32, 8


def cache(**kw):
    kw.setdefault("dtype", torch.float32)
    return TieredKVCache(B, KV, D, window=kw.pop("window", W), max_len=kw.pop("max_len", 64), device="cpu", **kw)


def rand_token(rng):
    return (torch.from_numpy(rng.normal(size=(B, KV, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, KV, D)).astype(np.float32)))


def rand_q(rng):
    return torch.from_numpy(rng.normal(size=(B, H, 1, D)).astype(np.float32))


def full_ref(c, q, all_k, all_v):
    return ref.decode_attention_ref(q, torch.stack(all_k, dim=2), torch.stack(all_v, dim=2), c.length)


def close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=tol, atol=tol)


class TestTieredKVCache:
    def test_attend_matches_full_reference(self):
        rng = np.random.default_rng(0)
        c = cache()
        all_k, all_v = [], []
        for _ in range(3 * W + 2):  # well past the ring
            k, v = rand_token(rng)
            c.append(k, v)
            all_k.append(k)
            all_v.append(v)
        q = rand_q(rng)
        close(c.attend(q, impl="kernel"), full_ref(c, q, all_k, all_v), 2e-4)
        close(c.attend(q, impl="plain"), full_ref(c, q, all_k, all_v), 2e-4)

    def test_all_hot_phase(self):
        rng = np.random.default_rng(1)
        c = cache(max_len=32)
        for _ in range(W - 2):
            c.append(*rand_token(rng))
        c.attend(rand_q(rng))
        assert c.cold_len == 0
        assert c.stats.hot_fraction() == 1.0
        assert c.stats.bytes_staged == 0

    def test_blend_fraction_tracks_paper_f(self):
        rng = np.random.default_rng(2)
        c = cache()
        n = 3 * W
        for _ in range(n):
            c.append(*rand_token(rng))
        c.attend(rand_q(rng))
        assert c.stats.hot_fraction() == pytest.approx(W / n)

    def test_rebuild_hot_from_cold_is_exact(self):
        rng = np.random.default_rng(3)
        c = cache()
        for _ in range(2 * W + 3):
            c.append(*rand_token(rng))
        c.flush_host()
        before_k = c.hot_k.clone()
        c.hot_k = torch.zeros_like(c.hot_k)  # simulate device-memory loss
        c.rebuild_hot_from_cold()
        torch.testing.assert_close(c.hot_k, before_k, rtol=0, atol=0)

    def test_rebuild_works_with_bf16_host_tier(self):
        rng = np.random.default_rng(7)
        c = cache(dtype=torch.bfloat16)
        for _ in range(2 * W + 1):
            c.append(*rand_token(rng))
        c.flush_host()
        assert c.cold_k.dtype == torch.bfloat16
        before_k = c.hot_k.clone()
        c.hot_k = torch.zeros_like(c.hot_k)
        c.rebuild_hot_from_cold()
        torch.testing.assert_close(c.hot_k, before_k, rtol=0, atol=0)

    def test_capacity_accounting(self):
        c = cache(max_len=128, dtype=torch.bfloat16)
        assert c.hot_device_bytes() == 2 * B * KV * W * D * 2
        assert c.host_bytes() == 2 * B * KV * 128 * D * 2
        assert c.hot_device_bytes() < c.host_bytes()
        assert c.host_bytes() * 2 == cache(max_len=128).host_bytes()
        assert c.device_bytes() == c.hot_device_bytes() + c.staged_device_bytes()

    def test_overflow_raises(self):
        rng = np.random.default_rng(4)
        c = cache(window=4, max_len=6)
        for _ in range(6):
            c.append(*rand_token(rng))
        with pytest.raises(ValueError, match="cache full"):
            c.append(*rand_token(rng))

    def test_page_must_fit_window(self):
        with pytest.raises(ValueError, match="page"):
            cache(window=4, max_len=16, page=8)


class TestPagedStaging:
    def _fill(self, c, rng, n, attend_every=1, impl="kernel"):
        all_k, all_v = [], []
        q = rand_q(rng)
        for i in range(n):
            k, v = rand_token(rng)
            c.append(k, v)
            all_k.append(k)
            all_v.append(v)
            if (i + 1) % attend_every == 0:
                close(c.attend(q, impl=impl), full_ref(c, q, all_k, all_v), 3e-4)
        return all_k, all_v, q

    def test_attend_across_page_boundaries(self):
        rng = np.random.default_rng(5)
        self._fill(cache(page=4), rng, 3 * W + 3, attend_every=1)

    def test_plain_impl_across_page_boundaries(self):
        rng = np.random.default_rng(6)
        self._fill(cache(page=4), rng, 2 * W + 3, attend_every=4, impl="plain")

    def test_partial_tail_page_masked(self):
        rng = np.random.default_rng(8)
        c = cache(page=5)
        all_k, all_v, q = self._fill(c, rng, W + 2, attend_every=W + 2)
        assert c.cold_len == 5
        assert c.hot_len == 5
        close(c.attend(q), full_ref(c, q, all_k, all_v), 3e-4)

    def test_pages_upload_at_most_once(self):
        rng = np.random.default_rng(9)
        page = 4
        c = cache(max_len=128, page=page)
        self._fill(c, rng, 4 * W, attend_every=1)
        page_bytes = 2 * B * KV * page * D * 4
        n_pages = c.cold_len // page
        assert c.stats.pages_staged == n_pages
        assert c.stats.bytes_staged == n_pages * page_bytes
        before = c.stats.bytes_staged
        c.attend(rand_q(rng))
        c.stage_cold()
        assert c.stats.bytes_staged == before

    def test_attend_after_ring_wrap_and_rebuild(self):
        rng = np.random.default_rng(10)
        c = cache(page=4)
        all_k, all_v, q = self._fill(c, rng, 3 * W + 1, attend_every=8)
        pages_before = c.stats.pages_staged
        c.hot_k = torch.zeros_like(c.hot_k)
        c.hot_v = torch.zeros_like(c.hot_v)
        c.rebuild_hot_from_cold()
        close(c.attend(q), full_ref(c, q, all_k, all_v), 3e-4)
        assert c.stats.pages_staged == pages_before + c.cold_len // 4

    def test_batched_write_through(self):
        rng = np.random.default_rng(11)
        c = cache(max_len=128, page=4)
        all_k, all_v = [], []
        for _ in range(40):
            k, v = rand_token(rng)
            c.append(k, v)
            all_k.append(k)
            all_v.append(v)
        assert c.stats.d2h_flushes < c.stats.appended / 2
        hk, hv = c.host_views()
        torch.testing.assert_close(hk, torch.stack(all_k, dim=2), rtol=0, atol=0)
        torch.testing.assert_close(hv, torch.stack(all_v, dim=2), rtol=0, atol=0)

    def test_append_block_matches_token_appends(self):
        rng = np.random.default_rng(12)
        ks = torch.from_numpy(rng.normal(size=(B, KV, 21, D)).astype(np.float32))
        vs = torch.from_numpy(rng.normal(size=(B, KV, 21, D)).astype(np.float32))
        bulk = cache(page=4)
        bulk.append_block(ks, vs)
        loop = cache(page=4)
        for i in range(21):
            loop.append(ks[:, :, i, :], vs[:, :, i, :])
        torch.testing.assert_close(bulk.hot_k, loop.hot_k, rtol=0, atol=0)
        torch.testing.assert_close(bulk.hot_v, loop.hot_v, rtol=0, atol=0)
        torch.testing.assert_close(bulk.host_views()[0], loop.host_views()[0], rtol=0, atol=0)

    def test_host_tier_matches_jax_byte_layout(self):
        """Same appends into both packages' caches: the host tiers hold the
        same bytes (bf16, page cut (B, KV, page, D), k then v)."""
        from repro.serving import TieredKVCache as JCache

        rng = np.random.default_rng(13)
        jc = JCache(B, KV, D, window=W, max_len=64, dtype=jnp.bfloat16, page=4)
        tc = cache(dtype=torch.bfloat16, page=4)
        for _ in range(19):
            k = rng.normal(size=(B, KV, D)).astype(np.float32)
            v = rng.normal(size=(B, KV, D)).astype(np.float32)
            jc.append(jnp.asarray(k), jnp.asarray(v))
            tc.append(torch.from_numpy(k), torch.from_numpy(v))
        jk, jv = jc.host_views()
        tk, tv = tc.host_views()
        page = lambda x, p: np.ascontiguousarray(x[:, :, 4 * p : 4 * p + 4]).tobytes()
        for p in range(19 // 4):
            assert page(tk.view(torch.int16).numpy(), p) == page(np.asarray(jk).view(np.int16), p)
            assert page(tv.view(torch.int16).numpy(), p) == page(np.asarray(jv).view(np.int16), p)


class FakeEvent:
    """``torch.cuda.Event`` on the CPU: the records and waits of a card's
    cache, counted."""

    records = waits = 0

    def record(self, stream=None):
        FakeEvent.records += 1

    def synchronize(self):
        FakeEvent.waits += 1


def with_fake_event(c, monkeypatch):
    """Give a CPU cache the event a cache on the card records after its
    host-tier copies, so its host reads wait as on the card."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    FakeEvent.records = FakeEvent.waits = 0
    c._host_event = FakeEvent()
    return c


class TestHostTierCopies:
    @pytest.mark.parametrize("direction", ["flush", "stage"])
    @pytest.mark.parametrize("lo, hi", [(16, 48), (5, 39)], ids=["aligned", "unaligned"])
    @pytest.mark.parametrize("kv", [1, 8])
    @pytest.mark.parametrize("b", [1, 4])
    def test_runs_copy_the_bytes_of_a_slice_copy(self, b, kv, lo, hi, direction):
        """A token range copied run by run, (batch row, kv head) at a time,
        gives the bytes of one slice copy of the range: into the host tier
        from a contiguous block, or out of it into the staging buffer."""
        from repro_torch.serving.kv_offload import copy_runs

        g = torch.Generator().manual_seed(b * 100 + kv * 10 + lo)
        rnd = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
        host, staging, block = rnd(b, kv, 64, 16), rnd(b, kv, 64, 16), rnd(b, kv, hi - lo, 16)
        if direction == "flush":
            want, got = host.clone(), host.clone()
            want[:, :, lo:hi].copy_(block)
            runs = copy_runs(got[:, :, lo:hi], block)
        else:
            want, got = staging.clone(), staging.clone()
            want[:, :, lo:hi].copy_(host[:, :, lo:hi])
            runs = copy_runs(got[:, :, lo:hi], host[:, :, lo:hi])
        assert runs == b * kv
        assert got.view(torch.int16).numpy().tobytes() == want.view(torch.int16).numpy().tobytes()
        assert all(t[i, h, lo:hi].is_contiguous() for t in (host, staging) for i in range(b) for h in range(kv))

    def test_cpu_cache_counts_no_dma(self, monkeypatch):
        """A cache on the CPU copies its host tier by the same runs as on the
        card, but none is a DMA and nothing waits: both counters stay 0."""
        from repro_torch.serving import kv_offload

        runs = []
        copy_runs = kv_offload.copy_runs
        monkeypatch.setattr(kv_offload, "copy_runs", lambda d, s: runs.append(copy_runs(d, s)) or runs[-1])
        rng = np.random.default_rng(14)
        c = cache(page=4)
        for _ in range(3 * W):
            c.append(*rand_token(rng))
        c.attend(rand_q(rng))
        c.host_views()
        assert c._host_event is None and runs and all(r == B * KV for r in runs)
        assert c.stats.dma_copies == c.stats.host_waits == 0

    @pytest.mark.parametrize("with_store", [False, True], ids=["no_store", "store"])
    def test_direct_path_waits_only_where_the_host_reads(self, monkeypatch, tmp_path, with_store):
        """A cache that records the card's event after its host-tier copies
        against one that does not, same appends: the same attention, host
        tier and store blobs.  Flush and stage never wait; the host waits
        where it reads the tier (store blobs, ``host_views``, the ring
        rebuild), once per batch of copies."""
        from repro_torch.core.store import TwoLevelStore

        rng = np.random.default_rng(15)
        with TwoLevelStore(str(tmp_path / "pfs"), mem_capacity_bytes=4 << 20) as store:
            kw = dict(dtype=torch.bfloat16, page=4)
            c = with_fake_event(cache(store=store, name="d", **kw) if with_store else cache(**kw), monkeypatch)
            plain = cache(store=store, name="p", **kw) if with_store else cache(**kw)
            ks, vs = (torch.from_numpy(rng.normal(size=(B, KV, 13, D)).astype(np.float32)) for _ in range(2))
            for x in (c, plain):
                x.append_block(ks, vs)
            q = rand_q(rng)
            for _ in range(2 * W + 1):
                k, v = rand_token(rng)
                for x in (c, plain):
                    x.append(k, v)
                assert torch.equal(c.attend(q), plain.attend(q))
            runs = 2 * B * KV  # k and v, one run a (batch row, kv head)
            assert c.stats.dma_copies > runs * c.stats.d2h_flushes and c.stats.dma_copies % runs == 0
            assert FakeEvent.records == c.stats.dma_copies // (B * KV)  # one record a k or v copy
            assert plain.stats.dma_copies == 0
            if with_store:
                assert 0 < c.stats.host_waits == FakeEvent.waits <= c.stats.d2h_flushes
                for p in range(c.length // 4):
                    assert store.get(f"serving/kv/d/page_{p:06d}") == store.get(f"serving/kv/p/page_{p:06d}")
            else:
                assert c.stats.host_waits == FakeEvent.waits == 0
            before = c.stats.host_waits
            for got, want in zip(c.host_views(), plain.host_views()):
                assert torch.equal(got, want)
            assert c.stats.host_waits == FakeEvent.waits == before + 1
            c.rebuild_hot_from_cold()
            assert c.stats.host_waits == before + 1  # nothing copied since the last wait
            assert torch.equal(c.attend(q), plain.attend(q))
            assert c.stats.host_waits == before + 1  # the re-stage issued copies, none waited for
            c.close()
            plain.close()


# ------------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3, fp32, unrolled, JAX params carried over to the port."""
    jc = dataclasses.replace(jcfgs.get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    jm = jcfgs.make_model(jc)
    jp, _ = jax_init(jm.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    tc = dataclasses.replace(tcfgs.get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    prompts = np.random.default_rng(0).integers(0, jc.vocab, (2, 12)).astype(np.int32)
    return jc, jm, jp, tc, params_from_jax(jp, device="cpu"), prompts


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_tiered_serve_loop_matches_jax(qwen, attn_impl):
    """The slice end to end: same params, same prompts, greedy tokens through
    both packages' two-level caches (B=2, S=12, T=6, W=6, page=3)."""
    jc, jm, jp, tc, tp, prompts = qwen
    jc = dataclasses.replace(jc, attn_impl=attn_impl)
    tc = dataclasses.replace(tc, attn_impl=attn_impl)
    jgen, _, _, jcaches = jax_tiered_serve_loop(jcfgs.make_model(jc), jc, jp, jnp.asarray(prompts), 6,
                                                window=6, page=3, dtype=jnp.float32)
    gen, _, _, caches = tiered_serve_loop(tcfgs.make_model(tc), tc, tp, torch.from_numpy(prompts).long(), 6,
                                          window=6, page=3, dtype=torch.float32)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(jgen))
    st = tiered_cache_stats(caches)
    assert st["layers"] == tc.n_layers and st["hot_fraction"] < 1.0 and st["pages_staged"] > 0
    from repro.launch.steps import tiered_cache_stats as jax_stats

    jst = jax_stats(jcaches)
    for key in ("length", "hot_fraction", "bytes_staged", "pages_staged", "bytes_written_through", "d2h_flushes"):
        assert st[key] == pytest.approx(jst[key]), key


def test_tiered_kv_serving_matches_dense_decode(qwen):
    """Port of test_serving.py::test_tiered_kv_serving_matches_dense_decode:
    the tiered path reproduces the port's dense dict-cache decode token for
    token, and the plain attend path gives the same tokens."""
    _, _, _, tc, tp, prompts = qwen
    model = tcfgs.make_model(tc)
    prompts = torch.from_numpy(prompts).long()
    caches = model.init_caches(2, 12 + 6 + 1, torch.float32, device="cpu")
    tok, caches = make_prefill_step(model, tc)(tp, {"inputs": prompts}, caches)
    tok = tok[:, None]
    out = [tok]
    step = make_serve_step(model, tc)
    for _ in range(6):
        tok, caches = step(tp, tok, caches)
        out.append(tok)
    dense = torch.cat(out, dim=1)
    gen, _, _, tcaches = tiered_serve_loop(model, tc, tp, prompts, 6, window=6, page=3, dtype=torch.float32)
    torch.testing.assert_close(gen, dense, rtol=0, atol=0)
    plain, *_ = tiered_serve_loop(model, tc, tp, prompts, 6, window=6, page=3, dtype=torch.float32, impl="plain")
    torch.testing.assert_close(plain, dense, rtol=0, atol=0)
    st = tiered_cache_stats(tcaches)
    assert st["layers"] > 0 and st["hot_fraction"] < 1.0
    assert st["pages_staged"] > 0


def test_serve_entry_points_on_cpu():
    """The serve driver's functions run when the caller asks for the CPU."""
    from repro_torch.launch.serve import serve_loop, tiered_serve

    cfg = tcfgs.get_reduced("qwen3_8b")
    gen, _, _, st = tiered_serve(cfg, 2, 20, 4, window=8, page=4, device="cpu")
    assert tuple(gen.shape) == (2, 5) and st["layers"] == cfg.n_layers and st["pages_staged"] > 0
    gen_x, _, _, _ = tiered_serve(cfg, 2, 20, 4, window=8, page=4, device="cpu", attn_impl="xla")
    assert torch.equal(gen, gen_x)  # flash prefill (the default) and masked softmax agree
    gen2, _, _ = serve_loop(cfg, 2, 20, 4, device="cpu")
    assert tuple(gen2.shape) == (2, 5)


@pytest.mark.parametrize("kind", ["dense", "tiered"])
def test_starcoder2_decode_matches_jax(kind):
    """Reduced starcoder2 (LayerNorm, biases, tanh-GELU MLP, tied head), fp32,
    JAX params: greedy tokens equal and every step's logits within 1e-4 of
    the largest |logit|, through the dense dict caches and through the
    two-level caches (window 6, page 3: the ring wraps, pages stage)."""
    from repro.launch.steps import make_tiered_caches as jax_tiered_caches
    from repro_torch.launch.steps import make_tiered_caches

    jc = dataclasses.replace(jcfgs.get_reduced("starcoder2_3b"), dtype="float32", scan_layers=False)
    tc = dataclasses.replace(tcfgs.get_reduced("starcoder2_3b"), dtype="float32", scan_layers=False)
    jm, tm = jcfgs.make_model(jc), tcfgs.make_model(tc)
    jp, _ = jax_init(jm.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_jax(jp, device="cpu")
    b, s, steps = 2, 12, 6
    prompts = np.random.default_rng(1).integers(0, jc.vocab, (b, s)).astype(np.int32)
    if kind == "dense":
        jcaches = jm.init_caches(b, s + steps + 1, jnp.float32)
        tcaches = tm.init_caches(b, s + steps + 1, torch.float32, device="cpu")
    else:
        jcaches = jax_tiered_caches(jm, jc, b, s + steps + 1, 6, 3, jnp.float32)
        tcaches = make_tiered_caches(tm, tc, b, s + steps + 1, 6, 3, torch.float32, device="cpu")
    jl, jcaches = jm.prefill(jp, jnp.asarray(prompts), jcaches)
    tl, tcaches = tm.prefill(tp, torch.from_numpy(prompts).long(), tcaches)
    for _ in range(steps + 1):
        want = np.asarray(jl[:, -1])
        got = tl[:, -1].numpy()
        assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
        jtok, ttok = want.argmax(-1), got.argmax(-1)
        np.testing.assert_array_equal(ttok, jtok)
        jl, jcaches = jm.decode_step(jp, jnp.asarray(jtok[:, None], jnp.int32), jcaches)
        tl, tcaches = tm.decode_step(tp, torch.from_numpy(ttok[:, None]).long(), tcaches)
    if kind == "tiered":
        st = tiered_cache_stats(tcaches)
        assert st["layers"] == tc.n_layers and st["pages_staged"] > 0 and st["hot_fraction"] < 1.0

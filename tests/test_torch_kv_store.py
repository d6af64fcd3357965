"""The store level of the port's two-level KV cache on the CPU.

Ports of ``tests/test_kv_offload.py::TestStoreOffload`` against
``repro_torch.serving.TieredKVCache(store=...)``; eviction to the store and
resume, bit-identical; the shared page registry; the arbiter pool returned
on ``close`` (as ``tests/test_arbiter.py`` checks the JAX cache); pages,
tail and manifest persisted by one package and restored or resumed by the
other, bit for bit, in fp32 and bf16; and the ``--store-root`` CLI.
"""

import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.serving import TieredKVCache as JaxTieredKVCache
import repro_torch.core as tcore
from repro_torch.core.arbiter import MemoryArbiter
from repro_torch.kernels import ref
from repro_torch.serving import SharedPageRegistry, TieredKVCache

B, KV, H, D, W = 2, 2, 4, 32, 8
MB = 2**20


def rand_token(rng):
    return (torch.from_numpy(rng.normal(size=(B, KV, D)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, KV, D)).astype(np.float32)))


def mk_store(pkg, root):
    return pkg.TwoLevelStore(str(root / "pfs"), mem_capacity_bytes=8 * MB, block_bytes=256 * 1024,
                             stripe_bytes=64 * 1024, n_pfs_servers=2)


def cache(store=None, dtype=torch.float32, max_len=64, **kw):
    return TieredKVCache(B, KV, D, window=W, max_len=max_len, dtype=dtype, page=4, device="cpu",
                         store=store, **kw)


class TestStoreOffload:
    """Ports of ``tests/test_kv_offload.py::TestStoreOffload``."""

    def test_completed_pages_persisted_once(self, tmp_path):
        rng = np.random.default_rng(21)
        with mk_store(tcore, tmp_path) as store:
            c = cache(store, name="c0")
            for _ in range(19):
                c.append(*rand_token(rng))
            c.flush_host()
            store.drain()
            assert c.stats.pages_persisted == 19 // 4
            for p in range(19 // 4):
                assert store.exists(f"serving/kv/c0/page_{p:06d}")
            assert not store.exists(f"serving/kv/c0/page_{19 // 4:06d}")  # partial tail: never
            persisted = c.stats.bytes_persisted
            c.flush_host()  # idempotent: completed pages go exactly once
            assert c.stats.bytes_persisted == persisted

    def test_restore_after_host_loss_is_bit_identical(self, tmp_path):
        rng = np.random.default_rng(22)
        with mk_store(tcore, tmp_path) as store:
            c = cache(store, name="c0")
            all_k, all_v = [], []
            for _ in range(23):
                k, v = rand_token(rng)
                all_k.append(k)
                all_v.append(v)
                c.append(k, v)
            c.flush_host()
            store.drain()

            fresh = cache(store, name="c0")  # host memory lost: a fresh cache on the same store
            n = fresh.restore_cold_from_store()
            assert n == (23 // 4) * 4  # durable prefix: last full page boundary
            assert torch.equal(fresh.cold_k[:, :, :n], c.cold_k[:, :, :n])
            assert torch.equal(fresh.cold_v[:, :, :n], c.cold_v[:, :, :n])
            q = torch.from_numpy(rng.normal(size=(B, H, 1, D)).astype(np.float32))
            want = ref.decode_attention_ref(q, torch.stack(all_k[:n], dim=2), torch.stack(all_v[:n], dim=2), n)
            np.testing.assert_allclose(fresh.attend(q, impl="plain").numpy(), want.numpy(), atol=2e-2)

    def test_restore_without_store_raises(self):
        c = cache(max_len=32)
        with pytest.raises(RuntimeError):
            c.restore_cold_from_store()

    def test_restore_on_live_cache_resets_to_durable_prefix(self, tmp_path):
        rng = np.random.default_rng(23)
        with mk_store(tcore, tmp_path) as store:
            c = cache(store, name="c0")
            for _ in range(23):
                c.append(*rand_token(rng))
            c.flush_host()
            store.drain()
            c.cold_k.zero_()  # host-memory loss under the live object
            c.cold_v.zero_()
            n = c.restore_cold_from_store()
            assert n == (23 // 4) * 4
            assert c.length == n and c._flushed == n
            k, v = rand_token(rng)
            c.append(k, v)  # must not trip the pending/flush invariant
            c.flush_host()
            assert torch.equal(c.cold_k[:, :, n], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_evict_resume_is_bit_identical_and_decodes_on(tmp_path, dtype):
    """A parked cache holds no device or host bytes; resumed, its tiers are
    bit-identical at the full length (tail included) and it attends and
    appends on exactly as a cache that was never parked."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(24)
    with mk_store(tcore, tmp_path) as store:
        c, twin = cache(store, dt, name="c0"), cache(None, dt)
        for _ in range(23):
            k, v = rand_token(rng)
            c.append(k, v)
            twin.append(k, v)
        assert c.evict_to_store() == 23
        assert c.device_bytes() == 0 and c.host_bytes() == 0
        with pytest.raises(RuntimeError, match="evicted"):
            c.append(*rand_token(rng))
        assert c.resume_from_store() == 23
        assert c.stats.evictions == 1 and c.stats.resumes == 1
        twin.flush_host()
        for name in ("cold_k", "cold_v", "hot_k", "hot_v"):
            assert torch.equal(getattr(c, name), getattr(twin, name)), name
        k, v = rand_token(rng)
        c.append(k, v)
        twin.append(k, v)
        q = torch.from_numpy(rng.normal(size=(B, H, 1, D)).astype(np.float32))
        assert torch.equal(c.attend(q), twin.attend(q))
        assert c.drop_staging() > 0 and c.stats.demotions == 1
        assert torch.equal(c.attend(q), twin.attend(q))  # re-staged from the host tier


def test_close_releases_arbiter_pool():
    """As ``tests/test_arbiter.py::test_kv_cache_close_releases_arbiter_pool``
    holds the JAX cache: a retired cache returns its pool, once."""
    arb = MemoryArbiter(total_bytes=64 * MB)
    c = TieredKVCache(1, 2, 16, window=8, max_len=64, dtype=torch.float32, device="cpu")
    c.attach_arbiter(arb)
    assert "kv_staging" in arb.report()["pools"]
    before = arb.releases
    c.close()
    assert arb.releases == before + 1
    assert "kv_staging" not in arb.report()["pools"]
    c.close()  # idempotent: no second release
    assert arb.releases == before + 1
    c2 = TieredKVCache(1, 2, 16, window=8, max_len=64, dtype=torch.float32, device="cpu")
    c2.attach_arbiter(arb)  # the freed name is reusable
    assert "kv_staging" in arb.report()["pools"]
    c2.close()
    assert arb.releases == before + 2


def test_shared_registry_stores_a_shared_prefix_once(tmp_path):
    """Two caches whose histories share 12 tokens (3 pages): the shared
    pages are stored once; each resumes bit-identical; closing one keeps the
    pages the other still maps, closing both frees every page."""
    rng = np.random.default_rng(25)
    prefix = [rand_token(rng) for _ in range(12)]
    with mk_store(tcore, tmp_path) as store:
        pages = SharedPageRegistry(store)
        a, b = (cache(name=n, pages=pages) for n in ("a", "b"))
        for c in (a, b):
            for k, v in prefix + [rand_token(rng) for _ in range(9)]:
                c.append(k, v)
            c.flush_host()
        assert pages.pages_logical == 10 and pages.pages_stored == 7  # 3 shared + 2 x 2 private
        assert pages.dedup_ratio() == pytest.approx(10 / 7)
        snapshot = a.cold_k.clone()
        a.evict_to_store()
        assert a.resume_from_store() == 21
        assert torch.equal(a.cold_k, snapshot)
        shared = a._page_keys[:3]
        assert shared == b._page_keys[:3]
        a.close()
        assert all(pages.refcount(k) == 1 and store.exists(f"serving/pages/{k}") for k in shared)
        b.close()
        assert pages.live_pages() == 0


def _bits(x) -> np.ndarray:
    """The raw bits of a host tier (torch tensor or numpy array, fp32 or bf16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int32 if x.dtype == torch.float32 else torch.int16).numpy().copy()
    return np.asarray(x).view(np.int32 if x.dtype.itemsize == 4 else np.int16).copy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_pages_persisted_by_one_package_restore_in_the_other(tmp_path, writer, dtype):
    """One package's cache evicts into its store (pages, tail, manifest);
    the other package's store at the same root restores the durable prefix
    and resumes the full history, bit for bit."""
    rng = np.random.default_rng(26)
    toks = [(rng.normal(size=(B, KV, D)).astype(np.float32), rng.normal(size=(B, KV, D)).astype(np.float32))
            for _ in range(23)]

    def make(pkg, store):
        if pkg is jcore:
            return JaxTieredKVCache(B, KV, D, window=W, max_len=64, dtype=getattr(jnp, dtype), page=4,
                                    store=store, name="c0")
        return cache(store, getattr(torch, dtype), name="c0")

    w_pkg, r_pkg = (jcore, tcore) if writer == "jax_package" else (tcore, jcore)
    with mk_store(w_pkg, tmp_path) as store:
        c = make(w_pkg, store)
        for k, v in toks:
            if w_pkg is jcore:
                c.append(jnp.asarray(k), jnp.asarray(v))
            else:
                c.append(torch.from_numpy(k), torch.from_numpy(v))
        c.flush_host()
        want_k, want_v = _bits(c.cold_k[:, :, :23]), _bits(c.cold_v[:, :, :23])
        c.evict_to_store()
    with mk_store(r_pkg, tmp_path) as store:
        restored = make(r_pkg, store)
        assert restored.restore_cold_from_store() == 20
        np.testing.assert_array_equal(_bits(restored.cold_k[:, :, :20]), want_k[:, :, :20])
        np.testing.assert_array_equal(_bits(restored.cold_v[:, :, :20]), want_v[:, :, :20])
        resumed = make(r_pkg, store)
        assert resumed.resume_from_store() == 23
        np.testing.assert_array_equal(_bits(resumed.cold_k[:, :, :23]), want_k)
        np.testing.assert_array_equal(_bits(resumed.cold_v[:, :, :23]), want_v)


def test_serve_cli_persists_pages_through_store_root(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import serve

    root = tmp_path / "kvstore"
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-8b", "--reduced", "--batch", "2",
                                      "--prompt-len", "20", "--tokens", "6", "--kv-window", "8", "--kv-page",
                                      "4", "--store-root", str(root), "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    line = next(l for l in out.splitlines() if l.startswith(f"store {root}"))
    n_pages = int(line.split(": ")[1].split()[0])
    assert n_pages > 0 and "bytes" in line
    with tcore.TwoLevelStore(str(root)) as store:
        assert store.exists("serving/kv/prefix_0/page_000000")


def test_make_tiered_caches_routes_store_prefix_and_shared_pages(tmp_path):
    """Two sessions' caches from ``make_tiered_caches`` over one registry,
    prefilled with the same prompt: each full-attention layer persists its
    manifest under ``<store_prefix>/prefix_<i>/`` and the pages of both
    sessions are stored once."""
    from repro_torch.configs import get_reduced, make_model
    from repro_torch.launch.serve import init_params
    from repro_torch.launch.steps import make_prefill_step, make_tiered_caches

    cfg = dataclasses.replace(get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    model = make_model(cfg)
    params = init_params(model, seed=0, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(27).integers(0, cfg.vocab, (2, 12)))
    with mk_store(tcore, tmp_path) as store:
        pages = SharedPageRegistry(store)
        sessions = []
        for prefix in ("sess_a/kv", "sess_b/kv"):
            caches = make_tiered_caches(model, cfg, 2, 16, 4, 4, torch.float32, "cpu", store=store,
                                        store_prefix=prefix, pages=pages)
            _, caches = make_prefill_step(model, cfg)(params, {"inputs": prompts}, caches)
            tiered = {k: c for k, c in caches.items() if isinstance(c, TieredKVCache)}
            for c in tiered.values():
                c.flush_host()
            sessions.append(tiered)
        a, b = sessions
        assert a and list(a) == list(b)
        for key, c in a.items():
            c.evict_to_store()
            assert store.exists(f"sess_a/kv/{key}/manifest")
        a, b = list(a.values()), list(b.values())
        per_layer = 12 // 4
        assert pages.pages_logical == 2 * per_layer * len(a) and pages.pages_stored == per_layer * len(a)
        for c, other in zip(a, b):
            c.resume_from_store()
            assert torch.equal(c.cold_k[:, :, :12], other.cold_k[:, :, :12])
            c.close()
            other.close()
        assert pages.live_pages() == 0

"""The port's multi-session serving plane on the CPU.

Ports of ``tests/test_serve_sessions.py`` against
``repro_torch.serving.SessionScheduler`` on ``repro_torch.core``; the port's
scheduler against the JAX package's on the same parameters, prompts and
budgets (tokens and counters equal, evictions forced); the per-row tiered
op's plain version and split arithmetic against the JAX session plane's
vmapped oracle (fp32, 2e-5, as ``tests/test_kernels.py``); the per-row
launcher's refusals; and the ``--sessions`` CLI.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.core as jcore
import repro_torch.core as tcore
from repro.kernels import tiered_decode_attention as jax_tiered
from repro.kernels.ref import tiered_ring_attention_ref as jax_tiered_ref
from repro.nn.module import init_with_axes as jax_init
from repro.serving import SessionScheduler as JaxSessionScheduler
import repro_torch.configs as tcfgs
from repro_torch.core.arbiter import MemoryArbiter
from repro_torch.core.store import TwoLevelStore
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tiered_decode import MAX_ROWS, split_merge_rows_plain, tiered_decode_rows_fwd
from repro_torch.nn.module import params_from_jax
from repro_torch.serving import SessionKVBatch, SessionScheduler, SessionState, SharedPageRegistry, TieredKVCache

torch.backends.cuda.matmul.allow_tf32 = False

PROMPT, NEW, WINDOW, PAGE = 10, 4, 4, 2


@pytest.fixture(scope="module")
def lm():
    """Reduced qwen3, fp32, unrolled; the JAX init carried over to the port."""
    jc = dataclasses.replace(jcfgs.get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    jm = jcfgs.make_model(jc)
    jp, _ = jax_init(jm.init, jax.random.PRNGKey(0), dtype=jnp.float32)
    tc = dataclasses.replace(tcfgs.get_reduced("qwen3_8b"), dtype="float32", scan_layers=False)
    return tcfgs.make_model(tc), tc, params_from_jax(jp, device="cpu"), (jm, jc, jp)


def make_sched(lm, **kw):
    model, cfg, params, _ = lm
    kw.setdefault("window", WINDOW)
    kw.setdefault("page", PAGE)
    kw.setdefault("max_batch", 2)
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("device", "cpu")
    return SessionScheduler(model, cfg, params, **kw)


def mk_store(pkg, root):
    return pkg.TwoLevelStore(str(root), mem_capacity_bytes=8 << 20, block_bytes=128 << 10, stripe_bytes=32 << 10)


def prompts(cfg, n, shared=0, seed=0, length=PROMPT):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, cfg.vocab, size=shared)
    return [
        np.concatenate([head, rng.integers(1, cfg.vocab, size=length - shared)]).astype(np.int32)
        for _ in range(n)
    ]


def decode_all(sched, ps, new_tokens=NEW):
    sids = [sched.submit(p, new_tokens) for p in ps]
    sched.run(max_steps=200)
    return {sid: sched.session_tokens(sid) for sid in sids}


class TestLifecycle:
    def test_admit_decode_retire(self, lm):
        """QUEUED → ACTIVE → RETIRED; every session finishes with exactly
        max_new_tokens and a recorded TTFT; caches are torn down."""
        _, cfg, _, _ = lm
        sched = make_sched(lm)
        sids = [sched.submit(p, NEW) for p in prompts(cfg, 3)]
        assert all(sched._sessions[s].state is SessionState.QUEUED for s in sids)
        rep = sched.run(max_steps=200)
        assert rep["retired"] == rep["sessions"] == 3
        assert rep["prefills"] == 3
        for sid in sids:
            sess = sched._sessions[sid]
            assert sess.state is SessionState.RETIRED
            assert sess.caches is None  # retire must free the tiers
            assert len(sess.tokens) == NEW
            assert sess.ttft_s is not None and sess.ttft_s > 0
        sched.close()

    def test_continuous_batching_interleaves(self, lm):
        """With max_batch < sessions, decode steps interleave sessions
        (round-robin on last_step) instead of running them serially."""
        _, cfg, _, _ = lm
        sched = make_sched(lm, max_batch=2, admit_per_step=4)
        toks = decode_all(sched, prompts(cfg, 4))
        assert sched.decoded_tokens == sum(len(t) - 1 for t in toks.values())
        assert sched.retired == 4
        sched.close()

    def test_batching_matches_unbatched_tokens(self, lm):
        """Batched decode (the per-row op, sessions at different lengths, per-row
        RoPE positions) gives the same tokens as max_batch=1 serial decode."""
        _, cfg, _, _ = lm
        ps = prompts(cfg, 3)
        batched = decode_all(make_sched(lm, max_batch=3, admit_per_step=3), ps)
        serial = decode_all(make_sched(lm, max_batch=1, admit_per_step=1), ps)
        assert list(batched.values()) == list(serial.values())

    def test_report_sums_host_tier_copies_over_every_session(self, lm, monkeypatch):
        """``dma_copies`` and ``host_waits`` in the report count the caches of
        retired sessions too.  On the CPU both are 0; with the first two
        sessions' caches given the event a card's cache records after its
        copies, every run they issue is counted, the tokens are unchanged and
        no host read waits (no store)."""
        _, cfg, _, _ = lm
        ps = prompts(cfg, 3)
        sched = make_sched(lm, max_batch=2)
        want = decode_all(sched, ps, new_tokens=3 * NEW)
        rep = sched.report()
        assert rep["dma_copies"] == rep["host_waits"] == 0

        class Event:  # torch.cuda.Event on the CPU; no host read waits here
            def record(self, stream=None):
                pass

        monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
        sched = make_sched(lm, max_batch=2)
        sids = [sched.submit(p, 3 * NEW) for p in ps]
        sched.step()  # admits the first two
        counted = [c for s in sched._live() for c in sched._tiered(s)]
        assert len(counted) == 2 * cfg.n_layers
        for c in counted:
            c._host_event = Event()
        while not any(c.stats.dma_copies for c in counted):
            sched.step()
        live = sched.report()
        assert live["retired"] == 0 and live["dma_copies"] == sum(c.stats.dma_copies for c in counted)
        sched.run(max_steps=200)
        assert [sched.session_tokens(s) for s in sids] == list(want.values())
        rep = sched.report()
        assert rep["retired"] == 3 and rep["dma_copies"] == sum(c.stats.dma_copies for c in counted)
        assert rep["dma_copies"] > live["dma_copies"] and rep["host_waits"] == 0
        sched.close()


class TestTierOverflow:
    def test_evict_resume_token_identical(self, lm, tmp_path):
        """Sessions parked in the store mid-generation resume bit-exactly:
        the over-capacity run's tokens equal the unbounded control run's."""
        _, cfg, _, _ = lm
        ps = prompts(cfg, 4, shared=6)
        with mk_store(tcore, tmp_path / "pfs") as store:
            sched = make_sched(lm, store=store, host_bytes=1, admit_per_step=4)
            toks = decode_all(sched, ps)
            rep = sched.report()
            assert rep["evictions"] >= 1 and rep["resumes"] >= 1
            assert [s.sid for s in sched._sessions.values() if s.evictions]
            sched.close()
        ctrl = decode_all(make_sched(lm, admit_per_step=4), ps)
        assert list(toks.values()) == list(ctrl.values())

    def test_hbm_pressure_demotes_mid_decode(self, lm):
        """An aggregate device budget below the staging footprint drops LRU
        staging buffers mid-decode; the tokens are untouched (the next
        attend re-stages).  Generations run long enough for the staging
        buffer to grow past its one-block floor."""
        _, cfg, _, _ = lm
        ps = prompts(cfg, 2)
        new = 14
        sched = make_sched(lm, hbm_bytes=1, admit_per_step=2)
        toks = decode_all(sched, ps, new_tokens=new)
        assert sched.demotions >= 1
        sched.close()
        ctrl = decode_all(make_sched(lm, admit_per_step=2), ps, new_tokens=new)
        assert list(toks.values()) == list(ctrl.values())


class TestPrefixSharing:
    def test_registry_refcounts_no_double_free(self, tmp_path):
        """Two holders of one page: first decref keeps the blob, second
        deletes it — a retiring session can't free a live session's page."""
        with TwoLevelStore(str(tmp_path / "pfs"), mem_capacity_bytes=4 << 20, block_bytes=64 << 10,
                           stripe_bytes=32 << 10) as store:
            reg = SharedPageRegistry(store, prefix="t/pages")
            blob = b"\x01" * 4096
            k1 = reg.put(blob)
            k2 = reg.put(blob)
            assert k1 == k2
            assert reg.pages_logical == 2 and reg.pages_stored == 1
            assert reg.refcount(k1) == 2
            assert reg.fetch(k1) == blob
            assert reg.decref(k1) is False  # one holder left
            assert reg.fetch(k1) == blob
            assert reg.decref(k1) is True  # last ref: physically deleted
            assert reg.live_pages() == 0
            with pytest.raises(Exception):
                reg.fetch(k1)
            reg.adopt([k1, k1])  # rebuilds counts after a registry restart
            assert reg.refcount(k1) == 2
            assert reg.dedup_ratio() > 1.0

    def test_shared_prefix_pages_stored_once_and_reclaimed(self, lm, tmp_path):
        """Sessions sharing a prompt prefix dedup their cold pages; once every
        session retires, no physical page survives."""
        _, cfg, _, _ = lm
        ps = prompts(cfg, 4, shared=6)
        with mk_store(tcore, tmp_path / "pfs") as store:
            sched = make_sched(lm, store=store, host_bytes=1, admit_per_step=4)
            decode_all(sched, ps)
            rep = sched.report()
            assert rep["pages_stored"] < rep["pages_logical"]
            assert rep["dedup_ratio"] > 1.0
            assert sched.pages.live_pages() == 0  # all retired: every reference dropped
            sched.close()


class TestArbiterIntegration:
    def test_close_releases_tier_pools(self, lm):
        """The scheduler's serve_hbm/serve_host pools return to the pot on
        close; closing twice is safe."""
        _, cfg, _, _ = lm
        arb = MemoryArbiter(total_bytes=64 << 20)
        sched = make_sched(lm, arbiter=arb)
        assert {"serve_hbm", "serve_host"} <= set(arb.report()["pools"])
        decode_all(sched, prompts(cfg, 2))
        before = arb.releases
        sched.close()
        assert arb.releases == before + 2
        assert not ({"serve_hbm", "serve_host"} & set(arb.report()["pools"]))
        sched.close()  # idempotent
        assert arb.releases == before + 2


COUNTERS = ("sessions", "retired", "steps", "prefills", "decoded_tokens", "evictions", "resumes", "demotions",
            "pages_logical", "pages_stored")


def test_scheduler_matches_jax(lm, tmp_path):
    """The port's scheduler and the JAX package's on the same parameters and
    prompts (5 sessions with a shared prefix, max_batch 2, a store each,
    host budget 2.5 sessions' history and a device budget below the staging
    buffers): the same tokens per session and the same counters, with
    evictions, resumes and demotions forced."""
    model, cfg, params, (jm, jc, jp) = lm
    ps = prompts(cfg, 5, shared=6, seed=3)
    new = 8
    per_session_host = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * (PROMPT + new + 1) * 4 * cfg.n_layers
    budgets = dict(host_bytes=5 * per_session_host // 2, hbm_bytes=1)
    with mk_store(jcore, tmp_path / "jax") as jstore, mk_store(tcore, tmp_path / "pt") as tstore:
        jsched = JaxSessionScheduler(jm, jc, jp, window=WINDOW, page=PAGE, max_batch=2, dtype=jnp.float32,
                                     store=jstore, **budgets)
        tsched = make_sched(lm, store=tstore, **budgets)
        jtoks = decode_all(jsched, ps, new)
        ttoks = decode_all(tsched, ps, new)
        jrep, trep = jsched.report(), tsched.report()
        jsched.close()
        tsched.close()
    assert ttoks == jtoks
    assert {k: trep[k] for k in COUNTERS} == {k: jrep[k] for k in COUNTERS}
    assert trep["evictions"] >= 1 and trep["resumes"] >= 1 and trep["demotions"] >= 1
    assert trep["pages_stored"] < trep["pages_logical"]


def test_session_batch_attend_is_the_rows_op(lm):
    """A ``SessionKVBatch`` over caches at different lengths and staging
    capacities: per-row positions, and one per-row op whose rows equal each
    cache's own attend (both impls), counting each cache's tier reads."""
    rng = np.random.default_rng(4)
    kv, d, h = 2, 16, 4
    caches = [TieredKVCache(1, kv, d, window=4, max_len=40, dtype=torch.float32, page=2, device="cpu")
              for _ in range(3)]
    for c, n in zip(caches, (3, 11, 30)):
        for _ in range(n):
            c.append(*(torch.from_numpy(rng.normal(size=(1, kv, d)).astype(np.float32)) for _ in range(2)))
    batch = SessionKVBatch(caches, SessionKVBatch.positions_of(caches))
    assert batch.row_positions().tolist() == [[3], [11], [30]]
    q = torch.from_numpy(rng.normal(size=(3, h, 1, d)).astype(np.float32))
    before = ops.tiered_decode_rows_attention.launches
    for impl in ("kernel", "plain"):
        got = batch.attend(q, impl=impl)
        for i, c in enumerate(caches):
            torch.testing.assert_close(got[i:i + 1], c.attend(q[i:i + 1], impl="plain"), rtol=0, atol=0)
    assert ops.tiered_decode_rows_attention.launches == before  # CPU tensors: the plain version, no launch
    assert len({c._cap for c in caches}) > 1
    for c in caches:  # two batched attends, two of its own
        assert c.stats.hot_hits_tokens == 4 * c.hot_len and c.stats.cold_reads_tokens == 4 * c.cold_len


# Rows of the per-row op over a ring of W = 8: (capacity C, hot_len,
# cold_len, ring_newest) — no key, hot only, cold only, a wrapped ring over
# a full cold buffer, both tiers, in three capacity groups.
W_ROWS, KV_ROWS, H_ROWS, D_ROWS = 8, 2, 6, 16
ROWS = [(16, 0, 0, 0), (16, 5, 0, 4), (32, 0, 24, 3), (8, 8, 8, 2), (32, 6, 20, 7), (16, 8, 14, 1)]


def rows_inputs(seed):
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s).astype(np.float32)
    q = arr(len(ROWS), H_ROWS, 1, D_ROWS)
    hot = [(arr(1, KV_ROWS, W_ROWS, D_ROWS), arr(1, KV_ROWS, W_ROWS, D_ROWS)) for _ in ROWS]
    cold = [(arr(1, KV_ROWS, c, D_ROWS), arr(1, KV_ROWS, c, D_ROWS)) for c, *_ in ROWS]
    lens = [r[1:] for r in ROWS]
    return q, hot, cold, lens


def jax_rows(q, hot, cold, lens):
    """The JAX session plane's oracle: ``jax.vmap(tiered_ring_attention_ref)``
    over the rows of each capacity group, stacked with their batch-1 dims.
    A row with no key (which no session has: the decode step appends before
    it attends) is the Pallas kernel's 0 instead, in interpret mode; the
    oracle softmaxes W + C equal -1e30 scores there."""
    out = [None] * len(lens)
    groups: dict[int, list[int]] = {}
    for i, (ck, _) in enumerate(cold):
        groups.setdefault(ck.shape[2], []).append(i)
    for idxs in groups.values():
        got = jax.vmap(jax_tiered_ref)(
            jnp.stack([q[i:i + 1] for i in idxs]), jnp.stack([hot[i][0] for i in idxs]),
            jnp.stack([hot[i][1] for i in idxs]), jnp.stack([cold[i][0] for i in idxs]),
            jnp.stack([cold[i][1] for i in idxs]), *(jnp.asarray([lens[i][j] for i in idxs], jnp.int32)
                                                     for j in range(3)))
        for j, i in enumerate(idxs):
            out[i] = np.asarray(got[j])
    for i, (hot_len, cold_len, newest) in enumerate(lens):
        if hot_len + cold_len == 0:
            out[i] = np.asarray(jax_tiered(q[i:i + 1], *hot[i], *cold[i], hot_len=0, cold_len=0, ring_newest=newest,
                                           block_k=8, interpret=True))
    return np.concatenate(out)


def torch_rows(q, hot, cold):
    t = torch.from_numpy
    return (t(q), [t(k) for k, _ in hot], [t(v) for _, v in hot], [t(k) for k, _ in cold], [t(v) for _, v in cold])


def test_rows_ref_matches_jax_vmapped_oracle():
    q, hot, cold, lens = rows_inputs(5)
    want = jax_rows(q, hot, cold, lens)
    got = ref.tiered_rows_attention_ref(*torch_rows(q, hot, cold), lens)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert not got[0].any()  # the row with no key gives 0
    # The op on CPU tensors is the plain version; a lens tensor reads the same.
    got_op = ops.tiered_decode_rows_attention(*torch_rows(q, hot, cold), torch.tensor(lens, dtype=torch.int32))
    torch.testing.assert_close(got_op, got, rtol=0, atol=0)


@pytest.mark.parametrize("n_split", [1, 3, 7])
def test_rows_split_merge_matches_jax(n_split):
    """Every row cut into the same n_split ranges of its own keys (some rows
    with empty splits, one with no key) merges to the vmapped oracle."""
    q, hot, cold, lens = rows_inputs(6)
    got = split_merge_rows_plain(*torch_rows(q, hot, cold), lens, n_split)
    np.testing.assert_allclose(got.numpy(), jax_rows(q, hot, cold, lens), rtol=2e-5, atol=2e-5)


def _rows_operands(n=3, w=(8, 8, 8), kv=(2, 2, 2), d=(16, 16, 16), dtypes=(torch.float32,) * 3):
    z = torch.zeros
    hot = [z(1, kv[i], w[i], d[i], dtype=dtypes[i]) for i in range(n)]
    cold = [z(1, kv[i], 16, d[i], dtype=dtypes[i]) for i in range(n)]
    return z(n, 4, 1, 16), hot, hot, cold, cold, [(2, 4, 1)] * n


@pytest.mark.parametrize("case,error,match", [
    (dict(w=(8, 4, 8)), ValueError, "every row"),
    (dict(kv=(2, 1, 2)), ValueError, "every row"),
    (dict(d=(16, 16, 32)), ValueError, "every row"),
    (dict(dtypes=(torch.float32, torch.bfloat16, torch.float32)), TypeError, "one dtype"),
    ("too_many", ValueError, f"1 to {MAX_ROWS} rows"),
])
def test_rows_launcher_refuses_bad_tables(case, error, match):
    """Mixed W, KV, D or dtype, or more rows than the kernel's table holds,
    raise before any device is touched: there is no fallback."""
    if case == "too_many":
        n = MAX_ROWS + 1
        args = _rows_operands(n, (8,) * n, (2,) * n, (16,) * n, (torch.float32,) * n)
    else:
        args = _rows_operands(**case)
    with pytest.raises(error, match=match):
        tiered_decode_rows_fwd(*args)


def test_sessions_cli_prints_report(tmp_path, monkeypatch, capsys):
    """``--sessions`` on the CPU: the reference's report lines, with evictions
    into ``--store-root`` and shared prefix pages stored once."""
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-8b", "--reduced", "--sessions", "4", "--max-batch", "2", "--prompt-len", "12",
        "--tokens", "4", "--kv-window", "4", "--kv-page", "2", "--shared-prefix", "8", "--store-root",
        str(tmp_path / "kv"), "--host-budget-kb", "16", "--device", "cpu"])
    serve.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("sessions 4 (retired 4) over ") and lines[0].endswith("max_batch 2")
    assert lines[1].startswith("decode 12 tokens: ")
    assert lines[2].startswith("ttft p50 ")
    overflow = lines[3].split()
    assert lines[3].startswith("tier overflow: ") and int(overflow[4]) >= 1  # evictions
    assert lines[3].endswith("host tier: 0 direct copies, 0 host waits")  # no DMA on the CPU
    logical, stored = int(lines[4].split()[2]), int(lines[4].split()[5])
    assert lines[4].startswith("shared pages: ") and stored < logical


def test_sessions_cli_needs_kv_window(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen3-8b", "--reduced", "--sessions", "2", "--device",
                                      "cpu"])
    with pytest.raises(SystemExit, match="--kv-window"):
        serve.main()

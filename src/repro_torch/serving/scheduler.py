"""Continuous-batching session scheduler over tiered KV caches — the port of
``repro/serving/scheduler.py``.

The serving plane of many concurrent decode sessions multiplexed over the
three-level memory hierarchy (device memory → pinned host memory → the
two-level store): the paper's working-set-exceeds-memory thesis applied to
inference.

* Each :class:`Session` owns one batch-1 :class:`TieredKVCache` per
  full-attention layer (hot device ring + paged host history + store-backed
  pages) and one :class:`SlidingKVRing` per sliding-window layer (a device
  ring of the layer's window and nothing behind it).  A session shorter
  than the tiered ring gets the full ring over a short host history.  The
  state machine is ``QUEUED → ACTIVE ⇄ EVICTED → RETIRED``: admission prefills the
  prompt eagerly, then every :meth:`SessionScheduler.step` assembles up to
  ``max_batch`` active sessions into **one** decode dispatch (continuous
  batching: a retiring session's slot is refilled next step).
* :class:`SessionKVBatch` is the per-layer adapter that presents N
  single-session caches as one batched tiered cache: per-row RoPE positions
  (sessions sit at different lengths), the newest token row appended to
  each session's ring, and one per-row tiered attention over the sessions'
  rings and staging buffers where they lie (a sliding layer's rings with
  no cold part).  On the card that is one launch
  of the hand-written per-row kernel (``ops.tiered_decode_rows_attention``)
  a layer-step, whatever the sessions' staging capacities; the JAX package
  instead stacks the buffers, grouped by capacity, under a vmapped oracle.
* Memory is governed per tier: the device footprint (rings, sliding rings
  included, + staging buffers) and the host footprint (cold histories) are
  measured every step against one :class:`~repro_torch.core.arbiter.MemoryArbiter` pool per tier
  (or fixed byte budgets).  Over the device budget, least recently decoded
  sessions **demote** (drop their staging buffer; the next attend
  re-stages).  Over the host budget, least recently decoded idle sessions
  **evict** fully to the store and resume bit-identically when scheduled
  again, so the number of live sessions is bounded by the store, not by
  device and host memory.
* Prefix sharing: one :class:`~repro_torch.serving.kv_offload.SharedPageRegistry`
  across all sessions interns completed cold pages by content hash, so
  sessions with a common prompt prefix persist each shared page once,
  refcounted so that retirement never frees a page a live session maps.

The decode loop runs eagerly, as ``tiered_serve_loop`` does.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.kernels import ops, ref
from repro_torch.runtime.trace import span
from repro_torch.serving.kv_offload import SharedPageRegistry, SlidingKVRing, TieredKVCache

# Cache counters the report sums over every session, retired ones included.
KV_COUNTS = ("dma_copies", "host_waits")

__all__ = ["Session", "SessionKVBatch", "SessionScheduler", "SessionState"]


class SessionState(enum.Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    EVICTED = "evicted"  # fully parked in the store; no device or host bytes
    RETIRED = "retired"


@dataclasses.dataclass
class Session:
    """One user decode session and its bookkeeping."""

    sid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    state: SessionState = SessionState.QUEUED
    caches: dict[str, Any] | None = None
    tokens: list[int] = dataclasses.field(default_factory=list)
    submitted_s: float = 0.0
    ttft_s: float | None = None  # time to first token (prefill completes)
    last_step: int = -1  # scheduler step this session last decoded in
    evictions: int = 0
    resumes: int = 0

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens


class SessionKVBatch:
    """Per-layer adapter: N batch-1 tiered caches (or N sliding rings) as
    one batched cache.

    Duck-typed to the ``TieredKVCache`` surface that the tiered decode branch
    of ``attention_apply`` touches (``sliding`` / ``window`` /
    ``row_positions`` / ``append`` / ``attend``), so the layer code does not
    know how many sessions it serves.
    """

    def __init__(self, caches: list[TieredKVCache | SlidingKVRing], positions: torch.Tensor):
        if not caches:
            raise ValueError("empty session batch")
        self.caches = caches
        self._positions = positions  # (N, 1): one tensor for every layer of a decode step
        self.sliding = caches[0].sliding
        self.window = caches[0].window

    @staticmethod
    def positions_of(caches: list[TieredKVCache]) -> torch.Tensor:
        """(N, 1) next-token positions on the caches' device: the sessions
        sit at different lengths.  On the card they cross from pinned memory
        without a wait (a copy from pageable memory would synchronise)."""
        pos = torch.tensor([[c.length] for c in caches], dtype=torch.int32)
        device = caches[0].device
        return pos if device.type == "cpu" else pos.pin_memory().to(device, non_blocking=True)

    def row_positions(self) -> torch.Tensor:
        return self._positions

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write the newest token rows (N, KV, D) into each session."""
        with span("kv.ring" if self.sliding else "kv.append"):
            for i, c in enumerate(self.caches):
                c.append(k[i : i + 1], v[i : i + 1])

    def attend(self, q: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        """Tiered attention for q (N, H, 1, D) over the sessions' own
        lengths: each session stages its new cold pages, then one per-row
        op reads every session's ring and staging buffer where they lie
        (the buffers are read after staging, which may reallocate them).
        ``impl`` overrides the caches' own: ``"kernel"`` goes through
        ``ops.tiered_decode_rows_attention`` (the Hopper kernel on CUDA, its
        plain version on CPU), ``"plain"`` runs the plain version.  Sliding
        rings stage nothing: the op reads each ring with no cold part."""
        if self.sliding:
            with span("kv.ring"):
                return self._attend(q, impl)
        with span("kv.stage"):
            for c in self.caches:
                c.stage_cold()
        return self._attend(q, impl)

    def _attend(self, q: torch.Tensor, impl: str | None) -> torch.Tensor:
        impl = impl or self.caches[0].impl
        rows = self.caches
        lens = [(c.hot_len, c.cold_len, c.ring_newest) for c in rows]
        fn = ops.tiered_decode_rows_attention if impl == "kernel" else ref.tiered_rows_attention_ref
        out = fn(q.to(rows[0].dtype).contiguous(), [c.hot_k for c in rows], [c.hot_v for c in rows],
                 [c._cold_k_dev for c in rows], [c._cold_v_dev for c in rows], lens)
        for c, (hot_n, cold_n, _) in zip(rows, lens):
            c.stats.hot_hits_tokens += hot_n
            c.stats.cold_reads_tokens += cold_n
        return out


class SessionScheduler:
    """Continuous batching over many tiered-KV decode sessions.

    ``hbm_bytes`` / ``host_bytes`` bound the *aggregate* device and host KV
    footprint across sessions (``None`` = unbounded).  With an ``arbiter``,
    the scheduler registers one LATENCY pool per tier (``serve_hbm`` /
    ``serve_host``) that reports live usage and demand, and, when no fixed
    budget is given, the pool's arbitrated budget *is* the bound.  A
    ``store`` enables full idle-session eviction; it also seeds a shared
    :class:`SharedPageRegistry` (pass ``pages`` to share one registry across
    schedulers).  ``device`` holds the rings and staging buffers (the card
    unless the caller asks for the CPU); ``impl`` is the caches' attend path
    (``"kernel"`` or ``"plain"``).
    """

    def __init__(
        self,
        model,
        cfg,
        params,
        *,
        window: int,
        page: int | None = None,
        max_batch: int = 4,
        dtype=torch.bfloat16,
        store=None,
        pages: SharedPageRegistry | None = None,
        arbiter=None,
        hbm_bytes: int | None = None,
        host_bytes: int | None = None,
        admit_per_step: int = 2,
        store_prefix: str = "serving/sessions",
        device="cuda",
        impl: str = "kernel",
    ) -> None:
        if model.n_periods:
            raise ValueError("session serving needs an unrolled stack (scan_layers=False)")
        for spec in model.prefix:
            if spec.mixer != "gqa":
                raise ValueError(f"session serving requires all layers GQA, full or windowed (got mixer={spec.mixer!r})")
        if cfg.attn_logit_softcap > 0:
            raise ValueError("tiered KV backend requires no logit softcap")
        self.model, self.cfg, self.params = model, cfg, params
        self.window, self.page, self.max_batch = window, page, max_batch
        self.dtype = dtype
        self.device = torch.device(device)
        self.impl = impl
        self.admit_per_step = admit_per_step
        self._store = store
        self._prefix = store_prefix
        if store is not None and pages is None:
            pages = SharedPageRegistry(store, prefix=f"{store_prefix}/pages")
        self.pages = pages
        self.hbm_bytes, self.host_bytes = hbm_bytes, host_bytes
        self._arbiter = arbiter
        self._hbm_pool = self._host_pool = None
        if arbiter is not None:
            self._hbm_pool = arbiter.register(
                "serve_hbm", cls="latency",
                initial_bytes=hbm_bytes or arbiter.total_bytes // 4,
            )
            self._host_pool = arbiter.register(
                "serve_host", cls="latency",
                initial_bytes=host_bytes or arbiter.total_bytes // 2,
            )
        self._queue: deque[Session] = deque()
        self._sessions: dict[int, Session] = {}
        self._next_sid = 0
        self._step = 0
        # plane-level counters
        self.prefills = 0
        self.decoded_tokens = 0
        self.evictions = 0
        self.resumes = 0
        self.demotions = 0
        self.retired = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # Inside those two: the admissions' cache allocation (pinned host
        # tiers), and the decode dispatches' waits for their tokens.
        self.alloc_s = 0.0
        self.decode_wait_s = 0.0
        self._kv_retired = dict.fromkeys(KV_COUNTS, 0)

    # ------------------------------------------------------------ lifecycle

    def submit(self, prompt: np.ndarray, max_new_tokens: int) -> int:
        """Queue a session; returns its id.  Prefill happens at admission."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("need max_new_tokens >= 1")
        sid = self._next_sid
        self._next_sid += 1
        sess = Session(sid, prompt, max_new_tokens, submitted_s=time.perf_counter())
        self._sessions[sid] = sess
        self._queue.append(sess)
        return sid

    def _live(self) -> list[Session]:
        return [
            s for s in self._sessions.values()
            if s.state in (SessionState.ACTIVE, SessionState.EVICTED)
        ]

    def _tiered(self, sess: Session) -> list[TieredKVCache]:
        return [c for c in sess.caches.values() if isinstance(c, TieredKVCache)]

    def _prefill(self, sess: Session) -> None:
        with span("serve.admit"):
            t0 = time.perf_counter()
            # A session shorter than the ring gets the whole ring over a short history.
            max_len = max(len(sess.prompt) + sess.max_new_tokens + 1, self.window)
            from repro_torch.launch.steps import make_tiered_caches  # local: launch.steps imports serving

            t_alloc = time.perf_counter()
            with span("kv.alloc"):
                sess.caches = make_tiered_caches(
                    self.model, self.cfg, 1, max_len, self.window, self.page, self.dtype, self.device, self.impl,
                    store=self._store, store_prefix=f"{self._prefix}/{sess.sid}", pages=self.pages,
                )
            self.alloc_s += time.perf_counter() - t_alloc
            prompt = torch.as_tensor(sess.prompt, dtype=torch.int64, device=self.device)[None, :]
            with span("serve.prefill"):
                logits, sess.caches = self.model.prefill(self.params, prompt, sess.caches)
            sess.tokens.append(int(torch.argmax(logits[:, -1, :], dim=-1)[0]))
            sess.ttft_s = time.perf_counter() - sess.submitted_s
            sess.state = SessionState.ACTIVE
            sess.last_step = self._step
            self.prefills += 1
            self.prefill_s += time.perf_counter() - t0
            if sess.done:
                self._retire(sess)

    def _evict(self, sess: Session) -> None:
        for c in self._tiered(sess):
            c.evict_to_store()
        sess.state = SessionState.EVICTED
        sess.evictions += 1
        self.evictions += 1

    def _resume(self, sess: Session) -> None:
        for c in self._tiered(sess):
            c.resume_from_store()
        sess.state = SessionState.ACTIVE
        sess.resumes += 1
        self.resumes += 1

    def _retire(self, sess: Session) -> None:
        with span("serve.retire"):
            for c in sess.caches.values():
                for name in KV_COUNTS:
                    self._kv_retired[name] += getattr(c.stats, name)
                c.close()
            sess.caches = None
            sess.state = SessionState.RETIRED
            if self._store is not None:
                # Clear this session's per-prefix LATENCY hint so the I/O
                # controller's hint table doesn't grow with retired sessions.
                self._store.hint_stream(f"{self._prefix}/{sess.sid}/", None)
            self.retired += 1

    # ----------------------------------------------------------------- step

    def _assemble(self) -> list[Session]:
        """Pick up to ``max_batch`` least-recently-decoded live sessions:
        deterministic round-robin fairness, independent of memory state (so
        eviction never perturbs the schedule)."""
        cand = sorted(
            (s for s in self._live() if not s.done),
            key=lambda s: (s.last_step, s.sid),
        )
        return cand[: self.max_batch]

    def _decode(self, batch: list[Session]) -> None:
        t0 = time.perf_counter()
        with span("serve.decode"):
            tok = torch.tensor([[s.tokens[-1]] for s in batch], dtype=torch.int64, device=self.device)
            keys = list(batch[0].caches.keys())
            # Every layer of a session is at the same length before the step.
            pos = SessionKVBatch.positions_of([s.caches[keys[0]] for s in batch])
            caches = {k: SessionKVBatch([s.caches[k] for s in batch], pos) for k in keys}
            logits, _ = self.model.decode_step(self.params, tok, caches)
            nxt = torch.argmax(logits[:, -1, :], dim=-1)
            with span("serve.decode.wait"):
                t_wait = time.perf_counter()
                nxt = nxt.tolist()  # waits for the step's device work
                self.decode_wait_s += time.perf_counter() - t_wait
        for s, t in zip(batch, nxt):
            s.tokens.append(int(t))
            s.last_step = self._step
        self.decoded_tokens += len(batch)
        self.decode_s += time.perf_counter() - t0

    def _budgets(self) -> tuple[int | None, int | None]:
        hbm, host = self.hbm_bytes, self.host_bytes
        if hbm is None and self._hbm_pool is not None:
            hbm = self._hbm_pool.budget
        if host is None and self._host_pool is not None:
            host = self._host_pool.budget
        return hbm, host

    def _enforce_memory(self, decoding: set[int]) -> None:
        """Per-tier overflow control: over the device budget, demote LRU
        staging buffers (safe mid-decode); over the host budget, evict LRU
        sessions *not in the current batch* fully to the store."""
        resident = [s for s in self._live() if s.state is SessionState.ACTIVE]
        lru = sorted(resident, key=lambda s: (s.last_step, s.sid))
        hbm_budget, host_budget = self._budgets()
        device_use = sum(c.device_bytes() for s in resident for c in s.caches.values())
        host_use = sum(c.host_bytes() for s in resident for c in self._tiered(s))
        if hbm_budget is not None and device_use > hbm_budget:
            for s in lru:
                freed = sum(c.drop_staging() for c in self._tiered(s))
                if freed:
                    device_use -= freed
                    self.demotions += 1
                if device_use <= hbm_budget:
                    break
        if host_budget is not None and self._store is not None and host_use > host_budget:
            for s in lru:
                if host_use <= host_budget:
                    break
                if s.sid in decoding:
                    continue  # never park a session mid-token
                host_use -= sum(c.host_bytes() for c in self._tiered(s))
                self._evict(s)
        if self._hbm_pool is not None:
            self._hbm_pool.note_used(device_use)
            self._hbm_pool.note_demand(device_use)
        if self._host_pool is not None:
            self._host_pool.note_used(host_use)
            total_demand = sum(
                c.host_bytes() for s in resident for c in self._tiered(s)
            ) + sum(
                # parked sessions still *want* residency: that demand lets
                # the arbiter grow this tier when it can
                2 * self.cfg.n_kv_heads * self.cfg.resolved_head_dim
                * (len(s.prompt) + s.max_new_tokens + 1) * self.dtype.itemsize
                * len(self.model.prefix)
                for s in self._live() if s.state is SessionState.EVICTED
            )
            self._host_pool.note_demand(total_demand)

    def step(self) -> dict:
        """One scheduler tick: admit → (resume) → decode one token for the
        assembled batch → retire finished → enforce per-tier budgets."""
        with span("serve.step"):
            self._step += 1
            for _ in range(self.admit_per_step):
                if not self._queue:
                    break
                self._prefill(self._queue.popleft())
            batch = self._assemble()
            for s in batch:
                if s.state is SessionState.EVICTED:
                    self._resume(s)
            if batch:
                self._decode(batch)
            still_decoding = set()
            for s in batch:
                if s.done:
                    self._retire(s)
                else:
                    still_decoding.add(s.sid)
            if self._arbiter is not None:
                self._arbiter.rebalance()
            with span("serve.memory"):
                self._enforce_memory(still_decoding)
            return {
                "step": self._step,
                "batch": len(batch),
                "queued": len(self._queue),
                "live": len(self._live()),
                "retired": self.retired,
            }

    def run(self, max_steps: int | None = None) -> dict:
        """Drive steps until every submitted session retires (or the step
        cap is hit); returns :meth:`report`."""
        steps = 0
        while self._queue or self._live():
            if max_steps is not None and steps >= max_steps:
                break
            self.step()
            steps += 1
        return self.report()

    # ------------------------------------------------------------ reporting

    def session_tokens(self, sid: int) -> list[int]:
        return list(self._sessions[sid].tokens)

    def report(self) -> dict:
        ttfts = sorted(
            s.ttft_s for s in self._sessions.values() if s.ttft_s is not None
        )
        pct = lambda q: float(np.percentile(ttfts, q)) if ttfts else 0.0
        out = {
            "sessions": len(self._sessions),
            "retired": self.retired,
            "steps": self._step,
            "prefills": self.prefills,
            "decoded_tokens": self.decoded_tokens,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "alloc_s": self.alloc_s,
            "decode_wait_s": self.decode_wait_s,
            "decode_tok_per_s": (
                self.decoded_tokens / self.decode_s if self.decode_s else 0.0
            ),
            "ttft_p50_s": pct(50),
            "ttft_p99_s": pct(99),
            "evictions": self.evictions,
            "resumes": self.resumes,
            "demotions": self.demotions,
        }
        for name in KV_COUNTS:
            out[name] = self._kv_retired[name] + sum(
                getattr(c.stats, name) for s in self._sessions.values() if s.caches is not None
                for c in self._tiered(s))
        if self.pages is not None:
            out["pages_logical"] = self.pages.pages_logical
            out["pages_stored"] = self.pages.pages_stored
            out["dedup_ratio"] = self.pages.dedup_ratio()
        return out

    def close(self) -> None:
        """Release both tier pools and every live session's caches."""
        for s in self._sessions.values():
            if s.caches is not None:
                for c in s.caches.values():
                    c.close()
                s.caches = None
        for pool in (self._hbm_pool, self._host_pool):
            if pool is not None:
                pool.release()
        self._hbm_pool = self._host_pool = None

"""Adaptive I/O control plane: online Eq. 1-7 model -> data-path decisions.

DESIGN.md §10.  The paper's headline result (Section 4.4, Eq. 7) is that
two-level read throughput is a harmonic blend of the memory-tier rate ν
and the PFS rate q_ofs, governed by the in-memory fraction ``f`` — and
Section 4.5's +25%/+95% gains at f=0.2/0.5 all assume the system actually
*achieves* a useful ``f`` for the data that gets re-read.  A static store
does not: promote-on-every-read lets a TeraSort scan evict the training
working set, a fixed readahead depth leaves PFS servers idle under one
stream and floods memory under another, and a fixed flush-lane count
either starves concurrent reads or leaves the PFS write ceiling unused.

:class:`IOController` closes the loop the paper leaves open:

* **Online estimation** — EWMA per-tier read/write throughput (the live
  ν and q_ofs analogues) from :class:`~repro_torch.core.tiers.TierStats`
  deltas, sampled on a time-gated tick from the store's own hot paths
  (no background thread).
* **Model inversion** — :func:`repro_torch.core.iomodel.f_for_read_mbps`
  inverts Eq. 7 to the in-memory fraction required to sustain observed
  read demand, and a greedy capacity plan assigns target ``f`` per
  *stream class* under current contention (latency-sensitive > reuse >
  default > write-burst > read-once; a read-once scan re-reads nothing,
  so Eq. 7 assigns its caching zero marginal value).
* **Decisions** — three hot-path knobs in :class:`TwoLevelStore`:
  admission (promote vs bypass, ghost-list scan resistance: a read-once
  block is promoted only when it provably comes back), per-stream
  adaptive readahead (deepen while the PFS pool is underutilized, shrink
  under memory pressure), and adaptive write-back concurrency (flush
  lanes sized toward the modeled PFS write ceiling without starving
  concurrent reads).

Clients declare intent with :class:`StreamClass` hints via
``TwoLevelStore.hint_stream(prefix, cls)``:

    ========== ===================================== =====================
    class       declared by                           controller behavior
    ========== ===================================== =====================
    SEQ_REUSE   ``data/pipeline.SyntheticCorpus``     admit always; medium
                (epoch re-reads)                      readahead
    SEQ_ONCE    ``apps/shuffle.ShuffleEngine``        ghost-gated admission;
                (scans + spill runs)                  deep readahead; spill
                                                      blocks dropped after
                                                      flush under pressure
    WRITE_BURST ``runtime/checkpoint``                write-through bypasses
                                                      the memory tier under
                                                      pressure; restore
                                                      reads admit
    LATENCY     ``serving/kv_offload`` host tier      admit always, never
                                                      dropped; minimum
                                                      readahead (latency,
                                                      not bandwidth)
    DEFAULT     everything unhinted                   the store's static
                                                      behavior
    ========== ===================================== =====================

The controller is strictly optional: a store constructed without one is
bit-for-bit the static system (every existing gate runs that way).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from collections import OrderedDict, deque

from repro_torch.core.iomodel import blend_read_mbps, compression_wins, f_for_read_mbps

MB = 2**20


class StreamClass(enum.Enum):
    DEFAULT = "default"
    SEQ_REUSE = "seq_reuse"  # sequential, re-read across epochs
    SEQ_ONCE = "seq_once"  # sequential, read exactly once (scan / spill run)
    WRITE_BURST = "write_burst"  # bursty writes, rarely read back
    LATENCY = "latency"  # small latency-sensitive reads
    SCRUB = "scrub"  # background integrity scrub / repair traffic


#: Greedy capacity-plan priority: who gets memory first under contention.
#: SCRUB goes last on purpose — its bytes are verification traffic with
#: zero Eq. 7 caching value, and its I/O lane is throttled separately
#: (``scrub_gate`` / ``scrub_pause_s``) whenever the PFS pool is busy.
_PLAN_PRIORITY = (
    StreamClass.LATENCY,
    StreamClass.SEQ_REUSE,
    StreamClass.DEFAULT,
    StreamClass.WRITE_BURST,
    StreamClass.SEQ_ONCE,
    StreamClass.SCRUB,
)


@dataclasses.dataclass
class ControllerConfig:
    tick_interval_s: float = 0.05  # EWMA / knob refresh cadence
    plan_interval_s: float = 0.25  # footprint scan + capacity plan cadence
    ewma_alpha: float = 0.3
    ghost_capacity: int = 4096  # recently seen-but-not-cached block keys
    min_readahead: int = 1
    max_readahead: int = 8
    pressure_free_frac: float = 0.25  # below this free fraction = contended
    pressure_release_frac: float = 0.5  # hysteresis: release only above this
    under_target_slack: float = 0.05  # reuse class this far under target f = contended
    util_low: float = 0.5  # PFS pool under this busy fraction -> deepen
    util_high: float = 0.9  # over this -> stop deepening / shrink
    # SCRUB lane throttle: the background scrubber sleeps this long between
    # objects — the floor while the PFS pool idles, the ceiling while
    # foreground traffic keeps it above util_high (so scrub verification
    # cannot push foreground p99 unbounded; DESIGN.md §15).
    scrub_pause_min_s: float = 0.0
    scrub_pause_max_s: float = 0.25
    trajectory_len: int = 256
    # Priors until the first EWMA samples land (MB/s).  Deliberately modest;
    # two ticks of real traffic dominate them.
    nu_prior_mbps: float = 2000.0
    q_prior_mbps: float = 400.0


@dataclasses.dataclass
class ClassStats:
    """Per-stream-class decision ledger."""

    admits: int = 0
    bypasses: int = 0
    readmits: int = 0  # ghost hits: bypassed once, proved reuse, admitted
    cached_writes: int = 0
    bypassed_writes: int = 0
    flush_drops: int = 0
    footprint_bytes: int = 0  # block bytes tracked for this class
    resident_bytes: int = 0  # of those, bytes in the memory tier
    target_f: float = 0.0  # capacity plan's assigned in-memory fraction

    def measured_f(self) -> float:
        return self.resident_bytes / self.footprint_bytes if self.footprint_bytes else 0.0


class AdaptiveGate:
    """Resizable concurrency limiter for the flush-lane pool.

    All ``flush_workers`` threads keep draining the queue, but at most
    ``limit`` of them may be inside a PFS flush at once — the controller
    resizes the limit each tick, which is how write-back concurrency
    adapts without stopping/starting threads.
    """

    def __init__(self, limit: int) -> None:
        self._cond = threading.Condition()
        self._limit = max(1, limit)
        self._active = 0

    @property
    def limit(self) -> int:
        return self._limit

    def set_limit(self, limit: int) -> None:
        with self._cond:
            self._limit = max(1, limit)
            self._cond.notify_all()

    def __enter__(self) -> "AdaptiveGate":
        with self._cond:
            while self._active >= self._limit:
                self._cond.wait()
            self._active += 1
        return self

    def __exit__(self, *exc) -> None:
        with self._cond:
            self._active -= 1
            self._cond.notify_all()


class IOController:
    """Online throughput-model-driven admission / prefetch / flush control.

    Bind to a store by passing it to ``TwoLevelStore(controller=...)``.
    Thread-safe; every public method is called from store hot paths and
    must stay cheap — the model refresh is time-gated (``tick_interval_s``)
    and runs inline on whichever I/O thread happens to cross the gate.
    """

    def __init__(self, config: ControllerConfig | None = None) -> None:
        self.cfg = config or ControllerConfig()
        self._store = None
        self._lock = threading.Lock()  # ghost list + stats + knobs
        self._tick_lock = threading.Lock()  # one tick at a time, never queued
        self._last_tick = 0.0
        self._last_plan = 0.0

        # EWMA tier-rate estimates (the live Table 2 analogues, MB/s).
        self.nu_mbps = self.cfg.nu_prior_mbps  # memory-tier read rate
        self.q_read_mbps = self.cfg.q_prior_mbps  # PFS read rate
        self.q_write_mbps = self.cfg.q_prior_mbps  # PFS write rate
        self.demand_read_mbps = 0.0  # app-level read demand (bytes/wall)
        self.pfs_utilization = 0.0  # busy fraction of the PFS worker pool
        self.memory_pressure = False

        # Tick-to-tick sample memory.
        self._prev: dict[str, float] = {}

        # Ghost list: block keys recently seen (scan-bypassed or evicted)
        # but not resident.  Membership = proof of re-reference.
        self._ghost: OrderedDict[str, None] = OrderedDict()

        self.flush_gate = AdaptiveGate(limit=1)
        self._max_lanes = 1
        # SCRUB lane (DESIGN.md §15): at most one object scrubbed at a time
        # (repair correctness wants serial per-key work anyway), paced by
        # ``scrub_pause_s`` which the tick retunes off PFS utilization —
        # the same busy-fraction signal that sizes flush lanes.
        self.scrub_gate = AdaptiveGate(limit=1)
        self.scrub_pause_s = self.cfg.scrub_pause_min_s

        # Codec telemetry (DESIGN.md §13): EWMA compression ratio and
        # encode/decode rates.  They feed the DEFAULT-class compress
        # decision and the compression-adjusted Eq. 7 terms — zero until
        # the store's codec path reports its first block.
        self.codec_ratio = 0.0
        self.encode_mbps = 0.0
        self.decode_mbps = 0.0
        # Elastic memory arbiter (core/arbiter.py), rebalanced from the
        # plan tick when attached so pool budgets follow the same cadence
        # and the same measured inputs as the capacity plan.
        self.arbiter = None

        self.class_stats: dict[StreamClass, ClassStats] = {
            c: ClassStats() for c in StreamClass
        }
        # Controller federation (DESIGN.md §11): peer host estimates ingested
        # from the gossip plane — host id -> (ingest wall time, estimates
        # dict as produced by export_estimates()).
        self.peer_estimates: dict[object, tuple[float, dict]] = {}
        self._readahead: dict[StreamClass, int] = {}
        self.readahead_trajectory: deque[tuple[float, str, int]] = deque(
            maxlen=self.cfg.trajectory_len
        )
        self.lane_trajectory: deque[tuple[float, int]] = deque(maxlen=self.cfg.trajectory_len)
        self.ticks = 0
        self._t0 = time.perf_counter()
        # classify() memo — invalidated by hint-tuple identity (see there).
        self._classify_cache: dict[str, StreamClass] = {}
        self._classify_hints: tuple = ()

    # ---------------------------------------------------------------- bind

    def bind(self, store) -> None:
        """Attach to a TwoLevelStore (called from the store's __init__)."""
        if self._store is not None and self._store is not store:
            raise RuntimeError("IOController is already bound to another store")
        self._store = store
        self._max_lanes = store.flush_workers
        self.flush_gate.set_limit(max(1, store.flush_workers // 2))
        base = max(self.cfg.min_readahead, store.readahead_blocks)
        self._readahead = {
            StreamClass.DEFAULT: base,
            StreamClass.SEQ_REUSE: base,
            StreamClass.SEQ_ONCE: base,
            StreamClass.WRITE_BURST: base,
            StreamClass.LATENCY: self.cfg.min_readahead,
        }

    def classify(self, name: str) -> StreamClass:
        """Longest registered prefix hint wins; unhinted files are DEFAULT.

        Memoized per file name: the serving plane registers one LATENCY
        hint per session, so the linear prefix scan would otherwise run
        O(sessions) on *every* block I/O.  The cache keys on the hint
        tuple's identity — ``hint_stream`` rebuilds the tuple on any
        change, which invalidates the whole memo for free.
        """
        hints = () if self._store is None else self._store._hint_items
        if hints is not self._classify_hints:
            self._classify_cache = {}
            self._classify_hints = hints
        cached = self._classify_cache.get(name)
        if cached is not None:
            return cached
        best: StreamClass | None = None
        best_len = -1
        for prefix, cls in hints:
            if len(prefix) > best_len and name.startswith(prefix):
                best, best_len = cls, len(prefix)
        out = best or StreamClass.DEFAULT
        if len(self._classify_cache) >= 65536:  # bound stale-name growth
            self._classify_cache = {}
        self._classify_cache[name] = out
        return out

    # ------------------------------------------------------------ sampling

    def maybe_tick(self) -> None:
        """Refresh estimates + knobs if the tick interval elapsed (cheap)."""
        now = time.perf_counter()
        if now - self._last_tick < self.cfg.tick_interval_s:
            return
        if not self._tick_lock.acquire(blocking=False):
            return  # someone else is mid-tick
        try:
            if now - self._last_tick < self.cfg.tick_interval_s:
                return
            self._tick(now)
            self._last_tick = now
        finally:
            self._tick_lock.release()

    def _ewma(self, old: float, new: float) -> float:
        a = self.cfg.ewma_alpha
        return new if old == 0.0 else (1 - a) * old + a * new

    def _tick(self, now: float) -> None:
        st = self._store
        if st is None:
            return
        mem, pfs = st.mem.stats, st.pfs.stats
        cur = {
            "wall": now,
            "mem_rb": mem.bytes_read,
            "mem_rs": mem.read_seconds,
            "pfs_rb": pfs.bytes_read,
            "pfs_rs": pfs.read_seconds,
            "pfs_wb": pfs.bytes_written,
            "pfs_ws": pfs.write_seconds,
        }
        prev = self._prev
        self._prev = cur
        self.ticks += 1
        if not prev:
            return
        dwall = cur["wall"] - prev["wall"]
        if dwall <= 0:
            return

        # -- EWMA tier rates from busy-time deltas (ν and q_ofs analogues) --
        def rate(db: float, ds: float) -> float | None:
            return (db / MB) / ds if ds > 1e-6 and db > 0 else None

        r = rate(cur["mem_rb"] - prev["mem_rb"], cur["mem_rs"] - prev["mem_rs"])
        if r is not None:
            self.nu_mbps = self._ewma(self.nu_mbps, r)
        r = rate(cur["pfs_rb"] - prev["pfs_rb"], cur["pfs_rs"] - prev["pfs_rs"])
        if r is not None:
            self.q_read_mbps = self._ewma(self.q_read_mbps, r)
        r = rate(cur["pfs_wb"] - prev["pfs_wb"], cur["pfs_ws"] - prev["pfs_ws"])
        if r is not None:
            self.q_write_mbps = self._ewma(self.q_write_mbps, r)

        read_bytes_delta = (cur["mem_rb"] - prev["mem_rb"]) + (cur["pfs_rb"] - prev["pfs_rb"])
        self.demand_read_mbps = self._ewma(self.demand_read_mbps, read_bytes_delta / MB / dwall)

        busy = (cur["pfs_rs"] - prev["pfs_rs"]) + (cur["pfs_ws"] - prev["pfs_ws"])
        self.pfs_utilization = min(1.0, busy / (dwall * max(1, st.io_workers)))

        # Capacity contention, with hysteresis (so one dropped block cannot
        # flap the decision) plus the model's own signal: a reuse-priority
        # class sitting *under* its planned in-memory fraction means the
        # tier is contended no matter what the free counter says — cached
        # write-bursts and spills would steal residency Eq. 7 wants spent
        # on re-read bytes.
        free_frac = st.mem.free_bytes / st.mem.capacity_bytes
        with self._lock:
            under_target = any(
                cs.footprint_bytes > 0
                and cs.target_f > cs.measured_f() + self.cfg.under_target_slack
                for cls, cs in self.class_stats.items()
                if cls in (StreamClass.SEQ_REUSE, StreamClass.LATENCY)
            )
        release = (
            self.cfg.pressure_release_frac if self.memory_pressure
            else self.cfg.pressure_free_frac
        )
        self.memory_pressure = under_target or free_frac < release

        self._retune_readahead()
        self._retune_flush_lanes(read_bytes_delta > 0)
        self._retune_scrub_lane()
        if now - self._last_plan >= self.cfg.plan_interval_s:
            self._replan()
            if self.arbiter is not None:
                try:
                    self.arbiter.rebalance(self)
                except Exception:
                    pass  # a failing pool callback must not kill the tick
            self._last_plan = now

    def _retune_readahead(self) -> None:
        """Deepen sequential prefetch while the PFS pool idles; shrink under
        memory pressure.  LATENCY stays at the floor — prefetch depth buys
        bandwidth, and that class asked for latency."""
        cfg = self.cfg
        for cls in (StreamClass.SEQ_ONCE, StreamClass.SEQ_REUSE, StreamClass.DEFAULT):
            depth = self._readahead[cls]
            if self.memory_pressure and cls is not StreamClass.SEQ_ONCE:
                # Reuse-class prefetch promotes blocks into a contended tier;
                # a read-once stream's prefetch lives only in transient
                # buffers, so pressure does not apply to it the same way.
                depth -= 1
            elif self.pfs_utilization < cfg.util_low:
                depth += 1
            elif self.pfs_utilization > cfg.util_high:
                depth -= 1
            depth = max(cfg.min_readahead, min(cfg.max_readahead, depth))
            if depth != self._readahead[cls]:
                self._readahead[cls] = depth
                self.readahead_trajectory.append(
                    (time.perf_counter() - self._t0, cls.value, depth)
                )

    def _retune_flush_lanes(self, read_active: bool) -> None:
        """Size write-back concurrency toward the modeled PFS write ceiling
        without starving concurrent reads: lanes grow with the flush
        backlog (each lane is one more stream toward the q_write ×
        io_workers ceiling), and are halved while reads keep the PFS pool
        saturated — unless the backlog is deep enough that the bounded
        queue would stall writers, at which point draining wins."""
        backlog = self._store._flush_q.qsize()
        want = -(-backlog // 4)  # one lane per ~4 queued flushes
        if (
            read_active
            and self.pfs_utilization > self.cfg.util_high
            and backlog < 4 * self._max_lanes
        ):
            want = min(want, max(1, self._max_lanes // 2))
        lanes = max(1, min(self._max_lanes, want))
        if lanes != self.flush_gate.limit:
            self.flush_gate.set_limit(lanes)
            self.lane_trajectory.append((time.perf_counter() - self._t0, lanes))

    def _retune_scrub_lane(self) -> None:
        """Pace the background scrubber off PFS-pool busyness: idle pool →
        scrub at full speed (pause floor), saturated pool → back off to the
        pause ceiling, linear in between.  Mirrors the flush-lane stance:
        background durability work yields to foreground latency."""
        cfg = self.cfg
        u = self.pfs_utilization
        if u <= cfg.util_low:
            pause = cfg.scrub_pause_min_s
        elif u >= cfg.util_high:
            pause = cfg.scrub_pause_max_s
        else:
            frac = (u - cfg.util_low) / max(1e-9, cfg.util_high - cfg.util_low)
            pause = cfg.scrub_pause_min_s + frac * (cfg.scrub_pause_max_s - cfg.scrub_pause_min_s)
        self.scrub_pause_s = pause

    def _replan(self) -> None:
        """Footprint scan + greedy Eq.7 capacity plan: assign target ``f``
        per class in priority order.  A SEQ_ONCE byte is read exactly once,
        so its Eq. 7 caching value is zero — it is planned last (target 0
        whenever anything else wants the space)."""
        st = self._store
        foot: dict[StreamClass, int] = {c: 0 for c in StreamClass}
        res: dict[StreamClass, int] = {c: 0 for c in StreamClass}
        with st._meta:
            blocks = [(meta.key, meta.length) for meta in st._blocks.values()]
        name_cls: dict[str, StreamClass] = {}
        for bkey, length in blocks:
            name = bkey.rsplit(":", 1)[0]
            cls = name_cls.get(name)
            if cls is None:
                cls = name_cls[name] = self.classify(name)
            foot[cls] += length
            if st.mem.contains(bkey):
                res[cls] += length
        remaining = st.mem.capacity_bytes
        with self._lock:
            for cls in _PLAN_PRIORITY:
                cs = self.class_stats[cls]
                cs.footprint_bytes = foot[cls]
                cs.resident_bytes = res[cls]
                if foot[cls] == 0:
                    cs.target_f = 0.0
                    continue
                give = min(remaining, foot[cls])
                cs.target_f = give / foot[cls]
                remaining -= give

    # ----------------------------------------------------------- decisions

    def admit(self, name: str, bkey: str) -> bool:
        """Promote-on-read decision for one missed block (TIERED reads).

        Ghost-list scan resistance: a read-once-class block is promoted
        only if its key is already in the ghost list — i.e. this is a
        *re*-reference, disproving the read-once hint for that block.
        Everything else keeps the store's promote-on-read contract.
        """
        self.maybe_tick()
        cls = self.classify(name)
        with self._lock:
            cs = self.class_stats[cls]
            if cls is StreamClass.SEQ_ONCE:
                if bkey in self._ghost:
                    del self._ghost[bkey]
                    cs.readmits += 1
                    cs.admits += 1
                    return True
                self._ghost[bkey] = None
                while len(self._ghost) > self.cfg.ghost_capacity:
                    self._ghost.popitem(last=False)
                cs.bypasses += 1
                return False
            cs.admits += 1
            return True

    def cache_on_write(self, name: str) -> bool:
        """Should a WRITE_THROUGH block also land in the memory tier?

        Under capacity contention a write burst (checkpoint) or a spill
        scan must not evict the re-read working set to cache bytes nobody
        reads back — the paper's Eq. 6 write path is PFS-bound anyway.
        """
        self.maybe_tick()
        cls = self.classify(name)
        bypass = (
            cls in (StreamClass.WRITE_BURST, StreamClass.SEQ_ONCE) and self.memory_pressure
        )
        with self._lock:
            cs = self.class_stats[cls]
            if bypass:
                cs.bypassed_writes += 1
            else:
                cs.cached_writes += 1
        return not bypass

    def promote_range_miss(self, name: str) -> bool:
        """Should a *partial* (sub-block) ranged miss fetch and promote the
        whole covering block?

        The static store never promotes bytes a range read didn't ask for.
        For a reuse-heavy or latency-sensitive stream running *below* its
        planned in-memory fraction, the model says the opposite: paying one
        whole-block fetch now moves the class toward its target ``f``, and
        every later window over that block becomes a ν-speed hit — this is
        how an evicted working set climbs back into the tier even though
        its reads are all sub-block ranged reads.
        """
        self.maybe_tick()
        cls = self.classify(name)
        if cls not in (StreamClass.SEQ_REUSE, StreamClass.LATENCY):
            return False
        with self._lock:
            cs = self.class_stats[cls]
            if cs.footprint_bytes == 0:
                return True  # no plan yet: reuse data defaults to resident
            return cs.target_f > cs.measured_f() + 0.01

    def drop_after_flush(self, bkey: str) -> bool:
        """After an async write-back lands on the PFS tier, should the clean
        memory copy be dropped?  Yes for write-burst / read-once classes
        under pressure: their Eq. 7 caching value is ~0, and holding them
        evicts blocks whose value is ν-vs-q_ofs real."""
        cls = self.classify(bkey.rsplit(":", 1)[0])
        if cls not in (StreamClass.WRITE_BURST, StreamClass.SEQ_ONCE):
            return False
        if not self.memory_pressure:
            return False
        with self._lock:
            self.class_stats[cls].flush_drops += 1
            # Deliberately NOT ghost-listed: this residency came from the
            # write, so the block's first read is its *expected* read-once
            # pass — treating it as a re-reference would promote every
            # dropped spill block into the contended tier exactly once.
        return True

    def compress_for_write(self, name: str) -> bool:
        """Class-driven codec policy for one block entering the PFS tier
        (DESIGN.md §13).

        SEQ_ONCE spills, WRITE_BURST checkpoint chunks, and SEQ_REUSE
        corpora compress by default — their bytes are scanned
        sequentially, exactly where the smaller cold footprint pays in
        both PFS MB/s and effective capacity.  LATENCY never compresses:
        its reads are small and the decode pass is pure added latency.
        DEFAULT consults the model: compress only while the estimated
        compressed-read rate ``(1/ratio)·q_pfs`` beats the decode rate
        (:func:`repro_torch.core.iomodel.compression_wins`); before the first
        codec samples land it defaults to yes, because the encode-time
        ratio probe already rejects incompressible blocks for free.
        """
        cls = self.classify(name)
        if cls is StreamClass.LATENCY:
            return False
        if cls is not StreamClass.DEFAULT:
            return True
        if self.codec_ratio <= 0.0:
            return True
        return compression_wins(
            self.q_read_mbps, self.codec_ratio, self.decode_mbps or None
        )

    def note_codec(self, op: str, logical: int, physical: int, seconds: float) -> None:
        """Codec telemetry from the store: one encode ('encode') or decode
        ('decode') pass of ``logical`` bytes that moved ``physical`` bytes
        in ``seconds``.  Feeds the EWMA ratio and MB/s estimates the
        DEFAULT-class policy and the Eq. 7 effective-rate terms use."""
        if logical <= 0 or physical <= 0:
            return
        with self._lock:
            self.codec_ratio = self._ewma(self.codec_ratio, logical / physical)
            if seconds > 1e-9:
                mbps = (logical / MB) / seconds
                if op == "encode":
                    self.encode_mbps = self._ewma(self.encode_mbps, mbps)
                else:
                    self.decode_mbps = self._ewma(self.decode_mbps, mbps)

    def note_eviction(self, bkey: str, read_promoted: bool = True) -> None:
        """Eviction feedback: evicted keys enter the ghost list so a
        re-read soon after proves reuse (and re-promotes immediately).

        ``read_promoted`` says whether the evicted residency was earned by
        a read (tiered-miss promotion) or by a write.  A read-once-class
        block only gets a ghost entry when its residency was read-earned:
        a written-then-evicted spill block's one guaranteed read must not
        count as proof of reuse.
        """
        if not read_promoted and self.classify(bkey.rsplit(":", 1)[0]) is StreamClass.SEQ_ONCE:
            return
        with self._lock:
            self._ghost[bkey] = None
            while len(self._ghost) > self.cfg.ghost_capacity:
                self._ghost.popitem(last=False)

    def readahead(self, name: str, default: int) -> int:
        """Current prefetch depth for one stream (refreshed every tick)."""
        self.maybe_tick()
        cls = self.classify(name)
        depth = self._readahead.get(cls)
        return default if depth is None else depth

    # ---------------------------------------------------------- federation

    def export_estimates(self) -> dict:
        """This host's gossip payload: the live (ν, q, f) analogues plus the
        per-class footprint the capacity plan is working against.

        Hosts of a distributed store exchange these (DESIGN.md §11) so each
        controller can plan capacity *per host* — Eq. 7 is per memory tier,
        and the cluster aggregate is the sum of the per-host blends.
        """
        with self._lock:
            classes = {
                cls.value: {
                    "footprint_bytes": cs.footprint_bytes,
                    "resident_bytes": cs.resident_bytes,
                    "target_f": cs.target_f,
                }
                for cls, cs in self.class_stats.items()
                if cs.footprint_bytes
            }
        return {
            "nu_mbps": self.nu_mbps,
            "q_read_mbps": self.q_read_mbps,
            "q_write_mbps": self.q_write_mbps,
            "demand_read_mbps": self.demand_read_mbps,
            "f": self.measured_f(),
            "memory_pressure": self.memory_pressure,
            "classes": classes,
        }

    def note_peer(self, host, estimates: dict) -> None:
        """Ingest one peer host's gossiped estimates (latest wins)."""
        with self._lock:
            self.peer_estimates[host] = (time.perf_counter(), estimates)

    def cluster_read_mbps(self, max_age_s: float = 30.0) -> float:
        """Eq. 7 summed over this host and every fresh peer: the modeled
        aggregate read rate of the whole distributed store — the paper's
        N·ν limit when every shard's ``f`` is 1."""
        total = self.predicted_read_mbps()
        now = time.perf_counter()
        with self._lock:
            peers = list(self.peer_estimates.values())
        for seen, est in peers:
            if now - seen > max_age_s:
                continue
            nu = max(est.get("nu_mbps", 0.0), est.get("q_read_mbps", 0.0), 1e-9)
            q = max(est.get("q_read_mbps", 0.0), 1e-9)
            total += blend_read_mbps(nu, q, min(1.0, max(0.0, est.get("f", 0.0))))
        return total

    def cluster_report(self) -> dict:
        """Per-host plan view over the federation: own + peer estimates and
        the modeled aggregate (for placement planners and observability)."""
        with self._lock:
            peers = {str(h): dict(est) for h, (_, est) in self.peer_estimates.items()}
        return {
            "self": self.export_estimates(),
            "peers": peers,
            "cluster_read_mbps": round(self.cluster_read_mbps(), 1),
        }

    # ------------------------------------------------------------- report

    def predicted_read_mbps(self, f: float | None = None) -> float:
        """Eq. 7 over the live EWMA rates (measured f by default)."""
        if f is None:
            f = self.measured_f()
        nu = max(self.nu_mbps, self.q_read_mbps, 1e-9)
        return blend_read_mbps(nu, max(self.q_read_mbps, 1e-9), f)

    def target_f(self) -> float:
        """Capacity-plan target in-memory fraction over all tracked bytes."""
        with self._lock:
            tot = sum(cs.footprint_bytes for cs in self.class_stats.values())
            want = sum(cs.target_f * cs.footprint_bytes for cs in self.class_stats.values())
        return want / tot if tot else 0.0

    def measured_f(self) -> float:
        """Achieved in-memory fraction over all tracked bytes (paper's f)."""
        with self._lock:
            tot = sum(cs.footprint_bytes for cs in self.class_stats.values())
            res = sum(cs.resident_bytes for cs in self.class_stats.values())
        return res / tot if tot else 0.0

    def f_required_for_demand(self) -> float:
        """Eq. 7 inverted at the observed app read demand: the residency
        the model says is needed to keep serving it at the blended rate."""
        nu = max(self.nu_mbps, self.q_read_mbps * (1 + 1e-9), 1e-6)
        demand = min(max(self.demand_read_mbps, 1e-9), nu)
        return f_for_read_mbps(nu, min(self.q_read_mbps, nu), demand)

    def report(self) -> dict:
        """Structured snapshot for CLI observability (examples/*.py)."""
        with self._lock:
            classes = {
                cls.value: dataclasses.asdict(cs) | {"measured_f": cs.measured_f()}
                for cls, cs in self.class_stats.items()
                if cs.admits or cs.bypasses or cs.footprint_bytes or cs.cached_writes
                or cs.bypassed_writes or cs.flush_drops
            }
            ra = dict(self._readahead)
            ghost = len(self._ghost)
        admits = sum(cs["admits"] for cs in classes.values())
        bypasses = sum(cs["bypasses"] for cs in classes.values())
        return {
            "nu_mbps": round(self.nu_mbps, 1),
            "q_read_mbps": round(self.q_read_mbps, 1),
            "q_write_mbps": round(self.q_write_mbps, 1),
            "demand_read_mbps": round(self.demand_read_mbps, 1),
            "pfs_utilization": round(self.pfs_utilization, 3),
            "memory_pressure": self.memory_pressure,
            "ticks": self.ticks,
            "ghost_keys": ghost,
            "admits": admits,
            "bypasses": bypasses,
            "flush_drops": sum(cs["flush_drops"] for cs in classes.values()),
            "flush_lanes": self.flush_gate.limit,
            "scrub_pause_s": round(self.scrub_pause_s, 4),
            "lane_trajectory": list(self.lane_trajectory),
            "readahead": {c.value: d for c, d in ra.items()},
            "readahead_trajectory": list(self.readahead_trajectory),
            "target_f": round(self.target_f(), 4),
            "measured_f": round(self.measured_f(), 4),
            "f_required_for_demand": round(self.f_required_for_demand(), 4),
            "predicted_read_mbps": round(self.predicted_read_mbps(), 1),
            "codec_ratio": round(self.codec_ratio, 3),
            "encode_mbps": round(self.encode_mbps, 1),
            "decode_mbps": round(self.decode_mbps, 1),
            "arbiter": self.arbiter.report() if self.arbiter is not None else None,
            "classes": classes,
        }

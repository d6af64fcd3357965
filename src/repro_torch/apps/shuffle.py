"""Out-of-core shuffle engine: spill-to-store external sort (DESIGN.md §9).

The defining I/O abstraction of MapReduce-class analytics on HPC storage
(Jha et al., "A Tale of Two Data-Intensive Paradigms") built on the
two-level store — so workloads are bounded by *store* capacity, not by
worker RAM:

* **Map/spill** — each mapper streams its input shard through
  ``get_buffered`` (sequential read, paper read mode (f)), accumulates
  records into a fixed-size sort buffer, and every time the buffer fills
  partitions the batch by sampled splitters, sorts it by ``(reducer,
  key)`` in one ``np.lexsort``, and spills each reducer's segment as a
  **per-reducer run file** through ``put_stream`` (``ASYNC_WRITEBACK``
  by default — Fig. 4 write mode beyond (c), so spill durability
  overlaps the next batch's compute).  One file per (batch, reducer)
  keeps every merge read whole-block aligned: no partial stripe-unit
  staging on the PFS tier, and each run is deletable the moment its one
  reader finishes.
* **Reduce/merge** — each reducer k-way-merges its runs with a chunked,
  vectorized merge: every run is read with *ranged* readahead
  (``get_buffered(offset, length)`` touches only covering blocks), a
  bounded chunk of records per run is resident, and batches that are
  globally safe to emit (key ≤ the minimum of the per-run chunk maxima)
  are sorted together with one ``np.argsort`` and streamed to the output
  shard through an :class:`~repro_torch.core.store.AppendHandle` as the merge
  drains.  Peak engine memory is O(memory_budget + k·readahead) no
  matter the dataset size.
* Each run file has exactly one reader — its reducer — and is deleted
  from *both tiers* the moment that reducer's merge has drained it.

Memory-budget math: each of ``workers`` concurrent mappers gets a
``budget / workers`` sort batch (the sorted permutation is streamed out
in small gather slices, so no second batch-sized copy exists); the
merge gives each of ``workers`` concurrent reducers ``budget /
workers``, a quarter-share per run chunk pool (``k`` resident chunks +
their re-blocking buffers) with the rest headroom for the emit batch —
which is double-counted while live (concat + sorted copies) — so
tracked engine buffers stay ≤ 2× budget at full occupancy.  The engine tracks every
buffer it allocates in a ledger — ``ShuffleStats.peak_buffer_bytes`` is
the acceptance-gate quantity (``benchmarks/terasort_scaling.py`` gates
it ≤ 2× budget).

The engine is workload-agnostic: records are fixed-size byte rows whose
leading ``key_bytes`` fold into a uint64 sort key.  TeraSort is the
identity reducer (``apps/terasort.py``); group-by/aggregate rides the
same primitives (``apps/groupby.py``) by handing ``run`` a reducer that
consumes sorted ``(keys, records)`` batches and emits aggregate rows.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from repro_torch.core.sched import StreamClass
from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode

MB = 2**20

#: A reducer consumes globally key-ordered ``(keys, records)`` batches and
#: yields bytes-like chunks for the output shard.  ``None`` = identity.
Reducer = Callable[[Iterator[tuple[np.ndarray, np.ndarray]]], Iterator[bytes]]


def fold_keys(records: np.ndarray, key_bytes: int) -> np.ndarray:
    """Fold each record's leading ``key_bytes`` into a sortable uint64.

    Big-endian byte weights mod 2^63 — the repo-wide key convention
    (matches the seed TeraSort and ``teravalidate``).
    """
    w = 256 ** np.arange(key_bytes - 1, -1, -1, dtype=np.uint64)
    return records[:, :key_bytes].astype(np.uint64) @ w % (1 << 63)


@dataclasses.dataclass
class ShuffleConfig:
    n_reducers: int
    record_bytes: int
    key_bytes: int
    memory_budget_bytes: int = 32 * MB
    workers: int = 1
    spill_mode: WriteMode = WriteMode.ASYNC_WRITEBACK
    output_mode: WriteMode | None = None  # None = store default
    read_mode: ReadMode | None = None  # None = store default
    # Per-run PFS readahead while merging: None defers to the store (its
    # static default, or the adaptive controller's per-stream depth when
    # one is attached); an int pins it.
    merge_readahead_blocks: int | None = 1
    sample_records: int = 2048  # splitter sample size per input shard
    prefix: str = "shuffle"  # spill namespace inside the store
    cleanup_spills: bool = True


@dataclasses.dataclass
class ShuffleStats:
    records_in: int = 0
    records_out: int = 0
    input_bytes: int = 0
    spill_batches: int = 0  # sort-buffer fills across mappers
    spill_files: int = 0  # per-reducer run files written
    spill_bytes: int = 0
    merge_bytes: int = 0
    output_bytes: int = 0
    runs_merged_max: int = 0  # widest k over reducers
    peak_buffer_bytes: int = 0  # ledger peak: sort + merge + emit buffers
    spills_deleted: int = 0
    sample_s: float = 0.0
    spill_s: float = 0.0
    merge_s: float = 0.0

    @property
    def moved_bytes(self) -> int:
        """Bytes that crossed the store, both directions, all phases."""
        return self.input_bytes + 2 * self.spill_bytes + self.output_bytes

    @property
    def shuffle_s(self) -> float:
        return self.sample_s + self.spill_s + self.merge_s

    def aggregate_mbps(self) -> float:
        return self.moved_bytes / MB / self.shuffle_s if self.shuffle_s > 0 else 0.0


class _BufferLedger:
    """Tracks engine-allocated buffer bytes; records the high-water mark."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.current = 0
        self.peak = 0

    def acquire(self, n: int) -> None:
        with self._lock:
            self.current += n
            if self.current > self.peak:
                self.peak = self.current

    def release(self, n: int) -> None:
        with self._lock:
            self.current -= n


class _RunReader:
    """One sorted run: a bounded record chunk fed by a ranged stream."""

    __slots__ = ("keys", "records", "pos", "_chunks", "_engine", "_nbytes")

    def __init__(self, engine: "ShuffleEngine", name: str, offset: int, length: int,
                 chunk_records: int) -> None:
        self._engine = engine
        self._nbytes = 0
        self.keys = np.empty(0, dtype=np.uint64)
        self.records = np.empty((0, engine.cfg.record_bytes), dtype=np.uint8)
        self.pos = 0
        self._chunks = engine._record_chunks(name, offset, length, chunk_records)
        self.refill()

    @property
    def exhausted(self) -> bool:
        return self.pos >= len(self.keys) and self._chunks is None

    def refill(self) -> None:
        """Load the next chunk once the current one is fully consumed."""
        if self.pos < len(self.keys) or self._chunks is None:
            return
        # Release the drained chunk *before* decoding the next one, so the
        # ledger never counts two chunks for one run.
        self._engine._ledger.release(self._nbytes)
        self._nbytes = 0
        nxt = next(self._chunks, None)
        if nxt is None:
            self._chunks = None
            self._nbytes = 0
            self.keys = np.empty(0, dtype=np.uint64)
            self.records = np.empty((0, self.records.shape[1]), dtype=np.uint8)
        else:
            self.keys, self.records = nxt
            self._nbytes = self.records.nbytes + self.keys.nbytes
            self._engine._ledger.acquire(self._nbytes)
        self.pos = 0

    def last_key(self) -> int:
        return int(self.keys[-1])

    def take_upto(self, bound: int) -> tuple[np.ndarray, np.ndarray] | None:
        """Consume the prefix with key ≤ bound (globally safe to emit)."""
        hi = int(np.searchsorted(self.keys, bound, side="right"))
        if hi <= self.pos:
            return None
        lo, self.pos = self.pos, hi
        return self.keys[lo:hi], self.records[lo:hi]

    def close(self) -> None:
        if self._chunks is not None:
            self._chunks.close()
            self._chunks = None
        self._engine._ledger.release(self._nbytes)
        self._nbytes = 0


class ShuffleEngine:
    """Bounded-memory external-sort shuffle over a :class:`TwoLevelStore`."""

    def __init__(self, store: TwoLevelStore, cfg: ShuffleConfig) -> None:
        if cfg.n_reducers < 1 or cfg.record_bytes < 1:
            raise ValueError("n_reducers and record_bytes must be positive")
        if not 0 < cfg.key_bytes <= cfg.record_bytes:
            raise ValueError("key_bytes must be in (0, record_bytes]")
        self.store = store
        self.cfg = cfg
        self.stats = ShuffleStats()
        self._ledger = _BufferLedger()
        self._arb_pool = None  # optional arbiter lease (attach_arbiter)
        self._lock = threading.Lock()
        # reducer -> [(run file name, byte length)] — each a key-sorted run
        self._runs: dict[int, list[tuple[str, int]]] = {r: [] for r in range(cfg.n_reducers)}
        # Stream intent for the adaptive controller: spill runs are written
        # once and read exactly once by their reducer — ghost-gated
        # admission + deep sequential readahead, and flushed spill blocks
        # may be dropped from the memory tier under contention.
        store.hint_stream(cfg.prefix + "/spill/", StreamClass.SEQ_ONCE)

    def attach_arbiter(self, arbiter, *, min_bytes: int = 0, weight: float = 1.0):
        """Lease the sort-buffer budget from a :class:`MemoryArbiter`.

        The pool's grant only ever *shrinks* the live budget below
        ``cfg.memory_budget_bytes`` (never raises it), so the ledger's
        ≤ 2×-budget acceptance gate keeps its original meaning.
        """
        floor = max(int(min_bytes), self.cfg.record_bytes * max(1, self.cfg.workers))
        pool = arbiter.register(
            "shuffle_sort",
            cls="seq_once",
            min_bytes=floor,
            initial_bytes=self.cfg.memory_budget_bytes,
        )

        def value_fn() -> float:
            pool.note_used(self._ledger.current)
            # Always demand the configured budget: jobs are bursty, and a
            # demand collapse between jobs would strand the next job on the
            # floor grant until a plan tick.  SEQ_ONCE's low class base is
            # what lets other pools outbid an idle engine.
            pool.note_demand(self.cfg.memory_budget_bytes)
            return 1.0 * weight * (1.0 + 4.0 * pool.miss_rate())

        pool.value_fn = value_fn
        self._arb_pool = pool
        return pool

    def _live_budget_bytes(self) -> int:
        if self._arb_pool is not None:
            return max(self.cfg.record_bytes,
                       min(self._arb_pool.budget, self.cfg.memory_budget_bytes))
        return self.cfg.memory_budget_bytes

    # ------------------------------------------------------------- phases

    def run(self, inputs: list[str], out_name: Callable[[int], str],
            reducer: Reducer | None = None) -> ShuffleStats:
        """Shuffle ``inputs`` into ``n_reducers`` output shards.

        ``out_name(r)`` names reducer ``r``'s output file; ``reducer``
        optionally transforms each reducer's sorted stream (group-by).
        """
        cfg = self.cfg
        for name in inputs:
            # Mapper input shards are one sequential scan each — they must
            # not evict anyone's re-read working set on the way through.
            # Cleared in the finally below: the scan is over when the run
            # ends, and per-file hints must not accumulate across jobs on a
            # long-lived store (classify() walks the hint table).
            self.store.hint_stream(name, StreamClass.SEQ_ONCE)
        try:
            return self._run_impl(inputs, out_name, reducer)
        finally:
            for name in inputs:
                self.store.hint_stream(name, None)

    def _run_impl(self, inputs: list[str], out_name: Callable[[int], str],
                  reducer: Reducer | None) -> ShuffleStats:
        splitters = self.sample(inputs)
        self.map_phase(inputs, splitters)
        self.reduce_phase(out_name, reducer)
        return self.stats

    def sample(self, inputs: list[str]) -> np.ndarray:
        """Phase 1: sample input keys → the global splitter vector.

        In a distributed run, one host samples and every host maps with
        the *same* splitters (they define the reducer partitioning, so
        they must be global) — publish them however the job coordinates,
        e.g. a small store file.
        """
        t0 = time.perf_counter()
        splitters = self._sample_splitters(inputs)
        self.stats.sample_s += time.perf_counter() - t0
        return splitters

    def map_phase(self, inputs: list[str], splitters: np.ndarray,
                  mapper_base: int = 0) -> None:
        """Phase 2: map/spill ``inputs`` into per-reducer run files.

        ``mapper_base`` offsets the mapper index baked into run-file names
        — in a multi-host job each host maps its own input subset with a
        disjoint index range (host ``h`` of ``H`` passes ``h * len(all) //
        H`` or any non-overlapping base) so spill names never collide in
        the shared namespace.
        """
        cfg = self.cfg
        t0 = time.perf_counter()
        workers = max(1, cfg.workers)
        if workers > 1 and len(inputs) > 1:
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="shuffle-map") as ex:
                list(
                    ex.map(
                        lambda mi: self._map_one(mapper_base + mi[0], mi[1], splitters),
                        enumerate(inputs),
                    )
                )
        else:
            for m, name in enumerate(inputs):
                self._map_one(mapper_base + m, name, splitters)
        self.stats.spill_s += time.perf_counter() - t0

    def reduce_phase(self, out_name: Callable[[int], str],
                     reducer: Reducer | None = None,
                     reducers: list[int] | None = None) -> None:
        """Phase 3: k-way-merge run files into output shards.

        ``reducers`` restricts this engine to a subset of reducer indexes
        — the multi-host path: :func:`place_reducers` assigns each reducer
        to the host whose memory shard holds the most of its run bytes
        hot, and each host calls ``reduce_phase(..., reducers=mine)``
        after :meth:`discover_runs`.
        """
        cfg = self.cfg
        todo = sorted(set(range(cfg.n_reducers) if reducers is None else reducers))
        for r in todo:
            if not 0 <= r < cfg.n_reducers:
                raise ValueError(f"reducer index {r} outside 0..{cfg.n_reducers - 1}")
        t0 = time.perf_counter()
        workers = max(1, cfg.workers)
        if workers > 1 and len(todo) > 1:
            with ThreadPoolExecutor(max_workers=workers, thread_name_prefix="shuffle-red") as ex:
                list(ex.map(lambda r: self._reduce_one(r, out_name(r), reducer), todo))
        else:
            for r in todo:
                self._reduce_one(r, out_name(r), reducer)
        self.stats.merge_s += time.perf_counter() - t0
        self.stats.peak_buffer_bytes = self._ledger.peak

    def discover_runs(self) -> int:
        """Rebuild the run registry from the store's file listing.

        The registry (`reducer → [(run name, length)]`) is engine-local
        state; an engine that did not run the map phase — a reducer host
        in a distributed job, or a restarted process resuming after the
        spills were written — recovers it from the shared namespace by
        the run-name pattern ``{prefix}/spill/m*-*-r{r:03d}``.  Returns
        the number of run files found.
        """
        cfg = self.cfg
        spill_prefix = f"{cfg.prefix}/spill/m"
        found = 0
        with self._lock:
            self._runs = {r: [] for r in range(cfg.n_reducers)}
            for name in self.store.list_files():
                if not name.startswith(spill_prefix):
                    continue
                tail = name.rsplit("-r", 1)
                if len(tail) != 2 or not tail[1].isdigit():
                    continue
                r = int(tail[1])
                if not 0 <= r < cfg.n_reducers:
                    continue
                self._runs[r].append((name, self.store.file_size(name)))
                found += 1
        return found

    # ------------------------------------------------------------ sampling

    def _sample_splitters(self, inputs: list[str]) -> np.ndarray:
        """Sample record keys from every input; quantiles → splitters."""
        cfg = self.cfg
        rb = cfg.record_bytes
        probes_per_shard = 8
        keys: list[np.ndarray] = []
        for name in inputs:
            size = self.store.file_size(name)
            n_rec = size // rb
            if n_rec == 0:
                continue
            per_probe = max(1, cfg.sample_records // probes_per_shard)
            for j in range(probes_per_shard):
                start = (j * n_rec) // probes_per_shard
                cnt = min(per_probe, n_rec - start)
                if cnt <= 0:
                    continue
                raw = self.store.get_range(name, start * rb, cnt * rb, mode=cfg.read_mode)
                with self._lock:
                    self.stats.input_bytes += len(raw)
                recs = np.frombuffer(raw, dtype=np.uint8)[: (len(raw) // rb) * rb]
                keys.append(fold_keys(recs.reshape(-1, rb), cfg.key_bytes))
        if not keys or cfg.n_reducers == 1:
            return np.empty(0, dtype=np.uint64)
        sample = np.concatenate(keys)
        qs = np.linspace(0, 1, cfg.n_reducers + 1)[1:-1]
        return np.quantile(sample, qs).astype(np.uint64)

    # ---------------------------------------------------------- map/spill

    def _per_mapper_batch_records(self) -> int:
        # Each concurrent mapper gets the full per-worker share: the sort
        # permutation is *streamed* out in app-buffer-sized gather slices
        # (see _spill), so no second batch-sized copy ever exists.
        per_mapper = self._live_budget_bytes() // max(1, self.cfg.workers)
        return max(1, per_mapper // self.cfg.record_bytes)

    def _map_one(self, m: int, name: str, splitters: np.ndarray) -> None:
        cfg = self.cfg
        rb = cfg.record_bytes
        batch_records = self._per_mapper_batch_records()
        buf = np.empty((batch_records, rb), dtype=np.uint8)
        self._ledger.acquire(buf.nbytes)
        fill = 0
        n_spills = 0
        read_bytes = 0
        carry = bytearray()
        try:
            for chunk in self.store.get_buffered(name, mode=cfg.read_mode):
                read_bytes += len(chunk)
                carry += chunk
                whole = (len(carry) // rb) * rb
                if not whole:
                    continue
                recs = np.frombuffer(bytes(carry[:whole]), dtype=np.uint8).reshape(-1, rb)
                del carry[:whole]
                pos = 0
                while pos < len(recs):
                    take = min(batch_records - fill, len(recs) - pos)
                    buf[fill : fill + take] = recs[pos : pos + take]
                    fill += take
                    pos += take
                    if fill == batch_records:
                        self._spill(m, n_spills, buf[:fill], splitters)
                        n_spills += 1
                        fill = 0
            if carry:
                raise ValueError(f"{name}: size not a multiple of record_bytes={rb}")
            if fill:
                self._spill(m, n_spills, buf[:fill], splitters)
        finally:
            self._ledger.release(buf.nbytes)
        with self._lock:
            self.stats.input_bytes += read_bytes

    def _run_name(self, m: int, s: int, r: int) -> str:
        return f"{self.cfg.prefix}/spill/m{m:03d}-{s:04d}-r{r:03d}"

    def _spill(self, m: int, s: int, records: np.ndarray, splitters: np.ndarray) -> None:
        """Sort one batch by (reducer, key); spill one run file per reducer.

        Separate files keep each run's merge read whole-block aligned —
        a ranged read into the middle of a shared spill file would stage
        whole boundary stripe units on the PFS tier (read amplification
        ∝ stripe/segment); a run file is read exactly once, exactly.
        """
        cfg = self.cfg
        rb = cfg.record_bytes
        keys = fold_keys(records, cfg.key_bytes)
        if len(splitters):
            dest = np.searchsorted(splitters, keys, side="right")
            order = np.lexsort((keys, dest))
            counts = np.bincount(dest, minlength=cfg.n_reducers)
        else:
            order = np.argsort(keys, kind="stable")
            counts = np.zeros(cfg.n_reducers, dtype=np.int64)
            counts[0] = len(keys)
        bounds = np.concatenate(([0], np.cumsum(counts)))
        slice_records = max(1, self.store.app_buffer_bytes // rb)
        n_files = 0
        for r in range(cfg.n_reducers):
            lo, hi = int(bounds[r]), int(bounds[r + 1])
            if hi == lo:
                continue
            idx = order[lo:hi]
            name = self._run_name(m, s, r)

            def seg_chunks(idx: np.ndarray = idx):
                # Stream the sorted permutation out in small gather slices —
                # the batch buffer is the only batch-sized allocation.
                for a in range(0, len(idx), slice_records):
                    part = records[idx[a : a + slice_records]]
                    yield memoryview(part.reshape(-1).data)

            self.store.put_stream(name, seg_chunks(), mode=cfg.spill_mode)
            n_files += 1
            with self._lock:
                self._runs[r].append((name, (hi - lo) * rb))
        with self._lock:
            self.stats.spill_batches += 1
            self.stats.spill_files += n_files
            self.stats.spill_bytes += len(records) * rb
            self.stats.records_in += len(records)

    # --------------------------------------------------------- reduce/merge

    def _record_chunks(self, name: str, offset: int, length: int,
                       chunk_records: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Decode a ranged stream into (keys, records) chunks of bounded size.

        Bytes are consumed straight off the store's streaming buffers in
        ≤ chunk-size slices, so engine-resident memory per run stays
        O(chunk) regardless of the store's app-buffer granularity.
        """
        cfg = self.cfg
        rb = cfg.record_bytes
        step = chunk_records * rb
        buf = bytearray()
        stream = self.store.get_buffered(
            name,
            mode=cfg.read_mode,
            readahead=cfg.merge_readahead_blocks,
            offset=offset,
            length=length,
        )

        def decode(b: bytes) -> tuple[np.ndarray, np.ndarray]:
            recs = np.frombuffer(b, dtype=np.uint8).reshape(-1, rb)
            return fold_keys(recs, cfg.key_bytes), recs

        read = 0
        self._ledger.acquire(step)  # the re-blocking buffer below
        try:
            for mv in stream:
                read += len(mv)
                pos = 0
                while pos < len(mv):
                    take = min(len(mv) - pos, step - len(buf))
                    buf += mv[pos : pos + take]
                    pos += take
                    if len(buf) == step:
                        blob = bytes(buf)
                        buf.clear()  # before the yield: one chunk live at a time
                        yield decode(blob)
            whole = (len(buf) // rb) * rb
            if whole != len(buf):
                raise ValueError(f"{name}: run length not a multiple of record_bytes")
            if buf:
                yield decode(bytes(buf))
        finally:
            self._ledger.release(step)
            stream.close()
            with self._lock:
                self.stats.merge_bytes += read

    def _merge_chunk_records(self, k: int) -> int:
        # Each of `workers` concurrent reducers holds k run chunks (keys +
        # records ≈ chunk bytes each, plus their re-blocking buffers) and
        # the emit batch, which is double-counted while live (concat +
        # sorted copies, see _merged_batches) and can span up to the sum of
        # all chunks — so a run's share is a quarter of the per-reducer
        # budget split k ways, keeping worst-case tracked bytes ≤ 2×budget.
        per_reducer = self._live_budget_bytes() // max(1, self.cfg.workers)
        per_run = per_reducer // (4 * max(1, k))
        return max(1, per_run // self.cfg.record_bytes)

    def _merged_batches(self, readers: list[_RunReader]) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Chunked k-way merge: emit globally-safe batches in key order.

        Invariant: any record not yet resident in a run's chunk has key ≥
        that chunk's last key, so everything ≤ the minimum of the per-run
        chunk maxima can be emitted after one batched argsort.
        """
        active = [r for r in readers if len(r.keys)]
        while active:
            bound = min(r.last_key() for r in active)
            parts_k: list[np.ndarray] = []
            parts_r: list[np.ndarray] = []
            for r in active:
                taken = r.take_upto(bound)
                if taken is not None:
                    parts_k.append(taken[0])
                    parts_r.append(taken[1])
                r.refill()
            keys = parts_k[0] if len(parts_k) == 1 else np.concatenate(parts_k)
            recs = parts_r[0] if len(parts_r) == 1 else np.concatenate(parts_r)
            # Emit accounting covers everything live while the consumer runs:
            # the concatenated batch, the argsort permutation, and the
            # gathered (sorted) copies handed downstream.
            nbytes = 2 * (keys.nbytes + recs.nbytes) + 8 * len(keys)
            self._ledger.acquire(nbytes)
            try:
                order = np.argsort(keys, kind="stable")
                yield keys[order], recs[order]
            finally:
                self._ledger.release(nbytes)
            active = [r for r in readers if not r.exhausted]

    def _reduce_one(self, r: int, out: str, reducer: Reducer | None) -> None:
        # Output-stream intent is the *client's* declaration (it owns the
        # naming and knows whether downstream re-reads) — e.g. terasort
        # hints its output prefix SEQ_ONCE; the engine registers nothing
        # per-file here, so hints cannot accumulate across jobs.
        cfg = self.cfg
        with self._lock:
            runs = sorted(self._runs[r])
            self.stats.runs_merged_max = max(self.stats.runs_merged_max, len(runs))
        chunk_records = self._merge_chunk_records(len(runs))
        readers = [_RunReader(self, name, 0, ln, chunk_records) for name, ln in runs]
        written = 0
        n_out = 0
        # A fresh shuffle replaces, never extends, a previous run's output
        # (open_append would resume at a leftover file's end).
        self.store.delete(out)
        handle = self.store.open_append(out, mode=cfg.output_mode)
        try:
            batches = self._merged_batches(readers)
            if reducer is not None:
                for chunk in reducer(batches):
                    written = handle.append_chunk(chunk)
            else:
                for _, recs in batches:
                    n_out += len(recs)
                    written = handle.append_chunk(memoryview(recs.reshape(-1).data))
        finally:
            handle.close()
            for reader in readers:
                reader.close()
        with self._lock:
            self.stats.output_bytes += written
            # A custom reducer defines its own output row shape; records_out
            # counts identity-path records only.
            self.stats.records_out += n_out
        if cfg.cleanup_spills:
            # Each run file has exactly one reader — this reducer — so its
            # spills leave both tiers the moment the merge has drained them.
            for name, _ in runs:
                self.store.delete(name)
            with self._lock:
                self._runs[r] = []
                self.stats.spills_deleted += len(runs)


def place_reducers(
    n_reducers: int,
    n_hosts: int,
    hot_bytes: dict[int, dict[str, int]],
    host_ids: list[int] | None = None,
    prefix: str = "shuffle",
) -> list[int]:
    """Assign reducers to hosts where their run bytes are already hot.

    ``hot_bytes`` is the distributed store's gossip view
    (``DistributedStore.cluster_hot_bytes()``).  A reducer's affinity to a
    host is the sum of hot bytes over that host's run files matching
    ``{prefix}/spill/m*-*-r{r:03d}`` — with async-writeback spills the
    mapper host still holds its runs in its memory shard, so the reducer
    lands where most of its merge input needs no peer or PFS transfer
    (the shuffle analogue of delay scheduling).  Greedy by descending
    affinity under a ``ceil(n_reducers / n_hosts)`` balance cap; reducers
    with no hot runs fill the least-loaded hosts.  Returns ``owners[r]`` =
    host index, for ``reduce_phase(..., reducers=[r for r in ... if
    owners[r] == me])``.
    """
    if n_hosts <= 0:
        raise ValueError("n_hosts must be positive")
    ids = list(range(n_hosts)) if host_ids is None else list(host_ids)
    if len(ids) != n_hosts:
        raise ValueError(f"host_ids has {len(ids)} entries for n_hosts={n_hosts}")
    spill_prefix = f"{prefix}/spill/m"
    affinity = np.zeros((n_reducers, n_hosts), dtype=np.int64)
    for h, hid in enumerate(ids):
        for name, nbytes in hot_bytes.get(hid, {}).items():
            if not name.startswith(spill_prefix):
                continue
            tail = name.rsplit("-r", 1)
            if len(tail) != 2 or not tail[1].isdigit():
                continue
            r = int(tail[1])
            if 0 <= r < n_reducers:
                affinity[r, h] += int(nbytes)
    cap = -(-n_reducers // n_hosts)  # ceil
    edges = sorted(
        ((-int(affinity[r, h]), r, h) for r in range(n_reducers) for h in range(n_hosts)),
    )
    owners = [-1] * n_reducers
    load = [0] * n_hosts
    for neg, r, h in edges:
        if neg == 0:
            break
        if owners[r] == -1 and load[h] < cap:
            owners[r] = h
            load[h] += 1
    for r in range(n_reducers):
        if owners[r] == -1:
            h = min(range(n_hosts), key=lambda i: (load[i], i))
            owners[r] = h
            load[h] += 1
    return owners

"""TeraSort on the two-level storage system (paper Section 5.3).

A faithful miniature of the benchmark's I/O pattern, now a thin client of
the out-of-core shuffle engine (``apps/shuffle.py``):

* **TeraGen** — map-only job writing random fixed-size records (10-byte
  key + payload) as shard files through a chosen write mode.
* **TeraSort** — the engine's external sort: mappers stream shards
  (read-once) and partition/sort/spill within a fixed memory budget;
  reducers k-way-merge their spill runs with ranged readahead and stream
  output shards as the merge drains.  Peak memory is bounded by the
  budget, so TeraSort runs on datasets far larger than the memory tier —
  the whole point of the benchmark.
* **TeraValidate** — streams outputs and checks global key order without
  materializing a partition.

Phase wall-times + spill/merge stats + store tier stats are returned so
the fig7 / terasort_scaling benchmarks can compare HDFS-style
(memory-only), OrangeFS-style (PFS bypass) and two-level (tiered)
storage on real moved bytes.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.apps.shuffle import ShuffleConfig, ShuffleEngine, ShuffleStats, fold_keys
from repro_torch.core.sched import StreamClass
from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode

RECORD = 100  # bytes per record (TeraSort convention)
KEY = 10  # leading key bytes

MB = 2**20


def _record_keys(records: np.ndarray) -> np.ndarray:
    """Fold each record's leading KEY bytes into a sortable uint64."""
    return fold_keys(records, KEY)


@dataclasses.dataclass
class TeraSortTimings:
    label: str
    gen_s: float
    map_s: float  # map/spill phase: stream + partition + sort + spill
    shuffle_s: float  # splitter sampling (the shuffle plan)
    reduce_s: float  # k-way merge + output streaming
    validate_s: float
    records: int
    mem_hit_rate: float
    # Spill/merge accounting from the engine (out-of-core path).
    spill_files: int = 0
    spill_bytes: int = 0
    merge_runs_max: int = 0
    peak_buffer_bytes: int = 0
    shuffle_mbps: float = 0.0

    @property
    def sort_s(self) -> float:
        return self.map_s + self.shuffle_s + self.reduce_s


def _shard_name(i: int) -> str:
    return f"terasort/in_{i:04d}"


def _out_name(i: int) -> str:
    return f"terasort/out_{i:04d}"


def teragen(
    store: TwoLevelStore,
    n_records: int,
    n_shards: int = 4,
    write_mode: WriteMode | None = None,
    seed: int = 0,
    workers: int = 1,
) -> float:
    """Generate and store the input; returns wall seconds."""
    t0 = time.perf_counter()
    per = n_records // n_shards

    def gen_shard(i: int) -> None:
        rng = np.random.default_rng(seed + i)
        # Generate + stream in bounded slabs so TeraGen itself stays
        # out-of-core friendly at dataset >> RAM-budget sizes.
        slab = max(1, (8 * MB) // RECORD)

        def chunks():
            left = per
            while left:
                n = min(slab, left)
                left -= n
                yield rng.integers(0, 256, size=(n, RECORD), dtype=np.uint8).tobytes()

        store.put_stream(_shard_name(i), chunks(), mode=write_mode)

    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(gen_shard, range(n_shards)))
    else:
        for i in range(n_shards):
            gen_shard(i)
    return time.perf_counter() - t0


def _spill_mode_for(write_mode: WriteMode | None) -> WriteMode:
    """Spills follow the storage organization under test.

    Memory-only and PFS-bypass runs must keep their single-tier contract;
    everything else spills via ASYNC_WRITEBACK so durability overlaps the
    next batch's sort (Fig. 4 write modes, DESIGN.md §9).
    """
    if write_mode in (WriteMode.MEMORY_ONLY, WriteMode.PFS_BYPASS):
        return write_mode
    return WriteMode.ASYNC_WRITEBACK


def terasort(
    store: TwoLevelStore,
    n_shards: int = 4,
    n_reducers: int = 4,
    read_mode: ReadMode | None = None,
    write_mode: WriteMode | None = None,
    label: str = "tls",
    workers: int = 1,
    memory_budget_bytes: int = 32 * MB,
) -> TeraSortTimings:
    """External-sort TeraSort: bounded-memory spill + merge on the store."""
    cfg = ShuffleConfig(
        n_reducers=n_reducers,
        record_bytes=RECORD,
        key_bytes=KEY,
        memory_budget_bytes=memory_budget_bytes,
        workers=workers,
        spill_mode=_spill_mode_for(write_mode),
        output_mode=write_mode,
        read_mode=read_mode,
        prefix="terasort/shuffle",
    )
    engine = ShuffleEngine(store, cfg)
    # Output shards are streamed once by the merge and scanned once by
    # TeraValidate — declare the whole prefix read-once (one bounded hint;
    # a genuine later re-reader still promotes via the ghost list).
    store.hint_stream("terasort/out_", StreamClass.SEQ_ONCE)
    stats: ShuffleStats = engine.run(
        [_shard_name(i) for i in range(n_shards)], _out_name
    )

    t0 = time.perf_counter()
    ok = teravalidate(store, n_reducers, read_mode=read_mode)
    validate_s = time.perf_counter() - t0
    if not ok:
        raise AssertionError("terasort output is not globally ordered")

    return TeraSortTimings(
        label=label,
        gen_s=0.0,
        map_s=stats.spill_s,
        shuffle_s=stats.sample_s,
        reduce_s=stats.merge_s,
        validate_s=validate_s,
        records=stats.records_out,
        mem_hit_rate=store.stats.hit_rate(),
        spill_files=stats.spill_files,
        spill_bytes=stats.spill_bytes,
        merge_runs_max=stats.runs_merged_max,
        peak_buffer_bytes=stats.peak_buffer_bytes,
        shuffle_mbps=stats.aggregate_mbps(),
    )


def teravalidate(
    store: TwoLevelStore, n_reducers: int, read_mode: ReadMode | None = None
) -> bool:
    """Global order: within-partition sorted AND partitions ordered.

    Streams each output shard through ``get_buffered`` — O(chunk) memory,
    so validation works at dataset >> memory-tier sizes too.
    """
    prev_max: int | None = None
    for r in range(n_reducers):
        if not store.exists(_out_name(r)):
            continue
        carry = bytearray()
        for chunk in store.get_buffered(_out_name(r), mode=read_mode):
            carry += chunk
            whole = (len(carry) // RECORD) * RECORD
            if not whole:
                continue
            part = np.frombuffer(bytes(carry[:whole]), dtype=np.uint8).reshape(-1, RECORD)
            del carry[:whole]
            keys = _record_keys(part)
            if len(keys) > 1 and (np.diff(keys.astype(np.int64)) < 0).any():
                return False
            if prev_max is not None and len(keys) and int(keys[0]) < prev_max:
                return False
            if len(keys):
                prev_max = int(keys[-1])
        if carry:
            return False  # trailing partial record
    return True

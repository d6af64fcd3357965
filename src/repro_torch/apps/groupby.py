"""Group-by/aggregate on the shuffle engine — the engine's second workload.

Proves the external-sort shuffle generalizes beyond TeraSort: the same
spill/merge data path, but reducers consume the globally key-ordered
``(keys, records)`` batches and emit one aggregate row per group
(sum + count of each record's value field), vectorized with
``np.unique``/``np.add.reduceat`` and carrying the open group across
batch boundaries.

Record layout (fixed 32 bytes):

* bytes ``[0, 8)``   — big-endian group key.  Generated keys keep the
  top bit clear, so the engine's 63-bit key fold is injective and equal
  folded keys ⇔ equal group keys (records of one group are contiguous
  in the merged stream).
* bytes ``[8, 16)``  — big-endian uint value (< 2^32 at gen time, so
  sums of any realistic group count fit the output field).
* bytes ``[16, 32)`` — payload padding.

Aggregate row layout (24 bytes): key(8) | sum(8) | count(8), big-endian.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator

import numpy as np

from repro_torch.apps.shuffle import ShuffleConfig, ShuffleEngine, ShuffleStats
from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode

RECORD = 32
KEY = 8
VAL_OFF, VAL_LEN = 8, 8
AGG_RECORD = 24

MB = 2**20

_BE64 = 256 ** np.arange(7, -1, -1, dtype=np.uint64)


def _shard_name(i: int) -> str:
    return f"groupby/in_{i:04d}"


def _out_name(i: int) -> str:
    return f"groupby/agg_{i:04d}"


def _values_of(records: np.ndarray) -> np.ndarray:
    return records[:, VAL_OFF : VAL_OFF + VAL_LEN].astype(np.uint64) @ _BE64


@dataclasses.dataclass
class GroupByResult:
    label: str
    gen_s: float
    shuffle_s: float
    groups: int
    stats: ShuffleStats


def groupgen(
    store: TwoLevelStore,
    n_records: int,
    n_groups: int,
    n_shards: int = 4,
    write_mode: WriteMode | None = None,
    seed: int = 0,
) -> float:
    """Generate shards of (group-key, value, padding) records."""
    t0 = time.perf_counter()
    per = n_records // n_shards
    for i in range(n_shards):
        rng = np.random.default_rng(seed + i)
        gids = rng.integers(0, n_groups, size=per, dtype=np.uint64)
        keys = (gids * np.uint64(0x9E3779B97F4A7C15)) & np.uint64((1 << 63) - 1)
        vals = rng.integers(0, 1 << 32, size=per, dtype=np.uint64)
        recs = np.empty((per, RECORD), dtype=np.uint8)
        # big-endian byte split of keys and values
        for b in range(8):
            shift = np.uint64(8 * (7 - b))
            recs[:, b] = (keys >> shift).astype(np.uint8)
            recs[:, VAL_OFF + b] = (vals >> shift).astype(np.uint8)
        recs[:, VAL_OFF + VAL_LEN :] = rng.integers(
            0, 256, size=(per, RECORD - VAL_OFF - VAL_LEN), dtype=np.uint8
        )
        store.put(_shard_name(i), recs.tobytes(), mode=write_mode)
    return time.perf_counter() - t0


def _agg_rows(keys: np.ndarray, sums: np.ndarray, counts: np.ndarray) -> bytes:
    out = np.empty((len(keys), AGG_RECORD), dtype=np.uint8)
    for b in range(8):
        shift = np.uint64(8 * (7 - b))
        out[:, b] = (keys >> shift).astype(np.uint8)
        out[:, 8 + b] = (sums >> shift).astype(np.uint8)
        out[:, 16 + b] = (counts >> shift).astype(np.uint8)
    return out.tobytes()


def _sum_reducer(batches: Iterator[tuple[np.ndarray, np.ndarray]]) -> Iterator[bytes]:
    """Aggregate sorted batches into per-group (key, sum, count) rows.

    The last group of a batch may continue in the next one (the merge
    only guarantees global key order), so it is carried, not emitted,
    until a batch starts with a different key or the stream ends.
    """
    open_key: int | None = None
    open_sum = 0
    open_cnt = 0
    for keys, records in batches:
        if not len(keys):
            continue
        vals = _values_of(records)
        uniq, starts = np.unique(keys, return_index=True)
        sums = np.add.reduceat(vals, starts)
        counts = np.diff(np.append(starts, len(keys))).astype(np.uint64)
        if open_key is not None:
            if int(uniq[0]) == open_key:
                sums[0] += np.uint64(open_sum)
                counts[0] += np.uint64(open_cnt)
            else:
                yield _agg_rows(
                    np.array([open_key], dtype=np.uint64),
                    np.array([open_sum], dtype=np.uint64),
                    np.array([open_cnt], dtype=np.uint64),
                )
        open_key = int(uniq[-1])
        open_sum = int(sums[-1])
        open_cnt = int(counts[-1])
        if len(uniq) > 1:
            yield _agg_rows(uniq[:-1], sums[:-1], counts[:-1])
    if open_key is not None:
        yield _agg_rows(
            np.array([open_key], dtype=np.uint64),
            np.array([open_sum], dtype=np.uint64),
            np.array([open_cnt], dtype=np.uint64),
        )


def groupby_sum(
    store: TwoLevelStore,
    n_shards: int = 4,
    n_reducers: int = 4,
    read_mode: ReadMode | None = None,
    write_mode: WriteMode | None = None,
    workers: int = 1,
    memory_budget_bytes: int = 16 * MB,
    label: str = "tls",
) -> GroupByResult:
    """Group-by-key sum/count over all shards; one aggregate shard per reducer."""
    cfg = ShuffleConfig(
        n_reducers=n_reducers,
        record_bytes=RECORD,
        key_bytes=KEY,
        memory_budget_bytes=memory_budget_bytes,
        workers=workers,
        spill_mode=(
            write_mode
            if write_mode in (WriteMode.MEMORY_ONLY, WriteMode.PFS_BYPASS)
            else WriteMode.ASYNC_WRITEBACK
        ),
        output_mode=write_mode,
        read_mode=read_mode,
        prefix="groupby/shuffle",
    )
    engine = ShuffleEngine(store, cfg)
    t0 = time.perf_counter()
    stats = engine.run(
        [_shard_name(i) for i in range(n_shards)], _out_name, reducer=_sum_reducer
    )
    shuffle_s = time.perf_counter() - t0
    groups = stats.output_bytes // AGG_RECORD
    return GroupByResult(
        label=label, gen_s=0.0, shuffle_s=shuffle_s, groups=groups, stats=stats
    )


def read_aggregates(
    store: TwoLevelStore, n_reducers: int, read_mode: ReadMode | None = None
) -> dict[int, tuple[int, int]]:
    """Load all aggregate shards as {group_key: (sum, count)} (validation)."""
    out: dict[int, tuple[int, int]] = {}
    for r in range(n_reducers):
        if not store.exists(_out_name(r)):
            continue
        raw = store.get(_out_name(r), mode=read_mode)
        rows = np.frombuffer(raw, dtype=np.uint8).reshape(-1, AGG_RECORD)
        keys = rows[:, :8].astype(np.uint64) @ _BE64
        sums = rows[:, 8:16].astype(np.uint64) @ _BE64
        counts = rows[:, 16:24].astype(np.uint64) @ _BE64
        for k, s, c in zip(keys, sums, counts):
            if int(k) in out:
                raise ValueError(f"group {int(k)} split across reducers")
            out[int(k)] = (int(s), int(c))
    return out

"""Sharded, prefetching, resumable token pipeline over the TwoLevelStore.

Design (mirrors the paper's Hadoop-on-TLS data path, DESIGN.md §2):

* The corpus is materialized as shard files in the store.  Hot shards live
  in the memory tier; every shard is persisted on the PFS tier
  (write-through), so any host can lose its cache and re-read (read mode f).
* **Ranged reads, not shard re-reads:** a sequence window is fetched with
  ``store.get_range`` through a small LRU *slab cache* (fixed-size token
  slabs per shard), so one batch moves O(batch × window) bytes instead of
  the seed's O(batch × shard) full-shard re-read per window.
* **Locality scheduling (implemented):** the epoch permutation never moves
  a window out of its home shard — windows are permuted *within* each
  shard and the global order interleaves shards round-robin.  Shards are
  owned in contiguous blocks (``shard_owner``); with ``global_batch ==
  n_shards`` (the train driver's default geometry) every row of host
  ``h`` draws from a shard ``h`` owns, every step — its slab cache and
  the store's memory tier see repeat traffic (the paper's high ridge) —
  and the per-owner permutation keeps the stream a pure function of
  ``(seed, epoch)`` regardless of ``n_hosts``.  Other geometries still
  get the round-robin spread (and stable per-host residue sets whenever
  ``n_shards`` divides the global batch), just not the perfect
  row↔owned-shard match; ``LoaderStats.locality_fraction`` reports the
  achieved fraction honestly either way.
* The loader is **deterministic and resumable**: ``state()`` returns an
  exact cursor that ``restore()`` resumes from — required by the
  checkpoint/restart story (DESIGN.md §6, test_checkpoint.py).
* Two levels of overlap: shard reads stream block-by-block through the
  store's readahead iterator (``get_buffered`` keeps PFS stripe fetches in
  flight while tokens are decoded), and a background prefetch thread keeps
  ``prefetch_depth`` whole batches staged ahead of the training step
  (DESIGN.md §3).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import OrderedDict

import numpy as np

from repro_torch.core.sched import StreamClass
from repro_torch.core.store import ReadMode, TwoLevelStore, WriteMode


class SyntheticCorpus:
    """Deterministic synthetic token corpus, materialized into a store.

    Shard ``i`` is an ``int32`` token array generated from ``seed + i`` —
    reproducible across runs/hosts without shipping a dataset.
    """

    def __init__(
        self,
        store: TwoLevelStore,
        vocab_size: int,
        n_shards: int = 8,
        tokens_per_shard: int = 1 << 16,
        seed: int = 0,
        prefix: str = "corpus/shard",
    ) -> None:
        self.store = store
        self.vocab_size = vocab_size
        self.n_shards = n_shards
        self.tokens_per_shard = tokens_per_shard
        self.seed = seed
        self.prefix = prefix
        # Stream intent for the adaptive controller: corpus shards are read
        # sequentially and re-read every epoch — the class whose Eq. 7
        # caching value is highest (DESIGN.md §10).
        store.hint_stream(prefix, StreamClass.SEQ_REUSE)

    def shard_name(self, i: int) -> str:
        return f"{self.prefix}_{i:05d}"

    def generate(self, write_mode: WriteMode | None = None) -> None:
        """Materialize every shard into the store (idempotent)."""
        for i in range(self.n_shards):
            name = self.shard_name(i)
            if self.store.exists(name):
                continue
            rng = np.random.default_rng(self.seed + i)
            toks = rng.integers(0, self.vocab_size, size=self.tokens_per_shard, dtype=np.int32)
            self.store.put(name, toks.tobytes(), mode=write_mode)

    def read_shard(self, i: int, mode: ReadMode | None = None) -> np.ndarray:
        """Stream a shard into a token array without materializing the file.

        Fills a preallocated array from the store's readahead iterator, so
        PFS stripe transfers for later blocks overlap the copy-out of
        earlier ones and peak extra memory is one block, not the shard.
        """
        name = self.shard_name(i)
        nbytes = self.store.file_size(name)
        out = np.empty(nbytes // 4, dtype=np.int32)
        raw = out.view(np.uint8)
        pos = 0
        for chunk in self.store.get_buffered(name, mode=mode):
            raw[pos : pos + len(chunk)] = np.frombuffer(chunk, dtype=np.uint8)
            pos += len(chunk)
        return out

    def read_tokens(self, shard: int, token_offset: int, n_tokens: int) -> np.ndarray:
        """Ranged read of ``n_tokens`` tokens from one shard — only the
        covering store blocks move (memory-tier hit or partial stripe read)."""
        raw = self.store.get_range(self.shard_name(shard), token_offset * 4, n_tokens * 4)
        return np.frombuffer(raw, dtype=np.int32)


@dataclasses.dataclass
class PipelineState:
    """Exact cursor for deterministic resume."""

    epoch: int = 0
    step: int = 0  # batches already emitted

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineState":
        return cls(**d)


@dataclasses.dataclass
class LoaderStats:
    """Two-level data-path ledger for one loader."""

    slab_hits: int = 0
    slab_misses: int = 0
    bytes_fetched: int = 0  # bytes pulled from the store (slab fills)
    local_windows: int = 0  # windows whose home shard this host owns
    remote_windows: int = 0

    def hit_rate(self) -> float:
        total = self.slab_hits + self.slab_misses
        return self.slab_hits / total if total else 0.0

    def locality_fraction(self) -> float:
        total = self.local_windows + self.remote_windows
        return self.local_windows / total if total else 0.0


class _SlabCache:
    """LRU cache of fixed-size token slabs, filled by ``store.get_range``.

    The slab is the data plane's caching unit below the store block: a
    window read touches only its covering slabs, a slab is fetched with a
    single ranged read (no full-shard materialization), and the LRU keeps
    the working set of the current permutation rounds resident.
    """

    #: token width — slabs are int32 token arrays
    TOKEN_BYTES = 4

    def __init__(self, corpus: SyntheticCorpus, slab_tokens: int, capacity: int, stats: LoaderStats) -> None:
        self.corpus = corpus
        self.slab_tokens = slab_tokens
        self.capacity = max(1, capacity)
        self.stats = stats
        self._slabs: OrderedDict[tuple[int, int], np.ndarray] = OrderedDict()

    @property
    def bytes_per_slab(self) -> int:
        return self.slab_tokens * self.TOKEN_BYTES

    def set_capacity_bytes(self, nbytes: int) -> None:
        """Retarget the cache budget (the elastic arbiter's resize hook,
        DESIGN.md §13).  Only the target moves here; a shrink drains
        through ``get``'s own LRU trim on the next fill — the cache is
        single-consumer, so no cross-thread eviction races."""
        self.capacity = max(1, int(nbytes) // self.bytes_per_slab)

    def get(self, shard: int, slab_idx: int) -> np.ndarray:
        key = (shard, slab_idx)
        slab = self._slabs.get(key)
        if slab is not None:
            self._slabs.move_to_end(key)
            self.stats.slab_hits += 1
            return slab
        off = slab_idx * self.slab_tokens
        n = min(self.slab_tokens, self.corpus.tokens_per_shard - off)
        slab = self.corpus.read_tokens(shard, off, n)
        self.stats.slab_misses += 1
        self.stats.bytes_fetched += slab.nbytes
        self._slabs[key] = slab
        while len(self._slabs) > self.capacity:
            self._slabs.popitem(last=False)
        return slab


class ShardedLoader:
    """Yields ``(inputs, labels)`` batches for one host of a data-parallel job.

    The *global* batch is ``global_batch`` sequences; this host materializes
    rows ``[host_id::n_hosts]`` of it (``global_batch % n_hosts == 0``).
    Token stream order is a pure function of (seed, epoch, step), so any
    host — or a restarted replacement host — reconstructs its slice exactly.
    """

    def __init__(
        self,
        corpus: SyntheticCorpus,
        global_batch: int,
        seq_len: int,
        host_id: int = 0,
        n_hosts: int = 1,
        prefetch_depth: int = 2,
        state: PipelineState | None = None,
        slab_tokens: int = 2048,
        cache_slabs: int = 64,
        shard_owner_map: dict[int, int] | list[int] | None = None,
    ) -> None:
        if global_batch % n_hosts:
            raise ValueError(f"global_batch={global_batch} not divisible by n_hosts={n_hosts}")
        if shard_owner_map is not None:
            owners = dict(enumerate(shard_owner_map)) if isinstance(
                shard_owner_map, (list, tuple)
            ) else dict(shard_owner_map)
            if sorted(owners) != list(range(corpus.n_shards)):
                raise ValueError(
                    f"shard_owner_map must cover shards 0..{corpus.n_shards - 1}"
                )
            bad = {s: h for s, h in owners.items() if not 0 <= h < n_hosts}
            if bad:
                raise ValueError(f"shard_owner_map assigns out-of-range hosts: {bad}")
            self.shard_owner_map: dict[int, int] | None = owners
        else:
            self.shard_owner_map = None
        self.corpus = corpus
        self.global_batch = global_batch
        self.local_batch = global_batch // n_hosts
        self.seq_len = seq_len
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._state = state or PipelineState()
        self.prefetch_depth = prefetch_depth
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch_depth))
        self._worker: threading.Thread | None = None
        self._stop = threading.Event()
        self.stats = LoaderStats()
        self.slab_tokens = max(1, min(slab_tokens, corpus.tokens_per_shard))
        self._cache = _SlabCache(corpus, self.slab_tokens, cache_slabs, self.stats)
        self._order_cache: tuple[int, np.ndarray] | None = None

        total_tokens = corpus.n_shards * corpus.tokens_per_shard
        self.tokens_per_global_batch = global_batch * (seq_len + 1)
        self.steps_per_epoch = total_tokens // self.tokens_per_global_batch
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"corpus too small: {total_tokens} tokens < one global batch "
                f"({self.tokens_per_global_batch})"
            )

    # ------------------------------------------------------------- locality

    def shard_owner(self, shard: int) -> int:
        """Owner host of a shard: the explicit ``shard_owner_map`` when one
        was planned (:func:`plan_shard_placement` over the distributed
        store's gossip board, DESIGN.md §11), else contiguous blocks of
        ``n_shards/n_hosts``.

        Matches the round-robin epoch order either way: groups are walked
        owner-by-owner, so with ``global_batch == n_shards`` host ``h``'s
        rows at batch positions ``[h*local_batch, (h+1)*local_batch)`` draw
        from exactly the shards this function assigns to ``h``, every step
        — provided the placement gives each host ``n_shards/n_hosts``
        shards (which :func:`plan_shard_placement` balances to).
        (Divisibility alone is not enough: with ``global_batch > n_shards``
        a host's ``local_batch`` consecutive residues wrap around all
        shards.)
        """
        if self.shard_owner_map is not None:
            return self.shard_owner_map[shard]
        return min(shard * self.n_hosts // self.corpus.n_shards, self.n_hosts - 1)

    def attach_arbiter(self, arbiter, min_bytes: int = 0, weight: float = 1.0):
        """Register the slab cache as pool ``"loader_slabs"`` (SEQ_REUSE)
        of an elastic :class:`~repro_torch.core.arbiter.MemoryArbiter`.

        The pool's ``value_fn`` doubles as its per-tick ledger refresh:
        slab hit/miss deltas from :class:`LoaderStats` become the miss
        rate the arbiter scales marginal value by, and a full cache
        signals demand above the current budget.  Budget changes land via
        :meth:`_SlabCache.set_capacity_bytes` (DESIGN.md §13).
        """
        cache = self._cache
        bps = cache.bytes_per_slab
        pool = arbiter.register(
            "loader_slabs",
            cls="seq_reuse",
            min_bytes=max(min_bytes, bps),
            weight=weight,
            initial_bytes=cache.capacity * bps,
            on_resize=cache.set_capacity_bytes,
        )
        last = {"h": 0, "m": 0}

        def value_fn() -> float:
            s = self.stats
            dh, dm = s.slab_hits - last["h"], s.slab_misses - last["m"]
            last.update(h=s.slab_hits, m=s.slab_misses)
            held = len(cache._slabs) * bps
            pool.note_used(held)
            # A cache running at capacity wants head-room; one with slack
            # only asks for what it holds.
            full = len(cache._slabs) >= cache.capacity
            pool.note_demand(int(cache.capacity * bps * 1.5) if full else held)
            if dh or dm:
                pool.note_hit(dh)
                pool.note_miss(dm)
            miss = dm / (dh + dm) if (dh + dm) else 0.0
            return 8.0 * weight * (1.0 + 4.0 * miss)

        pool.value_fn = value_fn
        return pool

    def _window_shard(self, w: int) -> int:
        """Home shard of window ``w`` (the shard holding its first token)."""
        return (w * (self.seq_len + 1)) // self.corpus.tokens_per_shard

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """Global window order for one epoch: per-shard (hence per-owner)
        permutation, interleaved round-robin across shards.

        Pure function of ``(corpus.seed, epoch)`` and the shard→owner map
        — independent of ``host_id``, so elastic restarts and host-slice
        reassembly stay exact (every host of one job must be built with
        the same ``shard_owner_map``) while every permutation round walks
        the shards in a fixed owner-grouped cycle (consecutive global rows
        hit consecutive shards of consecutive owners; each host's rows hit
        exactly its owned shards when ``global_batch == n_shards``).  With
        the default contiguous ownership the owner-grouped cycle *is*
        shard index order, so the stream is bit-identical to what it was
        before owner maps existed.
        """
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        span = self.seq_len + 1
        total_tokens = self.corpus.n_shards * self.corpus.tokens_per_shard
        n_windows = total_tokens // span
        home = (np.arange(n_windows, dtype=np.int64) * span) // self.corpus.tokens_per_shard
        rng = np.random.default_rng((self.corpus.seed << 16) ^ epoch)
        # Permutations are drawn in shard index order (keeps the rng stream
        # map-independent); only the *cycle* below follows the owner map.
        perms = []
        for s in range(self.corpus.n_shards):
            g = np.flatnonzero(home == s)
            perms.append(g[rng.permutation(len(g))])
        cycle = sorted(
            range(self.corpus.n_shards), key=lambda s: (self.shard_owner(s), s)
        )
        groups = [perms[s] for s in cycle]
        order = np.empty(n_windows, dtype=np.int64)
        pos = 0
        rnd = 0
        while pos < n_windows:
            for g in groups:
                if rnd < len(g):
                    order[pos] = g[rnd]
                    pos += 1
            rnd += 1
        self._order_cache = (epoch, order)
        return order

    # ------------------------------------------------------------- sampling

    def _batch_at(self, epoch: int, step: int) -> tuple[np.ndarray, np.ndarray]:
        """Deterministic batch materialization for this host's slice."""
        span = self.seq_len + 1
        order = self._epoch_order(epoch)
        n_windows = len(order)
        rows = []
        for b in range(self.local_batch):
            gidx = step * self.global_batch + self.host_id * self.local_batch + b
            w = int(order[gidx % n_windows])
            if self.shard_owner(self._window_shard(w)) == self.host_id:
                self.stats.local_windows += 1
            else:
                self.stats.remote_windows += 1
            rows.append(self._read_span(w * span, span))
        arr = np.stack(rows)
        return arr[:, :-1], arr[:, 1:]

    def _read_span(self, start: int, length: int) -> np.ndarray:
        """Read [start, start+length) tokens across shard boundaries.

        Served slab-by-slab from the LRU cache — each miss moves one
        ranged store read of ``slab_tokens`` tokens, never a whole shard.
        """
        tps = self.corpus.tokens_per_shard
        st = self.slab_tokens
        out = np.empty(length, dtype=np.int32)
        filled = 0
        while filled < length:
            shard, off = divmod(start + filled, tps)
            slab_idx, soff = divmod(off, st)
            slab = self._cache.get(shard % self.corpus.n_shards, slab_idx)
            take = min(length - filled, len(slab) - soff)
            out[filled : filled + take] = slab[soff : soff + take]
            filled += take
        return out

    # ------------------------------------------------------------- iterator

    def __iter__(self):
        return self

    def __next__(self) -> tuple[np.ndarray, np.ndarray]:
        if self._worker is None and self.prefetch_depth > 0:
            self._start_worker()
        if self.prefetch_depth > 0:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            return item
        return self._produce()

    def _produce(self) -> tuple[np.ndarray, np.ndarray]:
        st = self._state
        batch = self._batch_at(st.epoch, st.step)
        st.step += 1
        if st.step >= self.steps_per_epoch:
            st.epoch += 1
            st.step = 0
        return batch

    def _start_worker(self) -> None:
        def run() -> None:
            while not self._stop.is_set():
                try:
                    item = self._produce()
                except Exception as exc:  # propagate into consumer
                    self._q.put(exc)
                    return
                self._q.put(item)

        self._worker = threading.Thread(target=run, daemon=True, name="loader-prefetch")
        self._worker.start()

    def close(self) -> None:
        self._stop.set()
        if self._worker is not None:
            while self._worker.is_alive():
                try:
                    self._q.get(timeout=0.05)
                except queue.Empty:
                    pass
                self._worker.join(timeout=0.05)
            self._worker = None

    # ----------------------------------------------------------- resumption

    def state(self) -> PipelineState:
        """Cursor of the *next* batch to be produced.

        Note: with prefetching, batches already queued are counted as
        consumed only once handed to the caller — callers must snapshot
        state at a step boundary (the train loop does so after draining
        the queue via ``sync()``).
        """
        return PipelineState(**dataclasses.asdict(self._state))

    def sync(self) -> PipelineState:
        """Stop prefetch, drop staged batches, return the exact cursor.

        Used right before checkpointing: the returned state resumes from
        the first batch the training loop has *not* received. Staged but
        unconsumed batches are rewound.
        """
        if self._worker is not None:
            self._stop.set()
            rewound = 0
            # Drain until the worker is dead: it may be blocked on a full
            # queue mid-put; every drained item is a produced-but-unconsumed
            # batch that must be rewound.
            while self._worker.is_alive():
                try:
                    item = self._q.get(timeout=0.05)
                    if not isinstance(item, Exception):
                        rewound += 1
                except queue.Empty:
                    pass
                self._worker.join(timeout=0.05)
            try:
                while True:
                    item = self._q.get_nowait()
                    if not isinstance(item, Exception):
                        rewound += 1
            except queue.Empty:
                pass
            self._worker = None
            self._stop = threading.Event()
            for _ in range(rewound):
                self._rewind_one()
        return self.state()

    def _rewind_one(self) -> None:
        st = self._state
        if st.step == 0:
            # Clamp at the stream origin: rewinding past (epoch 0, step 0)
            # would fabricate an epoch −1 that never existed.
            if st.epoch <= 0:
                raise RuntimeError(
                    "pipeline cursor rewound past (epoch 0, step 0) — more "
                    "batches drained than were ever produced"
                )
            st.epoch -= 1
            st.step = self.steps_per_epoch - 1
        else:
            st.step -= 1

    def restore(self, state: PipelineState) -> None:
        self.sync()
        self._state = PipelineState(**dataclasses.asdict(state))


def plan_shard_placement(
    shard_names: list[str],
    n_hosts: int,
    hot_bytes: dict[int, dict[str, int]],
    host_ids: list[int] | None = None,
) -> list[int]:
    """Assign corpus shards to hosts where their bytes are already hot.

    ``hot_bytes`` is the distributed store's gossip view
    (``DistributedStore.cluster_hot_bytes()``: host → {file → resident
    bytes}).  Greedy by descending affinity under a balance cap of
    ``ceil(n_shards / n_hosts)`` shards per host — the cap is what lets
    :class:`ShardedLoader`'s owner-grouped epoch cycle line each host's
    batch rows up with its own shards; shards nobody holds hot fill the
    least-loaded hosts in index order.  Deterministic for a given board.

    Returns ``owners`` with ``owners[i]`` = host *index* (0..n_hosts-1) of
    ``shard_names[i]`` — pass it straight to ``ShardedLoader(...,
    shard_owner_map=owners)``.  ``host_ids`` maps index → gossip host id
    when the two differ (defaults to ``0..n_hosts-1``).
    """
    if n_hosts <= 0:
        raise ValueError("n_hosts must be positive")
    ids = list(range(n_hosts)) if host_ids is None else list(host_ids)
    if len(ids) != n_hosts:
        raise ValueError(f"host_ids has {len(ids)} entries for n_hosts={n_hosts}")
    n_shards = len(shard_names)
    cap = -(-n_shards // n_hosts)  # ceil
    # (hot bytes, shard, host index) — highest affinity first, index-order ties.
    edges = sorted(
        (
            (-int(hot_bytes.get(hid, {}).get(shard_names[s], 0)), s, h)
            for s in range(n_shards)
            for h, hid in enumerate(ids)
        ),
    )
    owners = [-1] * n_shards
    load = [0] * n_hosts
    for neg, s, h in edges:
        if neg == 0:
            break  # no hot bytes — leave for the balance fill below
        if owners[s] == -1 and load[h] < cap:
            owners[s] = h
            load[h] += 1
    for s in range(n_shards):
        if owners[s] == -1:
            h = min(range(n_hosts), key=lambda i: (load[i], i))
            owners[s] = h
            load[h] += 1
    return owners

"""TwoLevelStore — the paper's two-level storage system (Section 3).

Faithful semantics:

* Files are split into fixed-size logical blocks (fast-tier unit,
  Section 3.1); each block persisted to the PFS tier is striped across
  data-node servers (``PFSTier``/``StripeLayout``).
* **Write modes** (Fig. 4 a-c): ``MEMORY_ONLY``, ``PFS_BYPASS``,
  ``WRITE_THROUGH`` (synchronous dual write — the paper's prototype), plus
  the beyond-paper ``ASYNC_WRITEBACK`` (bounded queue + background flush
  worker pool; the paper's prototype is synchronous-only, Section 3.2).
* **Read modes** (Fig. 4 d-f): ``MEMORY_ONLY``, ``PFS_BYPASS``, ``TIERED``
  — the priority 'nearest available copy first' policy: memory tier, then
  PFS, promoting (caching) fetched blocks with LRU/LFU eviction.
* Tuned I/O buffers: 1 MB app↔memory-tier requests, 4 MB memory↔PFS
  transfers (Section 3.2 / 5.1) — ``PFSTier`` streams in 4 MB chunks and
  ``get_buffered`` yields 1 MB app-side chunks.
* Integrity: CRC32 per persisted stripe (PFSTier) + per-block CRC in the
  store's block table, checked on every read.

Concurrency model (DESIGN.md §3) — the data path is parallel end to end:

* ``put``/``get`` fan a file's blocks out over a shared thread pool
  (``io_workers``, default one worker per PFS server), so PFS transfers
  for different blocks overlap and aggregate throughput scales with the
  server count the way the Section 4 model predicts.
* Locking is sharded: a per-file readers-writer lock gives whole-file
  snapshot semantics (no torn multi-block reads across an overwrite), 64
  striped per-block locks serialize data movement of one block, and one
  short-critical-section metadata mutex guards the block/file tables.  No
  lock is ever held across a PFS transfer except the block's own stripe
  lock.  Lock order: file RW lock → block lock → metadata mutex.
* ``ASYNC_WRITEBACK`` flushes through a pool of ``flush_workers`` threads
  draining a bounded queue, coalescing superseded flushes of the same key
  (rapid re-puts flush once, with the latest bytes).
* ``get_buffered`` is a true streaming iterator: per-block ``memoryview``
  chunks with ``readahead_blocks`` of PFS prefetch in flight, never
  materializing the whole file.  ``put_stream`` is its write-side dual.

Ranged and batched I/O (DESIGN.md §6) — the training-plane surface:

* ``get_range(name, offset, size)`` fetches **only the covering blocks**
  of a byte range: a memory-tier hit serves a zero-copy sub-block view, a
  miss reads just the overlapping PFS stripe units (per-stripe CRCs still
  verified).  ``get_buffered`` accepts the same ``offset``/``length``.
  Partial blocks are served without promotion — a range read never drags
  a whole block through the cache it didn't ask for.
* ``put_many``/``get_many`` move *unrelated* files in one call: every
  block of every file fans out over the shared pool together, so many
  small files (checkpoint chunks) enjoy the same pipelining one large
  file gets.  File locks are taken in sorted-name order (no deadlocks
  between concurrent batch calls).

Appendable spill handles (DESIGN.md §9) — the shuffle-engine surface:

* ``open_append(name)`` returns an :class:`AppendHandle` whose
  ``append_chunk`` re-blocks arbitrary-size chunks into ``block_bytes``
  blocks, dispatching each block onto the shared pool the moment it
  fills — earlier blocks are **never** read back or rewritten (no
  read-modify-write), only the in-handle partial tail waits in RAM.
  Re-opening an existing file resumes at its end: at most the old
  partial tail block is fetched once; all earlier blocks stay put.

Adaptive control plane (DESIGN.md §10) — optional, off by default:

* Constructed with an :class:`~repro_torch.core.sched.IOController`, the store
  delegates three hot-path decisions to the online Eq. 1-7 model:
  promote-on-read admission (ghost-list scan resistance per stream
  class), per-stream readahead depth in ``get_buffered``, and write-back
  flush-lane concurrency.  Clients declare access patterns with
  ``hint_stream(prefix, StreamClass)``.  Without a controller every
  decision is the static knob — bit-for-bit the pre-controller store.
"""

from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

from repro_torch.core import codec as blockcodec
from repro_torch.core.codec import CodecSpec
from repro_torch.core.layout import BlockLayout
from repro_torch.core.sched import IOController, StreamClass
from repro_torch.core.scrub import Scrubber
from repro_torch.core.tiers import (
    BlockNotFound,
    CapacityExceeded,
    IntegrityError,
    MemoryTier,
    PFSTier,
    crc32_chunked,
)


class WriteMode(enum.Enum):
    MEMORY_ONLY = "memory_only"  # Fig. 4 (a)
    PFS_BYPASS = "pfs_bypass"  # Fig. 4 (b)
    WRITE_THROUGH = "write_through"  # Fig. 4 (c) — paper's prototype default
    ASYNC_WRITEBACK = "async_writeback"  # beyond-paper


class ReadMode(enum.Enum):
    MEMORY_ONLY = "memory_only"  # Fig. 4 (d)
    PFS_BYPASS = "pfs_bypass"  # Fig. 4 (e)
    TIERED = "tiered"  # Fig. 4 (f) — primary data-intensive pattern


class EvictionPolicy(enum.Enum):
    LRU = "lru"
    LFU = "lfu"


@dataclasses.dataclass
class StoreStats:
    mem_hits: int = 0
    mem_misses: int = 0
    promotions: int = 0
    evictions: int = 0
    async_flushes: int = 0
    flushes_coalesced: int = 0
    flush_retries: int = 0  # failed write-back flushes requeued for retry
    integrity_failures: int = 0
    range_reads: int = 0
    range_bytes: int = 0

    def hit_rate(self) -> float:
        total = self.mem_hits + self.mem_misses
        return self.mem_hits / total if total else 0.0


@dataclasses.dataclass
class _BlockMeta:
    key: str  # "<file>:<index>"
    length: int
    crc: int
    dirty: bool = False  # pending async write-back
    freq: int = 0  # LFU counter
    flush_attempts: int = 0  # consecutive failed write-back flushes
    # Memory-tier CRC is verified once per residency: the first hit checks
    # the resident bytes against the block CRC, later hits are zero-copy
    # with no checksum pass (the tier stores immutable bytes objects — a
    # re-put or re-promotion installs a fresh meta, resetting this).
    verified: bool = False
    # True when the current residency came from a *read* promotion (tiered
    # miss) rather than a write.  Eviction feedback uses it: for a
    # read-once-class block only read-proven residency earns a ghost-list
    # entry — a written-then-evicted spill block's first read is expected,
    # not proof of reuse.
    promoted: bool = False
    # Compressed-at-rest state (DESIGN.md §13).  ``crc`` above is always
    # the *logical* CRC (what the memory tier holds and every caller
    # reads).  When the PFS copy is a TLC1 container: ``enc`` is the
    # codec id, ``plen``/``pcrc`` the container's physical length and
    # transfer-folded CRC, ``findex`` the parsed frame index ranged
    # reads decode covering frames with.  ``enc is None`` = stored raw.
    enc: int | None = None
    plen: int = 0
    pcrc: int = 0
    findex: blockcodec.FrameIndex | None = None


@dataclasses.dataclass
class _FileMeta:
    size: int
    n_blocks: int


class FlushError(Exception):
    """Raised from drain() if a background flush failed."""


class _RWLock:
    """Writer-preferring readers-writer lock (per logical file).

    Readers of one file run concurrently; a writer (put / put_stream /
    delete) is exclusive, so a multi-block read can never observe a mix of
    old and new blocks across an overwrite.
    """

    __slots__ = ("_cond", "_readers", "_writer", "_writers_waiting")

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> None:
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if not self._readers:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class AppendHandle:
    """Appendable write handle: re-blocks chunk appends, no read-modify-write.

    Obtained from :meth:`TwoLevelStore.open_append`.  Chunks accumulate in
    an in-handle tail buffer; every time the buffer crosses ``block_bytes``
    a full block enters the store's write path (pool-fanned, per the write
    mode's contract) and is *done* — closing the handle writes only the
    final partial tail and registers the file's metadata.  Earlier blocks
    are never touched again, which is what makes this the right primitive
    for streaming spill runs and merge output: O(block) memory per open
    handle regardless of how much has been appended.

    Opening an existing file resumes appending at its end.  Only the old
    partial tail block (if any) is read — once — into the buffer so it can
    be completed and rewritten in place when it fills; full blocks of the
    existing file are never re-read.

    The file's write lock is held for the handle's lifetime (readers of
    this file block until ``close``); a handle is single-threaded, but
    different handles on different files append fully in parallel.  Use as
    a context manager to guarantee release.
    """

    def __init__(self, store: "TwoLevelStore", name: str, mode: WriteMode) -> None:
        self._store = store
        self.name = name
        self.mode = mode
        self._futures: list = []
        self._buf = bytearray()
        self._closed = False
        self._flock = store._acquire_file(name, write=True)
        try:
            try:
                # Known or cold file: metadata from the table, or registered
                # from the stripe manifests without data movement (the write
                # lock held here is stronger than the read lock the helper
                # documents).
                old = store._file_meta_or_cold(name)
            except BlockNotFound:
                old = None  # brand-new file
            bb = store.layout.block_size
            if old is None or old.n_blocks == 0:
                self._idx = 0
                self._total = 0
            else:
                tail_len = old.size - (old.n_blocks - 1) * bb
                if 0 < tail_len < bb:
                    # Resume mid-block: fetch just the partial tail once.
                    self._buf += store._read_block(name, old.n_blocks - 1, ReadMode.TIERED)
                    self._idx = old.n_blocks - 1
                    self._total = old.size - tail_len
                else:
                    self._idx = old.n_blocks
                    self._total = old.size
        except BaseException:
            self._flock.release_write()
            raise

    @property
    def size(self) -> int:
        """Bytes in the file so far (committed blocks + buffered tail)."""
        return self._total + len(self._buf)

    def append_chunk(self, chunk) -> int:
        """Append one bytes-like chunk; returns the file size so far.

        Full blocks are dispatched immediately (concurrent, per the write
        mode); at most ``block_bytes`` of tail stays buffered in the handle.
        """
        if self._closed:
            raise RuntimeError(f"append handle for {self.name!r} is closed")
        store = self._store
        self._buf += memoryview(chunk)
        bb = store.layout.block_size
        while len(self._buf) >= bb:
            store._put_block(
                store._bkey(self.name, self._idx), bytes(self._buf[:bb]), self.mode, self._futures
            )
            del self._buf[:bb]
            self._idx += 1
            self._total += bb
            # Reap settled transfers so a long append doesn't hoard futures
            # (they complete roughly in dispatch order).
            while len(self._futures) > 2 * store.io_workers and self._futures[0].done():
                self._futures.pop(0).result()
        return self.size

    def close(self) -> int:
        """Flush the tail, publish file metadata, release the file lock.

        Returns the final file size.  Idempotent.
        """
        if self._closed:
            return self._total
        store = self._store
        try:
            if self._buf:
                store._put_block(
                    store._bkey(self.name, self._idx), bytes(self._buf), self.mode, self._futures
                )
                self._total += len(self._buf)
                self._idx += 1
                self._buf.clear()
            with store._meta:
                old = store._files.get(self.name)
                store._files[self.name] = _FileMeta(size=self._total, n_blocks=self._idx)
            store._trim_tail(self.name, self._idx, old.n_blocks if old else 0)
            for f in self._futures:
                f.result()
            return self._total
        finally:
            self._closed = True
            store._settle(self._futures)
            self._futures.clear()
            self._flock.release_write()

    def __enter__(self) -> "AppendHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TwoLevelStore:
    """The integrated two-level storage system."""

    _N_BLOCK_LOCKS = 64
    #: bounded write-back retry: a dirty block whose flush fails transiently
    #: is requeued up to this many times before the error surfaces in drain()
    FLUSH_MAX_ATTEMPTS = 4

    def __init__(
        self,
        pfs_root: str,
        mem_capacity_bytes: int = 1 << 30,
        block_bytes: int = 4 * 2**20,
        n_pfs_servers: int = 2,
        stripe_bytes: int = 1 * 2**20,
        write_mode: WriteMode = WriteMode.WRITE_THROUGH,
        read_mode: ReadMode = ReadMode.TIERED,
        eviction: EvictionPolicy = EvictionPolicy.LRU,
        cache_on_read: bool = True,
        app_buffer_bytes: int = 1 * 2**20,  # paper: 1 MB app<->Tachyon
        pfs_buffer_bytes: int = 4 * 2**20,  # paper: 4 MB Tachyon<->OrangeFS
        async_queue_depth: int = 64,
        fsync: bool = False,
        io_workers: int | None = None,
        flush_workers: int = 2,
        readahead_blocks: int = 2,
        controller: IOController | None = None,
        codec: CodecSpec | None = None,
        chaos=None,  # runtime.failure.ChaosInjector | None (threaded to the PFS tier)
        replication: int = 1,
        scrub_interval_s: float | None = None,
    ) -> None:
        self.layout = BlockLayout(block_bytes)
        self.mem = MemoryTier(mem_capacity_bytes)
        # One in-flight request per PFS server by default — the paper's
        # aggregate-throughput model (Section 4) saturates M servers with M
        # concurrent streams; more buys nothing, fewer leaves servers idle.
        self.io_workers = max(1, n_pfs_servers if io_workers is None else io_workers)
        self.pfs = PFSTier(
            pfs_root,
            n_servers=n_pfs_servers,
            stripe_bytes=stripe_bytes,
            io_buffer_bytes=pfs_buffer_bytes,
            fsync=fsync,
            io_workers=self.io_workers,
            chaos=chaos,
            replication=replication,
        )
        self.write_mode = write_mode
        self.read_mode = read_mode
        # Transparent block compression (DESIGN.md §13): with a codec spec
        # every block entering the PFS tier is offered to the encoder
        # (class policy via the controller, ratio probe inside encode);
        # without one the store is bit-for-bit the uncompressed system.
        self.codec = codec
        self.eviction = eviction
        self.cache_on_read = cache_on_read
        self.app_buffer_bytes = app_buffer_bytes
        self.readahead_blocks = max(0, readahead_blocks)
        self.stats = StoreStats()

        # Sharded locking (see module docstring for the lock order).
        self._meta = threading.Lock()
        self._block_locks = [threading.RLock() for _ in range(self._N_BLOCK_LOCKS)]
        self._file_locks: dict[str, _RWLock] = {}

        self._files: dict[str, _FileMeta] = {}
        self._blocks: dict[str, _BlockMeta] = {}
        # Cold-block codec cache: bkey -> FrameIndex (compressed) or None
        # (raw).  Ranged reads of blocks with no table entry would otherwise
        # pay a manifest describe + container-head fetch per call; entries
        # are dropped whenever the block is rewritten or deleted.  Plain
        # dict ops only (GIL-atomic), same convention as ``_blocks`` reads.
        self._cold_index: dict[str, blockcodec.FrameIndex | None] = {}
        self._dirty: set[str] = set()
        # Memory-resident keys in LRU order → O(1) LRU victim selection.
        self._resident: OrderedDict[str, None] = OrderedDict()
        # Lazy (freq, seq, key) heap → O(log n) LFU victim selection; stale
        # entries (freq bumped or block evicted since push) are skipped on pop.
        self._lfu_heap: list[tuple[int, int, str]] = []
        self._lfu_seq = itertools.count()

        self._pool = ThreadPoolExecutor(
            max_workers=self.io_workers, thread_name_prefix="tls-io"
        )
        self.flush_workers = max(1, flush_workers)
        self._flush_q: queue.Queue[str | None] = queue.Queue(maxsize=async_queue_depth)
        self._flush_errors: list[Exception] = []
        self._flushers = [
            threading.Thread(target=self._flush_loop, daemon=True, name=f"tls-flusher-{i}")
            for i in range(self.flush_workers)
        ]
        for t in self._flushers:
            t.start()
        self._closed = False

        # Adaptive control plane (DESIGN.md §10) — strictly optional: with
        # no controller every decision below falls back to the static knob.
        self.controller = controller
        self._stream_hints: dict[str, StreamClass] = {}
        self._hint_items: tuple[tuple[str, StreamClass], ...] = ()
        if controller is not None:
            try:
                controller.bind(self)
            except BaseException:
                # Failed bind (e.g. controller already owned by another
                # store): tear down the threads this half-built store
                # started before re-raising.
                self._closed = True
                for _ in self._flushers:
                    self._flush_q.put(None)
                self._pool.shutdown(wait=False)
                self.pfs.close()
                raise

        # Self-healing cold tier (DESIGN.md §15): with a scrub interval the
        # store runs a background Scrubber over its PFS tier.  The scrubber
        # installs itself as the tier's ``on_degraded`` hook, so a read that
        # failed over past a bad replica queues an out-of-band repair; full
        # passes re-verify and re-replicate everything else on the interval.
        self.scrubber: Scrubber | None = None
        if scrub_interval_s is not None:
            self.scrubber = Scrubber(
                self.pfs, controller=controller, interval_s=scrub_interval_s
            )
            self.scrubber.start()

    def hint_stream(self, prefix: str, cls: StreamClass | None) -> None:
        """Declare the access pattern of every file under ``prefix``.

        Lightweight client intent for the adaptive controller (admission /
        readahead / flush scheduling differentiate stream classes instead
        of guessing).  Safe to call on any store: without a controller the
        hint is recorded and ignored.  ``None`` clears the hint.
        """
        with self._meta:
            if cls is None:
                self._stream_hints.pop(prefix, None)
            else:
                self._stream_hints[prefix] = cls
            # Immutable snapshot: the controller classifies against this
            # tuple lock-free on hot paths.
            self._hint_items = tuple(self._stream_hints.items())

    # ------------------------------------------------------------------ util

    @staticmethod
    def _bkey(name: str, idx: int) -> str:
        return f"{name}:{idx:06d}"

    @staticmethod
    def _settle(futures: list) -> None:
        """Wait out in-flight block transfers before lock release.

        Used on error paths: a file lock must never be released while its
        blocks are still moving, and a failed transfer must not rot in an
        unobserved future.  Secondary errors are swallowed — the primary
        exception is already propagating.
        """
        for f in futures:
            try:
                f.result()
            except Exception:
                pass

    def _block_lock(self, bkey: str) -> threading.RLock:
        return self._block_locks[hash(bkey) % self._N_BLOCK_LOCKS]

    def _file_lock(self, name: str) -> _RWLock:
        with self._meta:
            lock = self._file_locks.get(name)
            if lock is None:
                lock = self._file_locks[name] = _RWLock()
            return lock

    def _acquire_file(self, name: str, write: bool) -> _RWLock:
        """Acquire the per-file lock, surviving pruning by delete().

        delete() drops the registry entry for a file's lock; anyone who was
        blocked on the old object re-checks identity after acquiring and
        retries on the replacement, so two writers can never hold different
        lock objects for the same name.
        """
        while True:
            lock = self._file_lock(name)
            lock.acquire_write() if write else lock.acquire_read()
            with self._meta:
                if self._file_locks.get(name) is lock:
                    return lock
            lock.release_write() if write else lock.release_read()

    def _touch_locked(self, meta: _BlockMeta) -> None:
        """Record a hit on a resident block (caller holds the meta mutex)."""
        meta.freq += 1
        if meta.key in self._resident:
            self._resident.move_to_end(meta.key)
        if self.eviction is EvictionPolicy.LFU:
            heapq.heappush(self._lfu_heap, (meta.freq, next(self._lfu_seq), meta.key))
            # Lazy invalidation leaves one stale entry per touch; compact
            # when stale entries dominate so a hit-heavy workload with no
            # evictions can't grow the heap without bound.
            if len(self._lfu_heap) > 64 + 4 * len(self._resident):
                self._lfu_heap = [
                    (m.freq, next(self._lfu_seq), k)
                    for k in self._resident
                    if (m := self._blocks.get(k)) is not None
                ]
                heapq.heapify(self._lfu_heap)

    # --------------------------------------------------------------- eviction

    def _pop_victim(self) -> str | None:
        """Reserve and return the next eviction victim — O(1) LRU, O(log n) LFU."""
        with self._meta:
            if self.eviction is EvictionPolicy.LRU:
                while self._resident:
                    k = next(iter(self._resident))
                    del self._resident[k]
                    if self.mem.contains(k):
                        return k
                return None
            while self._lfu_heap:
                freq, _, k = heapq.heappop(self._lfu_heap)
                meta = self._blocks.get(k)
                if k not in self._resident or meta is None or meta.freq != freq:
                    continue  # stale heap entry — a fresher one exists
                del self._resident[k]
                if self.mem.contains(k):
                    return k
            return None

    def _evict(self, victim: str) -> None:
        """Evict one reserved victim, flushing it first if dirty.

        Durability is never sacrificed to make room: a dirty block is
        claimed and written down synchronously before its memory copy goes.
        """
        with self._block_lock(victim):
            with self._meta:
                meta = self._blocks.get(victim)
                claimed = victim in self._dirty
                self._dirty.discard(victim)
            if claimed and meta is not None and meta.dirty:
                self._flush_now(victim, meta)
            self.mem.delete(victim)
        with self._meta:
            popped = self._blocks.pop(victim, None)
            self.stats.evictions += 1
        if self.controller is not None:
            # Ghost-list feedback: a re-read of an evicted key soon after
            # proves reuse and re-promotes on sight.
            self.controller.note_eviction(
                victim, read_promoted=popped.promoted if popped else False
            )

    def _quarantine_block(self, bkey: str) -> None:
        """Drop a resident block whose bytes failed the CRC check against
        the block table (a torn overwrite): unlike :meth:`_evict`, the copy
        is *never* flushed down — it would overwrite the durable version
        with bad bytes — just forgotten, so readers fall through to PFS."""
        with self._block_lock(bkey):
            with self._meta:
                self._dirty.discard(bkey)
                self._resident.pop(bkey, None)
                self.stats.integrity_failures += 1
            self.mem.delete(bkey)

    def _cache_block(self, meta: _BlockMeta, chunk) -> None:
        """Insert a block into the memory tier, evicting until it fits."""
        while True:
            try:
                with self._block_lock(meta.key):
                    self.mem.put(meta.key, chunk)
                break
            except CapacityExceeded:
                victim = self._pop_victim()
                if victim is None:
                    raise
                self._evict(victim)
        with self._meta:
            self._resident[meta.key] = None
            self._resident.move_to_end(meta.key)
            if self.eviction is EvictionPolicy.LFU:
                heapq.heappush(self._lfu_heap, (meta.freq, next(self._lfu_seq), meta.key))

    # ------------------------------------------------------------ write path

    def put(self, name: str, data, mode: WriteMode | None = None) -> None:
        """Write a whole logical file through the configured write mode.

        Blocks are dispatched to the PFS tier concurrently (``io_workers``
        in flight); the call returns once every block is durable per the
        mode's contract.
        """
        mode = mode or self.write_mode
        if self._closed:
            raise RuntimeError("store is closed")
        flock = self._acquire_file(name, write=True)
        futures: list = []
        try:
            self._put_file_locked(name, memoryview(data), mode, futures)
            for f in futures:
                f.result()
        finally:
            self._settle(futures)
            flock.release_write()

    def _put_file_locked(self, name: str, mv: memoryview, mode: WriteMode, futures: list) -> None:
        """Dispatch one whole file's blocks (caller holds the file write lock
        and awaits ``futures``)."""
        n_new = self.layout.n_blocks(len(mv))
        self._prepare_overwrite(name, n_new, mode)
        with self._meta:
            self._files[name] = _FileMeta(size=len(mv), n_blocks=n_new)
        for block in self.layout.blocks(len(mv)):
            self._put_block(
                self._bkey(name, block.index), mv[block.offset : block.end], mode, futures
            )

    def _prepare_overwrite(self, name: str, n_new: int, mode: WriteMode) -> None:
        """Make room for an overwrite (caller holds the file write lock).

        Blocks ``[0, n_new)`` are overwritten *in place* — no delete+rewrite
        round trip, and a still-dirty block being re-put coalesces with its
        queued flush.  Only the stale tail beyond ``n_new`` is removed (the
        probe also clears leftover PFS blocks of a cold file, so a restart
        can never resurrect a longer stale version).  ``MEMORY_ONLY`` is the
        exception: it must not leave durable copies of the old version, so
        it deletes the file outright first.
        """
        if mode is WriteMode.MEMORY_ONLY:
            with self._meta:
                existed = name in self._files
            if existed or self.pfs.contains(self._bkey(name, 0)):
                self._delete_impl(name)
            return
        with self._meta:
            old = self._files.get(name)
        self._trim_tail(name, n_new, old.n_blocks if old else 0)

    def put_stream(self, name: str, chunks: Iterable, mode: WriteMode | None = None) -> int:
        """Write a file from an iterable of byte chunks without materializing it.

        Chunks are re-blocked to ``block_bytes`` and each block enters the
        write path as soon as it fills, overlapping upstream chunk
        production with PFS transfers.  Returns the total bytes written.
        """
        mode = mode or self.write_mode
        if self._closed:
            raise RuntimeError("store is closed")
        flock = self._acquire_file(name, write=True)
        futures: list = []
        try:
            if mode is WriteMode.MEMORY_ONLY:
                self._prepare_overwrite(name, 0, mode)
            buf = bytearray()
            idx = total = 0
            bb = self.layout.block_size
            for chunk in chunks:
                total += len(chunk)
                buf += chunk
                while len(buf) >= bb:
                    self._put_block(self._bkey(name, idx), bytes(buf[:bb]), mode, futures)
                    del buf[:bb]
                    idx += 1
            if buf:
                self._put_block(self._bkey(name, idx), bytes(buf), mode, futures)
                idx += 1
            with self._meta:
                old = self._files.get(name)
                self._files[name] = _FileMeta(size=total, n_blocks=idx)
            self._trim_tail(name, idx, old.n_blocks if old else 0)
            for f in futures:
                f.result()
            return total
        finally:
            self._settle(futures)
            flock.release_write()

    def open_append(self, name: str, mode: WriteMode | None = None) -> AppendHandle:
        """Open an appendable handle on ``name`` (created if absent).

        See :class:`AppendHandle`: chunk appends are re-blocked to
        ``block_bytes`` without read-modify-write of earlier blocks — the
        primitive spill runs and streaming merge output are built on.
        """
        mode = mode or self.write_mode
        if self._closed:
            raise RuntimeError("store is closed")
        return AppendHandle(self, name, mode)

    def put_many(self, items, mode: WriteMode | None = None) -> None:
        """Write many unrelated files in one batched, pool-fanned call.

        ``items`` is a mapping or an iterable of ``(name, bytes-like)``
        pairs.  Blocks of *every* file are dispatched onto the shared pool
        before any result is awaited, so a batch of small files (checkpoint
        chunks) pipelines PFS transfers exactly like one large file does.
        File write locks are acquired in sorted-name order — two concurrent
        batch calls can never deadlock — and released only after every
        block of the batch is durable per the mode's contract.
        """
        mode = mode or self.write_mode
        if self._closed:
            raise RuntimeError("store is closed")
        entries = sorted(items.items() if isinstance(items, dict) else items)
        names = [name for name, _ in entries]
        if len(set(names)) != len(names):
            raise ValueError("put_many: duplicate names in one batch")
        held: list[_RWLock] = []
        futures: list = []
        try:
            for name, data in entries:
                held.append(self._acquire_file(name, write=True))
                self._put_file_locked(name, memoryview(data), mode, futures)
            for f in futures:
                f.result()
        finally:
            self._settle(futures)
            for lock in held:
                lock.release_write()

    def _put_block(self, bkey: str, chunk, mode: WriteMode, futures: list) -> None:
        """Route one block through the write mode (caller holds file write lock).

        For PFS-writing modes the block CRC is produced *by* the transfer —
        the stripe writers fold CRC32 over the chunks they move and the
        combined object CRC comes back with the pooled future — so the
        caller thread never runs a separate checksum pass.
        """
        if mode is WriteMode.PFS_BYPASS:
            # Bypass writes must also invalidate any resident copy of the
            # block being overwritten in place, or later tiered reads would
            # serve stale memory bytes against the new CRC.
            with self._block_lock(bkey):
                self.mem.delete(bkey)
            meta = _BlockMeta(key=bkey, length=len(chunk), crc=0)
            with self._meta:
                self._blocks[bkey] = meta
                self._dirty.discard(bkey)
                self._resident.pop(bkey, None)
            futures.append(self._pool.submit(self._pfs_put, bkey, chunk, meta))
        elif mode is WriteMode.MEMORY_ONLY:
            meta = _BlockMeta(key=bkey, length=len(chunk), crc=crc32_chunked(chunk))
            self._cache_block(meta, chunk)
            with self._meta:
                self._blocks[bkey] = meta
        elif mode is WriteMode.WRITE_THROUGH:
            # Paper mode (c): dual write — memory insert now, PFS in flight.
            # The controller may veto the memory insert (write-burst /
            # read-once streams under capacity contention write straight
            # to the PFS tier instead of evicting the re-read working set).
            meta = _BlockMeta(key=bkey, length=len(chunk), crc=0)
            cache = self.controller is None or self.controller.cache_on_write(
                bkey.rsplit(":", 1)[0]
            )
            if cache:
                try:
                    self._cache_block(meta, chunk)
                except CapacityExceeded:
                    # Oversubscribed memory tier (all victims claimed by
                    # concurrent evictions, or block larger than capacity):
                    # the PFS copy below is the durable one — serve this
                    # block cold rather than failing the write.
                    with self._block_lock(bkey):
                        self.mem.delete(bkey)
            else:
                # In-place overwrite of a previously resident version must
                # still invalidate the stale memory copy.
                with self._block_lock(bkey):
                    self.mem.delete(bkey)
            with self._meta:
                self._blocks[bkey] = meta
                if not cache:
                    self._resident.pop(bkey, None)
            futures.append(self._pool.submit(self._pfs_put, bkey, chunk, meta))
        elif mode is WriteMode.ASYNC_WRITEBACK:
            meta = _BlockMeta(key=bkey, length=len(chunk), crc=crc32_chunked(chunk))
            if self.controller is not None and not self.controller.cache_on_write(
                bkey.rsplit(":", 1)[0]
            ):
                # Contended tier + a class nobody re-reads: skip the memory
                # copy entirely and degrade to a pooled write-through (the
                # same durable path the CapacityExceeded fallback takes).
                with self._block_lock(bkey):
                    self.mem.delete(bkey)
                with self._meta:
                    self._blocks[bkey] = meta
                    self._dirty.discard(bkey)
                    self._resident.pop(bkey, None)
                futures.append(self._pool.submit(self._pfs_put, bkey, chunk, meta))
                return
            meta.dirty = True
            try:
                self._cache_block(meta, chunk)
            except CapacityExceeded:
                # No memory copy to flush from later — degrade this block
                # to a pooled write-through (durability preserved; the
                # write-back optimization is best-effort by design).
                meta.dirty = False
                with self._block_lock(bkey):
                    self.mem.delete(bkey)
                with self._meta:
                    self._blocks[bkey] = meta
                    self._dirty.discard(bkey)
                futures.append(self._pool.submit(self._pfs_put, bkey, chunk, meta))
                return
            with self._meta:
                self._blocks[bkey] = meta
                if bkey in self._dirty:
                    # Coalesce: a flush for this key is already queued; it
                    # will pick up the latest bytes from the memory tier.
                    self.stats.flushes_coalesced += 1
                    enqueue = False
                else:
                    self._dirty.add(bkey)
                    enqueue = True
            if enqueue:
                self._flush_q.put(bkey)  # blocks when queue is full (bounded)

    # ----------------------------------------------------------------- codec

    @staticmethod
    def _codec_tag(index: blockcodec.FrameIndex) -> str:
        """Manifest annotation for a compressed PFS object: logical length
        + frame size, so any store instance (codec-configured or not) can
        size and decode a cold container without reading data bytes."""
        return f"tlc1:{index.logical_len}:{index.frame_bytes}"

    @staticmethod
    def _parse_codec_tag(tag: str | None) -> tuple[int, int] | None:
        """``(logical_len, frame_bytes)`` from a manifest codec tag, or
        ``None`` for an untagged (raw) object."""
        if not tag or not tag.startswith("tlc1:"):
            return None
        parts = tag.split(":")
        try:
            logical = int(parts[1])
            fb = int(parts[2]) if len(parts) > 2 else 256 * 1024
        except (ValueError, IndexError):
            return None
        return logical, fb

    def _encode_block(self, bkey: str, chunk) -> blockcodec.Encoded | None:
        """Offer one block to the codec for its PFS write.

        ``None`` means write raw: no codec configured, the class policy
        declined (LATENCY, or a DEFAULT stream the model says loses), or
        the ratio probe judged the bytes incompressible.
        """
        spec = self.codec
        if spec is None or len(chunk) == 0:
            return None
        if self.controller is not None and not self.controller.compress_for_write(
            bkey.rsplit(":", 1)[0]
        ):
            return None
        t0 = time.perf_counter()
        enc = blockcodec.encode(chunk, spec)
        dt = time.perf_counter() - t0
        if enc is None:
            return None
        with self.pfs._stats_lock:
            self.pfs.stats.record_compress(len(chunk), len(enc.payload), dt)
        if self.controller is not None:
            self.controller.note_codec("encode", len(chunk), len(enc.payload), dt)
        return enc

    def _decode_block(self, bkey: str, payload, frame_bytes: int):
        """Decode one whole TLC1 container (timed + telemetry).

        Returns ``(logical bytes, logical CRC, FrameIndex)``; any framing
        inconsistency or codec error raises ``IntegrityError``.
        """
        t0 = time.perf_counter()
        index = blockcodec.parse_index(payload, frame_bytes)
        raw = blockcodec.decode_frames(payload, index, 0, len(index.frame_lens), whole=True)
        if len(raw) != index.logical_len:
            raise IntegrityError(
                f"container for {bkey} decoded to {len(raw)} bytes, "
                f"header says {index.logical_len}"
            )
        lcrc = crc32_chunked(raw)
        dt = time.perf_counter() - t0
        with self.pfs._stats_lock:
            self.pfs.stats.record_decode(len(raw), len(memoryview(payload)), dt)
        if self.controller is not None:
            self.controller.note_codec("decode", len(raw), len(memoryview(payload)), dt)
        return raw, lcrc, index

    def _pfs_put(self, bkey: str, chunk, meta: _BlockMeta | None = None) -> None:
        enc = self._encode_block(bkey, chunk)
        with self._block_lock(bkey):
            self._cold_index.pop(bkey, None)
            if enc is None:
                crc = self.pfs.put(bkey, chunk)
                lcrc, encid, plen, pcrc, findex = crc, None, 0, 0, None
            else:
                pcrc = self.pfs.put(bkey, enc.payload, tag=self._codec_tag(enc.index))
                lcrc, encid, plen, findex = (
                    enc.logical_crc, enc.index.codec, len(enc.payload), enc.index
                )
        if meta is not None:
            with self._meta:
                meta.crc = lcrc
                meta.enc = encid
                meta.plen = plen
                meta.pcrc = pcrc
                meta.findex = findex

    # -------------------------------------------------------- async flushing

    def _flush_loop(self) -> None:
        while True:
            bkey = self._flush_q.get()
            if bkey is None:
                self._flush_q.task_done()
                return
            try:
                if self.controller is not None:
                    # Adaptive write-back concurrency: all lanes drain the
                    # queue, but at most ``flush_gate.limit`` run a PFS
                    # flush at once (the controller resizes it each tick).
                    with self.controller.flush_gate:
                        self._claim_and_flush(bkey)
                else:
                    self._claim_and_flush(bkey)
            except Exception as exc:  # pragma: no cover - defensive
                with self._meta:
                    self._flush_errors.append(exc)
            finally:
                self._flush_q.task_done()

    def _claim_and_flush(self, bkey: str) -> None:
        """Flush ``bkey`` if it is still dirty (superseded claims are no-ops).

        Claim and flush happen under the block lock as one atomic unit:
        an evictor holding the lock either sees the key still dirty (and
        flushes it itself before deleting) or sees our finished flush —
        there is no window where a claimed-but-unflushed block can have its
        memory copy evicted.
        """
        with self._block_lock(bkey):
            with self._meta:
                claimed = bkey in self._dirty
                self._dirty.discard(bkey)
                meta = self._blocks.get(bkey)
            if claimed and meta is not None and meta.dirty:
                try:
                    self._flush_now(bkey, meta)
                except Exception:
                    # Transient PFS failure (torn stripe write, brief server
                    # outage): the block is still hot + dirty — re-mark and
                    # requeue a bounded number of times before surfacing the
                    # error through drain().  A full queue just leaves the
                    # key in _dirty, where drain() flushes it inline.
                    with self._meta:
                        meta.flush_attempts += 1
                        retry = meta.flush_attempts < self.FLUSH_MAX_ATTEMPTS
                        if retry:
                            self._dirty.add(bkey)
                            self.stats.flush_retries += 1
                    if not retry:
                        raise
                    try:
                        self._flush_q.put_nowait(bkey)
                    except queue.Full:
                        pass
                    return
                with self._meta:
                    meta.flush_attempts = 0
                if (
                    self.controller is not None
                    and not meta.dirty  # flush actually landed
                    and self.controller.drop_after_flush(bkey)
                ):
                    # Flush-and-drop: a spill/burst block's clean memory
                    # copy has ~zero re-read value under contention — free
                    # the space before the evictor has to.  The meta stays
                    # (it describes the PFS copy), so the once-per-residency
                    # CRC flag must reset: a future re-promotion is a new
                    # residency whose first hit must verify again.
                    meta.verified = False
                    self.mem.delete(bkey)
                    with self._meta:
                        self._resident.pop(bkey, None)

    def _flush_now(self, bkey: str, meta: _BlockMeta) -> None:
        """Write one dirty block down to the PFS tier (caller holds block lock)."""
        try:
            view = self.mem.get_view(bkey)
        except BlockNotFound:
            return  # block deleted/superseded since the claim
        enc = self._encode_block(bkey, view)
        self._cold_index.pop(bkey, None)
        if enc is None:
            self.pfs.put(bkey, view)
            encid, plen, pcrc, findex = None, 0, 0, None
        else:
            pcrc = self.pfs.put(bkey, enc.payload, tag=self._codec_tag(enc.index))
            encid, plen, findex = enc.index.codec, len(enc.payload), enc.index
        with self._meta:
            meta.dirty = False
            meta.enc = encid
            meta.plen = plen
            meta.pcrc = pcrc
            meta.findex = findex
            self.stats.async_flushes += 1

    def drain(self) -> None:
        """Durability barrier: block until every dirty block is on the PFS tier."""
        self._flush_q.join()
        with self._meta:
            pending = list(self._dirty)
        for bkey in pending:
            self._claim_and_flush(bkey)
        with self._meta:
            errs, self._flush_errors = self._flush_errors, []
        if errs:
            raise FlushError(f"{len(errs)} background flushes failed: {errs[0]!r}") from errs[0]

    # ------------------------------------------------------------- read path

    def get(self, name: str, mode: ReadMode | None = None) -> bytes:
        """Read a whole logical file through the configured read mode.

        Blocks are fetched concurrently — memory-tier hits are zero-copy
        views, misses stream from the PFS tier in parallel stripes.
        """
        mode = mode or self.read_mode
        flock = self._acquire_file(name, write=False)
        try:
            with self._meta:
                fmeta = self._files.get(name)
            if fmeta is None:
                # File may exist only on the PFS tier (restart after losing RAM).
                return self._get_cold(name, mode)
            if fmeta.n_blocks <= 1:
                return bytes(self._read_block(name, 0, mode)) if fmeta.n_blocks else b""
            futures = [
                self._pool.submit(self._read_block, name, i, mode)
                for i in range(fmeta.n_blocks)
            ]
            return b"".join(f.result() for f in futures)
        finally:
            flock.release_read()

    def get_many(self, names: list[str], mode: ReadMode | None = None) -> list[bytes]:
        """Read many unrelated files in one batched, pool-fanned call.

        All blocks of all files are submitted to the shared pool before any
        result is awaited (read locks taken in sorted-name order), so a
        batch of small files pipelines PFS fetches like one large file.
        Returns the file contents in the order ``names`` was given.
        """
        mode = mode or self.read_mode
        order = sorted(set(names))
        held: dict[str, _RWLock] = {}
        jobs: dict[str, list] = {}
        try:
            for name in order:
                held[name] = self._acquire_file(name, write=False)
            for name in order:
                fmeta = self._file_meta_or_cold(name)
                jobs[name] = [
                    self._pool.submit(self._read_block, name, i, mode)
                    for i in range(fmeta.n_blocks)
                ]
            done = {name: b"".join(bytes(f.result()) for f in fs) for name, fs in jobs.items()}
            return [done[name] for name in names]
        finally:
            self._settle([f for fs in jobs.values() for f in fs])
            for lock in held.values():
                lock.release_read()

    def get_range(self, name: str, offset: int, size: int, mode: ReadMode | None = None) -> bytes:
        """Read ``[offset, offset+size)`` of a file, touching only covering blocks.

        A memory-tier hit serves a zero-copy sub-block view; a miss reads
        only the overlapping PFS stripe units (each staged unit's CRC is
        still verified).  The range is clamped to the file size.  On a
        static store, partial blocks are *not* promoted into the memory
        tier — promotion happens only when the range happens to cover a
        whole block.  With an adaptive controller attached there is one
        exception: a reuse-class/latency-class stream running below its
        planned in-memory fraction fetches and promotes the whole covering
        block on a sub-block miss (see ``IOController.promote_range_miss``).
        """
        mode = mode or self.read_mode
        if offset < 0 or size < 0:
            raise ValueError("offset/size must be non-negative")
        flock = self._acquire_file(name, write=False)
        try:
            fmeta = self._file_meta_or_cold(name)
            end = min(offset + size, fmeta.size)
            if end <= offset:
                return b""
            with self._meta:
                self.stats.range_reads += 1
                self.stats.range_bytes += end - offset
            bb = self.layout.block_size
            first, last = offset // bb, (end - 1) // bb

            def fetch(i: int) -> bytes:
                lo = max(offset, i * bb) - i * bb
                hi = min(end, (i + 1) * bb) - i * bb
                blen = min(bb, fmeta.size - i * bb)
                return bytes(self._read_block_range(name, i, lo, hi, blen, mode))

            if first == last:
                return fetch(first)
            return b"".join(self._pool.map(fetch, range(first, last + 1)))
        finally:
            flock.release_read()

    def get_buffered(
        self,
        name: str,
        mode: ReadMode | None = None,
        readahead: int | None = None,
        offset: int = 0,
        length: int | None = None,
    ) -> Iterator[memoryview]:
        """Stream a file (or a byte range of it) in app-side buffer chunks.

        True streaming: yields per-block ``memoryview`` slices while up to
        ``readahead`` further blocks are prefetched from the PFS tier in the
        background — the whole file is never materialized.  With
        ``offset``/``length`` only the covering blocks are touched, and the
        boundary blocks are read partially (paper's 1 MB app requests over
        the exact bytes asked for).  The file's read lock is held while the
        generator is live; don't overwrite/delete the same file from the
        consuming thread mid-iteration.
        """
        mode = mode or self.read_mode
        if offset < 0 or (length is not None and length < 0):
            raise ValueError("offset/length must be non-negative")
        # Readahead depth: an explicit argument wins; otherwise the
        # controller's per-stream depth (re-queried as the stream advances,
        # so one long scan deepens/shrinks with live conditions); otherwise
        # the static knob.
        adaptive = readahead is None and self.controller is not None
        if adaptive:
            ra = self.controller.readahead(name, self.readahead_blocks)
        else:
            ra = self.readahead_blocks if readahead is None else max(0, readahead)
        flock = self._acquire_file(name, write=False)
        try:
            fmeta = self._file_meta_or_cold(name)
            end = fmeta.size if length is None else min(fmeta.size, offset + length)
            if end <= offset:
                return
            bb = self.layout.block_size
            first, last = offset // bb, (end - 1) // bb

            def submit(i: int):
                lo = max(offset, i * bb) - i * bb
                hi = min(end, (i + 1) * bb) - i * bb
                blen = min(bb, fmeta.size - i * bb)
                return self._pool.submit(self._read_block_range, name, i, lo, hi, blen, mode)

            pending: deque = deque()
            nxt = first
            while nxt <= last and len(pending) <= ra:
                pending.append(submit(nxt))
                nxt += 1
            while pending:
                data = memoryview(pending.popleft().result())
                if adaptive:
                    ra = self.controller.readahead(name, self.readahead_blocks)
                while nxt <= last and len(pending) <= ra:
                    pending.append(submit(nxt))
                    nxt += 1
                for off in range(0, len(data), self.app_buffer_bytes):
                    yield data[off : off + self.app_buffer_bytes]
        finally:
            flock.release_read()

    def _file_meta_or_cold(self, name: str) -> _FileMeta:
        """File metadata, registering a PFS-only (post-restart) file if needed.

        Cold registration probes block manifests without moving any data,
        so ranged/batched reads of a cold file don't pay a full-file read
        just to learn its size.  Caller holds the file's read lock.
        """
        with self._meta:
            fmeta = self._files.get(name)
        if fmeta is not None:
            return fmeta
        n = 0
        size = 0
        while True:
            try:
                psize, tag = self.pfs.describe(self._bkey(name, n))
            except BlockNotFound:
                break
            # A compressed block's manifest records physical size; its
            # logical size rides in the codec tag.
            parsed = self._parse_codec_tag(tag)
            size += parsed[0] if parsed is not None else psize
            n += 1
        if n == 0:
            raise BlockNotFound(name)
        with self._meta:
            fmeta = self._files.get(name)
            if fmeta is None:
                fmeta = self._files[name] = _FileMeta(size=size, n_blocks=n)
        return fmeta

    def _read_block_range(self, name: str, idx: int, lo: int, hi: int, blen: int, mode: ReadMode):
        """Fetch bytes ``[lo, hi)`` of one block of length ``blen``, moving
        only what's asked.

        A full-block range delegates to ``_read_block`` (promotion + whole
        -block CRC) — cold blocks with no table entry included, so ranged
        reads still warm the memory tier after a restart; a partial range
        serves a zero-copy memory-tier slice on a hit or a partial PFS
        stripe read on a miss — per-stripe CRCs verified by the tier, no
        promotion of bytes the caller didn't ask for.
        """
        if lo == 0 and hi >= blen:
            return self._read_block(name, idx, mode)
        bkey = self._bkey(name, idx)
        meta = self._blocks.get(bkey)  # lock-free table read (GIL-atomic)
        if mode is not ReadMode.PFS_BYPASS:
            try:
                view = self.mem.get_view(bkey, lo, hi - lo)
            except BlockNotFound:
                view = None
            if view is not None:
                with self._meta:
                    self.stats.mem_hits += 1
                    if meta is not None:
                        self._touch_locked(meta)
                # The block CRC covers the whole block, so the first hit of
                # a residency verifies the resident bytes (stat-free peek —
                # the caller only consumes the slice) exactly like the
                # full-block hit path; later hits skip the pass.
                if meta is not None and not meta.verified:
                    blob = self.mem.peek(bkey)
                    if blob is not None:
                        if crc32_chunked(blob) != meta.crc:
                            with self._meta:
                                self.stats.integrity_failures += 1
                            raise IntegrityError(f"memory-tier CRC mismatch for {bkey}")
                        # Only a real pass may mark the residency verified —
                        # a concurrent drop can make peek() return None.
                        meta.verified = True
                return view
        if mode is ReadMode.MEMORY_ONLY:
            raise BlockNotFound(bkey)
        if (
            mode is ReadMode.TIERED
            and self.cache_on_read
            and self.controller is not None
            and self.controller.promote_range_miss(name)
        ):
            # Reuse-class stream below its planned residency: fetch the
            # whole covering block (promoting it) and serve the slice — the
            # next ranged read over this block is a memory-tier hit.
            return self._read_block(name, idx, mode)[lo:hi]
        with self._meta:
            self.stats.mem_misses += 1
        # A compressed PFS object's physical offsets are not logical
        # offsets: fetch + decode only the covering frames via the frame
        # index (from the block table, or parsed from the container head
        # for a cold block the manifest tag marks compressed).
        index = meta.findex if meta is not None and meta.enc is not None else None
        if index is None and meta is None:
            if bkey in self._cold_index:
                index = self._cold_index[bkey]
            else:
                try:
                    _, tag = self.pfs.describe(bkey)
                except BlockNotFound:
                    tag = None
                parsed = self._parse_codec_tag(tag)
                if parsed is not None:
                    index = self._cold_frame_index(bkey, parsed[0], parsed[1])
                self._cold_index[bkey] = index
        if index is not None:
            return self._read_range_compressed(bkey, index, lo, hi)
        buf = bytearray(hi - lo)
        n, _ = self.pfs.readinto(bkey, buf, offset=lo, length=hi - lo)
        if n < hi - lo:
            with self._meta:
                self.stats.integrity_failures += 1
            raise IntegrityError(f"short PFS range read for {bkey}")
        return memoryview(buf)[:n]

    def _cold_frame_index(self, bkey: str, logical_len: int, frame_bytes: int):
        """Frame index of a cold compressed block: fetch just the container
        head (header + frame table — the manifest tag sized it) and parse."""
        head_len = blockcodec.index_bytes(logical_len, frame_bytes)
        buf = bytearray(head_len)
        n, _ = self.pfs.readinto(bkey, buf, offset=0, length=head_len)
        if n < head_len:
            with self._meta:
                self.stats.integrity_failures += 1
            raise IntegrityError(f"short container-head read for {bkey}")
        return blockcodec.parse_index(buf, frame_bytes)

    def _read_range_compressed(self, bkey: str, index: blockcodec.FrameIndex, lo: int, hi: int):
        """Serve logical ``[lo, hi)`` of one compressed block: read the
        physical span of the covering frames, decode only those, slice."""
        first, last = index.frame_range(lo, hi)
        off, plen = index.physical_span(first, last)
        buf = bytearray(plen)
        n, _ = self.pfs.readinto(bkey, buf, offset=off, length=plen)
        if n < plen:
            with self._meta:
                self.stats.integrity_failures += 1
            raise IntegrityError(f"short PFS range read for {bkey}")
        t0 = time.perf_counter()
        raw = blockcodec.decode_frames(buf, index, first, last, whole=False)
        dt = time.perf_counter() - t0
        with self.pfs._stats_lock:
            self.pfs.stats.record_decode(len(raw), plen, dt)
        if self.controller is not None:
            self.controller.note_codec("decode", len(raw), plen, dt)
        base = first * index.frame_bytes
        return memoryview(raw)[lo - base : hi - base]

    def _read_block(self, name: str, idx: int, mode: ReadMode):
        """Fetch one block: memory view on a hit, parallel PFS stripes on a miss."""
        bkey = self._bkey(name, idx)
        meta = self._blocks.get(bkey)  # lock-free table read (GIL-atomic)
        if mode is not ReadMode.PFS_BYPASS:
            try:
                view = self.mem.get_view(bkey)
            except BlockNotFound:
                view = None
            if view is not None:
                # Priority read policy: nearest copy (local memory tier) first.
                with self._meta:
                    self.stats.mem_hits += 1
                    if meta is not None:
                        self._touch_locked(meta)
                if meta is not None and not meta.verified:
                    if crc32_chunked(view) != meta.crc:
                        if mode is ReadMode.MEMORY_ONLY:
                            with self._meta:
                                self.stats.integrity_failures += 1
                            raise IntegrityError(f"memory-tier CRC mismatch for {bkey}")
                        # Resident bytes no longer match the published block
                        # CRC — e.g. an interrupted in-place overwrite died
                        # between the table update and the recache.  The bad
                        # copy must never be served or flushed: quarantine it
                        # and fall through to the durable copy.
                        self._quarantine_block(bkey)
                        view = None
                    else:
                        meta.verified = True
                if view is not None:
                    return view
        if mode is ReadMode.MEMORY_ONLY:
            raise BlockNotFound(bkey)
        with self._meta:
            self.stats.mem_misses += 1
        # Physical geometry of the cold copy: a compressed block is read at
        # its container length; a cold block with no table entry learns
        # whether it is a container from the manifest codec tag — no data
        # bytes move to find out.
        enc = meta.enc if meta is not None else None
        findex = meta.findex if meta is not None else None
        cold_tag = None
        if meta is not None:
            psize = meta.plen if enc is not None else meta.length
        else:
            try:
                psize, tag = self.pfs.describe(bkey)
            except BlockNotFound:
                psize, tag = self.layout.block_size, None
            cold_tag = self._parse_codec_tag(tag)
        # Stripe-parallel zero-copy fetch: stripes assemble straight into the
        # block buffer and the verified per-stripe CRCs combine into the
        # whole-object CRC, so the end-to-end check costs no extra data pass.
        buf = bytearray(psize)
        try:
            n, crc = self.pfs.readinto(bkey, buf)
        except ValueError:
            with self._meta:
                self.stats.integrity_failures += 1
            raise IntegrityError(f"PFS object larger than block table entry for {bkey}") from None
        data = memoryview(buf)[:n]
        if crc is None:
            crc = crc32_chunked(data)
        if enc is not None or cold_tag is not None:
            # Transfer-folded CRC verified the *physical* (compressed)
            # bytes; the decode pass re-derives the logical CRC — still no
            # extra pass over the data (DESIGN.md §13).
            if meta is not None and (n != meta.plen or crc != meta.pcrc):
                with self._meta:
                    self.stats.integrity_failures += 1
                raise IntegrityError(f"PFS CRC mismatch for {bkey}")
            if findex is not None:
                fb = findex.frame_bytes
            elif cold_tag is not None:
                fb = cold_tag[1]
            else:
                fb = self.codec.frame_bytes if self.codec else 256 * 1024
            pcrc, plen = crc, n
            raw, lcrc, findex = self._decode_block(bkey, data, fb)
            if meta is not None and (len(raw) != meta.length or lcrc != meta.crc):
                with self._meta:
                    self.stats.integrity_failures += 1
                raise IntegrityError(f"decoded block mismatch for {bkey}")
            data, crc, enc = memoryview(raw), lcrc, findex.codec
        else:
            pcrc = plen = 0
            if meta is not None and (n != meta.length or crc != meta.crc):
                with self._meta:
                    self.stats.integrity_failures += 1
                raise IntegrityError(f"PFS CRC mismatch for {bkey}")
        if (
            mode is ReadMode.TIERED
            and self.cache_on_read
            and (self.controller is None or self.controller.admit(name, bkey))
        ):
            new_meta = meta or _BlockMeta(
                key=bkey, length=len(data), crc=crc,
                enc=enc, plen=plen, pcrc=pcrc, findex=findex,
            )
            try:
                self._cache_block(new_meta, data)
                with self._meta:
                    new_meta.promoted = True  # residency earned by a read
                    self._blocks[bkey] = new_meta
                    self.stats.promotions += 1
            except CapacityExceeded:
                pass  # larger-than-cache block: serve without promoting
        return data

    def _get_cold(self, name: str, mode: ReadMode) -> bytes:
        """Reassemble a file known only to the PFS tier (post-restart path)."""
        if mode is ReadMode.MEMORY_ONLY:
            raise BlockNotFound(name)
        n = 0
        while self.pfs.contains(self._bkey(name, n)):
            n += 1
        if n == 0:
            raise BlockNotFound(name)

        def fetch(i: int) -> tuple[bytes, _BlockMeta]:
            """One block → its logical bytes + a fully described meta
            (compressed objects decode here; raw ones pass through)."""
            bkey = self._bkey(name, i)
            blob = self.pfs.get(bkey)
            try:
                _, tag = self.pfs.describe(bkey)
            except BlockNotFound:
                tag = None
            parsed = self._parse_codec_tag(tag)
            if parsed is None:
                return blob, _BlockMeta(key=bkey, length=len(blob), crc=crc32_chunked(blob))
            raw, lcrc, index = self._decode_block(bkey, blob, parsed[1])
            return raw, _BlockMeta(
                key=bkey, length=len(raw), crc=lcrc,
                enc=index.codec, plen=len(blob),
                pcrc=crc32_chunked(blob), findex=index,
            )

        if n == 1:
            parts = [fetch(0)]
        else:
            parts = list(self._pool.map(fetch, range(n)))
        data = b"".join(blob for blob, _ in parts)
        with self._meta:
            self._files[name] = _FileMeta(size=len(data), n_blocks=n)
            for _, meta in parts:
                if meta.key not in self._blocks:
                    self._blocks[meta.key] = meta
        return data

    # ---------------------------------------------------------------- manage

    def exists(self, name: str) -> bool:
        with self._meta:
            if name in self._files:
                return True
        return self.pfs.contains(self._bkey(name, 0))

    def file_size(self, name: str) -> int:
        with self._meta:
            if name in self._files:
                return self._files[name].size
        # Cold file: size from the stripe manifests — no data movement.
        flock = self._acquire_file(name, write=False)
        try:
            return self._file_meta_or_cold(name).size
        finally:
            flock.release_read()

    def delete(self, name: str) -> bool:
        flock = self._acquire_file(name, write=True)
        try:
            found = self._delete_impl(name)
            with self._meta:
                # Prune the registry entry so deleted names don't leak lock
                # objects; blocked waiters re-check identity and retry.
                if self._file_locks.get(name) is flock:
                    del self._file_locks[name]
            return found
        finally:
            flock.release_write()

    def _delete_impl(self, name: str) -> bool:
        """Remove a file from both tiers (caller holds the file write lock)."""
        with self._meta:
            fmeta = self._files.pop(name, None)
        found = fmeta is not None
        removed = self._trim_tail(name, 0, fmeta.n_blocks if fmeta else 0)
        return found or removed

    def _trim_tail(self, name: str, start: int, known_n: int) -> bool:
        """Remove blocks ``start..`` from both tiers, probing past ``known_n``
        for stale leftovers (caller holds the file write lock)."""
        removed = False
        idx = start
        while True:
            bkey = self._bkey(name, idx)
            with self._block_lock(bkey):
                in_mem = self.mem.delete(bkey)
                in_pfs = self.pfs.delete(bkey)
            self._cold_index.pop(bkey, None)
            with self._meta:
                self._blocks.pop(bkey, None)
                self._dirty.discard(bkey)
                self._resident.pop(bkey, None)
            if not (in_mem or in_pfs):
                if idx >= known_n:
                    break
            else:
                removed = True
            idx += 1
        return removed

    def peek_block(self, name: str, idx: int) -> tuple[bytes, int] | None:
        """Resident bytes + block-table CRC of one *hot* block, or ``None``.

        The peer-read surface of the distributed store (DESIGN.md §11): an
        owner host serves hot blocks to non-owners straight from its memory
        tier, with the CRC it already holds carried alongside the bytes —
        neither side recomputes a checksum on the wire path (the CRC was
        produced when the block entered the store and travels with it).
        Returns ``None`` when the block is not memory-resident; the caller
        then reads the cold copy from the shared PFS tier directly.
        """
        flock = self._acquire_file(name, write=False)
        try:
            bkey = self._bkey(name, idx)
            blob = self.mem.peek(bkey)
            meta = self._blocks.get(bkey)
            if blob is None or meta is None:
                return None
            return blob, meta.crc
        finally:
            flock.release_read()

    def peek_block_wire(self, name: str, idx: int) -> tuple[bytes, int, int | None, int] | None:
        """Peer-wire variant of :meth:`peek_block` (DESIGN.md §13):
        ``(payload, crc, enc, frame_bytes)`` or ``None`` when not hot.

        ``enc is None`` → raw logical bytes + logical CRC, bit-identical
        to :meth:`peek_block`.  When the store carries a codec and the
        block's class already proved compressible (its durable copy is a
        container), the hot bytes are re-encoded so the wire moves the
        smaller container + its *compressed* CRC — the receiver checks
        transport integrity over the compressed bytes and decodes locally.
        """
        flock = self._acquire_file(name, write=False)
        try:
            bkey = self._bkey(name, idx)
            blob = self.mem.peek(bkey)
            meta = self._blocks.get(bkey)
            if blob is None or meta is None:
                return None
            if self.codec is not None and meta.enc is not None:
                t0 = time.perf_counter()
                enc = blockcodec.encode(blob, self.codec)
                if enc is not None:
                    dt = time.perf_counter() - t0
                    if self.controller is not None:
                        self.controller.note_codec(
                            "encode", len(blob), len(enc.payload), dt
                        )
                    return (
                        enc.payload,
                        crc32_chunked(enc.payload),
                        enc.index.codec,
                        enc.index.frame_bytes,
                    )
            return blob, meta.crc, None, 0
        finally:
            flock.release_read()

    # --------------------------------------------------------------- arbiter

    def set_mem_capacity(self, capacity_bytes: int) -> None:
        """Retarget the memory tier's capacity, evicting down to fit — the
        elastic arbiter's resize hook for the store's pool.  Shrinks drain
        through the normal victim path (dirty blocks flush before their
        copy goes), so durability is never traded for the new budget."""
        self.mem.set_capacity(capacity_bytes)
        while self.mem.used_bytes > capacity_bytes:
            victim = self._pop_victim()
            if victim is None:
                break
            self._evict(victim)

    def attach_arbiter(self, arbiter, min_bytes: int = 0, weight: float = 1.0):
        """Register the memory tier as pool ``"mem_tier"`` of an elastic
        :class:`~repro_torch.core.arbiter.MemoryArbiter` (DESIGN.md §13).

        The pool's ``value_fn`` doubles as the per-tick ledger refresh: it
        folds the store's live hit/miss/eviction deltas into the pool and
        returns a DEFAULT-class marginal value scaled by the measured miss
        rate (evictions signal demand beyond the current budget).  Budget
        changes land through :meth:`set_mem_capacity`.  Also wires the
        arbiter into the store's controller plan tick when one is bound.
        """
        pool = arbiter.register(
            "mem_tier",
            cls="default",
            min_bytes=min_bytes,
            weight=weight,
            initial_bytes=self.mem.capacity_bytes,
            on_resize=self.set_mem_capacity,
        )
        last = {"h": 0, "m": 0, "e": 0}

        def value_fn() -> float:
            s = self.stats
            dh, dm = s.mem_hits - last["h"], s.mem_misses - last["m"]
            de = s.evictions - last["e"]
            last.update(h=s.mem_hits, m=s.mem_misses, e=s.evictions)
            pool.note_used(self.mem.used_bytes)
            # Evictions mean the tier wants more than it holds; otherwise
            # its demand is what it currently holds.
            pool.note_demand(
                int(self.mem.capacity_bytes * 1.5) if de else self.mem.used_bytes
            )
            if dh or dm:
                pool.note_hit(dh)
                pool.note_miss(dm)
            miss = dm / (dh + dm) if (dh + dm) else 0.0
            return 4.0 * weight * (1.0 + 4.0 * miss)

        pool.value_fn = value_fn
        if self.controller is not None:
            self.controller.arbiter = arbiter
        return pool

    def adopt_cold(self, name: str) -> bool:
        """Register a PFS-only file written by another store instance.

        After adoption, tiered reads of the file run the per-block path
        (promoting into the memory tier) instead of the no-promotion
        whole-file cold reassembly.  Returns ``False`` when no PFS blocks
        exist under ``name``; no data moves either way.
        """
        flock = self._acquire_file(name, write=False)
        try:
            self._file_meta_or_cold(name)
        except BlockNotFound:
            return False
        finally:
            flock.release_read()
        return True

    def resident_fraction(self, name: str | None = None) -> float:
        """The paper's ``f``: fraction of bytes resident in the memory tier.

        For a named file the denominator is the *file size* — an evicted
        block lowers the fraction even though eviction also dropped its
        block-table entry.  With no name, the fraction is over all
        currently tracked blocks.
        """
        if name is not None:
            with self._meta:
                fmeta = self._files.get(name)
            if fmeta is None or fmeta.size == 0:
                return 0.0
            bb = self.layout.block_size
            hot = 0
            for i in range(fmeta.n_blocks):
                if self.mem.contains(self._bkey(name, i)):
                    hot += min(bb, fmeta.size - i * bb)
            return hot / fmeta.size
        with self._meta:
            total = hot = 0
            for bkey, meta in self._blocks.items():
                total += meta.length
                if self.mem.contains(bkey):
                    hot += meta.length
        return hot / total if total else 0.0

    def list_files(self) -> list[str]:
        with self._meta:
            names = set(self._files)
        for key in self.pfs.keys():
            names.add(key.rsplit(":", 1)[0])
        return sorted(names)

    def server_load(self) -> dict[int, int]:
        return self.pfs.server_bytes()

    def tier_stats(self) -> dict[str, dict]:
        out = {
            "mem": dataclasses.asdict(self.mem.stats),
            "pfs": dataclasses.asdict(self.pfs.stats),
            "store": dataclasses.asdict(self.stats),
        }
        if self.scrubber is not None:
            out["scrub"] = self.scrubber.stats.to_dict()
        return out

    def close(self) -> None:
        if self._closed:
            return
        self.drain()
        self._closed = True
        if self.scrubber is not None:
            self.scrubber.stop()
        for _ in self._flushers:
            self._flush_q.put(None)
        for t in self._flushers:
            t.join(timeout=10)
        self._pool.shutdown(wait=True)
        self.pfs.close()

    def __enter__(self) -> "TwoLevelStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

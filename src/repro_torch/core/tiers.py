"""Storage tiers: a per-host in-memory block store and a striped PFS tier.

``MemoryTier`` is the Tachyon analogue — a capacity-bounded, thread-safe,
in-RAM block store local to a compute host.  It stores immutable ``bytes``
objects and serves zero-copy ``memoryview`` slices (``get_view``), so a
reader never pays a copy for a memory-tier hit.  ``PFSTier`` is the
OrangeFS analogue — server-striped files on a shared directory tree (one
subdirectory per data-node server), with per-stripe CRC checksums standing
in for the data-node-internal erasure coding (DESIGN.md §4).

The PFS tier moves stripe units **in parallel**: each logical object's
stripe units are laid out round-robin across the server directories, and a
shared thread pool (sized to ``n_servers`` by default — one in-flight
request per data-node, the paper's aggregate-throughput model) reads and
writes the units concurrently.  Reads assemble stripes zero-copy via
``readinto`` on a preallocated buffer; CRC32 is folded incrementally over
the same 4 MB chunks that move the bytes, so integrity costs no extra pass.

Both tiers move *real bytes* and keep a ``TierStats`` ledger (bytes, ops,
wall seconds, and first-start/last-end spans) so benchmarks can report both
per-op and *aggregate* measured throughput alongside the analytic model's
prediction (DESIGN.md §5).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import threading
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

#: Granularity at which CRC32 is folded while moving bytes (the paper's
#: 4 MB Tachyon<->OrangeFS transfer buffer).  Chunking matters for
#: concurrency: zlib releases the GIL per call, so two threads can overlap
#: checksum work on a 2-core host instead of serializing on one giant buffer.
CRC_CHUNK_BYTES = 4 * 2**20


def crc32_chunked(data, chunk_bytes: int = CRC_CHUNK_BYTES) -> int:
    """CRC32 of ``data`` computed incrementally over ``chunk_bytes`` chunks."""
    mv = memoryview(data)
    crc = 0
    for off in range(0, len(mv), chunk_bytes):
        crc = zlib.crc32(mv[off : off + chunk_bytes], crc)
    return crc


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    total = 0
    i = 0
    while vec:
        if vec & 1:
            total ^= mat[i]
        vec >>= 1
        i += 1
    return total


def _gf2_matrix_square(square: list[int], mat: list[int]) -> None:
    for n in range(32):
        square[n] = _gf2_matrix_times(mat, mat[n])


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of ``A+B`` given ``crc32(A)``, ``crc32(B)`` and ``len(B)``.

    Port of zlib's ``crc32_combine`` (GF(2) matrix exponentiation of the
    CRC shift operator).  This is what lets stripe units be checksummed
    *in parallel* during transfer and still yield the exact whole-block
    CRC — integrity costs zero extra passes over the data.
    """
    if len2 <= 0:
        return crc1
    even = [0] * 32  # operator for 2^(2k) zero bits
    odd = [0] * 32  # operator for 2^(2k+1) zero bits
    odd[0] = 0xEDB88320  # CRC-32 polynomial, reflected
    row = 1
    for n in range(1, 32):
        odd[n] = row
        row <<= 1
    _gf2_matrix_square(even, odd)  # even = one-zero-byte operator squared...
    _gf2_matrix_square(odd, even)
    while True:
        _gf2_matrix_square(even, odd)
        if len2 & 1:
            crc1 = _gf2_matrix_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        _gf2_matrix_square(odd, even)
        if len2 & 1:
            crc1 = _gf2_matrix_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


class TierError(Exception):
    pass


class BlockNotFound(TierError, KeyError):
    pass


class CapacityExceeded(TierError):
    pass


class IntegrityError(TierError):
    pass


@dataclasses.dataclass
class TierStats:
    bytes_read: int = 0
    bytes_written: int = 0
    read_ops: int = 0
    write_ops: int = 0
    read_seconds: float = 0.0
    write_seconds: float = 0.0
    # Wall-clock span of the *current burst* of the read/write op stream:
    # first op start .. last op end.  With concurrent ops the per-op seconds
    # above sum *busy* time across threads (they overcount wall time), so
    # aggregate throughput — the quantity the paper's Section 4 model
    # predicts — must be computed over spans instead.
    read_span_start: float = 0.0
    read_span_end: float = 0.0
    write_span_start: float = 0.0
    write_span_end: float = 0.0
    # Idle-gap handling: an op starting more than ``idle_gap_s`` after the
    # previous burst's end closes that burst — its wall span is banked into
    # ``*_busy_seconds`` and a fresh span opens.  ``aggregate_*_mbps``
    # divides by busy span time only, so a bursty stream separated by long
    # idle stretches (a loader between epochs, a flush lane between burst
    # checkpoints) is not undercounted by the dead air between bursts.
    idle_gap_s: float = 0.5
    read_busy_seconds: float = 0.0  # closed read bursts (excludes current span)
    write_busy_seconds: float = 0.0
    read_bursts: int = 0  # closed bursts; current open span adds one more
    write_bursts: int = 0
    # Buffer-pool ledger (PFSTier stripe-assembly buffers): how often a
    # pooled buffer was reused vs freshly allocated.
    buf_allocs: int = 0
    buf_reuses: int = 0
    # Replication ledger (DESIGN.md §15): reads that had to fail over past
    # a missing/corrupt primary copy to a surviving replica, and stripe-unit
    # replicas rewritten by the repair path (inline or scrubber-driven).
    degraded_reads: int = 0
    repaired_units: int = 0
    # Codec ledger (DESIGN.md §13): logical bytes are what the application
    # wrote/read, physical bytes are what actually crossed this tier after
    # compression.  Both encode and decode events contribute a (logical,
    # physical) pair, so ``compression_ratio`` reflects the traffic mix.
    bytes_logical: int = 0
    bytes_physical: int = 0
    compress_seconds: float = 0.0
    decode_seconds: float = 0.0

    def record_read(self, nbytes: int, seconds: float, end: float | None = None) -> None:
        end = time.perf_counter() if end is None else end
        start = end - seconds
        self.bytes_read += nbytes
        self.read_ops += 1
        self.read_seconds += seconds
        if self.read_span_start and start > self.read_span_end + self.idle_gap_s:
            # New burst: bank the finished span, start fresh at this op.
            self.read_busy_seconds += self.read_span_end - self.read_span_start
            self.read_bursts += 1
            self.read_span_start = start
            self.read_span_end = end
            return
        if not self.read_span_start or start < self.read_span_start:
            self.read_span_start = start
        if end > self.read_span_end:
            self.read_span_end = end

    def record_write(self, nbytes: int, seconds: float, end: float | None = None) -> None:
        end = time.perf_counter() if end is None else end
        start = end - seconds
        self.bytes_written += nbytes
        self.write_ops += 1
        self.write_seconds += seconds
        if self.write_span_start and start > self.write_span_end + self.idle_gap_s:
            self.write_busy_seconds += self.write_span_end - self.write_span_start
            self.write_bursts += 1
            self.write_span_start = start
            self.write_span_end = end
            return
        if not self.write_span_start or start < self.write_span_start:
            self.write_span_start = start
        if end > self.write_span_end:
            self.write_span_end = end

    def record_buffer(self, reused: bool) -> None:
        if reused:
            self.buf_reuses += 1
        else:
            self.buf_allocs += 1

    def record_compress(self, logical: int, physical: int, seconds: float) -> None:
        self.bytes_logical += logical
        self.bytes_physical += physical
        self.compress_seconds += seconds

    def record_decode(self, logical: int, physical: int, seconds: float) -> None:
        self.bytes_logical += logical
        self.bytes_physical += physical
        self.decode_seconds += seconds

    def compression_ratio(self) -> float:
        """logical/physical over all codec traffic; 1.0 when no codec ran."""
        return self.bytes_logical / self.bytes_physical if self.bytes_physical else 1.0

    def read_mbps(self) -> float:
        return self.bytes_read / 2**20 / self.read_seconds if self.read_seconds else 0.0

    def write_mbps(self) -> float:
        return self.bytes_written / 2**20 / self.write_seconds if self.write_seconds else 0.0

    def read_busy_span(self) -> float:
        """Total busy wall time of the read stream: closed bursts + open span."""
        return self.read_busy_seconds + max(0.0, self.read_span_end - self.read_span_start)

    def write_busy_span(self) -> float:
        return self.write_busy_seconds + max(0.0, self.write_span_end - self.write_span_start)

    def aggregate_read_mbps(self) -> float:
        span = self.read_busy_span()
        return self.bytes_read / 2**20 / span if span > 0 else 0.0

    def aggregate_write_mbps(self) -> float:
        span = self.write_busy_span()
        return self.bytes_written / 2**20 / span if span > 0 else 0.0

    def buffer_reuse_rate(self) -> float:
        total = self.buf_allocs + self.buf_reuses
        return self.buf_reuses / total if total else 0.0

    # -- serialization / cross-process aggregation ---------------------------

    def to_dict(self) -> dict:
        """Plain-dict snapshot (JSON-safe) for shipping across processes."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TierStats":
        """Inverse of :meth:`to_dict`.  Unknown keys are ignored so ledgers
        serialized by a newer build still load (forward compatibility for
        the gossip / multihost-benchmark path)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def merge(self, other: "TierStats") -> "TierStats":
        """Combine two ledgers from *concurrent* streams (e.g. one per host
        shard) into a cluster-level ledger; returns a new ``TierStats``.

        Counters (bytes, ops, busy seconds, closed bursts, buffer ledger)
        sum.  The *open* spans union — min start to max end — because
        concurrent hosts' in-flight bursts overlap in wall time; closed
        bursts stay summed (conservative: treated as disjoint).  So
        ``aggregate_read_mbps`` of a merge of hosts that ran strictly in
        parallel reports total bytes over the shared wall window, which is
        the paper's cluster aggregate (Section 4, N·ν when memory-resident).
        """
        out = TierStats(
            bytes_read=self.bytes_read + other.bytes_read,
            bytes_written=self.bytes_written + other.bytes_written,
            read_ops=self.read_ops + other.read_ops,
            write_ops=self.write_ops + other.write_ops,
            read_seconds=self.read_seconds + other.read_seconds,
            write_seconds=self.write_seconds + other.write_seconds,
            idle_gap_s=self.idle_gap_s,
            read_busy_seconds=self.read_busy_seconds + other.read_busy_seconds,
            write_busy_seconds=self.write_busy_seconds + other.write_busy_seconds,
            read_bursts=self.read_bursts + other.read_bursts,
            write_bursts=self.write_bursts + other.write_bursts,
            buf_allocs=self.buf_allocs + other.buf_allocs,
            buf_reuses=self.buf_reuses + other.buf_reuses,
            degraded_reads=self.degraded_reads + other.degraded_reads,
            repaired_units=self.repaired_units + other.repaired_units,
            bytes_logical=self.bytes_logical + other.bytes_logical,
            bytes_physical=self.bytes_physical + other.bytes_physical,
            compress_seconds=self.compress_seconds + other.compress_seconds,
            decode_seconds=self.decode_seconds + other.decode_seconds,
        )
        starts = [s for s in (self.read_span_start, other.read_span_start) if s]
        out.read_span_start = min(starts) if starts else 0.0
        out.read_span_end = max(self.read_span_end, other.read_span_end)
        starts = [s for s in (self.write_span_start, other.write_span_start) if s]
        out.write_span_start = min(starts) if starts else 0.0
        out.write_span_end = max(self.write_span_end, other.write_span_end)
        return out


class _BufferPool:
    """Size-bucketed freelist of ``bytearray`` scratch buffers.

    The PFS tier's boundary-unit staging and whole-object ``get`` paths
    need a transient buffer per call; on the merge/readahead hot path that
    was a fresh ``bytearray`` per block read.  Stripe geometry makes the
    size population tiny (stripe size + a few tail lengths), so an
    exact-size bucket freelist gets near-perfect reuse.  Buffers are
    returned dirty — every consumer fully overwrites the bytes it reads
    before using them (``readinto`` raises on a short read).
    """

    def __init__(self, stats: TierStats, max_per_size: int = 8, max_total_bytes: int = 64 * 2**20):
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self._held = 0
        self.max_per_size = max_per_size
        self.max_total_bytes = max_total_bytes
        self.stats = stats

    def acquire(self, n: int) -> bytearray:
        with self._lock:
            bucket = self._free.get(n)
            if bucket:
                buf = bucket.pop()
                self._held -= n
                self.stats.record_buffer(reused=True)
                return buf
            self.stats.record_buffer(reused=False)
        return bytearray(n)

    def release(self, buf: bytearray) -> None:
        n = len(buf)
        if n == 0:
            return
        with self._lock:
            bucket = self._free.setdefault(n, [])
            if len(bucket) < self.max_per_size and self._held + n <= self.max_total_bytes:
                bucket.append(buf)
                self._held += n


class MemoryTier:
    """Capacity-bounded in-memory block store (the Tachyon tier).

    Keys are opaque strings (``"<file>:<block_index>"`` at the store layer).
    Eviction *policy* lives in the store; the tier only enforces capacity
    and exposes usage.

    Blocks are immutable ``bytes``; ``get_view`` hands out zero-copy
    ``memoryview`` slices.  A view stays valid even if the block is deleted
    or replaced concurrently — it pins the original bytes object, so readers
    can never observe a torn block.
    """

    def __init__(self, capacity_bytes: int) -> None:
        if capacity_bytes <= 0:
            raise ValueError("capacity must be positive")
        self.capacity_bytes = capacity_bytes
        self._data: dict[str, bytes] = {}
        self._used = 0
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = TierStats()

    # -- core ops -----------------------------------------------------------

    def put(self, key: str, data) -> None:
        t0 = time.perf_counter()
        blob = data if type(data) is bytes else bytes(data)
        with self._lock:
            old = len(self._data.get(key, b""))
            new_used = self._used - old + len(blob)
            if new_used > self.capacity_bytes:
                raise CapacityExceeded(
                    f"memory tier full: {new_used}/{self.capacity_bytes} bytes for {key!r}"
                )
            self._data[key] = blob
            self._used = new_used
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.record_write(len(blob), t1 - t0, end=t1)

    def get_view(self, key: str, offset: int = 0, length: int | None = None) -> memoryview:
        """Zero-copy read: a memoryview over the immutable stored bytes."""
        t0 = time.perf_counter()
        blob = self._data.get(key)  # dict read is atomic under the GIL
        if blob is None:
            raise BlockNotFound(key)
        end = len(blob) if length is None else min(len(blob), offset + length)
        out = memoryview(blob)[offset:end]
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.record_read(len(out), t1 - t0, end=t1)
        return out

    def get(self, key: str, offset: int = 0, length: int | None = None) -> bytes:
        return bytes(self.get_view(key, offset, length))

    def peek(self, key: str) -> bytes | None:
        """Raw resident bytes without touching the read ledger — for
        integrity checks over data the caller isn't actually consuming."""
        return self._data.get(key)  # dict read is atomic under the GIL

    def delete(self, key: str) -> bool:
        with self._lock:
            blob = self._data.pop(key, None)
            if blob is None:
                return False
            self._used -= len(blob)
            return True

    def contains(self, key: str) -> bool:
        return key in self._data

    def size_of(self, key: str) -> int:
        blob = self._data.get(key)
        if blob is None:
            raise BlockNotFound(key)
        return len(blob)

    def keys(self) -> list[str]:
        with self._lock:
            return list(self._data)

    def set_capacity(self, capacity_bytes: int) -> None:
        """Retarget the tier's capacity (the memory arbiter's resize hook).

        Shrinking below current usage is allowed — the tier simply refuses
        *new* puts until the owner (the store's eviction loop) drains it
        down; resident blocks are never dropped here, because victim
        selection is store policy, not tier mechanics.
        """
        if capacity_bytes <= 0:
            raise ValueError("capacity must be positive")
        self.capacity_bytes = capacity_bytes

    @property
    def used_bytes(self) -> int:
        return self._used

    @property
    def free_bytes(self) -> int:
        return self.capacity_bytes - self._used

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._used = 0


class PFSTier:
    """Striped persistent tier (the OrangeFS analogue).

    Each logical block key maps to stripe-unit files laid out round-robin
    across ``n_servers`` server directories::

        root/server_00/<key>.s0000   root/server_01/<key>.s0001  ...

    Every stripe unit carries a CRC32 recorded in a sidecar manifest,
    validated on read (stand-in for intra-data-node erasure coding).
    Reads/writes stream through ``io_buffer_bytes`` chunks — the paper's
    4 MB Tachyon↔OrangeFS buffer — with the unit CRC folded incrementally
    over the same chunks (no separate checksum pass).

    Stripe units of one object are moved **concurrently** by a shared
    worker pool (default ``n_servers`` workers — at most one in-flight
    request per data-node directory, which is how the paper's Section 4
    aggregate-throughput model saturates M servers).  Per-key striped
    locks serialize put/get/delete of the *same* key; different keys
    proceed fully in parallel.

    **Replication (DESIGN.md §15).**  With ``replication=r`` every stripe
    unit (and the manifest) is written to ``r`` distinct server
    directories — replica ``j`` of unit ``u`` lands on server
    ``(u + j) % n_servers``, a rotation, so no two replicas of one unit
    ever co-locate and each server carries an even 1/n share of every
    replica rank (the Eq. 2 μ/r write cost, read-any on the read side).
    Reads fail over past missing/corrupt copies (counting
    ``TierStats.degraded_reads`` and notifying ``on_degraded`` so a
    scrubber can queue a repair); :meth:`repair` rewrites bad replicas
    from a surviving good copy.  ``replication=1`` is byte-identical to
    the pre-replication layout on disk.
    """

    MANIFEST_SUFFIX = ".crc"
    _N_KEY_LOCKS = 64

    def __init__(
        self,
        root: str,
        n_servers: int = 2,
        stripe_bytes: int = 64 * 2**20,
        io_buffer_bytes: int = 4 * 2**20,
        fsync: bool = False,
        io_workers: int | None = None,
        chaos=None,  # runtime.failure.ChaosInjector | None
        replication: int = 1,
    ) -> None:
        if n_servers <= 0 or stripe_bytes <= 0 or io_buffer_bytes <= 0:
            raise ValueError("n_servers, stripe_bytes, io_buffer_bytes must be positive")
        if not 1 <= replication <= n_servers:
            raise ValueError(
                f"replication must be in [1, n_servers]: got r={replication}, n={n_servers}"
            )
        self.chaos = chaos
        self.root = root
        self.n_servers = n_servers
        self.stripe_bytes = stripe_bytes
        self.io_buffer_bytes = io_buffer_bytes
        self.fsync = fsync
        self.replication = replication
        # Called with the key whenever a read had to fail over past a bad
        # replica — the scrubber's repair-queue hook.  Exceptions are
        # swallowed: degraded reads must still succeed.
        self.on_degraded = None
        self.io_workers = n_servers if io_workers is None else max(1, io_workers)
        self._pool: ThreadPoolExecutor | None = (
            ThreadPoolExecutor(max_workers=self.io_workers, thread_name_prefix="pfs-io")
            if self.io_workers > 1
            else None
        )
        self._key_locks = [threading.RLock() for _ in range(self._N_KEY_LOCKS)]
        self._stats_lock = threading.Lock()
        self.stats = TierStats()
        self._buf_pool = _BufferPool(self.stats)
        for s in range(n_servers):
            os.makedirs(self._server_dir(s), exist_ok=True)

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    # -- path helpers ---------------------------------------------------------

    def _key_lock(self, key: str) -> threading.RLock:
        return self._key_locks[hash(key) % self._N_KEY_LOCKS]

    def _server_dir(self, server: int) -> str:
        return os.path.join(self.root, f"server_{server:02d}")

    @staticmethod
    def _safe(key: str) -> str:
        # Keys must not organically contain "@" or "__" (store-generated keys
        # use "<name>:<block>"); _unsafe inverts this for keys().
        return key.replace(os.sep, "__").replace(":", "@")

    @staticmethod
    def _unsafe(name: str) -> str:
        return name.replace("@", ":").replace("__", os.sep)

    def _stripe_path(self, key: str, unit: int, replica: int = 0) -> str:
        # Rotated placement: replica j of unit u on server (u + j) % n.
        # The unit index in the filename keeps cross-directory placement
        # collision-free, and replica 0 is exactly the pre-replication path.
        server = (unit + replica) % self.n_servers
        return os.path.join(self._server_dir(server), f"{self._safe(key)}.s{unit:04d}")

    def _manifest_path(self, key: str, replica: int = 0) -> str:
        server = replica % self.n_servers
        return os.path.join(self._server_dir(server), self._safe(key) + self.MANIFEST_SUFFIX)

    def _iter_units(self, total: int) -> Iterator[tuple[int, int, int]]:
        """Yield (unit_index, offset, length) stripe units covering ``total``."""
        unit = 0
        off = 0
        while off < total:
            ln = min(self.stripe_bytes, total - off)
            yield unit, off, ln
            unit += 1
            off += ln

    def _map_units(self, fn, units):
        """Run ``fn`` over stripe units — concurrently when a pool exists."""
        if self._pool is not None and len(units) > 1:
            return list(self._pool.map(fn, units))
        return [fn(u) for u in units]

    def _open_for_write(self, path: str):
        """Open a stripe/manifest file for writing, recreating a missing
        server directory — a replaced data node rejoins empty, and both
        foreground writes and scrubber re-replication must be able to
        land bytes on it."""
        try:
            return open(path, "wb")
        except FileNotFoundError:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            return open(path, "wb")

    def _maybe_chaos_server_down(self) -> None:
        """Chaos site "pfs.server_down": a ``server_down`` fault removes one
        server directory wholesale (``where={"server": k}`` picks the
        victim) — the lost-data-node scenario the replicated read path and
        the scrubber's re-replication exist to survive."""
        if self.chaos is None:
            return
        for s in range(self.n_servers):
            spec = self.chaos.at("pfs.server_down", server=s)
            if spec is not None and spec.kind == "server_down":
                shutil.rmtree(self._server_dir(s), ignore_errors=True)

    def _note_degraded(self, key: str) -> None:
        hook = self.on_degraded
        if hook is not None:
            try:
                hook(key)
            except Exception:
                pass  # repair enqueue is best-effort; the read must succeed

    # -- core ops -------------------------------------------------------------

    def put(self, key: str, data, tag: str | None = None) -> int:
        """Write one object; returns the CRC32 of the whole object.

        Stripe units stream out concurrently, each folding its CRC over the
        4 MB chunks it writes; the unit CRCs are then combined
        (``crc32_combine``) into the object CRC — integrity metadata for
        the layer above at zero extra passes over the data.

        ``tag`` is an opaque single-line annotation stored in the manifest
        (the store marks compressed containers ``tlc1:<logical_len>`` so a
        cold scan learns logical sizes without reading any data bytes);
        :meth:`describe` reads it back.
        """
        t0 = time.perf_counter()
        self._maybe_chaos_server_down()
        mv = memoryview(data)
        units = list(self._iter_units(len(mv)))

        def write_unit(u: tuple[int, int, int]) -> int:
            unit, off, ln = u
            # Chaos site "pfs.write_unit": a torn/short stripe write lands
            # only the first ``frac`` of the unit's bytes.  The CRC is still
            # folded over the *intended* bytes — exactly what a real torn
            # write produces: a manifest that convicts the short file on
            # the next read (silent mode), or an immediate write error the
            # flush pipeline retries (default).  Zero-cost without chaos.
            # Fired once per replica, so a count-bounded spec tears exactly
            # one copy and read-any serves the survivors.
            torn = None
            cutoffs = []
            for j in range(self.replication):
                cutoff = off + ln
                if self.chaos is not None:
                    spec = self.chaos.at("pfs.write_unit", key=key, unit=unit, replica=j)
                    if spec is not None and spec.kind == "torn_write":
                        torn = spec
                        cutoff = off + max(0, int(ln * spec.frac))
                cutoffs.append(cutoff)
            crc = 0
            handles = [
                self._open_for_write(self._stripe_path(key, unit, j))
                for j in range(self.replication)
            ]
            try:
                for b0 in range(off, off + ln, self.io_buffer_bytes):
                    chunk = mv[b0 : min(b0 + self.io_buffer_bytes, off + ln)]
                    crc = zlib.crc32(chunk, crc)
                    for fh, cutoff in zip(handles, cutoffs):
                        if b0 < cutoff:
                            fh.write(chunk[: cutoff - b0])
                if self.fsync:
                    for fh in handles:
                        fh.flush()
                        os.fsync(fh.fileno())
            finally:
                for fh in handles:
                    fh.close()
            # Replicas beyond the current factor are stale survivors of a
            # wider-replication past: an in-place overwrite must kill them
            # or read-any could later serve the *old* version of this unit.
            for j in range(self.replication, self.n_servers):
                try:
                    os.remove(self._stripe_path(key, unit, j))
                except FileNotFoundError:
                    pass
            if torn is not None and not torn.silent:
                raise IntegrityError(f"injected torn write on stripe unit {unit} of {key!r}")
            return crc

        with self._key_lock(key):
            crcs = self._map_units(write_unit, units)
            self._write_manifest(key, len(mv), crcs, tag)
            # In-place overwrite with fewer units: unlink the stale tail
            # (units are contiguous, so probe all replica placements until
            # the first unit with no file anywhere).
            unit = len(units)
            while True:
                found = False
                for j in range(self.n_servers):
                    try:
                        os.remove(self._stripe_path(key, unit, j))
                        found = True
                    except FileNotFoundError:
                        pass
                if not found:
                    break
                unit += 1
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.record_write(len(mv), t1 - t0, end=t1)
        whole = 0
        for (_, _, ln), crc in zip(units, crcs):
            whole = crc32_combine(whole, crc, ln)
        return whole

    def _write_manifest(self, key: str, total: int, crcs: list[int],
                        tag: str | None = None) -> None:
        manifest = f"{total}\n" + "\n".join(f"{c:08x}" for c in crcs) + "\n"
        if tag:
            if "\n" in tag:
                raise ValueError("manifest tag must be a single line")
            manifest += f"#{tag}\n"
        if self.replication > 1:
            # Recorded in the sidecar (not just tier config) so readers and
            # the scrubber know the replica set of *this object* even after
            # the tier is reopened with a different factor.  Omitted at r=1,
            # which keeps unreplicated manifests byte-identical to the
            # pre-replication format.
            manifest += f"#repl={self.replication}\n"
        for j in range(self.replication):
            self._replace_manifest_text(key, j, manifest)
        for j in range(self.replication, self.n_servers):
            # Stale manifest replicas from a wider-replication past would
            # let read-any resurrect the old object version; remove them.
            try:
                os.remove(self._manifest_path(key, j))
            except FileNotFoundError:
                pass

    def _replace_manifest_text(self, key: str, replica: int, text: str) -> None:
        """Atomically land one manifest replica (tmp + rename, fsync-aware)."""
        path = self._manifest_path(key, replica)
        tmp = path + ".tmp"
        try:
            fh = open(tmp, "w")
        except FileNotFoundError:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            fh = open(tmp, "w")
        with fh:
            fh.write(text)
            if self.fsync:
                fh.flush()
                os.fsync(fh.fileno())
        os.replace(tmp, path)  # atomic: readers see old or new, never partial

    @staticmethod
    def _load_manifest_text(path: str) -> str:
        """Read sidecar bytes and decode defensively: scribbled manifests
        can hold arbitrary bytes, and a UnicodeDecodeError here would be a
        crash where the contract promises IntegrityError.  Replacement
        characters fail the strict format checks in ``_parse_manifest``,
        which convicts the replica and lets read-any fail over."""
        with open(path, "rb") as fh:
            return fh.read().decode("utf-8", errors="replace")

    def _parse_manifest(self, key: str, text: str) -> tuple[int, list[int], int]:
        """Parse sidecar text into ``(total, unit CRCs, replication)``.

        Every malformation — truncation, scribbled bytes, a CRC count that
        disagrees with the recorded size — raises :class:`IntegrityError`:
        a manifest that cannot be fully trusted must never yield partial
        data (read-any then tries the next manifest replica).
        """
        lines = text.splitlines()
        try:
            total = int(lines[0])
        except (IndexError, ValueError):
            raise IntegrityError(f"corrupt manifest for {key!r}: bad size line") from None
        if total < 0:
            raise IntegrityError(f"corrupt manifest for {key!r}: negative size")
        crcs: list[int] = []
        repl = 1
        for ln in lines[1:]:
            if not ln:
                continue
            if ln.startswith("#"):
                if ln.startswith("#repl="):
                    try:
                        repl = int(ln[len("#repl="):])
                    except ValueError:
                        raise IntegrityError(
                            f"corrupt manifest for {key!r}: bad replication line"
                        ) from None
                continue
            try:
                crcs.append(int(ln, 16))
            except ValueError:
                raise IntegrityError(f"corrupt manifest for {key!r}: bad CRC line") from None
        expect = (total + self.stripe_bytes - 1) // self.stripe_bytes
        if len(crcs) != expect:
            raise IntegrityError(
                f"corrupt manifest for {key!r}: {len(crcs)} CRCs for {expect} stripe units"
            )
        if not 1 <= repl <= self.n_servers:
            raise IntegrityError(
                f"corrupt manifest for {key!r}: replication {repl} outside [1, {self.n_servers}]"
            )
        return total, crcs, repl

    def _read_manifest(self, key: str) -> tuple[int, list[int], int]:
        """Read-any over the manifest replicas: ``(total, CRCs, repl)``.

        The replica count of an existing object is recorded *inside* the
        manifest, so every server directory is probed — a key written at
        r=2 stays readable when server_00 (the primary manifest home) is
        lost.  A manifest that exists but fails to parse is treated like a
        bad data replica: fail over, and only surface the
        :class:`IntegrityError` when no replica parses.
        """
        last: IntegrityError | None = None
        for j in range(self.n_servers):
            try:
                text = self._load_manifest_text(self._manifest_path(key, j))
            except FileNotFoundError:
                continue
            try:
                parsed = self._parse_manifest(key, text)
            except IntegrityError as exc:
                last = exc
                continue
            if j:
                with self._stats_lock:
                    self.stats.degraded_reads += 1
                self._note_degraded(key)
            return parsed
        if last is not None:
            raise last
        raise BlockNotFound(key)

    def describe(self, key: str) -> tuple[int, str | None]:
        """``(physical size, manifest tag)`` without touching data bytes."""
        last: IntegrityError | None = None
        for j in range(self.n_servers):
            try:
                text = self._load_manifest_text(self._manifest_path(key, j))
            except FileNotFoundError:
                continue
            try:
                total, _, _ = self._parse_manifest(key, text)
            except IntegrityError as exc:
                last = exc
                continue
            lines = text.splitlines()
            tag = next(
                (x[1:] for x in lines[1:] if x.startswith("#") and not x.startswith("#repl=")),
                None,
            )
            return total, tag
        if last is not None:
            raise last
        raise BlockNotFound(key)

    def _read_unit_into(
        self, key: str, unit: int, uln: int, dst: memoryview, crc_want: int, replica: int = 0
    ) -> None:
        """Fill ``dst`` (length ``uln``) from one stripe replica, checking CRC."""
        # Chaos site "pfs.read_unit": a ``bit_flip`` fault rots one byte of
        # this replica *on disk* before the CRC is folded — the manifest
        # convicts the flipped copy now and on every later read (including
        # the scrubber's verification pass) until repair rewrites it.
        flip = None
        if self.chaos is not None:
            spec = self.chaos.at("pfs.read_unit", key=key, unit=unit, replica=replica)
            if spec is not None and spec.kind == "bit_flip":
                flip = spec
        path = self._stripe_path(key, unit, replica)
        crc = 0
        try:
            with open(path, "rb") as fh:
                pos = 0
                while pos < uln:
                    n = fh.readinto(dst[pos : pos + min(self.io_buffer_bytes, uln - pos)])
                    if not n:
                        raise IntegrityError(f"truncated stripe unit {unit} of {key!r}")
                    if flip is not None:
                        dst[pos] ^= 0xFF
                        with open(path, "r+b") as rot:
                            rot.seek(pos)
                            rot.write(bytes(dst[pos : pos + 1]))
                        flip = None
                    crc = zlib.crc32(dst[pos : pos + n], crc)
                    pos += n
        except FileNotFoundError:
            raise IntegrityError(f"missing stripe unit {unit} of {key!r}") from None
        if crc != crc_want:
            raise IntegrityError(
                f"CRC mismatch on stripe unit {unit} of {key!r} (replica {replica})"
            )

    def _read_unit_any(
        self, key: str, unit: int, uln: int, dst: memoryview, crc_want: int, repl: int
    ) -> None:
        """Read-any failover: fill ``dst`` from the first intact replica.

        A replica that is missing, truncated, or CRC-convicted is skipped
        (each failed attempt is fully overwritten by the next — the unit
        read loop always writes all ``uln`` bytes or raises).  Serving from
        a non-primary copy counts one degraded read and pokes
        ``on_degraded`` so the scrubber queues this key for repair.  Every
        replica failing is data loss: the last error surfaces.
        """
        last: IntegrityError | None = None
        for j in range(repl):
            try:
                self._read_unit_into(key, unit, uln, dst, crc_want, replica=j)
            except IntegrityError as exc:
                last = exc
                continue
            if j:
                with self._stats_lock:
                    self.stats.degraded_reads += 1
                self._note_degraded(key)
            return
        assert last is not None
        raise last

    def readinto(
        self, key: str, buf, offset: int = 0, length: int | None = None
    ) -> tuple[int, int | None]:
        """Zero-copy read of ``[offset, offset+length)`` into ``buf``.

        Stripe units are fetched concurrently (one worker per data-node by
        default), each ``readinto``-assembled directly at its position in
        ``buf`` — no intermediate chunk list, no join.  Returns
        ``(bytes_read, whole_object_crc)``; the CRC is combined from the
        verified per-unit CRCs (``crc32_combine``) when the full object was
        read, ``None`` for a partial range.
        """
        t0 = time.perf_counter()
        self._maybe_chaos_server_down()
        out = memoryview(buf)
        with self._key_lock(key):
            total, crcs, repl = self._read_manifest(key)
            end = total if length is None else min(total, offset + length)
            want = max(0, end - offset)
            if len(out) < want:
                raise ValueError(f"buffer too small: {len(out)} < {want}")

            def read_unit(u: tuple[int, int, int]) -> None:
                unit, uoff, uln = u
                if uoff >= offset and uoff + uln <= end:
                    # Fast path: the whole unit lands inside the request —
                    # read it straight into place.
                    self._read_unit_any(key, unit, uln, out[uoff - offset :], crcs[unit], repl)
                else:
                    # Boundary unit: CRC covers the whole unit, so stage it
                    # once, verify, then copy only the overlapping slice.
                    # The staging buffer comes from the tier's pool — ranged
                    # merge/readahead streams hit this path per block, and a
                    # fresh bytearray each time is pure allocator churn.
                    stage = self._buf_pool.acquire(uln)
                    try:
                        self._read_unit_any(key, unit, uln, memoryview(stage), crcs[unit], repl)
                        lo = max(offset - uoff, 0)
                        hi = min(end - uoff, uln)
                        out[uoff + lo - offset : uoff + hi - offset] = stage[lo:hi]
                    finally:
                        self._buf_pool.release(stage)

            units = [u for u in self._iter_units(total) if u[1] + u[2] > offset and u[1] < end]
            self._map_units(read_unit, units)
        t1 = time.perf_counter()
        with self._stats_lock:
            self.stats.record_read(want, t1 - t0, end=t1)
        whole: int | None = None
        if offset == 0 and end == total:
            whole = 0
            for (_, _, ln), crc in zip(units, crcs):
                whole = crc32_combine(whole, crc, ln)
        return want, whole

    def get(self, key: str, offset: int = 0, length: int | None = None) -> bytes:
        # Hold the (reentrant) key lock across sizing AND the read, so a
        # concurrent put growing the key can't invalidate the buffer size
        # between the two manifest reads.
        with self._key_lock(key):
            total, _, _ = self._read_manifest(key)
            end = total if length is None else min(total, offset + length)
            out = self._buf_pool.acquire(max(0, end - offset))
            try:
                self.readinto(key, out, offset, length)
                return bytes(out)
            finally:
                self._buf_pool.release(out)

    def delete(self, key: str) -> bool:
        with self._key_lock(key):
            try:
                total, _, _ = self._read_manifest(key)
            except BlockNotFound:
                return False
            except IntegrityError:
                # No parsable manifest anywhere: fall back to a directory
                # scan so a fully-corrupt key can still be reaped.
                return self._delete_by_scan(key)
            for unit, _, _ in self._iter_units(total):
                for j in range(self.n_servers):
                    try:
                        os.remove(self._stripe_path(key, unit, j))
                    except FileNotFoundError:
                        pass
            for j in range(self.n_servers):
                try:
                    os.remove(self._manifest_path(key, j))
                except FileNotFoundError:
                    pass
            return True

    def _delete_by_scan(self, key: str) -> bool:
        safe = self._safe(key)
        manifest = safe + self.MANIFEST_SUFFIX
        found = False
        for s in range(self.n_servers):
            d = self._server_dir(s)
            try:
                names = os.listdir(d)
            except FileNotFoundError:
                continue
            for name in names:
                if name == manifest or (name.startswith(safe + ".s") and not name.endswith(".tmp")):
                    try:
                        os.remove(os.path.join(d, name))
                        found = True
                    except FileNotFoundError:
                        pass
        return found

    def contains(self, key: str) -> bool:
        return any(
            os.path.exists(self._manifest_path(key, j)) for j in range(self.n_servers)
        )

    def size_of(self, key: str) -> int:
        total, _, _ = self._read_manifest(key)
        return total

    def keys(self) -> list[str]:
        # Manifests replicate across server directories, so scan them all
        # (dedup by key) — a key written at r=2 stays listed when the
        # primary manifest home is a lost server directory.
        out: set[str] = set()
        for s in range(self.n_servers):
            try:
                names = os.listdir(self._server_dir(s))
            except FileNotFoundError:
                continue
            for name in names:
                if name.endswith(self.MANIFEST_SUFFIX):
                    out.add(self._unsafe(name[: -len(self.MANIFEST_SUFFIX)]))
        return sorted(out)

    def server_bytes(self) -> dict[int, int]:
        """On-disk bytes per server directory (load-balance check)."""
        out = {}
        for s in range(self.n_servers):
            d = self._server_dir(s)
            try:
                names = os.listdir(d)
            except FileNotFoundError:
                out[s] = 0
                continue
            total = 0
            for f in names:
                if f.endswith(self.MANIFEST_SUFFIX) or f.endswith(".tmp"):
                    continue
                try:
                    total += os.path.getsize(os.path.join(d, f))
                except FileNotFoundError:
                    pass
            out[s] = total
        return out

    # -- repair ---------------------------------------------------------------

    def verify(self, key: str) -> list[tuple[int, int]]:
        """CRC-check every replica of every stripe unit of ``key``.

        Returns the bad ``(unit, replica)`` pairs without modifying
        anything — the scrubber's detection pass.  Raises
        :class:`BlockNotFound`/:class:`IntegrityError` only when no
        manifest replica is readable at all.
        """
        with self._key_lock(key):
            total, crcs, repl = self._read_manifest(key)
            units = list(self._iter_units(total))

            def check_unit(u: tuple[int, int, int]) -> list[tuple[int, int]]:
                unit, _, ln = u
                bad = []
                stage = self._buf_pool.acquire(ln)
                try:
                    for j in range(repl):
                        try:
                            self._read_unit_into(
                                key, unit, ln, memoryview(stage), crcs[unit], replica=j
                            )
                        except IntegrityError:
                            bad.append((unit, j))
                finally:
                    self._buf_pool.release(stage)
                return bad

            return [b for bads in self._map_units(check_unit, units) for b in bads]

    def repair(self, key: str) -> dict:
        """Rewrite every bad or missing replica of ``key`` from a surviving
        good copy — the failure-model table's "re-replication from
        surviving replicas" row as real code.

        Verifies all ``r`` replicas of every stripe unit (and all manifest
        replicas), rewrites the convicted ones (recreating lost server
        directories), counts ``TierStats.repaired_units``, and returns a
        summary dict.  A unit with **no** intact replica raises
        :class:`IntegrityError` — that is genuine data loss, and the caller
        must not believe the object is healthy.
        """
        t0 = time.perf_counter()
        with self._key_lock(key):
            total, crcs, repl = self._read_manifest(key)
            units = list(self._iter_units(total))

            def fix_unit(u: tuple[int, int, int]) -> int:
                unit, _, ln = u
                stage = self._buf_pool.acquire(ln)
                scratch = self._buf_pool.acquire(ln)
                try:
                    good = None
                    bad: list[int] = []
                    for j in range(repl):
                        dst = memoryview(stage) if good is None else memoryview(scratch)
                        try:
                            self._read_unit_into(key, unit, ln, dst, crcs[unit], replica=j)
                        except IntegrityError:
                            bad.append(j)
                            continue
                        if good is None:
                            good = j
                    if good is None:
                        raise IntegrityError(
                            f"stripe unit {unit} of {key!r}: no intact replica — cannot repair"
                        )
                    src = memoryview(stage)[:ln]
                    for j in bad:
                        with self._open_for_write(self._stripe_path(key, unit, j)) as fh:
                            for b0 in range(0, ln, self.io_buffer_bytes):
                                fh.write(src[b0 : b0 + self.io_buffer_bytes])
                            if self.fsync:
                                fh.flush()
                                os.fsync(fh.fileno())
                    return len(bad)
                finally:
                    self._buf_pool.release(scratch)
                    self._buf_pool.release(stage)

            repaired = sum(self._map_units(fix_unit, units))
            # Manifest replicas heal the same way: copy the first parsable
            # sidecar text over the missing/corrupt ones.
            good_text: str | None = None
            bad_manifests: list[int] = []
            for j in range(repl):
                try:
                    text = self._load_manifest_text(self._manifest_path(key, j))
                    self._parse_manifest(key, text)
                except (FileNotFoundError, IntegrityError):
                    bad_manifests.append(j)
                    continue
                if good_text is None:
                    good_text = text
            for j in bad_manifests:
                assert good_text is not None  # _read_manifest above succeeded
                self._replace_manifest_text(key, j, good_text)
        t1 = time.perf_counter()
        repaired_bytes = 0
        if repaired:
            # Approximate: repaired units are full stripes except a tail.
            repaired_bytes = sum(min(self.stripe_bytes, total) for _ in range(repaired))
        with self._stats_lock:
            self.stats.repaired_units += repaired
            # Verification reads every replica and repair rewrites the bad
            # ones — both land in the ledger so the controller's PFS
            # utilization estimate sees scrub traffic like any other I/O.
            self.stats.record_read(total * repl, t1 - t0, end=t1)
            if repaired or bad_manifests:
                self.stats.record_write(repaired_bytes, t1 - t0, end=t1)
        return {
            "units": len(units),
            "replication": repl,
            "repaired_units": repaired,
            "repaired_manifests": len(bad_manifests),
        }

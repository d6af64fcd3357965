"""Two-level KV cache: a hot device ring + paged, incrementally staged cold
host history — the port of ``repro/serving/kv_offload.py``.

The paper's architecture one level down the hierarchy: *device memory*
plays Tachyon (small, memory-speed, holds the hot working set), *pinned
host memory* plays OrangeFS (large, slower, holds everything).  Eq. 7's
blended read applies with ``f = hot_len / total_len``; the decode path is
the paper's read mode — nearest copy first, fall through to the big tier.

Semantics (as in the JAX package):
* ``append(k, v)`` writes the newest token into the hot ring (in place on
  the device) and queues it for **batched** host write-through; pending
  tokens are flushed in one device-to-host copy once two pages have
  accumulated (or on ``flush_host()``).
* ``stage_cold()`` uploads newly completed cold pages into a device
  staging buffer — each page exactly once, since the history is
  append-only.  The buffer's capacity is a block multiple and grows by
  doubling.  With ``page <= window`` every page is complete before the
  first step that needs it; the capacity tail past ``cold_len`` is masked
  by the kernel.
* ``attend(q)`` runs the ring-aware tiered decode kernel over both tiers
  (``impl="kernel"``: the Hopper kernel on CUDA, its plain version on CPU)
  or the plain version wherever the tensors lie (``impl="plain"``).
* ``host_views()`` returns the flushed history; ``rebuild_hot_from_cold()``
  is the device-loss recovery path.
* Optional third level: constructed with a ``store=`` (a
  :class:`~repro_torch.core.store.TwoLevelStore`), every *completed* cold
  page is also persisted into the store (async write-back) under
  ``<store_prefix>/<name>/page_NNNNNN``, or once per content through a
  :class:`SharedPageRegistry`; the host tier declares itself a
  latency-sensitive stream to the store's I/O controller.
  ``restore_cold_from_store()`` rebuilds the history up to the last
  persisted page after host-memory loss; ``evict_to_store()`` parks an idle
  cache (pages, tail and manifest into the store, every tier freed) and
  ``resume_from_store()`` brings it back bit-identical.

Copies: on the card, the device-to-host flush and the host-to-device
staging move the pinned host tier by direct DMA, one contiguous
``(batch row, kv head)`` run at a time (``copy_runs``), issued on the
current stream without a host wait.  Stream order reads a staged page after
the write-through that filled it, launches ``attend`` after the upload,
and lets the caching allocator reuse a flushed block only after its copy.
The host tier is complete when the host reads it: an event recorded after
each batch of copies is waited on by every host access of ``cold_k`` /
``cold_v`` (store blobs, restores, ``host_views``, the ring rebuild).  On
the CPU the same runs are plain memory copies, done on return.
Overlapping them with compute on a side stream is later work.

The host tier keeps the JAX package's byte layout: ``(B, KV, max_len, D)``
in the cache dtype, pages ``(B, KV, page, D)`` contiguous when cut out,
k before v.  The store's page, tail and manifest files are the JAX
package's too (a page blob is the k bytes of the page followed by its v
bytes), so a history persisted by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading

import torch

from repro_torch.core.sched import StreamClass
from repro_torch.core.store import WriteMode
from repro_torch.kernels import ops, ref
from repro_torch.runtime.trace import span


@dataclasses.dataclass
class TieredKVStats:
    appended: int = 0
    hot_hits_tokens: int = 0
    cold_reads_tokens: int = 0
    bytes_staged: int = 0  # host->device page uploads (each page once)
    pages_staged: int = 0
    bytes_written_through: int = 0  # device->host write-through traffic
    d2h_flushes: int = 0  # batched sync points
    pages_persisted: int = 0  # completed pages written into the store tier
    bytes_persisted: int = 0
    evictions: int = 0  # full evict-to-store cycles (idle session parked)
    resumes: int = 0  # full resume-from-store cycles
    demotions: int = 0  # staging-buffer drops under arbiter pressure
    dma_copies: int = 0  # direct (batch row, kv head) runs to or from the pinned host tier
    host_waits: int = 0  # host accesses of the host tier that waited for its copies

    def hot_fraction(self) -> float:
        """The paper's f = hot / (hot + cold) over all attends so far."""
        total = self.hot_hits_tokens + self.cold_reads_tokens
        return self.hot_hits_tokens / total if total else 1.0


def _tensor_bytes(t: torch.Tensor) -> bytes:
    """The bytes of ``t`` in C order, in its own dtype (bf16 included)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _from_bytes(blob, dtype, shape) -> torch.Tensor:
    """A host tensor over a writable copy of ``blob``, read as ``dtype``."""
    return torch.frombuffer(bytearray(blob), dtype=dtype).reshape(shape)


def copy_runs(dst: torch.Tensor, src: torch.Tensor) -> int:
    """Copy ``src`` into ``dst``, both (B, KV, n, D), one (batch row, kv
    head) run at a time, without waiting.  Each run is contiguous on both
    sides where one side is a token range of the host tier and the other a
    range of the staging buffer or a contiguous block, so a run between the
    device and pinned memory is one DMA.  Returns the runs copied."""
    for dst_b, src_b in zip(dst.unbind(0), src.unbind(0)):
        for d, s in zip(dst_b.unbind(0), src_b.unbind(0)):
            d.copy_(s, non_blocking=True)
    return dst.shape[0] * dst.shape[1]


class SharedPageRegistry:
    """Content-addressed, refcounted cold-page table over one store.

    Sessions sharing a prompt prefix produce bit-identical completed cold
    pages (causal attention: k/v at position *i* depend only on tokens up
    to *i*, and the host tier stores the cache dtype exactly), so pages are
    keyed by content hash and stored **once** across every session.
    ``put`` takes a reference (storing the blob on first sight), ``decref``
    drops one and deletes the blob when the count reaches zero, so a
    retiring session never frees a page another live session still maps.
    Counters are cumulative so the dedup ratio survives sessions retiring.
    """

    def __init__(self, store, prefix: str = "serving/pages") -> None:
        self.store = store
        self.prefix = prefix
        self._lock = threading.Lock()
        self._refs: dict[str, int] = {}
        self.pages_logical = 0  # references handed out (puts + adopts)
        self.pages_stored = 0  # distinct blobs ever written to the store
        self.dedup_hits = 0
        store.hint_stream(prefix + "/", StreamClass.LATENCY)

    def _file(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def put(self, blob: bytes) -> str:
        """Intern a completed page; returns its content key (ref held)."""
        key = hashlib.sha1(blob).hexdigest()
        with self._lock:
            self.pages_logical += 1
            n = self._refs.get(key, 0)
            self._refs[key] = n + 1
            if n:
                self.dedup_hits += 1
                return key
            self.pages_stored += 1

        self.store.put(self._file(key), blob, mode=WriteMode.ASYNC_WRITEBACK)
        return key

    def fetch(self, key: str) -> bytes:
        return self.store.get(self._file(key))

    def adopt(self, keys) -> None:
        """Take references on already-stored pages: the resume path after the
        registry's in-memory refcounts were lost (host restart)."""
        with self._lock:
            for key in keys:
                self.pages_logical += 1
                n = self._refs.get(key, 0)
                self._refs[key] = n + 1
                if n:
                    self.dedup_hits += 1

    def decref(self, key: str) -> bool:
        """Drop one reference; deletes the blob at zero.  Returns whether
        the physical page was deleted."""
        with self._lock:
            n = self._refs.get(key, 0) - 1
            if n > 0:
                self._refs[key] = n
                return False
            self._refs.pop(key, None)
        self.store.delete(self._file(key))
        return True

    def refcount(self, key: str) -> int:
        with self._lock:
            return self._refs.get(key, 0)

    def live_pages(self) -> int:
        with self._lock:
            return len(self._refs)

    def dedup_ratio(self) -> float:
        """Logical page references per physical stored page (at least 1)."""
        return self.pages_logical / self.pages_stored if self.pages_stored else 1.0


class TieredKVCache:
    """Per-layer two-level KV cache for one decoding batch (a full-attention
    layer's: ``sliding`` is False).

    Shapes: k, v tokens are (B, KV, D). Hot ring: (B, KV, W, D) on
    ``device``. Cold tier: a host tensor (B, KV, max_len, D) in the cache
    dtype (pinned when ``device`` is CUDA), staged to the device in
    immutable ``page``-token pages; reading ``cold_k`` / ``cold_v`` first
    waits for the copies in flight to or from it.  ``store`` / ``pages``
    add the durable third level (see the module note).
    """

    sliding = False

    def __init__(
        self,
        batch: int,
        kv_heads: int,
        head_dim: int,
        window: int,
        max_len: int,
        dtype=torch.bfloat16,
        page: int | None = None,
        device="cuda",
        impl: str = "kernel",
        store=None,
        store_prefix: str = "serving/kv",
        name: str = "kv0",
        pages: SharedPageRegistry | None = None,
    ):
        if window <= 0 or max_len < window:
            raise ValueError("need 0 < window <= max_len")
        page = min(window, 512) if page is None else page
        if not 0 < page <= window:
            # page <= window guarantees a cold page is complete (and
            # flushable) before the first token it holds leaves the ring.
            raise ValueError("need 0 < page <= window")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.batch, self.kv, self.dim = batch, kv_heads, head_dim
        self.window, self.max_len, self.page = window, max_len, page
        self.dtype = dtype
        self.device = torch.device(device)
        self.impl = impl
        # Device staging buffer: paged capacity, a _block_k multiple (the
        # JAX kernel's streaming block), grown by doubling.
        self._block_k = page if page % 8 == 0 else 8 * (-(-page // 8))
        # On the card, an event re-recorded after each batch of copies to or
        # from the pinned host tier; host readers wait on it.
        self._host_event = torch.cuda.Event() if self.device.type == "cuda" else None
        self._host_pending = False  # copies issued that the host has not waited for
        self._alloc_tiers()
        self._pending_k: list[torch.Tensor] = []  # (B, KV, n, D) blocks awaiting
        self._pending_v: list[torch.Tensor] = []  # batched host write-through
        self._flushed = 0  # tokens on the host tier
        self.length = 0
        self.stats = TieredKVStats()
        # Optional store-backed third level.  With a SharedPageRegistry,
        # completed pages are content-addressed and refcounted (shared
        # across sessions); tail and manifest stay private under this
        # cache's own store directory.
        if pages is not None and store is None:
            store = pages.store
        self._store = store
        self._store_dir = f"{store_prefix}/{name}"
        self._persisted_pages = 0
        self._pages = pages
        self._page_keys: list[str] = []
        self._arb_pool = None
        self._closed = False
        if store is not None:
            store.hint_stream(store_prefix + "/", StreamClass.LATENCY)

    def _alloc_tiers(self) -> None:
        """Allocate every tier empty: the hot ring and the staging buffer on
        the device, the host tier pinned when the device is CUDA.  Also the
        resume path after a full eviction freed them."""
        b, kv, d = self.batch, self.kv, self.dim
        self.hot_k = torch.zeros((b, kv, self.window, d), dtype=self.dtype, device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        pin = self.device.type == "cuda"
        self._cold_k = torch.zeros((b, kv, self.max_len, d), dtype=self.dtype, pin_memory=pin)
        self._cold_v = torch.zeros((b, kv, self.max_len, d), dtype=self.dtype, pin_memory=pin)
        self._cap = self._block_k
        self._cold_k_dev = self._zeros_dev(self._cap)
        self._cold_v_dev = self._zeros_dev(self._cap)
        self._staged_pages = 0  # completed pages valid in the staging buffer

    def _zeros_dev(self, tokens: int) -> torch.Tensor:
        return torch.zeros((self.batch, self.kv, tokens, self.dim), dtype=self.dtype, device=self.device)

    @property
    def cold_k(self) -> torch.Tensor | None:
        """The host tier's k, (B, KV, max_len, D), complete for the host."""
        self._await_host()
        return self._cold_k

    @property
    def cold_v(self) -> torch.Tensor | None:
        self._await_host()
        return self._cold_v

    def _await_host(self) -> None:
        """Wait for the direct copies in flight to or from the host tier."""
        if self._host_pending:
            self._host_event.synchronize()
            self._host_pending = False
            self.stats.host_waits += 1

    def _copy_host(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """One copy between the device and the host tier, in direct runs.
        On the card each run is one DMA to or from the pinned tier, and the
        host waits later, where it reads."""
        runs = copy_runs(dst, src)
        if self._host_event is None:  # on the CPU the copies are done on return
            return
        self.stats.dma_copies += runs
        self._host_event.record(torch.cuda.current_stream(self.device))  # the stream the copies ran on
        self._host_pending = True

    def attach_arbiter(self, arbiter, min_bytes: int = 0, weight: float = 1.0, name: str = "kv_staging"):
        """Register the host KV history as pool ``name`` (latency class) of an
        elastic :class:`~repro_torch.core.arbiter.MemoryArbiter`.

        The pool floors to live usage: decode needs every appended token's
        host copy, so the arbiter may route idle headroom elsewhere but never
        asks this pool to shed held bytes.  Usage grows with the decoded
        length; demand is the full ``max_len`` history.  :meth:`close`
        deregisters the pool, so a retired session returns its bytes.
        """
        per_token = 2 * self.batch * self.kv * self.dim * self.dtype.itemsize
        pool = arbiter.register(
            name,
            cls="latency",
            min_bytes=min_bytes,
            weight=weight,
            initial_bytes=per_token * self.max_len,
            floor_to_usage=True,
        )

        def value_fn() -> float:
            pool.note_used(per_token * self.length)
            pool.note_demand(per_token * self.max_len)
            return 16.0 * weight

        pool.value_fn = value_fn
        self._arb_pool = pool
        return pool

    # ------------------------------------------------------- store offload

    def _page_file(self, p: int) -> str:
        return f"{self._store_dir}/page_{p:06d}"

    def _tail_file(self) -> str:
        return f"{self._store_dir}/tail"

    def _manifest_file(self) -> str:
        return f"{self._store_dir}/manifest"

    def _write_manifest(self, tail: int = 0) -> None:
        """Persist the page map: ordered content keys (registry mode), page
        geometry, and after an eviction the tail length, so a resume restores
        the exact logical length, not just the durable page boundary."""
        man: dict = {"page": self.page, "pages": self._persisted_pages, "length": self.length, "tail": tail}
        if self._pages is not None:
            man["keys"] = self._page_keys
        self._store.put(self._manifest_file(), json.dumps(man).encode(), mode=WriteMode.ASYNC_WRITEBACK)

    def _read_manifest(self) -> dict:
        if self._store.exists(self._manifest_file()):
            return json.loads(self._store.get(self._manifest_file()))
        return {}

    def _span_blob(self, lo: int, hi: int) -> bytes:
        """Tokens [lo, hi) of the host tier as stored: k bytes, then v bytes."""
        return _tensor_bytes(self.cold_k[:, :, lo:hi]) + _tensor_bytes(self.cold_v[:, :, lo:hi])

    def _load_span(self, lo: int, hi: int, blob: bytes) -> None:
        """Copy a k-then-v blob of tokens [lo, hi) into the host tier."""
        shape = (self.batch, self.kv, hi - lo, self.dim)
        per = len(blob) // 2
        self.cold_k[:, :, lo:hi].copy_(_from_bytes(blob[:per], self.dtype, shape))
        self.cold_v[:, :, lo:hi].copy_(_from_bytes(blob[per:], self.dtype, shape))

    def _persist_pages(self) -> None:
        """Write newly completed (immutable) cold pages into the store, each
        exactly once, async write-back: through the registry by content hash,
        or under this cache's private ``page_NNNNNN`` name."""
        full = self._flushed // self.page
        new = full > self._persisted_pages
        for p in range(self._persisted_pages, full):
            blob = self._span_blob(p * self.page, (p + 1) * self.page)
            if self._pages is not None:
                self._page_keys.append(self._pages.put(blob))
            else:
                self._store.put(self._page_file(p), blob, mode=WriteMode.ASYNC_WRITEBACK)
            self.stats.pages_persisted += 1
            self.stats.bytes_persisted += len(blob)
        self._persisted_pages = full
        if new and self._pages is not None:
            self._write_manifest()

    def _restore_pages(self) -> int:
        """Refill cold pages from the store; returns tokens restored.  Clamped
        at this cache's capacity, so a store written by a longer history
        cannot walk the restore past ``max_len``."""
        max_pages = self.max_len // self.page
        if self._pages is not None:
            keys = list(self._read_manifest().get("keys", []))[:max_pages]
            fresh = not self._page_keys  # this handle held no refs yet
            for p, key in enumerate(keys):
                self._load_span(p * self.page, (p + 1) * self.page, self._pages.fetch(key))
            self._page_keys = keys
            if fresh and keys:
                self._pages.adopt(keys)
            p = len(keys)
        else:
            p = 0
            while p < max_pages and self._store.exists(self._page_file(p)):
                self._load_span(p * self.page, (p + 1) * self.page, self._store.get(self._page_file(p)))
                p += 1
        self._persisted_pages = p
        return p * self.page

    def restore_cold_from_store(self, rebuild_hot: bool = True) -> int:
        """Host-memory loss recovery: refill the cold history from the store.

        Restores every persisted page in order (the durable prefix: tokens
        past the last completed page were never persisted), resets the
        cache's logical state to that prefix (length included), and by
        default rebuilds the hot ring.  Returns the restored length."""
        if self._store is None:
            raise RuntimeError("no store attached to restore from")
        if self._cold_k is None:
            self._alloc_tiers()
        n = self._restore_pages()
        self._pending_k, self._pending_v = [], []
        self._flushed = n
        self.length = n
        self._staged_pages = 0  # staging buffer contents presumed stale
        if rebuild_hot and n:
            self.rebuild_hot_from_cold()
        return n

    # ----------------------------------------------- session evict / resume

    def evict_to_store(self) -> int:
        """Park the cache in the store: persist every completed page *and*
        the partial tail, then free all three tiers.  Eviction is exact:
        ``resume_from_store`` restores the cache bit-identically at its full
        length, so a parked session holds no device or host memory.
        Returns the parked length in tokens."""
        if self._store is None:
            raise RuntimeError("no store attached to evict into")
        if self._cold_k is None:
            return self.length  # already parked

        self.flush_host()  # drains pending + persists completed pages
        tail_lo = self._persisted_pages * self.page
        tail_n = self.length - tail_lo
        if tail_n > 0:
            self._store.put(self._tail_file(), self._span_blob(tail_lo, self.length),
                            mode=WriteMode.ASYNC_WRITEBACK)
        self._write_manifest(tail=tail_n)
        self.stats.evictions += 1
        self._free_tiers()
        return self.length

    def resume_from_store(self) -> int:
        """Un-park an evicted cache: reallocate the tiers (the host tier
        pinned again), restore every page plus the tail, and rebuild the hot
        ring on the device, bit-identical to the state before the eviction.
        Returns the restored length."""
        if self._store is None:
            raise RuntimeError("no store attached to resume from")
        expect = self.length
        if self._cold_k is None:
            self._alloc_tiers()
        n = self._restore_pages()
        tail_n = int(self._read_manifest().get("tail", 0))
        if tail_n > 0 and self._store.exists(self._tail_file()):
            self._load_span(n, n + tail_n, self._store.get(self._tail_file()))
            n += tail_n
        self._pending_k, self._pending_v = [], []
        self._flushed = n
        self.length = n
        self._staged_pages = 0
        if n:
            self.rebuild_hot_from_cold()
        self.stats.resumes += 1
        if expect and n != expect:
            raise RuntimeError(f"resume restored {n} tokens, expected {expect}")
        return n

    def drop_staging(self) -> int:
        """Demotion under arbiter pressure: shrink the device staging buffer
        back to one block.  The next ``attend`` re-stages the pages it needs
        from the host tier (paying the H2D bytes again).  Returns the device
        bytes freed."""
        if self._cold_k_dev is None:
            return 0
        if self._cap == self._block_k and self._staged_pages == 0:
            return 0
        before = self.staged_device_bytes()
        self._cap = self._block_k
        self._cold_k_dev = self._zeros_dev(self._cap)
        self._cold_v_dev = self._zeros_dev(self._cap)
        self._staged_pages = 0
        self.stats.demotions += 1
        return before - self.staged_device_bytes()

    def close(self, delete_store_files: bool = True) -> None:
        """Retire the cache: release its arbiter pool, drop its references on
        shared pages (deleting any that reach zero), delete its private store
        files, and free every tier.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._arb_pool is not None:
            self._arb_pool.release()
            self._arb_pool = None
        if self._pages is not None:
            for key in self._page_keys:
                self._pages.decref(key)
            self._page_keys = []
        if self._store is not None and delete_store_files:
            if self._pages is None:
                for p in range(self._persisted_pages):
                    self._store.delete(self._page_file(p))
            self._store.delete(self._tail_file())
            self._store.delete(self._manifest_file())
        self._free_tiers()

    def _free_tiers(self) -> None:
        self.hot_k = self.hot_v = None
        self._cold_k = self._cold_v = None  # the host allocator frees pinned blocks after their copies
        self._host_pending = False
        self._cold_k_dev = self._cold_v_dev = None
        self._pending_k, self._pending_v = [], []
        self._cap = 0
        self._staged_pages = 0

    # ------------------------------------------------------------- append

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one token (B, KV, D): hot ring slot + queued write-through."""
        self.append_block(k[:, :, None, :], v[:, :, None, :])

    def append_block(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write S tokens (B, KV, S, D) — the prefill bulk path."""
        s = k.shape[2]
        if self._cold_k is None:
            raise RuntimeError("cache is evicted/closed; resume before appending")
        if self.length + s > self.max_len:
            raise ValueError("cache full")
        w = self.window
        k = k.to(self.dtype)
        v = v.to(self.dtype)
        n = min(s, w)  # only the last `w` tokens can be in the ring
        slots = torch.remainder(torch.arange(self.length + s - n, self.length + s, device=self.device), w)
        self.hot_k[:, :, slots] = k[:, :, s - n:]
        self.hot_v[:, :, slots] = v[:, :, s - n:]
        self._pending_k.append(k)
        self._pending_v.append(v)
        self.length += s
        self.stats.appended += s
        if self.length - self._flushed >= 2 * self.page:
            self.flush_host()

    # -------------------------------------------------------------- tiers

    @property
    def cold_len(self) -> int:
        """Tokens served from the cold tier: the page-aligned boundary
        covering everything already evicted from the hot ring."""
        evicted = self.length - self.window
        if evicted <= 0:
            return 0
        return -(-evicted // self.page) * self.page  # ceil to a page

    @property
    def hot_len(self) -> int:
        return self.length - self.cold_len

    @property
    def ring_newest(self) -> int:
        """Hot-ring slot of the most recent token."""
        return (self.length - 1) % self.window

    def host_views(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The written-through history [0, length) as host tensors."""
        self.flush_host()
        n = self.length
        return self.cold_k[:, :, :n, :], self.cold_v[:, :, :n, :]

    def flush_host(self) -> None:
        """Batched write-through: one device-to-host copy for all pending
        tokens, issued without a wait; the host tier is complete for every
        host access of ``cold_k`` / ``cold_v``, which waits for it."""
        if not self._pending_k:
            return
        with span("kv.flush"):
            ks = torch.cat(self._pending_k, dim=2)
            vs = torch.cat(self._pending_v, dim=2)
            self._pending_k, self._pending_v = [], []
            n = ks.shape[2]
            start = self._flushed
            if start + n != self.length:
                raise RuntimeError("pending run out of sync with the cache length")
            self._copy_host(self._cold_k[:, :, start : start + n], ks)
            self._copy_host(self._cold_v[:, :, start : start + n], vs)
            self._flushed = self.length
            self.stats.d2h_flushes += 1
            self.stats.bytes_written_through += 2 * ks.numel() * ks.element_size()
            if self._store is not None:
                self._persist_pages()

    def _ensure_capacity(self, tokens: int) -> None:
        if tokens <= self._cap:
            return
        cap = self._cap
        while cap < tokens:
            cap *= 2  # doubling: O(log T) reallocations over a decode
        cap = min(cap, -(-self.max_len // self._block_k) * self._block_k)
        for name in ("_cold_k_dev", "_cold_v_dev"):
            grown = self._zeros_dev(cap)
            grown[:, :, : self._cap] = getattr(self, name)
            setattr(self, name, grown)
        self._cap = cap

    def stage_cold(self) -> None:
        """Upload newly completed cold pages host-to-device — each exactly
        once (append-only history makes completed pages immutable)."""
        need = self.cold_len // self.page
        if need <= self._staged_pages:
            return
        self.flush_host()  # pages to stage are complete, so flushable now
        self._ensure_capacity(need * self.page)
        lo, hi = self._staged_pages * self.page, need * self.page
        self._copy_host(self._cold_k_dev[:, :, lo:hi], self._cold_k[:, :, lo:hi])  # the H2D copies
        self._copy_host(self._cold_v_dev[:, :, lo:hi], self._cold_v[:, :, lo:hi])
        self.stats.pages_staged += need - self._staged_pages
        self.stats.bytes_staged += 2 * self.batch * self.kv * (hi - lo) * self.dim * self.dtype.itemsize
        self._staged_pages = need

    # ------------------------------------------------------------- attend

    def attend(self, q: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        """Tiered decode attention for q (B, H, 1, D) over both tiers.

        The hot ring goes to the kernel as stored (decode softmax is
        permutation-invariant, so the ring rotation is position arithmetic
        inside the kernel).  ``impl`` overrides the cache's own setting:
        ``"kernel"`` goes through ``ops.tiered_decode_attention`` (the Hopper
        kernel on CUDA, its plain version on CPU), ``"plain"`` runs the plain
        version on the tensors where they lie.
        """
        if self.length == 0:
            raise ValueError("attend on an empty cache")
        if self._cold_k is None:
            raise RuntimeError("cache is evicted/closed; resume before attending")
        impl = impl or self.impl
        self.stage_cold()
        hot_n, cold_n = self.hot_len, self.cold_len
        self.stats.hot_hits_tokens += hot_n
        self.stats.cold_reads_tokens += cold_n
        fn = ops.tiered_decode_attention if impl == "kernel" else ref.tiered_ring_attention_ref
        return fn(q.to(self.dtype).contiguous(), self.hot_k, self.hot_v, self._cold_k_dev, self._cold_v_dev,
                  hot_n, cold_n, self.ring_newest)

    # ----------------------------------------------------------- recovery

    def rebuild_hot_from_cold(self) -> None:
        """Device loss: reconstruct the hot ring from the host tier (one
        vectorised gather, dtype-preserving); the staging buffer is marked
        unstaged so the next attend re-uploads the needed pages."""
        self.flush_host()
        n = min(self.length, self.window)
        pos = torch.arange(self.length - n, self.length)
        ring_k = torch.zeros((self.batch, self.kv, self.window, self.dim), dtype=self.dtype)
        ring_v = torch.zeros_like(ring_k)
        ring_k[:, :, pos % self.window] = self.cold_k[:, :, pos]
        ring_v[:, :, pos % self.window] = self.cold_v[:, :, pos]
        self.hot_k = ring_k.to(self.device)
        self.hot_v = ring_v.to(self.device)
        self._staged_pages = 0  # staging buffer presumed lost with the device

    # --------------------------------------------------------- accounting

    def hot_device_bytes(self) -> int:
        if self.hot_k is None:  # evicted/closed: the ring is freed
            return 0
        return 2 * self.batch * self.kv * self.window * self.dim * self.dtype.itemsize

    def staged_device_bytes(self) -> int:
        return 2 * self.batch * self.kv * self._cap * self.dim * self.dtype.itemsize

    def device_bytes(self) -> int:
        return self.hot_device_bytes() + self.staged_device_bytes()

    def host_bytes(self) -> int:
        if self._cold_k is None:  # evicted/closed: the host tier is freed
            return 0
        return 2 * self.batch * self.kv * self.max_len * self.dim * self.dtype.itemsize


class SlidingKVRing:
    """A sliding-window layer's KV for one decoding batch: a device ring of
    the layer's ``window`` slots and nothing else.  A window layer's query
    reads only the last ``window`` keys, so no host tier, staging buffer or
    store stands behind the ring: what leaves it is never read again.

    It has the surface of ``TieredKVCache`` that the layer code and the
    session plane (``SessionKVBatch``) touch: ``append`` / ``append_block``
    (the prefill's last ``window`` tokens) write ring slots; ``attend``
    reads them for a batch whose rows share one length; ``hot_len``,
    ``cold_len`` (always 0) and ``ring_newest`` are the tiered kernels'
    lengths, with an empty one-block staging buffer as their cold operand.
    Query ``p`` sees keys ``(p - window, p]``, the window layers' mask.
    """

    sliding = True
    _EMPTY = 8  # the cold operand's capacity: one block, never read

    def __init__(self, batch: int, kv_heads: int, head_dim: int, window: int, dtype=torch.bfloat16,
                 device="cuda", impl: str = "kernel"):
        if window <= 0:
            raise ValueError("need window > 0")
        if impl not in ("kernel", "plain"):
            raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
        self.batch, self.kv, self.dim, self.window = batch, kv_heads, head_dim, window
        self.dtype, self.device, self.impl = dtype, torch.device(device), impl
        self.hot_k = torch.zeros((batch, kv_heads, window, head_dim), dtype=dtype, device=self.device)
        self.hot_v = torch.zeros_like(self.hot_k)
        self._cold_k_dev = torch.zeros((batch, kv_heads, self._EMPTY, head_dim), dtype=dtype, device=self.device)
        self._cold_v_dev = self._cold_k_dev
        self.length = 0
        self.stats = TieredKVStats()

    cold_len = 0

    @property
    def hot_len(self) -> int:
        return min(self.length, self.window)

    @property
    def ring_newest(self) -> int:
        return (self.length - 1) % self.window

    def stage_cold(self) -> None:
        """Nothing to stage: the ring is the whole cache."""

    def append(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write one token (B, KV, D) into its slot."""
        slot = self.length % self.window
        self.hot_k[:, :, slot] = k.to(self.dtype)
        self.hot_v[:, :, slot] = v.to(self.dtype)
        self.length += 1
        self.stats.appended += 1

    def append_block(self, k: torch.Tensor, v: torch.Tensor) -> None:
        """Write S tokens (B, KV, S, D): only the last ``window`` land."""
        s, w = k.shape[2], self.window
        n = min(s, w)
        slots = torch.remainder(torch.arange(self.length + s - n, self.length + s, device=self.device), w)
        self.hot_k[:, :, slots] = k[:, :, s - n:].to(self.dtype)
        self.hot_v[:, :, slots] = v[:, :, s - n:].to(self.dtype)
        self.length += s
        self.stats.appended += s

    def attend(self, q: torch.Tensor, impl: str | None = None) -> torch.Tensor:
        """Decode attention for q (B, H, 1, D) over the ring: the tiered
        decode op with no cold part (``"kernel"``), or its plain version
        (``"plain"``); ``impl`` overrides the ring's own setting."""
        if self.length == 0:
            raise ValueError("attend on an empty ring")
        if self.hot_k is None:
            raise RuntimeError("the ring is closed")
        fn = ops.tiered_decode_attention if (impl or self.impl) == "kernel" else ref.tiered_ring_attention_ref
        with span("kv.ring"):
            return fn(q.to(self.dtype).contiguous(), self.hot_k, self.hot_v, self._cold_k_dev, self._cold_v_dev,
                      self.hot_len, 0, self.ring_newest)

    def device_bytes(self) -> int:
        if self.hot_k is None:
            return 0
        return self.batch * self.kv * (2 * self.window + self._EMPTY) * self.dim * self.dtype.itemsize

    def close(self) -> None:
        """Free the ring.  Idempotent."""
        self.hot_k = self.hot_v = self._cold_k_dev = self._cold_v_dev = None

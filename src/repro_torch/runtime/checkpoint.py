"""Two-level checkpointing over the TwoLevelStore — the port of
``repro/runtime/checkpoint.py``, writing the same bytes.

This is the paper's architecture applied to training state (DESIGN.md §2,
row L1): the fast path writes the checkpoint into the compute-host memory
tier (Tachyon analogue — memory-speed, survives process restart only if
the tier outlives the process); durability comes from the PFS tier.

* ``mode="sync"``  — paper write mode (c): synchronous write-through.
  ``save()`` returns only after PFS stripes + CRCs are on disk.
* ``mode="async"`` — beyond-paper: ``save()`` snapshots the leaves off
  device (a device-to-host copy of each tensor) and returns; serialization and store puts
  run on a background thread, and the store's own write-back flushers
  drain to the PFS tier behind that.  The training critical path pays
  only the device→host copy.  ``wait_until_durable()`` is the barrier.

Checkpoint layout inside the store (atomic-commit protocol, DESIGN.md §6)::

    ckpt/<tag>/step_00000042/chunk_0000   packed leaf bytes, ~chunk_bytes each
    ckpt/<tag>/step_00000042/chunk_0001   ...
    ckpt/<tag>/step_00000042/manifest     JSON: chunk sizes + keypath ->
                                          {shape, dtype, chunk, offset, size}
    ckpt/<tag>/step_00000042/COMMIT       written last; restore only sees
                                          committed steps

Chunks are written with one batched ``put_many`` (every block of every
chunk in flight on the store's pool together) and restored with ranged
reads: a leaf is fetched via ``get_range(chunk, offset, size)``, so a
restore that needs only part of a chunk — or an elastic
``restore_sharded`` filling a template subset — moves only the bytes it
asks for.  Whole chunks whose every leaf is needed come back through one
batched ``get_many``.

Restore takes a **template tree** (a train state of the right shapes) and
fills leaves by keypath, each on its template leaf's device: the stored
arrays are full logical arrays.  ``restore_sharded`` places each leaf on a
``DeviceMesh`` instead (elastic restore: the mesh need not be the one that
saved it), and a save of DTensor leaves stores their full logical arrays.
Under a process group of more than one rank ``save`` is collective: every
rank gathers the full leaves, global rank 0 alone writes them, and all
ranks leave together, so the bytes are those of a one-process save.

bfloat16 leaves, which numpy lacks, are stored as their 16-bit patterns
under the dtype name ``"bfloat16"`` (numpy's name for it where ml_dtypes
is loaded, as in the JAX package), so such checkpoints too cross between
the packages.

Leaves are named as ``jax.tree_util.keystr`` names them and packed in jax's
flattening order (``repro_torch.tree``), with numpy's dtype strings, so for
the same state the manifest and every chunk are the same bytes in both
packages and a checkpoint written by one restores in the other.  A model's
params go in as the reference lays them out
(``nn.module.to_reference_layout``).
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.sched import StreamClass
from repro_torch.core.store import TwoLevelStore, WriteMode
from repro_torch.tree import flatten_with_path, keystr, map_with_path

PyTree = Any

#: Default packed-chunk target size.  Big enough that PFS striping wins,
#: small enough that several chunks are in flight per checkpoint and a
#: partial restore skips real bytes.
DEFAULT_CHUNK_BYTES = 16 * 2**20


def _flatten_with_names(tree: PyTree) -> list[tuple[str, Any]]:
    return [(keystr(p), v) for p, v in flatten_with_path(tree)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and its manifest dtype name: tensors are
    copied off their device (a DTensor gathered whole first), bfloat16 as
    its bit pattern."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy(), "bfloat16"
        leaf = leaf.cpu().numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_array(raw: bytes, meta: dict) -> np.ndarray:
    """A stored leaf's bytes as a host array (bfloat16 as its bit pattern)."""
    dtype = np.int16 if meta["dtype"] == "bfloat16" else np.dtype(meta["dtype"])
    return np.frombuffer(raw, dtype=dtype).reshape(meta["shape"])


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    t = torch.from_numpy(arr.copy())
    return t.view(torch.bfloat16) if dtype_name == "bfloat16" else t


def _like(arr: np.ndarray, dtype_name: str, leaf):
    """A restored array, placed as its template leaf is: a tensor on the
    leaf's device, or a host array."""
    if isinstance(leaf, torch.Tensor):
        return _tensor(arr, dtype_name).to(leaf.device)
    return arr.copy().view(np.dtype(dtype_name))


def _is_writer() -> bool:
    """Global rank 0, or no process group at all."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _pack_chunks(
    named: list[tuple[str, np.ndarray, str]], chunk_bytes: int
) -> tuple[dict[str, dict], list[bytes]]:
    """Greedy-pack leaf bytes into ~``chunk_bytes`` chunks, in leaf order.

    Every leaf lands whole inside exactly one chunk (an oversized leaf
    gets a chunk of its own), so restore can fetch it with a single
    ranged read.  Returns (manifest leaves, chunk blobs).
    """
    leaves: dict[str, dict] = {}
    chunks: list[bytes] = []
    parts: list[bytes] = []
    filled = 0

    def flush() -> None:
        nonlocal parts, filled
        if parts:
            chunks.append(b"".join(parts))
            parts = []
            filled = 0

    for name, arr, dtype_name in named:
        raw = np.ascontiguousarray(arr).tobytes()
        if filled and filled + len(raw) > chunk_bytes:
            flush()
        leaves[name] = {
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "chunk": len(chunks),
            "offset": filled,
            "size": len(raw),
        }
        parts.append(raw)
        filled += len(raw)
        if filled >= chunk_bytes:
            flush()
    flush()
    return leaves, chunks


class CheckpointManager:
    """Save/restore train-state pytrees through the two-level store."""

    def __init__(
        self,
        store: TwoLevelStore,
        tag: str = "default",
        mode: str = "sync",
        keep_last: int = 3,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    ) -> None:
        if mode not in ("sync", "async", "memory_only"):
            raise ValueError(f"mode must be sync/async/memory_only, got {mode!r}")
        if chunk_bytes <= 0:
            raise ValueError("chunk_bytes must be positive")
        self.store = store
        self.tag = tag
        self.mode = mode
        self.keep_last = keep_last
        self.chunk_bytes = chunk_bytes
        # Stream intent for the adaptive controller: checkpoints are write
        # bursts that are read back only on restore — under capacity
        # contention their write-through skips the memory tier instead of
        # evicting the training working set (DESIGN.md §10).
        store.hint_stream(f"ckpt/{tag}/", StreamClass.WRITE_BURST)
        # One background lane: saves serialize+put off the critical path but
        # still land in submission order (COMMIT order == save order).
        self._bg = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt-save")
        self._pending: list[Future] = []
        self._pending_lock = threading.Lock()
        #: wall seconds save() spent on the caller's critical path, per save
        self.save_critical_s: list[float] = []
        # Elastic-arbiter staging ledger (DESIGN.md §13): host bytes of
        # async-save snapshots still queued/serializing on the lane.
        self._inflight_bytes = 0
        self._arb_pool = None

    # -------------------------------------------------------------- naming

    def _prefix(self, step: int) -> str:
        return f"ckpt/{self.tag}/step_{step:08d}"

    def _write_mode(self) -> WriteMode:
        return {
            "sync": WriteMode.WRITE_THROUGH,
            "async": WriteMode.ASYNC_WRITEBACK,
            "memory_only": WriteMode.MEMORY_ONLY,
        }[self.mode]

    # ---------------------------------------------------------------- save

    def save(self, step: int, state: PyTree) -> None:
        """Store one checkpoint; commit marker written last.

        Sync/memory_only: fully synchronous.  Async: the device→host leaf
        snapshot happens here (the only part that must see consistent
        training state); chunk packing and store puts run on the
        background lane and ``save`` returns immediately.

        Under a process group of more than one rank every rank calls it:
        each gathers the full leaves, rank 0 alone writes them, and all
        wait at a barrier before returning.
        """
        t0 = time.perf_counter()
        named = [(name, *_to_host(leaf)) for name, leaf in _flatten_with_names(state)]
        if _is_writer():
            self._put(step, named)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        self.save_critical_s.append(time.perf_counter() - t0)

    def _put(self, step: int, named: list[tuple[str, np.ndarray, str]]) -> None:
        """Write the snapshot ``named``: now, or on the background lane."""
        if self.mode != "async":
            self._serialize_and_put(step, named)
            return
        # Surface failures of already-finished saves without blocking on
        # the one still in flight — the critical path stays snapshot-only.
        self._join_pending(wait=False)
        nbytes = sum(a.nbytes for _, a, _ in named)
        if self._arb_pool is not None:
            with self._pending_lock:
                over = self._inflight_bytes + nbytes > max(
                    self._arb_pool.budget, nbytes
                )
            if over:
                # Staging budget exhausted: drain the lane before
                # snapshotting another copy — the arbiter throttles
                # async staging instead of letting it balloon.
                self._join_pending(wait=True)
        with self._pending_lock:
            self._inflight_bytes += nbytes
        fut = self._bg.submit(self._bg_save, step, named, nbytes)
        with self._pending_lock:
            self._pending.append(fut)

    def _bg_save(self, step: int, named: list[tuple[str, np.ndarray, str]], nbytes: int) -> None:
        try:
            self._serialize_and_put(step, named)
        finally:
            with self._pending_lock:
                self._inflight_bytes = max(0, self._inflight_bytes - nbytes)

    def attach_arbiter(self, arbiter, min_bytes: int = 0, weight: float = 1.0):
        """Register async-save staging as pool ``"ckpt_staging"``
        (WRITE_BURST) of an elastic
        :class:`~repro_torch.core.arbiter.MemoryArbiter` (DESIGN.md §13).

        The pool floors to live usage — a snapshot mid-serialize cannot be
        dropped — and when in-flight snapshot bytes exceed the budget the
        next async :meth:`save` drains the lane before copying more.
        """
        pool = arbiter.register(
            "ckpt_staging",
            cls="write_burst",
            min_bytes=min_bytes,
            weight=weight,
            floor_to_usage=True,
        )

        def value_fn() -> float:
            with self._pending_lock:
                held = self._inflight_bytes
            pool.note_used(held)
            pool.note_demand(max(held, pool.min_bytes))
            return 2.0 * weight

        pool.value_fn = value_fn
        self._arb_pool = pool
        return pool

    def _serialize_and_put(self, step: int, named: list[tuple[str, np.ndarray, str]]) -> None:
        leaves, chunks = _pack_chunks(named, self.chunk_bytes)
        manifest = {"chunks": [len(c) for c in chunks], "leaves": leaves}
        mode = self._write_mode()
        prefix = self._prefix(step)
        batch = {f"{prefix}/chunk_{i:04d}": blob for i, blob in enumerate(chunks)}
        batch[f"{prefix}/manifest"] = json.dumps(manifest).encode()
        self.store.put_many(batch, mode=mode)
        # Commit marker LAST: a crash mid-save leaves an uncommitted step
        # that restore ignores and gc() reaps.
        self.store.put(f"{prefix}/COMMIT", str(len(chunks)).encode(), mode=mode)
        self.gc()

    def _join_pending(self, wait: bool = True) -> None:
        """Re-raise background save failures; optionally block on completion."""
        with self._pending_lock:
            pending = list(self._pending)
        done: list[Future] = []
        for fut in pending:
            if wait or fut.done():
                fut.result()  # re-raises a background failure here
                done.append(fut)
        with self._pending_lock:
            self._pending = [f for f in self._pending if f not in done]

    def wait_until_durable(self) -> None:
        """Barrier: all saves are serialized AND on the PFS tier."""
        self._join_pending()
        self.store.drain()

    # ------------------------------------------------------------- restore

    def steps(self, committed_only: bool = True) -> list[int]:
        self._join_pending()
        return self._steps_impl(committed_only)

    def _steps_impl(self, committed_only: bool = True) -> list[int]:
        """steps() without the pending-save join (safe on the save lane)."""
        base = f"ckpt/{self.tag}/"
        steps = set()
        committed = set()
        for name in self.store.list_files():
            if not name.startswith(base):
                continue
            rest = name[len(base) :]
            if "/" not in rest:
                continue
            stepdir, leafname = rest.split("/", 1)
            if not stepdir.startswith("step_"):
                continue
            try:
                s = int(stepdir[len("step_") :])
            except ValueError:
                continue  # stray debris under ckpt/<tag>/ — not a step dir
            steps.add(s)
            if leafname == "COMMIT":
                committed.add(s)
        return sorted(committed if committed_only else steps)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: int | None = None) -> tuple[int, PyTree]:
        """Fill ``template``'s leaves from the checkpoint at ``step`` (or latest),
        each on its template leaf's device (tensors) or on the host (arrays).

        Only the chunks holding the template's leaves are touched: chunks
        needed in full arrive via one batched ``get_many``; a chunk needed
        partially is read leaf-by-leaf with ``get_range`` — restore byte
        traffic follows the template, not the checkpoint.
        """
        return self._restore(template, step, lambda path, leaf, arr, dtype_name: _like(arr, dtype_name, leaf))

    def restore_sharded(self, template: PyTree, shardings: PyTree, step: int | None = None) -> tuple[int, PyTree]:
        """Elastic restore: place each leaf with its (possibly new) sharding.

        ``shardings`` is a tree of ``nn.module.NamedSharding`` over the
        template's structure (``launch.steps.state_shardings``).  Because
        checkpoints hold full logical arrays, the target mesh may have
        another size than the one that saved them: every rank restores each
        full leaf through the ranged reads of ``restore`` into host memory
        and copies only its own block of it to its device
        (``NamedSharding.shard``), as the reference's ``device_put`` from
        the host moves each device's shard; nothing is sent between ranks.
        Template leaves may be meta tensors; chunks not referenced by the
        template are never read.
        """
        by_name = {keystr(p): sh for p, sh in flatten_with_path(shardings)}

        def place(path, leaf, arr, dtype_name):
            sh = by_name[keystr(path)]
            block = sh.local_slices(arr.shape)
            return sh.wrap(_tensor(arr[block] if block else arr, dtype_name), arr.shape)

        return self._restore(template, step, place)

    def _restore(self, template: PyTree, step: int | None, place) -> tuple[int, PyTree]:
        """``restore`` with ``place(path, template leaf, host array, dtype
        name)`` making each restored leaf."""
        self._join_pending()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no committed checkpoint under tag {self.tag!r}")
        prefix = self._prefix(step)
        manifest = json.loads(self.store.get(f"{prefix}/manifest").decode())
        if "leaves" not in manifest or "chunks" not in manifest:
            # Pre-chunked monolithic layout (flat keypath -> {offset,size,...}
            # manifest + one `leaves` blob) from an older run on the same
            # PFS root — still restorable.
            return step, self._restore_legacy(prefix, manifest, template, step, place)
        leaves_meta: dict[str, dict] = manifest["leaves"]
        chunk_sizes: list[int] = manifest["chunks"]

        named = _flatten_with_names(template)
        missing = [name for name, _ in named if name not in leaves_meta]
        if missing:
            raise KeyError(
                f"checkpoint step {step} has no leaf {missing[0]!r}; "
                f"template/checkpoint structure mismatch"
            )

        by_chunk: dict[int, int] = {}
        for name, _ in named:
            meta = leaves_meta[name]
            by_chunk[meta["chunk"]] = by_chunk.get(meta["chunk"], 0) + meta["size"]
        full = sorted(c for c, need in by_chunk.items() if need == chunk_sizes[c])
        blobs = dict(
            zip(full, self.store.get_many([f"{prefix}/chunk_{c:04d}" for c in full]))
        )
        # Leaves in partially-needed chunks: fan the ranged reads out over a
        # transient pool so they pipeline on the store like get_many does,
        # instead of one blocking round trip per leaf inside tree_map.
        partial = [
            (name, leaves_meta[name])
            for name, _ in named
            if leaves_meta[name]["chunk"] not in blobs
        ]
        ranged: dict[str, bytes] = {}
        if partial:
            with ThreadPoolExecutor(
                max_workers=min(8, len(partial)), thread_name_prefix="ckpt-restore"
            ) as pool:
                for (name, _), raw in zip(
                    partial,
                    pool.map(
                        lambda m: self.store.get_range(
                            f"{prefix}/chunk_{m['chunk']:04d}", m["offset"], m["size"]
                        ),
                        [m for _, m in partial],
                    ),
                ):
                    ranged[name] = raw

        def fill(path, leaf):
            name = keystr(path)
            meta = leaves_meta[name]
            c = meta["chunk"]
            if c in blobs:
                raw = blobs[c][meta["offset"] : meta["offset"] + meta["size"]]
            else:
                raw = ranged[name]
            arr = _host_array(raw, meta)
            want = getattr(leaf, "shape", None)
            if want is not None and tuple(want) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch for {name!r}: checkpoint {arr.shape} vs template {want}"
                )
            return place(path, leaf, arr, meta["dtype"])

        restored = map_with_path(fill, template)
        return step, restored

    def _restore_legacy(self, prefix: str, manifest: dict, template: PyTree, step: int, place) -> PyTree:
        """Fill a template from the pre-chunked monolithic-blob layout."""
        def fill(path, leaf):
            name = keystr(path)
            try:
                meta = manifest[name]
            except KeyError:
                raise KeyError(
                    f"checkpoint step {step} has no leaf {name!r}; "
                    f"template/checkpoint structure mismatch"
                ) from None
            raw = self.store.get_range(f"{prefix}/leaves", meta["offset"], meta["size"])
            arr = _host_array(raw, meta)
            want = getattr(leaf, "shape", None)
            if want is not None and tuple(want) != tuple(arr.shape):
                raise ValueError(
                    f"shape mismatch for {name!r}: checkpoint {arr.shape} vs template {want}"
                )
            return place(path, leaf, arr, meta["dtype"])

        return map_with_path(fill, template)

    # ----------------------------------------------------------------- gc

    def gc(self) -> None:
        """Delete all but the newest ``keep_last`` committed checkpoints,
        plus any uncommitted debris older than the newest commit."""
        # _steps_impl, not steps(): gc runs *on* the background save lane,
        # and joining the lane from itself would deadlock.
        committed = self._steps_impl(committed_only=True)
        doomed = set(committed[: -self.keep_last]) if self.keep_last > 0 else set()
        if committed:
            newest = committed[-1]
            for s in self._steps_impl(committed_only=False):
                if s < newest and s not in committed:
                    doomed.add(s)  # crashed, uncommitted save
        if not doomed:
            return
        # COMMIT first: if gc dies midway the leftover is uncommitted
        # debris (reaped next round), never a committed-but-gutted step.
        prefixes = tuple(self._prefix(s) + "/" for s in sorted(doomed))
        for s in sorted(doomed):
            self.store.delete(f"{self._prefix(s)}/COMMIT")
        for name in self.store.list_files():  # one listing pass for all steps
            if name.startswith(prefixes):
                self.store.delete(name)

    def close(self) -> None:
        self._join_pending()
        self._bg.shutdown(wait=True)

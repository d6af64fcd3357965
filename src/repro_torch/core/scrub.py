"""Background integrity scrubber for the replicated PFS tier.

DESIGN.md §15.  :class:`Scrubber` is the online half of the self-healing
cold tier: it walks the tier's manifests, CRC-verifies every replica of
every stripe unit (``PFSTier.repair`` — which also *rewrites* the
convicted or missing copies from a surviving good one), and services a
repair queue fed by the read path's degraded-read hook, so a key that
just failed over gets healed ahead of the next full pass.

Two pacing mechanisms keep foreground p99 bounded while the scrubber
runs — the acceptance gate in ``benchmarks/repair_scaling.py`` measures
exactly this:

* **Lane gate** — at most one object is scrubbed at a time, through the
  controller's ``scrub_gate`` (an :class:`~repro_torch.core.sched.AdaptiveGate`,
  the SCRUB stream class's I/O lane).
* **Utilization pacing** — between objects the scrubber sleeps
  ``controller.scrub_pause_s``, which the controller tick retunes off the
  PFS pool's busy fraction (idle → scrub flat out, saturated → back off),
  the same signal that sizes flush lanes.

The scrubber is deliberately store-agnostic: it needs only the
``PFSTier`` surface (``keys``/``repair``/``on_degraded``).  The
distributed layer composes it with a ``filter_fn`` that partitions key
ownership by lease — each file is scrubbed by exactly one host — and an
``on_repair`` callback that publishes repair events on the gossip board
(``core/dstore.py``).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from repro_torch.core.tiers import BlockNotFound, IntegrityError

__all__ = ["Scrubber", "ScrubStats"]


@dataclasses.dataclass
class ScrubStats:
    passes: int = 0  # completed full walks of the manifest set
    keys_scanned: int = 0
    keys_repaired: int = 0  # keys where repair rewrote >= 1 replica
    units_repaired: int = 0  # stripe-unit replicas rewritten
    manifests_repaired: int = 0
    queue_repairs: int = 0  # keys healed via the degraded-read queue
    lost_objects: int = 0  # keys with some unit beyond repair (data loss)
    errors: int = 0  # unexpected failures (key skipped, scrub lives on)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Scrubber:
    """Walks PFS manifests in the background, verifying and re-replicating.

    Parameters
    ----------
    pfs:
        The :class:`~repro_torch.core.tiers.PFSTier` to scrub.  The scrubber
        installs itself as the tier's ``on_degraded`` hook so degraded
        reads enqueue an out-of-band repair.
    controller:
        Optional :class:`~repro_torch.core.sched.IOController`; when present the
        scrubber runs inside its ``scrub_gate`` and paces itself by
        ``scrub_pause_s``.  Without one it paces by ``pause_s``.
    interval_s:
        Idle time between full passes of the background thread.
    filter_fn:
        Optional ``key -> bool`` ownership predicate — the distributed
        layer's lease partition.  Keys it rejects are skipped entirely
        (some other host scrubs them).
    on_repair:
        Optional ``(key, result_dict) -> None`` called after a repair that
        actually rewrote something (gossip/telemetry hook).  Exceptions
        are swallowed.
    """

    def __init__(
        self,
        pfs,
        controller=None,
        interval_s: float = 5.0,
        filter_fn=None,
        on_repair=None,
        pause_s: float = 0.0,
    ) -> None:
        self.pfs = pfs
        self.controller = controller
        self.interval_s = interval_s
        self.filter_fn = filter_fn
        self.on_repair = on_repair
        self.pause_s = pause_s
        self.stats = ScrubStats()
        self._stats_lock = threading.Lock()
        self._queue: deque[str] = deque()
        self._queued: set[str] = set()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._pass_lock = threading.Lock()  # one scrub pass at a time
        # Bind once: ``self.enqueue`` makes a fresh bound-method object on
        # every attribute access, so stop()'s identity check below needs a
        # stable reference to know the installed hook is still ours.
        self._hook = self.enqueue
        pfs.on_degraded = self._hook

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="pfs-scrub")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if getattr(self.pfs, "on_degraded", None) is self._hook:
            self.pfs.on_degraded = None

    def __enter__(self) -> "Scrubber":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- queue

    def enqueue(self, key: str) -> None:
        """Queue an out-of-band repair (the degraded-read hook).  Deduped;
        the background thread services the queue ahead of full passes."""
        with self._stats_lock:
            if key in self._queued:
                return
            self._queued.add(key)
            self._queue.append(key)
        self._wake.set()

    def _drain_queue(self) -> int:
        healed = 0
        while not self._stop.is_set():
            with self._stats_lock:
                if not self._queue:
                    break
                key = self._queue.popleft()
                self._queued.discard(key)
            if self._repair_key(key, from_queue=True):
                healed += 1
        return healed

    # ----------------------------------------------------------------- scrub

    def scrub_once(self) -> dict:
        """One full pass: drain the repair queue, then verify-and-repair
        every owned key.  Returns a summary dict; callable directly by
        tests/operators whether or not the background thread runs."""
        with self._pass_lock:
            queue_healed = self._drain_queue()
            scanned = repaired = 0
            for key in self.pfs.keys():
                if self._stop.is_set():
                    break
                if self.filter_fn is not None and not self.filter_fn(key):
                    continue
                scanned += 1
                if self._repair_key(key):
                    repaired += 1
                self._pace()
            with self._stats_lock:
                self.stats.passes += 1
                self.stats.keys_scanned += scanned
        return {"scanned": scanned, "repaired": repaired, "queue_healed": queue_healed}

    def scrub_until_clean(self, max_passes: int = 8) -> int:
        """Run full passes until one finds nothing to repair (the
        "fully repaired" signal the acceptance gate waits on).  Returns
        the number of passes run; raises after ``max_passes`` dirty
        passes — repairs that never converge mean new damage is landing
        faster than the scrubber heals it, and callers should know."""
        for i in range(1, max_passes + 1):
            out = self.scrub_once()
            if out["repaired"] == 0 and out["queue_healed"] == 0:
                return i
        raise IntegrityError(f"scrub did not converge after {max_passes} passes")

    def _repair_key(self, key: str, from_queue: bool = False) -> bool:
        gate = self.controller.scrub_gate if self.controller is not None else None
        try:
            if gate is not None:
                with gate:
                    result = self.pfs.repair(key)
            else:
                result = self.pfs.repair(key)
        except BlockNotFound:
            return False  # deleted between listing and repair — fine
        except IntegrityError:
            # Some unit has no intact replica: genuine data loss.  Count it
            # and keep scrubbing — the rest of the namespace still heals.
            with self._stats_lock:
                self.stats.lost_objects += 1
            return False
        except Exception:
            with self._stats_lock:
                self.stats.errors += 1
            return False
        healed = bool(result["repaired_units"] or result["repaired_manifests"])
        with self._stats_lock:
            self.stats.units_repaired += result["repaired_units"]
            self.stats.manifests_repaired += result["repaired_manifests"]
            if healed:
                self.stats.keys_repaired += 1
                if from_queue:
                    self.stats.queue_repairs += 1
        if healed and self.on_repair is not None:
            try:
                self.on_repair(key, result)
            except Exception:
                pass  # telemetry must not stall repair
        return healed

    def _pace(self) -> None:
        pause = self.pause_s
        if self.controller is not None:
            self.controller.maybe_tick()
            pause = max(pause, self.controller.scrub_pause_s)
        if pause > 0:
            self._stop.wait(pause)

    # ------------------------------------------------------------ background

    def _loop(self) -> None:
        while not self._stop.is_set():
            # Degraded-read repairs jump the queue: service them as they
            # arrive instead of waiting out the full-pass interval.
            self._wake.wait(self.interval_s)
            if self._stop.is_set():
                return
            if self._wake.is_set():
                self._wake.clear()
                self._drain_queue()
                continue
            try:
                self.scrub_once()
            except Exception:
                with self._stats_lock:
                    self.stats.errors += 1

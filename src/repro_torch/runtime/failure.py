"""Failure detection and injection for the resilient data plane.

At 1000+ nodes, node failure is routine: the driver must (1) notice —
heartbeat timeout; (2) recover — restore the last committed two-level
checkpoint (memory-tier hit = seconds; PFS fallback = read mode (f));
(3) continue, possibly elastically on fewer hosts.  This module provides
the detection/injection machinery; the training loop lives in
``launch/train.py`` and the distributed-store recovery paths in
``core/dstore.py``.

Two injectors:

* :class:`FailureInjector` — the original step-counted host-loss
  injector (raise at configured step numbers, once each).
* :class:`ChaosInjector` — site-addressable fault injection
  (DESIGN.md §12).  Production code is threaded with named *sites*
  (``peer.request``, ``pfs.write_unit``, ``registry.renew``,
  ``lease.takeover.locked``, ...); an armed :class:`FaultSpec` matches
  sites by ``fnmatch`` pattern and fires deterministically from a
  seeded RNG.  With no injector attached every hook is a
  ``None``-check — zero cost on the hot path.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import threading
import time
from typing import Callable


class SimulatedFailure(RuntimeError):
    """Raised by the FailureInjector to emulate a host/device loss."""

    def __init__(self, step: int, kind: str = "host-loss") -> None:
        super().__init__(f"simulated {kind} at step {step}")
        self.step = step
        self.kind = kind


class InjectedFault(ConnectionError):
    """Raised at transport sites for ``drop``/``error`` faults — an
    ``OSError`` subclass so the production retry paths handle it exactly
    like a real socket failure."""


@dataclasses.dataclass
class FaultSpec:
    """One armed fault: *where* (site pattern), *what* (kind), *when*
    (probability / visit window / firing budget), and kind parameters.

    Kinds understood by the instrumented sites:

    * ``delay`` — sleep ``delay_s`` (+ uniform ``jitter_s``) at the site.
    * ``drop`` / ``error`` — the site fails as if the transport broke
      (socket closed, connect refused).
    * ``torn_write`` — a PFS stripe write lands only the first ``frac``
      of its bytes; raises unless ``silent`` (silent leaves the
      corruption for the CRC manifest to catch on read).
    * ``heartbeat_pause`` — the registry skips this renew tick (``count``
      consecutive firings ≈ a pause of ``count * ttl/3``).
    * ``corrupt`` — scribble garbage over the file the site just wrote
      (lease-file corruption).
    * ``bit_flip`` — rot one byte of the stripe replica being read, *on
      disk*, before its CRC is folded (site ``pfs.read_unit``): the
      manifest convicts the copy on this and every later read until the
      repair path rewrites it.
    * ``server_down`` — remove one PFS server directory wholesale (site
      ``pfs.server_down``; ``where={"server": k}`` picks the victim) —
      a lost data node that replicated reads and scrubber
      re-replication must survive.
    * ``crash`` — raise :class:`SimulatedFailure` at the site, emulating
      process death at that exact point (e.g. mid-takeover with the
      sidecar lock held).
    """

    site: str
    kind: str
    prob: float = 1.0  # per-visit firing probability (seeded RNG)
    count: int | None = None  # max firings (None = unlimited)
    after: int = 0  # skip the first ``after`` matching visits
    delay_s: float = 0.0
    jitter_s: float = 0.0
    frac: float = 0.5  # torn write: fraction of bytes that land
    silent: bool = False  # torn write: corrupt without raising
    where: dict = dataclasses.field(default_factory=dict)  # ctx subset filter
    # -- bookkeeping (mutated under the injector lock) --
    visits: int = 0
    fired: int = 0


class ChaosInjector:
    """Deterministic, seedable, site-addressable fault injection.

    Call sites invoke ``injector.at("site.name", **ctx)``; the injector
    matches armed specs in order (``fnmatch`` on the site name, ``where``
    must be a subset of ``ctx``), applies probability / visit-window /
    budget bookkeeping under a lock, and returns the fired spec (or
    ``None``).  ``delay`` faults sleep inline; ``crash`` faults raise
    :class:`SimulatedFailure`; all other kinds are returned for the site
    to apply its transport-specific action.

    Determinism: firing decisions come from one seeded ``random.Random``
    consumed in call order — a single-threaded fault schedule replays
    exactly; concurrent schedules are deterministic per-site when specs
    use visit windows (``after``/``count``) rather than probabilities.
    """

    def __init__(self, faults: list[FaultSpec] | None = None, seed: int = 0) -> None:
        self._faults: list[FaultSpec] = list(faults or [])
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.history: list[tuple[str, str]] = []  # (site, kind) per firing

    def arm(self, site: str, kind: str, **kw) -> FaultSpec:
        spec = FaultSpec(site=site, kind=kind, **kw)
        with self._lock:
            self._faults.append(spec)
        return spec

    @classmethod
    def from_specs(cls, specs: list[str], seed: int = 0) -> "ChaosInjector":
        """Parse CLI fault strings: ``site:kind[,key=value,...]`` — e.g.
        ``peer.request:delay,prob=0.2,delay_s=0.05``.

        Keys that are not :class:`FaultSpec` fields become ``where``
        context filters (int-valued when they look like ints), so a
        victim can be named from the CLI:
        ``pfs.server_down:server_down,server=1,count=1``.
        """
        inj = cls(seed=seed)
        for s in specs:
            head, _, tail = s.partition(",")
            site, _, kind = head.partition(":")
            kw: dict = {}
            for item in filter(None, tail.split(",")):
                k, _, v = item.partition("=")
                field = FaultSpec.__dataclass_fields__.get(k)
                if field is None:
                    try:
                        val: object = int(v)
                    except ValueError:
                        val = v
                    kw.setdefault("where", {})[k] = val
                    continue
                field_type = field.type
                if field_type.startswith("bool"):
                    kw[k] = v.lower() in ("1", "true", "yes")
                elif field_type.startswith("int"):
                    kw[k] = int(v)
                else:
                    kw[k] = float(v)
            inj.arm(site, kind, **kw)
        return inj

    def at(self, site: str, **ctx) -> FaultSpec | None:
        """Fault hook: returns the fired spec (``delay`` already applied,
        ``crash`` raises), or ``None`` when nothing fires here."""
        fired: FaultSpec | None = None
        with self._lock:
            for spec in self._faults:
                if not fnmatch.fnmatch(site, spec.site):
                    continue
                if spec.where and any(ctx.get(k) != v for k, v in spec.where.items()):
                    continue
                spec.visits += 1
                if spec.visits <= spec.after:
                    continue
                if spec.count is not None and spec.fired >= spec.count:
                    continue
                if spec.prob < 1.0 and self._rng.random() >= spec.prob:
                    continue
                spec.fired += 1
                self.history.append((site, spec.kind))
                fired = spec
                break
        if fired is None:
            return None
        if fired.delay_s or fired.jitter_s:
            with self._lock:
                jit = self._rng.uniform(0.0, fired.jitter_s) if fired.jitter_s else 0.0
            time.sleep(fired.delay_s + jit)
        if fired.kind == "crash":
            raise SimulatedFailure(fired.fired, kind=f"chaos:{site}")
        return fired

    def fired_count(self, site: str | None = None, kind: str | None = None) -> int:
        with self._lock:
            return sum(
                1
                for s, k in self.history
                if (site is None or fnmatch.fnmatch(s, site)) and (kind is None or k == kind)
            )


class FailureInjector:
    """Deterministically injects failures at configured steps (once each).

    Thread-safe: ``maybe_fail`` may race between the training loop and
    watcher threads (heartbeat stall handlers re-checking the same step);
    claim-and-record happens under a lock so one configured step can
    never inject twice.
    """

    def __init__(self, fail_at_steps: dict[int, str] | list[int] | None = None) -> None:
        if fail_at_steps is None:
            fail_at_steps = {}
        if isinstance(fail_at_steps, list):
            fail_at_steps = {s: "host-loss" for s in fail_at_steps}
        self._pending = dict(fail_at_steps)
        self._lock = threading.Lock()
        self.injected: list[SimulatedFailure] = []

    def maybe_fail(self, step: int) -> None:
        with self._lock:
            kind = self._pending.pop(step, None)
            if kind is None:
                return
            failure = SimulatedFailure(step, kind)
            self.injected.append(failure)
        raise failure


class Heartbeat:
    """Liveness monitor: the training loop beats once per step; a watcher
    thread flags a stall if no beat arrives within ``timeout_s``.

    On real clusters the watcher would fence the job and trigger reschedule;
    here it invokes ``on_stall`` (tests hook this) and keeps watching.
    """

    def __init__(self, timeout_s: float = 30.0, on_stall: Callable[[float], None] | None = None) -> None:
        self.timeout_s = timeout_s
        self.on_stall = on_stall
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._stalls = 0
        self._thread: threading.Thread | None = None

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()

    @property
    def stalls(self) -> int:
        return self._stalls

    def age(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    def start(self) -> "Heartbeat":
        def watch() -> None:
            while not self._stop.wait(min(self.timeout_s / 4.0, 0.5)):
                age = self.age()
                if age > self.timeout_s:
                    self._stalls += 1
                    if self.on_stall is not None:
                        self.on_stall(age)
                    self.beat()  # re-arm; repeated stalls re-fire
        self._thread = threading.Thread(target=watch, daemon=True, name="heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

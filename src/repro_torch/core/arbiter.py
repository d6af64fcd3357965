"""One elastic memory arbiter for every byte pool in the process.

DESIGN.md §13.  Before this module, four independent budgets competed
for the same physical RAM: the store's memory tier, the data pipeline's
slab cache, the serving KV staging buffers, and the shuffle sort buffer
— each sized at construction and frozen, so a shuffle storm thrashed
the PFS tier while the slab cache sat on idle bytes.  The arbiter is the
paper's Eq. 7 logic applied *across* pools: memory goes where the
marginal MB/s per byte is highest right now.

Protocol: each pool :meth:`registers <MemoryArbiter.register>` with a
stream class, a floor, a weight, and optionally a marginal-value
callback; it reports usage/demand/hits/misses as it runs, and receives
budget changes through an ``on_resize`` callback.  The
:class:`~repro_torch.core.sched.IOController` calls :meth:`rebalance` from its
plan tick, so reallocation follows the same cadence — and the same
measured ν/q/f inputs — as the rest of the control plane.

Reallocation is a value-proportional water-fill with **hysteresis**:

* marginal value = ``value_fn()`` if the pool gave one, else a class-rank
  base (LATENCY ≫ SEQ_REUSE ≫ DEFAULT ≫ WRITE_BURST ≫ SEQ_ONCE) scaled
  by the pool's weight and its recent miss rate — a pool that is missing
  is starved, a pool that never misses is over-provisioned;
* with a controller attached, a pool whose class runs under its Eq. 7
  plan target ``f`` gets a 2× boost (the model says those bytes pay);
* budgets move at most ``hysteresis_frac`` of the total per tick per
  pool, and moves under ~1% of total are skipped — no thrash;
* floors are honored (``min_bytes``, and live usage for pools flagged
  ``floor_to_usage`` — KV staging must never be told to shrink below
  what it already holds).

The arbiter never allocates memory itself; it only retargets budgets.
Pools apply a shrink by evicting at their own pace (the store's memory
tier evicts through its normal victim path, the slab cache drops LRU
slabs), so a transient overshoot is allowed and self-corrects.
"""

from __future__ import annotations

import threading
from typing import Callable

__all__ = ["MemoryArbiter", "MemoryPool"]

#: Class-rank base values: relative MB/s a resident byte of each class
#: buys, per DESIGN.md §10's admission ordering.
_CLASS_BASE = {
    "latency": 16.0,
    "seq_reuse": 8.0,
    "default": 4.0,
    "write_burst": 2.0,
    "seq_once": 1.0,
}


class MemoryPool:
    """One registered byte pool (handle held by the client subsystem)."""

    def __init__(
        self,
        arbiter: "MemoryArbiter",
        name: str,
        cls: str,
        min_bytes: int,
        weight: float,
        budget: int,
        value_fn: Callable[[], float] | None,
        on_resize: Callable[[int], None] | None,
        floor_to_usage: bool,
    ) -> None:
        self._arbiter = arbiter
        self.name = name
        self.cls = cls
        self.min_bytes = min_bytes
        self.weight = weight
        self.budget = budget
        self.value_fn = value_fn
        self.on_resize = on_resize
        self.floor_to_usage = floor_to_usage
        self.used = 0
        self.demand = budget  # high-water demand signal; caps growth
        self.hits = 0
        self.misses = 0
        self._last_hits = 0
        self._last_misses = 0

    # --- client-side reporting (cheap; no lock — single-writer counters) ---

    def note_used(self, nbytes: int) -> None:
        self.used = max(0, int(nbytes))

    def note_demand(self, nbytes: int) -> None:
        self.demand = max(self.min_bytes, int(nbytes))

    def note_hit(self, n: int = 1) -> None:
        self.hits += n

    def note_miss(self, n: int = 1) -> None:
        self.misses += n

    def floor(self) -> int:
        return max(self.min_bytes, self.used if self.floor_to_usage else 0)

    def miss_rate(self) -> float:
        """Miss fraction since the previous rebalance tick."""
        h = self.hits - self._last_hits
        m = self.misses - self._last_misses
        return m / (h + m) if (h + m) > 0 else 0.0

    def _tick(self) -> None:
        self._last_hits = self.hits
        self._last_misses = self.misses

    def release(self) -> None:
        """Deregister (client shut down); its bytes return to the pot.

        Idempotent, and a no-op if a *newer* pool has since reclaimed the
        name: releasing a stale handle must never evict its successor.
        """
        self._arbiter._release(self)


class MemoryArbiter:
    """Elastic budget assignment across registered pools."""

    def __init__(
        self,
        total_bytes: int,
        hysteresis_frac: float = 0.125,
        deadband_frac: float = 0.01,
    ) -> None:
        if total_bytes <= 0:
            raise ValueError("total_bytes must be positive")
        self.total_bytes = int(total_bytes)
        self.hysteresis_frac = hysteresis_frac
        self.deadband_frac = deadband_frac
        self._lock = threading.Lock()
        self._pools: dict[str, MemoryPool] = {}
        self.rebalances = 0
        self.bytes_moved = 0
        self.releases = 0  # pools retired (session/cache close must hit this)

    # ------------------------------------------------------------ registry

    def register(
        self,
        name: str,
        cls: str = "default",
        min_bytes: int = 0,
        weight: float = 1.0,
        initial_bytes: int | None = None,
        value_fn: Callable[[], float] | None = None,
        on_resize: Callable[[int], None] | None = None,
        floor_to_usage: bool = False,
    ) -> MemoryPool:
        """Register a pool; returns its handle.

        ``initial_bytes`` defaults to an equal share of the total.  The
        first rebalance after registration redistributes for real.
        """
        with self._lock:
            if name in self._pools:
                raise ValueError(f"pool {name!r} already registered")
            if initial_bytes is None:
                initial_bytes = self.total_bytes // (len(self._pools) + 1)
            pool = MemoryPool(
                self, name, cls, int(min_bytes), float(weight),
                max(int(min_bytes), int(initial_bytes)),
                value_fn, on_resize, floor_to_usage,
            )
            self._pools[name] = pool
            return pool

    def _release(self, pool: MemoryPool) -> None:
        with self._lock:
            if self._pools.get(pool.name) is pool:
                del self._pools[pool.name]
                self.releases += 1

    def pools(self) -> dict[str, MemoryPool]:
        with self._lock:
            return dict(self._pools)

    # ----------------------------------------------------------- rebalance

    def _marginal_value(self, pool: MemoryPool, under_target: set[str]) -> float:
        if pool.value_fn is not None:
            try:
                v = float(pool.value_fn())
            except Exception:
                v = 0.0
            base = max(v, 1e-6)
        else:
            base = _CLASS_BASE.get(pool.cls, _CLASS_BASE["default"]) * pool.weight
            base *= 1.0 + 4.0 * pool.miss_rate()
        if pool.cls in under_target:
            base *= 2.0  # the Eq. 7 plan says this class's bytes pay off
        return base

    def rebalance(self, controller=None) -> dict[str, int]:
        """One arbitration tick: retarget every pool's budget.

        ``controller`` (an :class:`~repro_torch.core.sched.IOController`) marks
        classes running under their planned ``f`` for the model boost.
        Returns the new budgets.  ``on_resize`` callbacks run outside the
        lock (they may evict, which may call back into clients).
        """
        under_target: set[str] = set()
        if controller is not None:
            try:
                for cls, cs in controller.class_stats.items():
                    if cs.footprint_bytes and cs.measured_f() < 0.9 * cs.target_f:
                        under_target.add(cls.value)
            except Exception:
                pass
        notify: list[tuple[Callable[[int], None], int]] = []
        with self._lock:
            pools = list(self._pools.values())
            if not pools:
                return {}
            self.rebalances += 1
            values = {p.name: self._marginal_value(p, under_target) for p in pools}
            floors = {p.name: min(p.floor(), self.total_bytes) for p in pools}
            # Demand-capped: a pool never gets more than it has asked for
            # (plus slack headroom), so idle pools shed bytes to busy ones.
            caps = {
                p.name: max(floors[p.name], min(self.total_bytes, int(p.demand * 1.25)))
                for p in pools
            }
            target = dict(floors)
            remaining = self.total_bytes - sum(floors.values())
            # Water-fill the surplus value-proportionally, re-offering any
            # overflow past a pool's cap to the still-open pools.
            open_pools = [p.name for p in pools if caps[p.name] > target[p.name]]
            for _ in range(len(pools) + 1):
                if remaining <= 0 or not open_pools:
                    break
                vsum = sum(values[n] for n in open_pools)
                if vsum <= 0:
                    break
                spill = 0
                still_open = []
                for n in open_pools:
                    give = int(remaining * values[n] / vsum)
                    room = caps[n] - target[n]
                    take = min(give, room)
                    target[n] += take
                    spill += give - take
                    if caps[n] > target[n]:
                        still_open.append(n)
                # Whatever integer rounding left over joins the spill.
                spill += remaining - sum(
                    int(remaining * values[n] / vsum) for n in open_pools
                )
                remaining = spill
                open_pools = still_open
            if remaining > 0 and open_pools:
                target[open_pools[0]] += remaining
            # Hysteresis: bounded, deadbanded moves toward the target.
            max_move = max(1, int(self.total_bytes * self.hysteresis_frac))
            deadband = int(self.total_bytes * self.deadband_frac)
            out = {}
            for p in pools:
                want = max(floors[p.name], target[p.name])
                delta = want - p.budget
                if abs(delta) <= deadband and p.budget >= floors[p.name]:
                    out[p.name] = p.budget
                    p._tick()
                    continue
                step = max(-max_move, min(max_move, delta))
                new = max(floors[p.name], p.budget + step)
                if new != p.budget:
                    self.bytes_moved += abs(new - p.budget)
                    p.budget = new
                    if p.on_resize is not None:
                        notify.append((p.on_resize, new))
                out[p.name] = p.budget
                p._tick()
        for cb, budget in notify:
            try:
                cb(budget)
            except Exception:
                pass  # a failing client must not kill the control plane
        return out

    def report(self) -> dict:
        with self._lock:
            return {
                "total_bytes": self.total_bytes,
                "rebalances": self.rebalances,
                "bytes_moved": self.bytes_moved,
                "releases": self.releases,
                "pools": {
                    p.name: {
                        "cls": p.cls,
                        "budget": p.budget,
                        "used": p.used,
                        "demand": p.demand,
                        "miss_rate": round(p.miss_rate(), 4),
                    }
                    for p in self._pools.values()
                },
            }

"""Straggler detection and shard-rebalance mitigation.

In a synchronous data-parallel step, the slowest host sets the step time.
The monitor keeps an EWMA of per-host step durations and flags hosts whose
duration exceeds the cross-host median by ``threshold`` MADs (robust
z-score).  Mitigation rebalances data-loader work: flagged hosts get a
proportionally smaller slice of the global batch (weights renormalized),
the exact counterpart of the paper's load-balance concern for PFS servers
(Section 3.1) applied to compute hosts.
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict


@dataclasses.dataclass
class StragglerReport:
    step: int
    medians: float
    flagged: dict[int, float]  # host -> robust z-score
    weights: dict[int, float]  # suggested work weights (sum == n_hosts)


class StepTimeMonitor:
    def __init__(self, n_hosts: int, alpha: float = 0.3, threshold: float = 3.5, min_steps: int = 3) -> None:
        if n_hosts <= 0:
            raise ValueError("n_hosts must be positive")
        self.n_hosts = n_hosts
        self.alpha = alpha
        self.threshold = threshold
        self.min_steps = min_steps
        self._ewma: dict[int, float] = {}
        self._count: dict[int, int] = defaultdict(int)
        self._step = 0

    def record(self, host_times: dict[int, float]) -> StragglerReport:
        """Record one synchronous step's per-host durations; return analysis."""
        self._step += 1
        for h, t in host_times.items():
            if h < 0 or h >= self.n_hosts:
                raise ValueError(f"host {h} out of range")
            prev = self._ewma.get(h)
            self._ewma[h] = t if prev is None else self.alpha * t + (1 - self.alpha) * prev
            self._count[h] += 1
        return self.analyze()

    def analyze(self) -> StragglerReport:
        vals = sorted(self._ewma.values())
        if not vals:
            return StragglerReport(self._step, 0.0, {}, {h: 1.0 for h in range(self.n_hosts)})
        median = vals[len(vals) // 2]
        mad = sorted(abs(v - median) for v in vals)[len(vals) // 2]
        scale = 1.4826 * mad if mad > 0 else max(median * 0.01, 1e-9)
        flagged = {}
        for h, v in self._ewma.items():
            if self._count[h] < self.min_steps:
                continue
            z = (v - median) / scale
            if z > self.threshold:
                flagged[h] = z
        weights = self._weights(median, flagged)
        return StragglerReport(self._step, median, flagged, weights)

    def _weights(self, median: float, flagged: dict[int, float]) -> dict[int, float]:
        """Inverse-speed work weights, renormalized to sum to n_hosts."""
        raw = {}
        for h in range(self.n_hosts):
            v = self._ewma.get(h, median)
            raw[h] = median / v if v > 0 else 1.0
        total = sum(raw.values())
        return {h: w * self.n_hosts / total for h, w in raw.items()}

    def synchronous_step_time(self) -> float:
        """Current step time (slowest host gates the barrier)."""
        return max(self._ewma.values()) if self._ewma else 0.0

    def mitigated_step_time(self) -> float:
        """Predicted step time if work were rebalanced by ``weights``.

        With work w_h and speed s_h = 1/ewma_h, host time = w_h * ewma_h;
        the optimum equalizes them: t* = n / sum(1/ewma).
        """
        if not self._ewma:
            return 0.0
        inv = sum(1.0 / v for v in self._ewma.values() if v > 0)
        return len(self._ewma) / inv if inv else 0.0


def rebalance_batch(global_batch: int, weights: dict[int, float]) -> dict[int, int]:
    """Integer batch split proportional to weights (largest-remainder)."""
    n = sum(weights.values())
    shares = {h: global_batch * w / n for h, w in weights.items()}
    base = {h: int(math.floor(s)) for h, s in shares.items()}
    rem = global_batch - sum(base.values())
    order = sorted(weights, key=lambda h: shares[h] - base[h], reverse=True)
    for h in order[:rem]:
        base[h] += 1
    return base

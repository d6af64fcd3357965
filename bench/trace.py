"""The traced window: ``torch.profiler`` over a stretch of the run, reduced
to what the per-layer metrics and the ``breakdown`` read.

The profiler's own event objects are not built (that is slow for the
hundreds of thousands of launches of a serving window): the raw kineto
events are read directly.  A device operation is busy time unless it is a
copy on the copy engines (``Memcpy HtoD`` / ``DtoH``), which leaves the
SMs idle; the busy seconds are the union of the operations' intervals, so
work that overlaps counts once.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

from bench.yardstick import gaps, union_seconds

BREAKDOWN = 10  # entries of each list a result line's breakdown may carry


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_s_by_name: dict[str, float]
    idle_gaps: list[tuple[str, float]]
    device_n_by_name: dict[str, int] = dataclasses.field(default_factory=dict)

    def device_ops(self) -> list[tuple[str, float]]:
        ops = sorted(self.device_s_by_name.items(), key=lambda kv: -kv[1])
        return [(name, s) for name, s in ops[:BREAKDOWN]]

    def kernel_seconds(self, *fragments: str) -> float:
        """Device seconds of the operations whose names hold any of ``fragments``."""
        return sum(s for name, s in self.device_s_by_name.items() if any(f in name for f in fragments))

    def kernel_count(self, *fragments: str) -> int:
        """Device operations in the trace whose names hold any of ``fragments``."""
        return sum(n for name, n in self.device_n_by_name.items() if any(f in name for f in fragments))


def _ns(ev, what: str) -> float:
    fn = getattr(ev, f"{what}_ns", None)
    return float(fn()) if fn is not None else 1e3 * float(getattr(ev, f"{what}_us")())


def _is_copy_engine(name: str) -> bool:
    return name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name)


def _is_annotation(ev) -> bool:
    """A host span's projection onto the device timeline (``record_function``
    shows there too): not device work."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None and "user_annotation" in str(kind()):
        return True
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


class Tracer:
    """``with Tracer() as t: ...`` profiles the block on the card;
    ``t.summary`` is filled on exit.  Host spans that the harness opens
    with ``torch.profiler.record_function`` name the idle gaps."""

    def __init__(self):
        self.summary: TraceSummary | None = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        self._sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def __exit__(self, *exc):
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(self._prof.profiler.kineto_results.events(), window_s)
        return False


def reduce_events(events, window_s: float) -> TraceSummary:
    """Busy seconds, device seconds by operation and the longest idle gaps
    (each named by the innermost host span or operation running at its
    middle) from kineto events."""
    device, host = [], []
    by_name: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    for ev in events:
        start, dur = _ns(ev, "start") * 1e-9, _ns(ev, "duration") * 1e-9
        name = ev.name()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if _is_annotation(ev):
                continue
            by_name[name] += dur
            count[name] += 1
            if not _is_copy_engine(name):
                device.append((start, start + dur))
        elif dur > 0:
            host.append((start, start + dur, name))
    busy = union_seconds(device)
    named: list[tuple[str, float]] = []
    if device:
        lo, hi = min(s for s, _ in device), max(e for _, e in device)
        for gs, ge in gaps(device, lo, hi)[:BREAKDOWN]:
            mid = 0.5 * (gs + ge)
            inner = [h for h in host if h[0] <= mid <= h[1]]
            label = min(inner, key=lambda h: h[1] - h[0])[2] if inner else "no host op"
            spans = [h[2] for h in sorted(inner, key=lambda h: h[0]) if h[2].startswith("bench.")]
            named.append((" > ".join(spans[-1:] + [label]) if spans and spans[-1] != label else label, ge - gs))
    return TraceSummary(window_s=window_s, busy_s=busy, device_s_by_name=dict(by_name), idle_gaps=named,
                        device_n_by_name=dict(count))

"""The benchmark's own arithmetic: the card's published peaks, the roofline
bound, the operations and bytes of the kernels and of a model step, the
device's idle share from kernel intervals, and percentiles over samples.

Nothing here reads the program: every count comes from shapes the harness
knows.  The peaks and ``bound`` are those of ``chip_smoke.py::bound``,
frozen here so that the program's repository can change without moving
the yardstick.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (NVIDIA's data sheet): HBM bandwidth and dense peaks.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def bound(bytes_moved: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least seconds the card could take: the larger of bytes over HBM
    bandwidth and operations over the dtype's peak, and which of the two."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- kernels


def flash_work(s: int, heads: int, kv_heads: int, d: int, batch: int = 1, itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one causal flash-attention forward over ``s``
    queries and keys: QK^T and PV over the s(s+1)/2 visible pairs, 2
    operations a multiply-add; q, k, v read once and the output written
    once."""
    pairs = s * (s + 1) / 2
    flops = 4.0 * batch * heads * d * pairs
    nbytes = itemsize * batch * s * d * (2 * heads + 2 * kv_heads)
    return flops, nbytes


def tiered_rows_work(contexts: list[int], heads: int, kv_heads: int, d: int, itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one per-row tiered decode launch: row i attends one
    query per head over ``contexts[i]`` cached tokens (hot ring and staged
    cold pages together); each key and value is read once, q read and the
    output written once."""
    keys = float(sum(contexts))
    flops = 4.0 * heads * d * keys
    nbytes = itemsize * (2 * kv_heads * d * keys + 2 * len(contexts) * heads * d)
    return flops, nbytes


# -------------------------------------------------------------- model step


def matmul_params(cfg: dict) -> dict[str, int]:
    """Weights that enter a matrix product, per layer and in the head."""
    d, h, kv, ff = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    hd = cfg.get("head_dim") or d // h
    gates = 3 if cfg["mlp_type"] in ("swiglu", "geglu") else 2
    layer = d * h * hd * 2 + d * kv * hd * 2 + gates * d * ff
    return {"layer": layer, "head": d * cfg["vocab"]}


def attention_flops(cfg: dict, queries: int, first: int) -> float:
    """Causal attention operations of one layer for ``queries`` new
    positions starting at position ``first``: each query at position p
    sees p + 1 keys."""
    h, d = cfg["n_heads"], cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]
    keys = queries * first + queries * (queries + 1) / 2
    return 4.0 * h * d * keys


def prefill_flops(cfg: dict, s: int) -> float:
    """One prompt of ``s`` tokens: every layer over every position, the
    head at the last position only (as the program's prefill computes it)."""
    mp = matmul_params(cfg)
    return cfg["n_layers"] * (2.0 * mp["layer"] * s + attention_flops(cfg, s, 0)) + 2.0 * mp["head"]


def decode_flops(cfg: dict, contexts: list[int]) -> float:
    """One decode step of rows whose new token sits at position
    ``contexts[i]`` (so it attends contexts[i] + 1 keys)."""
    mp = matmul_params(cfg)
    per_row = cfg["n_layers"] * 2.0 * mp["layer"] + 2.0 * mp["head"]
    attn = sum(cfg["n_layers"] * attention_flops(cfg, 1, c) for c in contexts)
    return len(contexts) * per_row + attn


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model operations of one training step, forward and backward (3x the
    forward), without what rematerialisation computes again."""
    mp = matmul_params(cfg)
    fwd = cfg["n_layers"] * (2.0 * mp["layer"] * seq + attention_flops(cfg, seq, 0)) + 2.0 * mp["head"] * seq
    return 3.0 * batch * fwd


# ------------------------------------------------------------ device trace


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals: overlapping
    kernels (several streams, copy engines) count once."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers, longest first."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return sorted((g for g in out if g[1] > g[0]), key=lambda g: g[0] - g[1])


# ------------------------------------------------------------- percentiles


def percentile(samples: list[float], q: float) -> float:
    """The ``q``-th percentile of all ``samples`` by linear interpolation
    between closest ranks (numpy's default), without numpy."""
    if not samples:
        raise ValueError("percentile of no samples")
    xs = sorted(samples)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

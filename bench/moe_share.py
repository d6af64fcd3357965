"""The benchmark's own arithmetic for an expert share that mixes window and
global layers (Command A+): the model's operations a prefill and a decode
step, the grouped expert product's operations and bytes, and the per-row
tiered kernel's keys when window layers read only their window.

Like ``bench.yardstick``, nothing here reads the program: every count
comes from the configuration file's ``model`` block and from counts the
harness takes.  The routed experts' work depends on the routing, so it is
counted apart (``expert_flops`` of the rows the share's counters report);
``prefill_flops`` and ``decode_flops`` count the rest.  ``percentile`` is
the yardstick's, so this module stands in for it in a loop.
"""

from __future__ import annotations

from bench.yardstick import percentile, tiered_rows_work  # noqa: F401  (percentile: the loop's)

__all__ = ["decode_flops", "expert_flops", "layer_windows", "moe_grouped_work", "percentile", "prefill_flops",
           "tiered_rows_mixed_work"]


def layer_windows(m: dict) -> list[int]:
    """Each layer's window: 0 on every ``global_every``-th layer (global,
    the whole context), else ``window``."""
    g = m["global_every"]
    return [0 if g and i % g == g - 1 else m["window"] for i in range(m["n_layers"])]


def _dense_params(m: dict) -> tuple[int, int]:
    """Matrix weights a token meets in every layer (attention projections,
    the router over every expert, the shared experts) and in the head."""
    d, h, kv, hd, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["moe_expert_ff"]
    layer = 2 * d * h * hd + 2 * d * kv * hd + d * m["moe_experts"] + 3 * d * f * m["moe_shared"]
    return layer, d * m["vocab"]


def _keys(queries: int, first: int, window: int) -> float:
    """Keys seen by ``queries`` new positions from ``first``: position p sees
    p + 1, or at most ``window``."""
    last = first + queries  # positions first .. last - 1 see p + 1 keys each
    if not window:
        return queries * first + queries * (queries + 1) / 2
    capped = max(0, last - max(first, window - 1))  # positions p >= window - 1 see window keys
    uncapped = queries - capped  # p + 1 for p in first .. first + uncapped - 1
    return capped * window + uncapped * first + uncapped * (uncapped + 1) / 2


def attention_flops(m: dict, queries: int, first: int, window: int) -> float:
    return 4.0 * m["n_heads"] * m["head_dim"] * _keys(queries, first, window)


def prefill_flops(m: dict, s: int) -> float:
    """One prompt of ``s`` tokens, but the routed experts: every layer over
    every position (window layers' attention window-limited), the head at
    the last position only."""
    layer, head = _dense_params(m)
    return sum(2.0 * layer * s + attention_flops(m, s, 0, w) for w in layer_windows(m)) + 2.0 * head


def decode_flops(m: dict, contexts: list[int]) -> float:
    """One decode step of rows whose new token sits at position
    ``contexts[i]``, but the routed experts."""
    layer, head = _dense_params(m)
    windows = layer_windows(m)
    per_row = len(windows) * 2.0 * layer + 2.0 * head
    return len(contexts) * per_row + sum(attention_flops(m, 1, c, w) for c in contexts for w in windows)


def expert_flops(m: dict, rows: int) -> float:
    """The routed experts' operations over ``rows`` held assignments: three
    matrices of d x f at 2 operations a multiply-add."""
    return 6.0 * rows * m["d_model"] * m["moe_expert_ff"]


def moe_grouped_work(rows: int, experts_read: int, m: dict, itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of grouped expert products over ``rows`` held
    assignments in all, ``experts_read`` of the launches' experts having at
    least one row: each such expert's three matrices read once, each row's
    input read and output written once."""
    d, f = m["d_model"], m["moe_expert_ff"]
    return expert_flops(m, rows), itemsize * (3.0 * d * f * experts_read + 2.0 * rows * d)


def tiered_rows_mixed_work(m: dict, contexts: list[int], window: int, itemsize: int = 2) -> tuple[float, float]:
    """(flops, bytes) of one per-row launch of a layer of window ``window``
    (0: global) for rows whose new token sits at ``contexts[i]``: a window
    layer reads min(context + 1, window) keys a row, a global layer
    context + 1."""
    keys = [min(c + 1, window) if window else c + 1 for c in contexts]
    return tiered_rows_work(keys, m["n_heads"], m["n_kv_heads"], m["head_dim"], itemsize)

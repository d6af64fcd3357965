"""Top-k gradient compression with error feedback — the port of
``repro/optim/compression.py`` over the port's trees (``repro_torch.tree``).

Each leaf sends the elements of its EF accumulator (grad + residual, fp32)
whose magnitude reaches the k-th largest, k = ``max(1, int(size * ratio))``,
and keeps the rest as the next residual.  The mask is built from the k-th
*value* (``|acc| >= thresh & |acc| > 0``), as the reference builds it, not
from ``torch.topk``'s indices: ties at the threshold send more than k
elements, and the same inputs give the same mask in both packages and on
any device.  ``stats["elements_sent"]`` counts k a leaf, as the reference's.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree

PyTree = Any


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    flat = x.reshape(-1).abs()
    if k >= flat.numel():
        return torch.ones_like(x, dtype=torch.bool)
    thresh = torch.topk(flat, k, sorted=True).values[-1]
    return (x.abs() >= thresh) & (x.abs() > 0)


def topk_compress_with_ef(
    grads: PyTree,
    ef_state: PyTree | None,
    ratio: float = 0.01,
) -> tuple[PyTree, PyTree, dict]:
    """Sparsify grads to the top ``ratio`` fraction per leaf, with EF.

    Returns (sparse_grads, new_ef_state, stats).  ``sparse_grads`` has the
    same (dense) structure and dtypes but is zero outside the mask; the
    residuals are fp32.
    """
    if ef_state is None:
        ef_state = tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)

    def one(g: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        acc = g.to(torch.float32) + e
        mask = _topk_mask(acc, max(1, int(acc.numel() * ratio)))
        sent = torch.where(mask, acc, 0.0)
        return sent.to(g.dtype), acc - sent

    outs = tree.tree_map(one, grads, ef_state)
    # ``outs`` has a (sent, residual) pair at each leaf: split it back into two trees.
    sparse = tree.tree_map(lambda o: o[0], outs)
    new_ef = tree.tree_map(lambda o: o[1], outs)
    flat_g = tree.leaves(grads)
    total = sum(g.numel() for g in flat_g)
    sent = sum(max(1, int(g.numel() * ratio)) for g in flat_g)
    stats = {"ratio": sent / max(total, 1), "elements_sent": sent, "elements_total": total}
    return sparse, new_ef, stats

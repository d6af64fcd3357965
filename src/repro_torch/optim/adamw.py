"""AdamW with decoupled weight decay, global-norm clipping, LR schedules —
the port of ``repro/optim/adamw.py``.

Functional, as the reference is: the state is a plain tree
``{"m", "v", "count"}`` (fp32 moments shaped like the params, an int32
step count), so the two-level checkpoint manager serialises it unchanged,
and ``update`` returns the updates instead of writing into the params.
``torch.optim.AdamW`` is not used: it clips nothing and decays the weights
before the moment step, where the reference adds the decay to the step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any


def cosine_warmup(
    peak_lr: float,
    warmup_steps: int = 500,
    total_steps: int = 100_000,
    final_frac: float = 0.1,
) -> Callable[[torch.Tensor], torch.Tensor]:
    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0

    def init(self, params: PyTree) -> dict:
        zeros = lambda p: tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device), p)
        device = leaves(params)[0].device
        return {"m": zeros(params), "v": zeros(params), "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return torch.tensor(self.learning_rate, dtype=torch.float32, device=count.device)

    @torch.no_grad()
    def update(self, grads: PyTree, state: dict, params: PyTree) -> tuple[PyTree, dict, dict]:
        """Returns (updates, new_state, metrics)."""
        if self.max_grad_norm > 0:
            grads, gnorm = clip_by_global_norm(grads, self.max_grad_norm)
        else:
            gnorm = global_norm(grads)
        count = state["count"] + 1
        cf = count.to(torch.float32)
        b1c = 1.0 - torch.pow(self.b1, cf)
        b2c = 1.0 - torch.pow(self.b2, cf)
        lr = self._lr(count)

        def upd(g, m, v, p):
            gf = g.to(torch.float32)
            m_new = self.b1 * m + (1 - self.b1) * gf
            v_new = self.b2 * v + (1 - self.b2) * gf * gf
            mhat = m_new / b1c
            vhat = v_new / b2c
            step = mhat / (torch.sqrt(vhat) + self.eps)
            step = step + self.weight_decay * p.to(torch.float32)
            return (-lr * step).to(p.dtype), m_new, v_new

        out = tree_map(upd, grads, state["m"], state["v"], params)
        new_state = {"m": _pick(out, 1), "v": _pick(out, 2), "count": count}
        return _pick(out, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree: PyTree, i: int) -> PyTree:
    """The ``i``-th element of every tuple leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)

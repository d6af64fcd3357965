"""Parameter scopes with logical axes — the port of ``repro/nn/module.py``.

A ``Scope`` threads a ``torch.Generator`` through ``init`` functions and
records, for every parameter, a tuple of logical axis names.  One init
pass yields two parallel trees — params (tensors) and axes (tuples) —
under the same key paths as the JAX package (``prefix_0/mixer/wq`` with
the einsum layout ``(d, H, hd)``), so a JAX parameter tree converts leaf
for leaf (``params_from_jax``).

The numbers differ from JAX's by construction (``jax.random`` and
``torch.Generator`` are different generators); the schemes are the same:
``normal`` (std 0.02 unless scaled), ``fan_in`` (std scale/sqrt(shape[0])),
``zeros``, ``ones``, ``uniform`` (U(-s, s), s = scale or 1).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


class Scope:
    """Threads a generator + path through init; collects params and axes."""

    def __init__(self, generator: torch.Generator, device, dtype=torch.float32,
                 path: str = "", store: dict | None = None, axes: dict | None = None,
                 cast: Callable[[tuple[str, ...], torch.Tensor], torch.Tensor] | None = None):
        self._gen = generator
        self._device = torch.device(device)
        self._dtype = dtype
        self._path = path
        self._cast = cast
        self.params: dict = store if store is not None else {}
        self.axes: dict = axes if axes is not None else {}

    def child(self, name: str) -> "Scope":
        self.params.setdefault(name, {})
        self.axes.setdefault(name, {})
        return Scope(self._gen, self._device, self._dtype, f"{self._path}/{name}",
                     self.params[name], self.axes[name], self._cast)

    def param(
        self,
        name: str,
        shape: tuple[int, ...],
        axes: tuple[str | None, ...],
        init: str = "normal",
        scale: float | None = None,
    ) -> torch.Tensor:
        if len(shape) != len(axes):
            raise ValueError(f"{self._path}/{name}: shape {shape} vs axes {axes} length mismatch")
        if name in self.params:
            raise ValueError(f"duplicate param {self._path}/{name}")
        kw = dict(device=self._device, dtype=self._dtype)
        # In place after the draw: one buffer of the leaf's size at a time.
        if init == "normal":
            s = scale if scale is not None else 0.02
            val = torch.randn(shape, generator=self._gen, **kw).mul_(s)
        elif init == "fan_in":
            fan_in = shape[0] if len(shape) >= 1 else 1
            s = scale if scale is not None else 1.0
            val = torch.randn(shape, generator=self._gen, **kw).mul_(s / math.sqrt(max(fan_in, 1)))
        elif init == "zeros":
            val = torch.zeros(shape, **kw)
        elif init == "ones":
            val = torch.ones(shape, **kw)
        elif init == "uniform":
            s = scale if scale is not None else 1.0
            val = torch.rand(shape, generator=self._gen, **kw).mul_(2.0).sub_(1.0).mul_(s)
        else:
            raise ValueError(f"unknown init {init!r}")
        if self._cast is not None:
            val = self._cast((*self._path.split("/")[1:], name), val)
        self.params[name] = val
        self.axes[name] = tuple(axes)
        return val


def init_with_axes(
    init_fn: Callable[[Scope], None],
    seed: int,
    device="cuda",
    dtype=torch.float32,
    cast: Callable[[tuple[str, ...], torch.Tensor], torch.Tensor] | None = None,
) -> tuple[PyTree, PyTree]:
    """Run ``init_fn`` under a fresh Scope on ``device``; return (params, axes).

    ``cast(path, leaf)`` (optional) maps each leaf as soon as it is drawn
    (``matrix_cast``), so the master-dtype draws never coexist: the peak is
    the cast model plus one leaf in ``dtype``, and the values are those of
    casting the whole tree afterwards."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    scope = Scope(gen, device, dtype, cast=cast)
    with torch.no_grad():
        init_fn(scope)
    return scope.params, scope.axes


def matrix_cast(dtype, keep: tuple[str, ...] = ("head",)) -> Callable[[tuple[str, ...], torch.Tensor], torch.Tensor]:
    """``cast_matrices``' rule for one leaf at key path ``path``: a floating
    leaf of rank >= 2 goes to ``dtype`` unless a key of its path is in
    ``keep``."""

    def cast(path: tuple[str, ...], v: torch.Tensor) -> torch.Tensor:
        if v.ndim >= 2 and v.is_floating_point() and not any(k in keep for k in path):
            return v.to(dtype)
        return v

    return cast


def cast_matrices(params: PyTree, dtype, keep: tuple[str, ...] = ("head",)) -> PyTree:
    """Cast every parameter of rank >= 2 to ``dtype``, except the subtrees
    and leaves named in ``keep``; vectors (norm scales, biases) stay as they
    are (``matrix_cast`` applies the same rule leaf by leaf at init).

    The JAX layers cast each matrix with ``.astype(compute dtype)`` at every
    call (``linear_apply``, the attention einsums, ``embedding_apply``), so
    one cast up front gives exactly the values they use and halves the
    weights' memory.  Vectors are read in fp32 by the norms, and the LM head
    is read in fp32 by ``logits_apply``: both keep their master dtype.  A
    tied head reads the embedding table, so a tied model keeps ``embed`` as
    well (the lookup casts the gathered rows, as the JAX layer does).
    """
    cast = matrix_cast(dtype, keep)

    def walk(node: dict, path: tuple[str, ...]) -> dict:
        return {k: walk(v, (*path, k)) if isinstance(v, dict) else cast((*path, k), v) for k, v in node.items()}

    return walk(params, ())


_LAYER = re.compile(r"^(prefix|suffix)_(\d+)$")
_SLOT = re.compile(r"^slot_(\d+)$")
_ENCDEC_SIDES = ("encoder", "decoder")


def params_from_jax(tree: PyTree, device="cuda", dtype=None) -> PyTree:
    """Convert a JAX parameter tree (numpy-convertible leaves) to tensors.

    Key paths are kept (``prefix_0/mixer/wq`` stays ``(d, H, hd)``) and the
    stack is unrolled (``from_reference_layout``), so both ``scan_layers``
    settings load into the same model.  ``dtype`` (optional) casts every
    floating leaf.
    """

    def leaf(x) -> torch.Tensor:
        t = torch.from_numpy(np.array(x))  # np.array copies: the tensor owns its bytes
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return from_reference_layout(tree, leaf)


def from_reference_layout(tree: PyTree, leaf: Callable = lambda x: x) -> PyTree:
    """The JAX package's parameter layout -> the port's unrolled one.

    The reference's LM stacks the repeating layers: ``prefix_i``, then
    ``periods/slot_j`` with a leading period axis, then ``suffix_i``
    (``models.lm.stack_plan``).  Its encoder-decoder stacks each side's
    layers under ``encoder/periods`` and ``decoder/periods``, one layer a
    period and no ``slot_j``.  The port's stacks are always unrolled, so the
    layers are renumbered into consecutive ``prefix_i`` (``encoder/prefix_i``
    and ``decoder/prefix_i`` for the encoder-decoder); ``leaf`` maps every
    leaf on the way (tensors and numpy arrays are indexed as they are).
    """

    def conv(node):
        return {k: conv(v) for k, v in node.items()} if isinstance(node, dict) else leaf(node)

    layers: dict[int, PyTree] = {}
    suffix: dict[int, PyTree] = {}
    out: dict = {}
    for k, v in tree.items():
        m = _LAYER.match(k)
        if m and m.group(1) == "prefix":
            layers[int(m.group(2))] = conv(v)
        elif m:
            suffix[int(m.group(2))] = conv(v)
        elif k in _ENCDEC_SIDES:
            out[k] = from_reference_layout(v, leaf)
        elif k != "periods":
            out[k] = conv(v)
    n = len(layers)
    if "periods" in tree:
        periods = tree["periods"]
        n_periods = _leading_dim(periods)
        if all(_SLOT.match(s) for s in periods):
            slots = sorted(int(_SLOT.match(s).group(1)) for s in periods)
        else:  # one layer a period (the encoder-decoder's sides)
            periods, slots = {"slot_0": periods}, [0]
        for p in range(n_periods):
            for j in slots:
                layers[n] = conv(_index_leading(periods[f"slot_{j}"], p))
                n += 1
    for i in sorted(suffix):
        layers[n] = suffix[i]
        n += 1
    for i in range(n):
        out[f"prefix_{i}"] = layers[i]
    return out


def to_reference_layout(params: PyTree, cfg) -> PyTree:
    """The port's unrolled layers -> the JAX package's layout for ``cfg``
    (the inverse of ``from_reference_layout``).

    The port's ``prefix_0 .. prefix_{L-1}`` are split by the reference's
    ``stack_plan`` (which honours ``cfg.scan_layers``): the leading layers
    stay ``prefix_i``, the periods' layers are stacked into
    ``periods/slot_j`` along a new leading axis (``torch.stack`` for
    tensors, ``np.stack`` for arrays, so this copies them) and the rest
    become ``suffix_i``.  A checkpoint of the result names and lays out
    every leaf as the JAX package's does.

    An encoder-decoder (``cfg.encdec``) stacks each side's ``prefix_i``
    into its ``periods``, whatever ``cfg.scan_layers`` says, as the
    reference's ``stacked_init`` lays them out.
    """
    from repro_torch.models.lm import stack_plan  # models.lm imports this module

    if cfg.encdec is not None:
        return {k: _stack_side(v) if k in _ENCDEC_SIDES else v for k, v in params.items()}
    prefix, period, n_periods, suffix = stack_plan(cfg)
    layers = [params[f"prefix_{i}"] for i in range(cfg.n_layers)]
    out = {k: v for k, v in params.items() if not _LAYER.match(k)}
    for i in range(len(prefix)):
        out[f"prefix_{i}"] = layers[i]
    if n_periods:
        base = len(prefix)
        out["periods"] = {
            f"slot_{j}": _stack([layers[base + p * len(period) + j] for p in range(n_periods)])
            for j in range(len(period))
        }
    for i in range(len(suffix)):
        out[f"suffix_{i}"] = layers[len(prefix) + n_periods * len(period) + i]
    return out


def _stack_side(side: dict) -> dict:
    """One side of an encoder-decoder: its ``prefix_i`` stacked into ``periods``."""
    n = sum(bool(_LAYER.match(k)) for k in side)
    out = {k: v for k, v in side.items() if not _LAYER.match(k)}
    return {**out, "periods": _stack([side[f"prefix_{i}"] for i in range(n)])}


def _stack(trees: list) -> PyTree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], torch.Tensor):
        return torch.stack(trees)
    return np.stack(trees)


def _leading_dim(node) -> int:
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return int(node.shape[0])


def _index_leading(node, i: int):
    if isinstance(node, dict):
        return {k: _index_leading(v, i) for k, v in node.items()}
    return node[i] if isinstance(node, torch.Tensor) else np.asarray(node)[i]

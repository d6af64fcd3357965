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

Logical axes resolve to a mesh through the reference's rules tables
(``DEFAULT_RULES``, ``FSDP_RULES``) with its **shard-if-divisible** guard
(``resolve_axes``): the same ``PartitionSpec`` entries, as a plain tuple.
A ``NamedSharding`` turns a spec into DTensor placements on a
``DeviceMesh`` — ``Shard(i)`` on each mesh dim that names tensor dim i,
``Replicate()`` elsewhere — and ``constrain`` redistributes a DTensor
activation to its logical axes' placements (a no-op off-mesh and on a
plain tensor).  ``init_with_axes(..., device="meta")`` is the counterpart
of the reference's ``abstract=True``: shapes, dtypes and axes, no memory.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Callable

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import tree_map

PyTree = Any

# logical axis -> mesh axis (None = replicate). The "data" axes appear only
# on activations, never on params.  (The reference's table, verbatim.)
DEFAULT_RULES: dict[str, str | None] = {
    "vocab": "model",
    "embed": None,
    "ff": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "dispatch": ("pod", "data"),  # MoE group-local dispatch (one group/DP shard)
    # expert_ff ALSO maps to model: resolve_axes claims each mesh axis once
    # per tensor, so when the expert axis shards (deepseek, 256%16==0) the
    # ff dim replicates, and when it cannot (grok, 8%16!=0) the ff dim
    # shards instead of replicating the whole expert stack on every rank.
    "expert_ff": "model",
    "q_lora": None,
    "kv_lora": None,
    "rnn": "model",
    "conv": None,
    "batch": ("pod", "data"),
    "seq": None,
    "residual_seq": "model",  # sequence-parallel residual stream
    "act_embed": None,
    "act_heads": "model",
    "act_ff": "model",
    "cache_seq": None,
    "layers": None,
    "scalar": None,
}

# FSDP/ZeRO-style variant: weight d_model dims additionally shard over the
# data axis (2D "hybrid" sharding).
FSDP_RULES: dict[str, str | None] = dict(DEFAULT_RULES, embed="data")

RULE_SETS: dict[str, dict[str, str | None]] = {
    "default": DEFAULT_RULES,
    "fsdp": FSDP_RULES,
}


class Scope:
    """Threads a generator + path through init; collects params and axes."""

    def __init__(self, generator: torch.Generator | None, device, dtype=torch.float32,
                 path: str = "", store: dict | None = None, axes: dict | None = None,
                 cast: Callable[[tuple[str, ...], torch.Tensor], torch.Tensor] | None = None):
        self._gen = generator  # None on "meta": nothing is drawn there
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

    ``device="meta"`` (the reference's ``abstract=True``) draws nothing and
    allocates nothing: the params are meta tensors of the same shapes and
    dtypes, with the same axes.

    ``cast(path, leaf)`` (optional) maps each leaf as soon as it is drawn
    (``matrix_cast``), so the master-dtype draws never coexist: the peak is
    the cast model plus one leaf in ``dtype``, and the values are those of
    casting the whole tree afterwards."""
    gen = None
    if torch.device(device).type != "meta":
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


# ---------------------------------------------------------------------------
# Logical axes -> mesh placements
# ---------------------------------------------------------------------------


class MeshShape:
    """A mesh's axis sizes without its devices: ``.shape`` maps each axis
    name to its size, in mesh-dim order (what ``resolve_axes`` and the
    dry-run's accounting read)."""

    def __init__(self, **shape: int):
        self.shape = dict(shape)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def mesh_shape(mesh: Any) -> dict[str, int]:
    """Axis name -> size, in mesh-dim order, of a ``DeviceMesh`` or of
    anything with a ``.shape`` mapping (``MeshShape``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {a: int(n) for a, n in mesh.shape.items()}


def resolve_axes(
    logical: tuple[str | None, ...],
    shape: tuple[int, ...],
    mesh: Any,
    rules: dict[str, str | None] | None = None,
) -> tuple:
    """Logical axes -> the reference's ``PartitionSpec`` entries as a tuple
    (``None``, a mesh axis name, or a tuple of names), with the
    shard-if-divisible guard: a mesh axis is claimed once per tensor, and a
    dim that its axes' size does not divide is replicated."""
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    spec: list = []
    used: set = set()
    for dim, name in zip(shape, logical):
        mesh_axis = rules.get(name) if name is not None else None
        if mesh_axis is None:
            spec.append(None)
            continue
        flat = tuple(mesh_axis) if isinstance(mesh_axis, (tuple, list)) else (mesh_axis,)
        flat = tuple(a for a in flat if a in sizes)
        if not flat or any(a in used for a in flat):
            spec.append(None)
            continue
        size = math.prod(sizes[a] for a in flat)
        if size <= 1 or dim % size != 0:
            spec.append(None)  # shard-if-divisible: replicate instead
            continue
        used.update(flat)
        spec.append(flat[0] if len(flat) == 1 else flat)
    return tuple(spec)


def logical_to_pspec(axes_tree: PyTree, shapes_tree: PyTree, mesh: Any, rules=None) -> PyTree:
    """Map the (axes, shapes) trees to a tree of spec tuples."""
    return tree_map(lambda axes, shaped: resolve_axes(tuple(axes), tuple(shaped.shape), mesh, rules),
                    axes_tree, shapes_tree)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh — the port's counterpart of JAX's ``NamedSharding``.

    ``mesh`` is a ``DeviceMesh`` (or, for accounting only, anything
    ``mesh_shape`` reads); ``spec`` holds ``resolve_axes``' entries, one a
    tensor dim (missing trailing entries replicate)."""

    mesh: Any
    spec: tuple

    def _dim_of(self, axis: str) -> int | None:
        for i, entry in enumerate(self.spec):
            if entry == axis or (isinstance(entry, tuple) and axis in entry):
                return i
        return None

    def placements(self) -> tuple:
        """One placement a mesh dim: ``Shard(i)`` where the spec names that
        mesh axis at tensor dim i, ``Replicate()`` otherwise.  A tuple entry
        such as ``("pod", "data")`` shards its dim over both mesh dims in
        mesh-dim order — JAX's major-to-minor order, so rank r holds the
        rows JAX's device r does."""
        return tuple(Replicate() if (i := self._dim_of(a)) is None else Shard(i) for a in mesh_shape(self.mesh))

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The local shard's shape of a tensor of global ``shape`` (every
        sharded dim divides its axes' size: ``resolve_axes``' guard)."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for axis, n in sizes.items():
            if (i := self._dim_of(axis)) is not None:
                out[i] //= n
        return tuple(out)

    def local_slices(self, shape: tuple[int, ...]) -> tuple[slice, ...]:
        """This rank's block of a tensor of global ``shape`` on the
        ``DeviceMesh``: each sharded dim is cut by its mesh dims in mesh-dim
        order, at this rank's coordinate (``DTensor``'s own layout)."""
        coord = self.mesh.get_coordinate()
        start, length = [0] * len(shape), list(shape)
        for m, (axis, n) in enumerate(mesh_shape(self.mesh).items()):
            if (i := self._dim_of(axis)) is not None:
                if length[i] % n:
                    raise ValueError(f"dim {i} of {tuple(shape)} does not divide over {axis}={n}")
                length[i] //= n
                start[i] += coord[m] * length[i]
        return tuple(slice(a, a + n) for a, n in zip(start, length))

    def shard(self, full: torch.Tensor) -> DTensor:
        """``full`` (the same whole tensor on every rank, on any device) as a
        DTensor on this sharding: only this rank's block is copied to the
        mesh's device, and nothing is sent between ranks."""
        return self.wrap(full[self.local_slices(tuple(full.shape))].contiguous(), tuple(full.shape))

    def wrap(self, local: torch.Tensor, shape: tuple[int, ...]) -> DTensor:
        """This rank's block ``local`` of a tensor of global ``shape`` as a
        DTensor, moved to the mesh's device (a meta block stays meta)."""
        if local.device.type != "meta":
            local = local.to(self.mesh.device_type)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, self.placements(), run_check=False, shape=shape, stride=stride)


def named_shardings(axes_tree: PyTree, shapes_tree: PyTree, mesh: Any, rules=None) -> PyTree:
    return tree_map(lambda s: NamedSharding(mesh, s), logical_to_pspec(axes_tree, shapes_tree, mesh, rules))


# Explicit context for activation constraints: launch code wraps a sharded
# step in `axis_rules(mesh)` and `constrain` reads the stack.
_AXIS_CTX: list[tuple[Any, dict]] = []


class axis_rules:
    """Context manager registering (mesh, rules) for ``constrain``."""

    def __init__(self, mesh: Any, rules: dict[str, str | None] | None = None):
        self.entry = (mesh, rules or DEFAULT_RULES)

    def __enter__(self):
        _AXIS_CTX.append(self.entry)
        return self

    def __exit__(self, *exc):
        _AXIS_CTX.pop()


def current_dp_groups() -> int:
    """Data-parallel group count from the active ``axis_rules`` mesh (1
    off-mesh): the MoE dispatch routes each group's tokens on their own."""
    if not _AXIS_CTX:
        return 1
    sizes = mesh_shape(_AXIS_CTX[-1][0])
    return max(sizes.get("pod", 1) * sizes.get("data", 1), 1)


def active_spec(shape: tuple[int, ...], *logical: str | None) -> tuple:
    """``resolve_axes``' entries for a value of ``shape`` whose dims are
    named ``logical`` under the active ``axis_rules`` (all None off-mesh)."""
    if not _AXIS_CTX:
        return (None,) * len(shape)
    mesh, rules = _AXIS_CTX[-1]
    return resolve_axes(tuple(logical), tuple(shape), mesh, rules)


def splits(shape: tuple[int, ...], *logical: str | None) -> bool:
    """Whether the active ``axis_rules`` split a value of ``shape`` whose
    dims are named ``logical`` (False off-mesh)."""
    return any(a is not None for a in active_spec(shape, *logical))


def _place(x: DTensor, placements: tuple) -> DTensor:
    if tuple(x.placements) == placements:
        return x
    y = x.redistribute(x.device_mesh, placements)
    local = y.to_local()
    if local.is_contiguous():
        return y
    # A block cut from a replicated tensor along a later dim is a strided
    # view, which the products' reshapes of the block cannot take.
    return DTensor.from_local(local.contiguous(), y.device_mesh, placements, run_check=False,
                              shape=y.shape, stride=y.stride())


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, and its gradient too: the
    cotangent of JAX's sharding constraint is constrained alike.  (Where
    the input was a partial sum, its gradient is whole there, as DTensor's
    own redistribute gives it.)"""

    @staticmethod
    def forward(ctx, x: DTensor, placements: tuple) -> DTensor:
        ctx.placements, ctx.partial = placements, tuple(p.is_partial() for p in x.placements)
        return _place(x, placements).view_as(x)

    @staticmethod
    def backward(ctx, grad: DTensor):
        grad = _place(grad, ctx.placements)
        whole = tuple(Replicate() if partial else p for partial, p in zip(ctx.partial, grad.placements))
        return _place(grad, whole), None


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Activation sharding constraint via logical names: on a mesh, a
    DTensor (and, under autograd, its gradient) is redistributed to the
    placements its axes resolve to; off-mesh, or on a plain tensor, ``x``
    comes back as it is."""
    if not _AXIS_CTX:
        return x
    mesh, rules = _AXIS_CTX[-1]
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {len(logical)} axes for rank-{x.ndim} value")
    if not isinstance(x, DTensor):
        return x
    placements = NamedSharding(mesh, resolve_axes(tuple(logical), tuple(x.shape), mesh, rules)).placements()
    if x.requires_grad and torch.is_grad_enabled():
        return _Constrain.apply(x, placements)
    return _place(x, placements)

"""Multi-pod dry-run of the port: per-device memory and matrix-product FLOPs
of every (arch × shape × mesh) cell, without the devices — the port of
``repro/launch/dryrun.py``'s abstract init and accounting.

Per cell the dry-run:
  1. builds the abstract train state and the cell's inputs on the ``meta``
     device (shapes and dtypes, no memory);
  2. resolves their shardings on the production mesh's axis sizes
     (``launch.mesh.production_shape``) by the shard-if-divisible rules;
  3. records per-device bytes of params, optimizer state, batch or caches,
     each leaf counted at its local shard's shape (the counterpart of XLA's
     ``argument_size_in_bytes``);
  4. records ``global_dot_flops``, the whole step's matrix-product FLOPs
     (mm, addmm, bmm, baddbmm; 2·M·N·K each), from a run on unsharded meta
     tensors under the mesh's ``axis_rules`` (forward and backward for
     ``train``; the MoE dispatches one group per data-parallel shard, as on
     the mesh), and ``dot_flops``, one device's share, from a second run
     on those shardings: every leaf a DTensor over meta blocks, on a
     ``DeviceMesh`` of the production shape over a ``fake`` process group
     of its world size in this one process (collectives do nothing), the
     step ``steps.on_mesh``.  A dispatch mode beneath DTensor
     (``DeviceCounter``) counts each product at the shapes of the blocks
     it runs on, the FLOPs of one device, as the reference's
     ``corrected.dot_flops`` counts the SPMD-partitioned program of one
     device.  The port's layers are unrolled, so there is no loop trip
     count to correct for.  The recurrent archs' train and
     prefill steps loop over time steps in Python (the plain scans), which
     on meta costs hours at 32k steps: there ``global_dot_flops`` is a
     polynomial of degree <= 2 in the sequence length (loops linear,
     attention quadratic) interpolated through three short lengths of a run
     on unsharded meta tensors and checked exactly at a fourth, and one
     device's counts (``dot_flops``, ``collectives``, temporaries) are each
     fitted the same way through a window of short runs on the mesh and
     checked at two further lengths (``fit_record_in_seq``), where the
     model's own constraints fix every placement; which window, the record's
     ``dot_flops_from`` says;
  5. records, from the same run on DTensors, one device's
     ``collectives`` and ``memory["temp_size_in_bytes"]`` (the same
     ``DeviceCounter``): every collective DTensor's
     redistributions issue, counted by its output bytes on one device in
     the reference's keys, and the peak bytes
     of the storages the step allocates, each DTensor by its local block;
  6. writes JSON under ``build/dryrun_torch/`` (``--out``).

Not recorded: XLA's ``cost_analysis`` (no compiled program to read it
from).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --arch xlstm-125m,qwen3-8b --reduced
  python -m repro_torch.launch.dryrun --all [--force]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from fractions import Fraction
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, applicable_shapes, get_config, get_reduced, make_model
from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.steps import (
    batch_shardings,
    cache_shardings,
    init_state,
    input_specs,
    make_prefill_step,
    make_serve_step,
    make_sharded_train_step,
    make_train_step,
    on_mesh,
    shard_state,
    state_shardings,
)
from repro_torch.nn import layers as L
from repro_torch.nn.module import RULE_SETS, MeshShape, axis_rules, mesh_shape
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import flatten_with_path

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

_DOTS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm, torch.ops.aten.baddbmm}


def device_bytes(tree, shardings) -> int:
    """Bytes one device holds of ``tree``: each tensor leaf at its local
    shard's shape; a host int (a cache's ``index``) holds none."""
    sh = dict(flatten_with_path(shardings))
    out = 0
    for path, leaf in flatten_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            out += math.prod(sh[path].shard_shape(tuple(leaf.shape))) * leaf.element_size()
    return out


COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

# DTensor's collectives (functional: each returns its output) -> the
# reference's collective types.
_COLLECTIVE_OPS = {
    torch.ops._c10d_functional.all_reduce.default: "all-reduce",
    torch.ops._c10d_functional.all_gather_into_tensor.default: "all-gather",
    torch.ops._c10d_functional.reduce_scatter_tensor.default: "reduce-scatter",
    torch.ops._c10d_functional.all_to_all_single.default: "all-to-all",
}


class DeviceCounter(TorchDispatchMode):
    """One device's matrix-product FLOPs, collectives and temporary bytes in
    a step run on DTensors (or, on plain tensors, the whole step's).  It
    hands every DTensor op on to DTensor (``NotImplemented``) and sees the
    plain ops DTensor then runs on this device's blocks, and the step's
    plain ops.

    ``dot_flops``: every product (mm, addmm, bmm, baddbmm) at the shapes it
    runs at, 2·M·N·K each: a DTensor product at this device's blocks of its
    operands, whether it splits the work (a sharded output, or a partial
    sum of a split contraction) or repeats it (a replicated output, or a
    partial sum computed from a partial operand, the same size on every
    device), as the reference's ``corrected.dot_flops`` counts the
    SPMD-partitioned program of one device.

    ``collectives``: each collective DTensor issues (the step calls none
    of ``torch.distributed``'s itself) by its output bytes on one device
    (all-reduce: the whole tensor; all-gather: the gathered tensor;
    reduce-scatter: the shard; all-to-all: the received block), summed by
    type, as the reference's ``collective_bytes`` sums them from HLO, and
    the largest single op of each type (``largest_bytes``).

    ``temp_bytes``: the peak bytes of the storages the step allocates, live
    at once, each counted once however many views it has and dropped when
    freed (a weakref finalizer on the storage).  The arguments' storages,
    given to the constructor, are not counted: this is the peak less the
    arguments' bytes, and it includes autograd's saved tensors (live until
    backward frees them) and the outputs (the new state) as they are made.
    It is an upper bound on what a compiled program needs: nothing is
    reused beyond PyTorch's own frees."""

    def __init__(self, args=()):
        super().__init__()
        self.bytes_by_type = dict.fromkeys(COLLECTIVES, 0)
        self.counts = dict.fromkeys(COLLECTIVES, 0)
        self.largest = dict.fromkeys(COLLECTIVES, 0)
        self.ops: list[tuple[str, int]] = []  # (type, bytes) of each collective, in program order
        self._args = [t.untyped_storage() for t in tree_leaves(args) if isinstance(t, torch.Tensor)
                      for t in [t.to_local() if isinstance(t, DTensor) else t]]
        self._known = {id(st) for st in self._args}
        self._live: dict[int, int] = {}
        self.live_bytes = self.temp_bytes = self.dot_flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation runs each op on fake tensors of
            # its global shapes for their metadata; no device runs it.
            return out
        if func._overloadpacket in _DOTS:
            self.dot_flops += flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        kind = _COLLECTIVE_OPS.get(func, "all-to-all" if func._opname == "shard_dim_alltoall" else None)
        if kind is not None:
            nbytes = out.numel() * out.element_size()
            self.bytes_by_type[kind] += nbytes
            self.counts[kind] += 1
            self.largest[kind] = max(self.largest[kind], nbytes)
            self.ops.append((kind, nbytes))
        returns = func._schema.returns
        for i, t in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and not (i < len(returns) and returns[i].alias_info is not None):
                self._allocated(t)
        return out

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += self._live[key]
        self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        weakref.finalize(st, self._freed, key)

    def _freed(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def collectives(self) -> dict:
        return {"bytes_by_type": dict(self.bytes_by_type), "counts": dict(self.counts),
                "total_bytes": sum(self.bytes_by_type.values()), "largest_bytes": dict(self.largest)}


@contextlib.contextmanager
def _alltoall_as_on_the_card():
    """DTensor moves a Shard(i) -> Shard(j) block with one all-to-all, but on
    a mesh of device type ``cpu`` (the dry-run's) it gathers the whole
    tensor and keeps its chunk instead, as gloo has no all-to-all.  Within
    this context it issues the all-to-all op (its meta kernel gives the
    block), so the count is that of the card's program."""
    from torch.distributed.tensor import placement_types

    if not (hasattr(placement_types, "shard_dim_alltoall") and hasattr(torch.ops._dtensor, "shard_dim_alltoall")):
        yield
        return

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


@contextlib.contextmanager
def fake_mesh(mesh) -> DeviceMesh:
    """A ``DeviceMesh`` of ``mesh``'s axis sizes on the CPU over a ``fake``
    process group of its world size, as rank 0, in this process: DTensor
    runs its sharding rules and collectives do nothing.  Torn down after;
    refused where a process group already exists."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers the "fake" backend)

    if dist.is_initialized():
        raise RuntimeError("the dry-run runs its own fake process group; one is already initialised")
    sizes = mesh_shape(mesh)
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=math.prod(sizes.values()))
    try:
        yield init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()


FIT_SEQ = (8, 16, 24, 32)
# Windows of sequence lengths for one device's counts of the recurrent archs'
# train and prefill steps: (first, step) gives first + i * step for i < 5,
# three to fit, two to check.  Below a config's first few dozen steps,
# DTensor may place a product's gradient otherwise than at length (it picks
# by cost), so a window that does not fit gives way to the next.
DEVICE_FIT_WINDOWS = ((8, 8), (16, 16), (48, 16), (80, 16))


def fit_in_seq(count, seq_len: int, points: tuple[int, ...] = FIT_SEQ) -> int:
    """``count(seq_len)`` for a count that is a polynomial of degree <= 2
    in the sequence length: interpolated through ``count`` at the first
    three ``points``, and refused unless it gives each further point
    exactly."""
    xs, ys = points[:3], [count(s) for s in points]

    def at(x: int) -> Fraction:
        total = Fraction(0)
        for i, (xi, yi) in enumerate(zip(xs, ys)):
            term = Fraction(yi)
            for j, xj in enumerate(xs):
                if j != i:
                    term *= Fraction(x - xj, xi - xj)
            total += term
        return total

    if any(at(x) != y for x, y in zip(points[3:], ys[3:])):
        raise ValueError(f"count is not quadratic in the sequence length: {dict(zip(points, ys))}")
    return int(at(seq_len))


def fit_record_in_seq(run, seq_len: int) -> tuple[dict, tuple[int, ...]]:
    """``sharded_run``'s record at ``seq_len`` from runs at short lengths
    (``run(s)``): each count fitted by ``fit_in_seq`` through the first
    window of ``DEVICE_FIT_WINDOWS`` that fits every count and gives its two
    further points exactly, the number of collectives of each type too.
    The largest collective of a type is the largest of its ops' fitted
    bytes: the runs send the same ops in the same order, each of a size
    polynomial in the length (their maximum is not) — where they send
    more ops the longer they run (a scan's step that communicates, once a
    step), once an op repeated back to back is taken once.  Returns
    (record, the window's points)."""
    failed, runs = {}, {}
    for first, step in DEVICE_FIT_WINDOWS:
        points = tuple(first + i * step for i in range(5))
        records = {x: runs[x] if x in runs else runs.setdefault(x, run(x)) for x in points}

        def fit(path):
            def at(x):
                node = records[x]
                for key in path:
                    node = node[key]
                return node
            node = at(points[0])
            if isinstance(node, dict):
                return {key: fit((*path, key)) for key in node if key != "largest_bytes"}
            return fit_in_seq(at, seq_len, points)

        try:
            ops = {x: records[x]["ops"] for x in points}
            if len({len(o) for o in ops.values()}) > 1:
                ops = {x: [op for i, op in enumerate(o) if i == 0 or op != o[i - 1]] for x, o in ops.items()}
            kinds = [[kind for kind, _ in ops[x]] for x in points]
            if any(k != kinds[0] for k in kinds):
                raise ValueError(f"the runs issue other collectives: {[len(k) for k in kinds]} ops")
            record = fit(("dot_flops",)), fit(("collectives",)), fit(("temp_size_in_bytes",))
            sizes = [fit_in_seq(lambda x: ops[x][i][1], seq_len, points) for i in range(len(kinds[0]))]
        except ValueError as e:
            failed[points] = str(e)
            continue
        largest = dict.fromkeys(COLLECTIVES, 0)
        for kind, size in zip(kinds[0], sizes):
            largest[kind] = max(largest[kind], size)
        return {"dot_flops": record[0], "collectives": {**record[1], "largest_bytes": largest},
                "temp_size_in_bytes": record[2]}, points
    raise ValueError(f"no window fits one device's counts: {failed}")


def _inputs(model, cfg: ArchConfig, cell: ShapeCell) -> dict:
    """The cell's meta inputs.  Prefill fills fresh caches (an
    encoder-decoder's cross (k, v) come out of it), as the reference's
    dry-run lowers it."""
    inputs = input_specs(model, cfg, cell)
    if cell.kind == "prefill":
        inputs["caches"] = model.init_caches(cell.global_batch, cell.seq_len, getattr(torch, cfg.dtype), "meta")
    return inputs


def sharded_run(model, cfg: ArchConfig, cell: ShapeCell, state: dict, axes, optimizer: AdamW, mesh,
                rules: dict, seq_shard: bool = False) -> dict:
    """One device's matrix-product FLOPs (``dot_flops``), collectives and
    temporary bytes in one run of the cell's step on ``mesh`` (a
    ``DeviceMesh``), its state, batch and caches sharded as the dry-run
    accounts them."""
    sh = state_shardings(state, axes, mesh, rules)
    state = shard_state(state, sh)
    inputs = _inputs(model, cfg, cell)
    if cell.kind == "train":
        step = make_sharded_train_step(model, cfg, optimizer, sh, rules)
        args = (state, shard_state(inputs["batch"], batch_shardings(inputs["batch"], mesh)))
    else:
        first = inputs["batch"] if cell.kind == "prefill" else inputs["token"]
        step = on_mesh((make_prefill_step if cell.kind == "prefill" else make_serve_step)(model, cfg), mesh, rules)
        args = (state["params"], shard_state(first, batch_shardings(first, mesh)),
                shard_state(inputs["caches"], cache_shardings(inputs["caches"], cfg, mesh, seq_shard)))
    device = DeviceCounter(args)
    with _alltoall_as_on_the_card():
        flops = _count(step, args, device)
    return {"dot_flops": flops, "collectives": device.collectives(), "temp_size_in_bytes": device.temp_bytes,
            "ops": device.ops}


def whole_dot_flops(model, cfg: ArchConfig, cell: ShapeCell, state: dict, optimizer: AdamW, mesh,
                    rules: dict) -> int:
    """The whole step's matrix-product FLOPs, from one run on unsharded
    meta tensors under ``mesh``'s ``axis_rules`` (the MoE dispatches one
    group per data-parallel shard, as on the mesh)."""
    inputs = _inputs(model, cfg, cell)
    if cell.kind == "train":
        step, args = make_train_step(model, cfg, optimizer), (state, inputs["batch"])
    elif cell.kind == "prefill":
        step, args = make_prefill_step(model, cfg), (state["params"], inputs["batch"], inputs["caches"])
    else:
        step, args = make_serve_step(model, cfg), (state["params"], inputs["token"], inputs["caches"])
    with axis_rules(mesh, rules):
        return _count(step, args)


def _count(step, args, device: DeviceCounter | None = None) -> int:
    """The dot FLOPs of ``step(*args)``, counted by ``device`` (a fresh
    ``DeviceCounter`` if none is given), which counts the same run."""
    device = device or DeviceCounter(args)
    try:
        with device:
            step(*args)
    finally:
        L.reset_moe_counts()  # the run's counters hold meta tensors
    return device.dot_flops


def account(cfg: ArchConfig, cell: ShapeCell, mesh, rules_name: str = "default", seq_shard: bool = False) -> dict:
    """The dry-run's record of one cell on ``mesh`` (anything ``mesh_shape``
    reads): ``memory`` (per-device bytes, ``temp_size_in_bytes`` among
    them), ``dot_flops`` and ``collectives`` (per device) and
    ``global_dot_flops`` (the whole step)."""
    rules = RULE_SETS[rules_name]
    model = make_model(cfg)
    optimizer = AdamW()
    state, axes = init_state(model, cfg, optimizer, device="meta")
    st_sh = state_shardings(state, axes, mesh, rules)
    inputs = _inputs(model, cfg, cell)
    memory = {"params": device_bytes(state["params"], st_sh["params"])}
    if cell.kind == "train":
        memory["opt"] = device_bytes(state["opt"], st_sh["opt"]) + device_bytes(state["step"], st_sh["step"])
    else:
        memory["caches"] = device_bytes(inputs["caches"], cache_shardings(inputs["caches"], cfg, mesh, seq_shard))
    if "batch" in inputs:
        memory["batch"] = device_bytes(inputs["batch"], batch_shardings(inputs["batch"], mesh))
    else:
        memory["token"] = device_bytes(inputs["token"], batch_shardings(inputs["token"], mesh))
    memory["argument_size_in_bytes"] = sum(memory.values())

    if cfg.recurrent is not None and cell.kind != "decode":
        # A full-length run of the Python time loop takes hours on meta: the
        # counts are polynomials in the sequence length (loops linear,
        # attention quadratic), fitted through short runs.
        at = lambda s: dataclasses.replace(cell, seq_len=s)
        total = fit_in_seq(lambda s: whole_dot_flops(model, cfg, at(s), state, optimizer, mesh, rules),
                           cell.seq_len)
        with fake_mesh(mesh) as dmesh:
            device, points = fit_record_in_seq(
                lambda s: sharded_run(model, cfg, at(s), state, axes, optimizer, dmesh, rules, seq_shard),
                cell.seq_len)
        how = (f"seq fit {'/'.join(map(str, FIT_SEQ))} of the whole step; one device's: seq fit "
               f"{'/'.join(map(str, points[:3]))}, checked at {'/'.join(map(str, points[3:]))}")
    else:
        total = whole_dot_flops(model, cfg, cell, state, optimizer, mesh, rules)
        with fake_mesh(mesh) as dmesh:
            device = sharded_run(model, cfg, cell, state, axes, optimizer, dmesh, rules, seq_shard)
        how = "run"
    memory["temp_size_in_bytes"] = device["temp_size_in_bytes"]
    return {"memory": memory, "dot_flops": device["dot_flops"], "collectives": device["collectives"],
            "global_dot_flops": total, "dot_flops_from": how}


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    seq_shard: bool = False,
    seq_parallel: bool = False,
    remat: str | None = None,
    rules_name: str = "default",
    dp: int | None = None,
    reduced: bool = False,
) -> dict:
    cfg = (get_reduced if reduced else get_config)(arch)
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    cell = SHAPES[shape_name]
    if reduced:  # a reduced config's positions may not reach the cell's length (whisper's 128)
        cell = dataclasses.replace(cell, seq_len=min(cell.seq_len, cfg.max_seq_len))
    if dp is not None:
        # perf-variant mesh: same 256 ranks, different dp x tp split
        if 256 % dp:
            raise ValueError(f"dp={dp} must divide 256")
        mesh = MeshShape(data=dp, model=256 // dp)
    else:
        mesh = production_shape(multi_pod=multi_pod)
    t0 = time.time()
    acc = account(cfg, cell, mesh, rules_name, seq_shard)
    n_devices = math.prod(mesh_shape(mesh).values())
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh_shape(mesh).values()),
        "n_devices": n_devices,
        "kind": cell.kind,
        "seq_len": cell.seq_len,
        "seq_shard": seq_shard,
        "account_s": round(time.time() - t0, 2),
        **acc,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
    }


def cell_path(arch: str, shape_name: str, multi_pod: bool, tag: str = "", out: Path = OUT_DIR) -> Path:
    out.mkdir(parents=True, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    return out / f"{arch}__{shape_name}__{'multi' if multi_pod else 'single'}{suffix}.json"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="an arch, or several separated by commas")
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--seq-shard", action="store_true", help="shard cache seq dim (perf variant)")
    ap.add_argument("--seq-parallel", action="store_true", help="sequence-parallel residual (perf variant)")
    ap.add_argument("--remat", default=None, choices=["none", "full", "dots"], help="override remat policy")
    ap.add_argument("--rules", default="default", choices=["default", "fsdp"], help="sharding rule set")
    ap.add_argument("--dp", type=int, default=None, help="override dp size (single-pod perf variant)")
    ap.add_argument("--tag", default="", help="suffix for output JSON (perf variants)")
    ap.add_argument("--reduced", action="store_true", help="the archs' reduced configs")
    ap.add_argument("--out", type=Path, default=OUT_DIR, help="directory of the JSON records")
    args = ap.parse_args(argv)

    if args.all:
        archs = ARCH_IDS
    elif args.arch:
        archs = [a.replace("-", "_") for a in args.arch.split(",")]
    else:
        ap.error("--arch or --all required")

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = []
    for arch in archs:
        cfg = get_config(arch)
        shapes = [args.shape] if args.shape else [c.name for c in applicable_shapes(cfg)]
        for shape_name in shapes:
            for multi in meshes:
                path = cell_path(arch, shape_name, multi, args.tag, args.out)
                if path.exists() and not args.force:
                    print(f"[skip] {path}")
                    continue
                label = f"{arch} x {shape_name} x {'2x16x16' if multi else '16x16'}"
                print(f"[dryrun] {label} ...", flush=True)
                try:
                    res = run_cell(
                        arch, shape_name, multi,
                        seq_shard=args.seq_shard, seq_parallel=args.seq_parallel,
                        remat=args.remat, rules_name=args.rules, dp=args.dp, reduced=args.reduced,
                    )
                    path.write_text(json.dumps(res, indent=2))
                    m, coll = res["memory"], res["collectives"]
                    print(
                        f"[ok] {label}: {res['account_s']}s "
                        f"args/device={m['argument_size_in_bytes']:.3e}B temp/device={m['temp_size_in_bytes']} "
                        f"dot_flops/device={res['dot_flops']} global={res['global_dot_flops']:.3e} "
                        f"collective_bytes/device={coll and coll['total_bytes']}",
                        flush=True,
                    )
                except Exception as e:
                    failures.append((label, repr(e)))
                    traceback.print_exc()
                    print(f"[FAIL] {label}: {e}", flush=True)

    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for label, err in failures:
            print(f"  {label}: {err[:200]}")
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()

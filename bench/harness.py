"""What every cell shares: the benchmark's files found by name, the program's
configuration built from a configuration file, weights drawn from the seed,
per-layer metric readers, and the result line.

Files are found by the names in ``BENCHMARK.json``, so a new cell, traffic
mix, configuration or metric is a new file and new entries, never an edit:

    bench/configs/<config>.json    sizes as run, source, what was cut
    bench/traffic/<traffic>.json   the mix: its loop and parameters
    bench/loops/<loop>.py          ``run(ctx) -> Record``
    bench/limits/<workload>.json   each compared number's limit
    bench/metrics/<metric>.py      ``read(record, name)``; a name ``a.b``
                                   falls back to ``a.py``
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names the run may not hold


def log(t_start: float, what: str) -> None:
    """A progress line on standard error, seconds since the process began."""
    print(f"[{time.perf_counter() - t_start:8.2f}s] {what}", file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    spec: dict
    workload: dict
    config: dict  # the configuration file
    traffic: dict  # the traffic file
    limits: dict  # number -> {"limit": ...}
    bench: Path

    @classmethod
    def load(cls, name: str, bench: Path = BENCH, root: Path = ROOT) -> "Cell":
        spec = load_json(root / "BENCHMARK.json")
        work = {w["name"]: w for w in spec["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r}; have {sorted(work)}")
        w = work[name]
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        return cls(name=name, spec=spec, workload=w, config=load_json(root / conf["file"]),
                   traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
                   limits=load_json(bench / "limits" / f"{name}.json"), bench=bench)

    def metrics(self, section: str) -> list[dict]:
        """The cell's entries of ``end_to_end`` or ``per_layer``: those that
        list it, or list no cells."""
        return [m for m in self.spec[section] if self.name in m.get("workloads", [self.name])]

    def loop(self) -> Callable:
        """The ``run`` of the loop module that the traffic file names."""
        name = self.traffic["loop"]
        return load_module(self.bench / "loops" / f"{name}.py", f"bench_loop_{name}").run

    def reader(self, metric: str) -> Callable:
        base = self.bench / "metrics"
        path = base / f"{metric}.py"
        if not path.exists():
            path = base / f"{metric.split('.')[0]}.py"
        return load_module(path, f"bench_metric_{path.stem}").read


# ------------------------------------------------------------------- model


def model_config(config: dict):
    """The program's configuration for a configuration file: the registry's
    published config with the file's ``model`` block written over it, each
    field checked to be what the file says."""
    from repro_torch.configs import get_config

    base = get_config(config["arch"])
    fields = {f.name for f in dataclasses.fields(base)}
    model = {k: v for k, v in config["model"].items() if k in fields}
    cfg = dataclasses.replace(base, **model)
    for k, v in model.items():
        if getattr(cfg, k) != v:
            raise ValueError(f"{config['arch']}: {k} is {getattr(cfg, k)!r}, the file says {v!r}")
    return cfg


def _chunk_seed(seed: int, chunk: int) -> int:
    return (seed * 1_000_003 + chunk * 7919 + 12345) % (1 << 62)


def _scale(path: tuple[str, ...], shape: tuple[int, ...]) -> tuple[float, float]:
    """(scale, offset) of a leaf drawn as offset + scale * N(0, 1): fan-in
    scaled matrices, a 0.02 embedding, norms near one, small biases."""
    name = path[-1]
    if name == "table":
        return 0.02, 0.0
    if path[-2].endswith("norm"):
        return 0.05, 1.0 if name == "scale" else 0.0
    if name == "wo":
        return 1.0 / math.sqrt(shape[0] * shape[1]), 0.0
    if name.startswith("w"):
        return 1.0 / math.sqrt(shape[0]), 0.0
    return 0.02, 0.0


class Weights:
    """Weights drawn from the seed on the device, one chunk at a time (the
    embedding, each layer, the final norm), a few large draws per chunk:
    one ``randn`` per dtype of the chunk with its own generator, carved into
    the leaves.  ``served`` casts the matrices (but the tied embedding) to
    the compute dtype, as the program serves them; otherwise every leaf is
    float32, as the program trains.  ``chunk(name)`` draws one chunk again,
    bit for bit."""

    def __init__(self, model, cfg, seed: int, device, served: bool):
        import torch

        from repro_torch.nn.module import init_with_axes
        from repro_torch.tree import flatten_with_path

        meta, _ = init_with_axes(model.init, 0, device="meta", dtype=torch.float32)
        self.leaves = flatten_with_path(meta)
        self.chunks = sorted({p[0] for p, _ in self.leaves})
        self.seed, self.device = seed, torch.device(device)
        compute = getattr(torch, cfg.dtype)
        self.dtype = lambda path, shape: (
            compute if served and len(shape) >= 2 and path[0] != "embed" else torch.float32)

    def chunk(self, name: str) -> dict[tuple[str, ...], Any]:
        import torch

        ci = self.chunks.index(name)
        mine = [(p, tuple(t.shape)) for p, t in self.leaves if p[0] == name]
        out = {}
        by_dtype: dict = {}
        for p, shape in mine:
            by_dtype.setdefault(self.dtype(p, shape), []).append((p, shape))
        for di, (dtype, group) in enumerate(sorted(by_dtype.items(), key=lambda kv: str(kv[0]))):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_chunk_seed(self.seed, 2 * ci + di))
            total = sum(math.prod(s) for _, s in group)
            flat = torch.randn(total, generator=gen, device=self.device, dtype=dtype)
            at = 0
            for p, shape in group:
                n = math.prod(shape)
                scale, offset = _scale(p, shape)
                leaf = flat[at : at + n].view(shape)
                leaf.mul_(scale).add_(offset)
                out[p] = leaf
                at += n
        return out

    def tree(self) -> dict:
        tree: dict = {}
        for name in self.chunks:
            for path, leaf in self.chunk(name).items():
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = leaf
        return tree


# ------------------------------------------------------------------ record


@dataclasses.dataclass
class Record:
    """What a loop hands back: end-to-end values, the program's counters
    over the window, the benchmark's own counts, the traced stretch, and
    the numbers compared with their limits."""

    setup_s: float
    window_s: float
    e2e: dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: list[tuple[str, float, float]]  # (name, value, limit): correct iff value <= limit
    counters: dict[str, float] = dataclasses.field(default_factory=dict)
    traced: dict[str, Any] = dataclasses.field(default_factory=dict)  # counts inside the traced stretch
    trace: Any = None  # bench.trace.TraceSummary of the traced stretch
    cfg: dict = dataclasses.field(default_factory=dict)  # the model block of the configuration file
    readings: dict[str, dict[str, float]] = dataclasses.field(default_factory=dict)  # those ``ctx.readings`` asked for

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(math.isfinite(v) and v <= lim for _, v, lim in self.checks)


def check_line(checks: list[tuple[str, float, float]]) -> dict:
    return {name: {"value": v, "limit": lim} for name, v, lim in checks}


def forbidden_modules() -> list[str]:
    """Modules held whose top-level name, compared whole, is JAX's or the
    JAX package's (``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def device_info(count: int, peak: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count, "memory_peak_bytes": peak}


def result(cell: Cell, rec: Record, trace: bool, device: dict) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    per-layer metrics read from the record (``--trace 1``); a reader that
    finds nothing to read leaves its metric out."""
    metrics = {}
    if not trace:
        values = dict(rec.e2e, setup_s=rec.setup_s)
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.metrics("per_layer"):
            v = cell.reader(m["name"])(rec, m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed, "metrics": metrics,
           "device": device}
    if trace and rec.trace is not None:
        out["device"] = dict(device, busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in rec.trace.device_ops()],
                            "idle_gaps": [list(x) for x in rec.trace.idle_gaps]}
    out["checks"] = check_line(rec.checks)
    return out

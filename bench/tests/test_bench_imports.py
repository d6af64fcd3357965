"""Import isolation: what a cell loads, and what the reference loads, in
fresh interpreters on the CPU.  A module's top-level name (the part before
the first dot) is compared whole, so ``repro_torch`` is not ``repro``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}

CELL = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from bench.harness import Cell, model_config, Weights
from repro_torch.configs import make_model
for name in {cells!r}:
    cell = Cell.load(name)
    cell.loop()
    for m in cell.metrics("per_layer"):
        cell.reader(m["name"])
import bench.calibrate, bench.run
import repro_torch.serving, repro_torch.launch.steps, repro_torch.data.pipeline, repro_torch.core.store
import repro_torch.optim.adamw
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{root!r}]
import torch
from bench.reference import dense_lm
m = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4, d_ff=16, vocab=11, mlp_type="gelu",
         rope_theta=1e4, norm_eps=1e-5)
g = torch.Generator().manual_seed(0)
r = lambda *s: torch.randn(*s, generator=g) * 0.1
ln = lambda: {{"scale": 1 + r(8), "bias": r(8)}}
p = {{"embed": {{"table": r(11, 8)}}, "final_norm": ln(),
     "prefix_0": {{"pre_norm": ln(), "pre_ffn_norm": ln(),
                  "mixer": {{"wq": r(8, 2, 4), "wk": r(8, 1, 4), "wv": r(8, 1, 4), "wo": r(2, 4, 8)}},
                  "ffn": {{"w_up": r(8, 16), "b_up": r(16), "w_down": r(16, 8), "b_down": r(8)}}}}}}
dense_lm.served_gaps(p, m, torch.tensor([1, 2, 3]), [4, 5], precisions=("fp32", "fp8"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(script: str) -> set[str]:
    env = {"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "USE_FLAX": "0", "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.fixture(scope="module")
def cells():
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def test_cell_import_path_loads_no_jax(cells):
    names = _top_level(CELL.format(root=str(ROOT), src=str(ROOT / "src"), cells=cells))
    assert "repro_torch" in names and "bench" in names
    assert not names & JAX_NAMES, names & JAX_NAMES


def test_reference_loads_nothing_of_either_package():
    names = _top_level(REFERENCE.format(root=str(ROOT)))
    assert "torch" in names
    assert not names & (JAX_NAMES | {"repro_torch"}), names & (JAX_NAMES | {"repro_torch"})


def test_the_harness_check_names_whole_top_levels():
    sys.path[:0] = [str(ROOT)]
    from bench.harness import forbidden_modules

    held = forbidden_modules()
    saved = {k: sys.modules.get(k) for k in ("repro_torch_like", "reproduce", "repro.x")}
    try:
        sys.modules["repro_torch_like"] = sys.modules["sys"]
        sys.modules["reproduce"] = sys.modules["sys"]
        assert forbidden_modules() == held
        sys.modules["repro.x"] = sys.modules["sys"]
        assert "repro.x" in forbidden_modules()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v

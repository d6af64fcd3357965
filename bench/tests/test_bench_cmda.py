"""The expert-share cell on the CPU at a reduced size, through the harness's
loop, wrapper and comparison: correct, nothing dropped, the routed rows
counted into the model's operations, the float8 control read; and the
reference loads nothing of the program."""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import Cell, result  # noqa: E402
from bench.run import Context  # noqa: E402

TINY = dict(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16, d_ff=32, vocab=512, window=16,
            global_every=4, experts_held=4, experts_lo=4, moe_experts=8, moe_top_k=3, moe_expert_ff=32, moe_shared=2)
MIX = dict(clients=3, block=4, kv_window=8, kv_page=4, max_batch=3, trace_after_s=0.2, trace_steps=3,
           prompt=dict(mean=30, sigma=1.0, range=[10, 60]), output=dict(mean=9, sigma=1.0, range=[6, 12]))


@pytest.fixture()
def reduced_registry(monkeypatch):
    """The registry's Command A+ at its reduced size, whose MoE the tiny file states."""
    import repro_torch.configs as C

    real = C.get_config
    monkeypatch.setattr(C, "get_config", lambda arch: C.get_reduced(arch) if arch == "command_a_plus_05_2026"
                        else real(arch))


def run_tiny(trace: bool, readings: tuple = ()):
    cell = Cell.load("cmda-moe-rag-c16")
    config = copy.deepcopy(cell.config)
    config["model"].update(TINY)
    ctx = Context(config=config, traffic=dict(cell.traffic, **MIX), limits=cell.limits, seed=2**33 + 5, seconds=3.0,
                  trace=trace, device="cpu", t_start=time.perf_counter(), readings=readings)
    rec = cell.loop()(ctx)
    return rec, result(cell, rec, trace, {"kind": "cpu"})


def test_cell_is_correct_with_its_control(reduced_registry):
    rec, line = run_tiny(False, readings=("control",))
    assert line["correct"] and list(line["checks"]) == ["served_gap", "logit_gap", "moe_dropped"]
    assert line["checks"]["moe_dropped"]["value"] == 0
    assert rec.counters["moe_held"] > 0 and rec.counters["bytes_staged"] > 0
    for name in ("served_gap", "logit_gap"):
        assert rec.readings["control"][name] > line["checks"][name]["value"]
    assert set(line["metrics"]) == {"output_tok_s", "itl_p99_ms", "setup_s"}


def test_traced_run_notes_the_share_call_by_call(reduced_registry):
    rec, line = run_tiny(True)
    moe = rec.traced["moe"]
    assert moe["calls"] and all(rows >= experts >= 0 for rows, experts in moe["calls"])
    assert moe["launches"] == 0  # the CPU runs the plain twin: no kernel launched, none traced
    assert "moe_grouped_roofline" not in line["metrics"] and "decode_step_ms" in line["metrics"]


def test_reference_loads_nothing_of_either_package():
    script = (f"import sys, json; sys.path[:0] = [{str(ROOT)!r}]\n"
              "from bench.reference import cohere2_moe\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "JAX_PLATFORMS": "cpu"})
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}

"""The benchmark's yardstick: percentiles over all samples, the union of
overlapping kernel intervals, idle gaps, and the counts of operations and
bytes at shapes worked out by hand; the per-layer readers on records."""

from __future__ import annotations

import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path[:0] = [str(Path(__file__).resolve().parents[2]), str(Path(__file__).resolve().parents[2] / "src")]

from bench import yardstick as Y  # noqa: E402
from bench.harness import Cell, Record  # noqa: E402
from bench.trace import TraceSummary, reduce_events  # noqa: E402


@pytest.mark.parametrize("q", [50, 95, 99, 100])
def test_percentile_matches_numpy_over_all_samples(q):
    xs = list(np.random.default_rng(0).exponential(size=1001))
    assert Y.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_percentile_is_not_a_maximum_of_a_few():
    xs = [1.0] * 99 + [100.0]
    assert Y.percentile(xs, 95) == 1.0
    assert Y.percentile(xs, 99) == pytest.approx(1.99)
    with pytest.raises(ValueError):
        Y.percentile([], 99)


def test_union_counts_overlap_once():
    assert Y.union_seconds([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert Y.union_seconds([(0, 10), (2, 3), (4, 5)]) == pytest.approx(10.0)
    assert Y.union_seconds([]) == 0.0


def test_gaps_longest_first():
    got = Y.gaps([(0, 1), (3, 4), (4.5, 9)], 0, 10)
    assert got == [(1, 3), (9, 10), (4, 4.5)]


def test_bound_picks_the_slower_roof():
    t, which = Y.bound(3.35e12, 1.0)
    assert (t, which) == (pytest.approx(1.0), "bytes")
    t, which = Y.bound(1.0, 989e12)
    assert (t, which) == (pytest.approx(1.0), "operations")


def test_flash_work_by_hand():
    # s = 4: 10 visible pairs; 2 heads of 8: 4 * 2 * 8 * 10 operations.
    flops, nbytes = Y.flash_work(4, 2, 1, 8)
    assert flops == 640
    assert nbytes == 2 * 4 * 8 * (2 * 2 + 2 * 1)


def test_tiered_rows_work_by_hand():
    flops, nbytes = Y.tiered_rows_work([3, 5], heads=4, kv_heads=2, d=16)
    assert flops == 4 * 4 * 16 * 8
    assert nbytes == 2 * (2 * 2 * 16 * 8 + 2 * 2 * 4 * 16)


M = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab": 10,
     "mlp_type": "swiglu"}


def test_model_counts_by_hand():
    mp = Y.matmul_params(M)
    # q and o 8x8 each, k and v 8x4 each, three 8x16 MLP matrices.
    assert mp == {"layer": 64 + 64 + 32 + 32 + 3 * 128, "head": 80}
    # one prompt of 3: 2 layers x (2 * 576 * 3 + 4 * 2 * 4 * 6) + the head once.
    assert Y.prefill_flops(M, 3) == 2 * (2 * 576 * 3 + 192) + 160
    # rows at positions 0 and 2 see 1 and 3 keys.
    assert Y.decode_flops(M, [0, 2]) == 2 * (2 * 2 * 576 + 160) + 2 * 4 * 2 * 4 * (1 + 3)
    # a train step: 3 forwards of every position's layers and head.
    assert Y.train_flops(M, 2, 3) == 3 * 2 * (2 * (2 * 576 * 3 + 192) + 2 * 80 * 3)


def _ev(name, start_us, dur_us, cuda):
    import torch

    dt = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, start_ns=lambda: start_us * 1000, duration_ns=lambda: dur_us * 1000,
                           device_type=lambda: dt)


def test_reduce_events_union_copies_and_gap_names():
    evs = [_ev("gemm", 0, 100, True), _ev("gemm", 50, 100, True), _ev("Memcpy HtoD (Pinned -> Device)", 150, 400, True),
           _ev("flash", 600, 100, True), _ev("bench.decode", 140, 500, False), _ev("aten::copy_", 200, 300, False)]
    s = reduce_events(evs, window_s=1e-3)
    assert s.busy_s == pytest.approx(250e-6)  # the copy leaves the SMs idle
    assert s.device_s_by_name["gemm"] == pytest.approx(200e-6)
    assert s.kernel_seconds("flash") == pytest.approx(100e-6)
    name, length = s.idle_gaps[0]
    assert length == pytest.approx(450e-6) and name == "bench.decode > aten::copy_"


def _rec(**kw):
    base = dict(setup_s=1.0, window_s=10.0, e2e={}, attempted=1, failed=0, memory_peak_bytes=0, checks=[])
    return Record(**{**base, **kw})


def _reader(name):
    return Cell.reader(SimpleNamespace(bench=Path(__file__).resolve().parents[1]), name)


def test_readers_return_nothing_without_data():
    rec = _rec(counters={"prefill_s": 0.0, "decode_s": 0.0, "bytes_staged": 0}, cfg=M)
    for name in ("prefill_ms_per_ktok.rag", "decode_step_ms", "kv_h2d_mb_per_step", "mfu.serve", "flash_roofline",
                 "tiered_rows_roofline", "data_wait_ms.train", "device_idle.serve"):
        assert _reader(name)(rec, name) is None, name


def test_readers_on_a_record():
    trace = TraceSummary(window_s=2.0, busy_s=1.5, idle_gaps=[],
                         device_s_by_name={"void flash_wgmma_kernel<128>": 0.004, "tiered_rows_partial_kernel<x>": 0.002,
                                           "void tiered_merge_kernel<y>": 0.001},
                         device_n_by_name={"void flash_wgmma_kernel<128>": 2, "tiered_rows_partial_kernel<x>": 2,
                                           "void tiered_merge_kernel<y>": 2})
    rec = _rec(counters={"prefill_s": 2.0, "prefill_tokens": 4000, "decode_s": 1.0, "decode_steps": 100,
                         "bytes_staged": 5e8, "model_flops": 989e12, "steps": 4, "data_wait_s": 0.02},
               trace=trace, traced={"prefill_tokens": [1024], "decode_contexts": [[10, 20]],
                                    "launches": {"flash": 2, "tiered_rows": 2}}, cfg=M)
    assert _reader("prefill_ms_per_ktok.rag")(rec, "") == pytest.approx(500.0)
    assert _reader("decode_step_ms")(rec, "") == pytest.approx(10.0)
    assert _reader("kv_h2d_mb_per_step")(rec, "") == pytest.approx(5.0)
    assert _reader("mfu.serve")(rec, "") == pytest.approx(10.0)
    assert _reader("data_wait_ms.train")(rec, "") == pytest.approx(5.0)
    assert _reader("device_idle.train")(rec, "") == pytest.approx(25.0)
    # flash at s = 1024, 2 heads of 4: 4 * 2 * 4 * 524800 operations, bound by them.
    least = 2 * 4 * 2 * 4 * 524800 / 989e12
    assert _reader("flash_roofline")(rec, "") == pytest.approx(100 * least / 0.004)
    # rows over 11 and 21 keys: k and v of one kv head of 4, q and out of 2 heads, bound by bytes.
    least = 2 * 2 * (2 * 1 * 4 * 32 + 2 * 2 * 2 * 4) / 3.35e12
    assert _reader("tiered_rows_roofline")(rec, "") == pytest.approx(100 * least / 0.003)


def test_roofline_readers_refuse_a_trace_that_lost_launches():
    trace = TraceSummary(window_s=2.0, busy_s=1.5, idle_gaps=[], device_s_by_name={"flash_wgmma_kernel<128>": 0.004},
                         device_n_by_name={"flash_wgmma_kernel<128>": 1})
    rec = _rec(trace=trace, traced={"prefill_tokens": [1024], "launches": {"flash": 2, "tiered_rows": 0}}, cfg=M)
    assert _reader("flash_roofline")(rec, "") is None


def test_every_seed_sends_the_same_sizes_in_another_order():
    from bench.traffic import Sessions

    mix = {"clients": 4, "block": 4, "prompt": {"mean": 150, "sigma": 1.0, "range": [100, 200]},
           "output": {"mean": 20, "sigma": 1.0, "range": [10, 30]}}
    a, b = Sessions(mix, 1, 50), Sessions(mix, 2**31 + 5, 50)
    for block in range(3):
        la = sorted(a.lengths(4 * block + j) for j in range(4))
        lb = sorted(b.lengths(4 * block + j) for j in range(4))
        assert [p for p, _ in la] == [p for p, _ in lb] == [108, 127, 150, 181]
        assert la == lb == [(108, 11), (127, 25), (150, 19), (181, 15)]  # the same pairs
    assert [a.lengths(i) for i in range(8)] != [b.lengths(i) for i in range(8)]
    assert (a[3].prompt == Sessions(mix, 1, 50)[3].prompt).all()


def test_strata_follow_the_conditioned_lognormal():
    """Each stratum's length has the probability of its slice's midpoint
    under the log-normal of that mean, conditioned on the range."""
    from statistics import NormalDist

    from bench.traffic import strata

    spec = {"mean": 7590, "sigma": 1.0, "range": [2048, 16384]}
    got = strata(spec, 8)
    assert list(got) == sorted(got) and 2048 < got[0] and got[-1] < 16384
    dist = NormalDist(math.log(7590) - 0.5, 1.0)
    lo, hi = dist.cdf(math.log(2048)), dist.cdf(math.log(16384))
    for j, x in enumerate(got):
        assert (dist.cdf(math.log(x)) - lo) / (hi - lo) == pytest.approx((j + 0.5) / 8, abs=1e-3)
    wide = strata(dict(spec, range=[1, 10**9]), 2000)  # nearly unconditioned: the mean comes back
    assert wide.mean() == pytest.approx(7590, rel=0.05)

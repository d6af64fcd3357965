"""Model FLOP/s utilisation over the window: the benchmark's own count of
the model's operations (``bench.yardstick``: products over every matrix
weight, causal attention, the head where the program computes it; a train
step counted as three forwards, without recomputation) over the window's
seconds and the card's bf16 peak."""

from bench.yardstick import PEAK_FLOPS


def read(rec, name):
    flops = rec.counters.get("model_flops", 0)
    return 100.0 * flops / rec.window_s / PEAK_FLOPS["bfloat16"] if flops else None

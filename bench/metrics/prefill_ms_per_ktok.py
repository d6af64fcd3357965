"""Scheduler prefill time per 1000 prompt tokens over the window: the
program's own ``SessionScheduler.prefill_s`` (a host clock ending in the
device's wait for the first token), over the benchmark's count of the
prompt tokens prefilled."""


def read(rec, name):
    n = rec.counters.get("prefill_tokens", 0)
    return 1e6 * rec.counters["prefill_s"] / n if n else None

"""Milliseconds a training step waits for its batch: a host clock around
``next(loader)`` of the program's ``ShardedLoader``, averaged over the
window's steps."""


def read(rec, name):
    n = rec.counters.get("steps", 0)
    return 1e3 * rec.counters["data_wait_s"] / n if n else None

"""Milliseconds a decode dispatch: the program's ``SessionScheduler.decode_s``
over the window (a host clock ending in the device's wait for the step's
tokens), over the decode dispatches the benchmark counted."""


def read(rec, name):
    n = rec.counters.get("decode_steps", 0)
    return 1e3 * rec.counters["decode_s"] / n if n else None

"""The card's idle share of the traced stretch: one less the union of the
device operations' intervals (copies on the copy engines left out) over
the stretch's wall seconds."""


def read(rec, name):
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)

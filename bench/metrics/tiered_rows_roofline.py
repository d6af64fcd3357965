"""The per-row tiered decode kernel's share of its roofline in the traced
stretch: the least time for every layer of every decode dispatch traced,
each row reading its whole context of keys and values once
(``bench.yardstick.tiered_rows_work``), over the device time of the
kernel's two passes in the trace."""

from bench.yardstick import bound, tiered_rows_work

KERNELS = ("tiered_rows_partial_kernel", "tiered_merge_kernel")


def read(rec, name):
    if rec.trace is None or not rec.traced.get("decode_contexts"):
        return None
    busy = rec.trace.kernel_seconds(*KERNELS)
    if busy <= 0 or rec.trace.kernel_count(*KERNELS[:1]) != rec.traced["launches"]["tiered_rows"]:
        return None  # the trace lost launches that the program counted
    m = rec.cfg
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = 0.0
    for ctx in rec.traced["decode_contexts"]:
        flops, nbytes = tiered_rows_work([c + 1 for c in ctx], m["n_heads"], m["n_kv_heads"], hd)
        least += m["n_layers"] * bound(nbytes, flops)[0]
    return 100.0 * least / busy

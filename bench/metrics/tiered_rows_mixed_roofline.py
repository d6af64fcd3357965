"""The per-row tiered decode kernel's share of its roofline in the traced
stretch of a model that mixes window and global layers: as
``tiered_rows_roofline``, but each window layer's launch reads min(context
+ 1, window) keys a row from its ring and each global layer's the whole
context (``bench.moe_share.tiered_rows_mixed_work``; the layers' windows
from the configuration file's ``window`` and ``global_every``), over the
device time of the kernel's two passes in the trace."""

from bench.moe_share import layer_windows, tiered_rows_mixed_work
from bench.yardstick import bound

KERNELS = ("tiered_rows_partial_kernel", "tiered_merge_kernel")


def read(rec, name):
    if rec.trace is None or not rec.traced.get("decode_contexts"):
        return None
    busy = rec.trace.kernel_seconds(*KERNELS)
    if busy <= 0 or rec.trace.kernel_count(*KERNELS[:1]) != rec.traced["launches"]["tiered_rows"]:
        return None  # the trace lost launches that the program counted
    windows = layer_windows(rec.cfg)
    least = 0.0
    for ctx in rec.traced["decode_contexts"]:
        for w in windows:
            flops, nbytes = tiered_rows_mixed_work(rec.cfg, ctx, w)
            least += bound(nbytes, flops)[0]
    return 100.0 * least / busy

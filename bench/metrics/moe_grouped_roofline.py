"""The grouped expert product's share of its roofline in the traced
stretch: the least time the card could take for the held experts' work of
every prefill and decode step traced (``bench.moe_share.moe_grouped_work``
a call: each held expert with a row reads its three matrices once, each
row is read and written once; ``bound`` a call) over the device time of
the product's two kernels in the trace."""

from bench.moe_share import moe_grouped_work
from bench.yardstick import bound

KERNELS = ("moe_gate_up_kernel", "moe_down_kernel")
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def read(rec, name):
    moe = rec.traced.get("moe")
    if rec.trace is None or not moe or not moe["calls"]:
        return None
    busy = rec.trace.kernel_seconds(*KERNELS)
    if busy <= 0 or rec.trace.kernel_count(*KERNELS[:1]) != moe["launches"]:
        return None  # the trace lost launches that the program counted
    least = 0.0
    for rows, experts in moe["calls"]:
        flops, nbytes = moe_grouped_work(rows, experts, rec.cfg, ITEMSIZE[rec.cfg["dtype"]])
        least += bound(nbytes, flops)[0]
    return 100.0 * least / busy

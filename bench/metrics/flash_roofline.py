"""The flash kernel's share of its roofline in the traced stretch: the
least time the card could take for the causal attention of every layer of
every prefill traced (``bench.yardstick.flash_work``, ``bound``) over the
device time of the kernel's launches in the trace."""

from bench.yardstick import bound, flash_work

KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel")


def read(rec, name):
    if rec.trace is None or not rec.traced.get("prefill_tokens"):
        return None
    busy = rec.trace.kernel_seconds(*KERNELS)
    if busy <= 0 or rec.trace.kernel_count(*KERNELS) != rec.traced["launches"]["flash"]:
        return None  # the trace lost launches that the program counted
    m = rec.cfg
    hd = m.get("head_dim") or m["d_model"] // m["n_heads"]
    least = 0.0
    for s in rec.traced["prefill_tokens"]:
        flops, nbytes = flash_work(s, m["n_heads"], m["n_kv_heads"], hd)
        least += m["n_layers"] * bound(nbytes, flops)[0]
    return 100.0 * least / busy

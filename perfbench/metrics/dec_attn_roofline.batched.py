"""Share of its roofline that the decode's attention reaches: the least
time of the bytes that the steps' self- and cross-attention need at each
call's shapes (``work.decode_attn_bytes``) over the HBM bandwidth, over the
device time of the kernels named below."""

from perfbench import work

KERNELS = ["beam_attend_append_kernel", "cross_attend_kernel"]


def read(ctx):
    if ctx.driver != "batched":
        return None
    sec = ctx.trace.device_seconds(names=KERNELS)
    if not sec:
        return None
    nbytes = sum(work.decode_attn_bytes(ctx.dims, d["rows"], d["beams"], d["prompt"], d["steps"], ctx.kv_int8)
                 for d in ctx.decodes)
    return 100.0 * nbytes / work.peaks()["hbm_bytes_per_s"] / sec

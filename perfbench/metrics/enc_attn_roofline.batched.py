"""Share of its roofline that the encoder's self-attention reaches: the
least time of its QK and PV operations over the bf16 peak (or of its q, k,
v and output bytes over the HBM bandwidth, where that is longer) at the
rows each encode was given, over the device time of the kernels named
below."""

from perfbench import work

KERNELS = ["flash_fwd_wgmma_kernel", "flash_fwd_f32_kernel"]


def read(ctx):
    if ctx.driver != "batched":
        return None
    sec = ctx.trace.device_seconds(names=KERNELS)
    rows = sum(ctx.encodes)
    if not sec or not rows:
        return None
    p = work.peaks()
    ops = work.encoder_attn_ops(ctx.dims, rows)
    nbytes = rows * ctx.dims.enc_layers * 4 * ctx.dims.audio_ctx * ctx.dims.d * 2
    return 100.0 * max(ops / p["bf16_flops"], nbytes / p["hbm_bytes_per_s"]) / sec

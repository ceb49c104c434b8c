"""The whole step's share of the card's peak in the batched path: the
model's operations in the traced slice, counted from the published shapes
(``work``: the encoder and the cross K/V per window encoded, the decoder
per row and step, the logits), each over its type's peak (int8 products at
the int8 peak, the rest at the bf16 peak), over the wall time of the slice
run untraced.
Rows are counted as the batches ran, pow2 padding included."""

from perfbench import work


def read(ctx):
    if ctx.driver != "batched" or not ctx.decodes:
        return None
    p = work.peaks()
    mm_peak = p["int8_ops"] if ctx.kv_int8 else p["bf16_flops"]
    t = 0.0
    enc = work.encoder_ops(ctx.dims)
    for rows in ctx.encodes:
        t += rows * (enc["conv"] / p["bf16_flops"] + enc["attn"] / p["bf16_flops"] + enc["matmul"] / mm_peak)
        t += rows * work.cross_kv_ops(ctx.dims) / mm_peak
    for d in ctx.decodes:
        ops = work.decode_ops(ctx.dims, d["rows"], d["beams"], d["prompt"], d["steps"])
        t += (ops["matmul"] + ops["logits"]) / mm_peak + ops["attn"] / p["bf16_flops"]
    return 100.0 * t / ctx.wall_s

"""Host ms of the batched pipeline's own bookkeeping per minute of audio:
the program's ``fwt.pipeline.chunks`` (the VAD's chunks, their metadata,
the speech concat) and ``fwt.pipeline.segments`` (the segment split, the
tokenizer's decode, the ``Segment`` objects) spans, on the program's clock
over the slice run untraced."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    names = ("fwt.pipeline.chunks", "fwt.pipeline.segments")
    if ctx.driver != "batched" or not spans or not ctx.audio_s or not any(n in spans for n in names):
        return None
    host_s = sum(spans[n][1] for n in names if n in spans)
    return 1e3 * host_s / (ctx.audio_s / 60.0)

"""Host ms per decode step of the batched path inside the program's own
spans: ``fwt.decode.select`` (the logits rules through the beams' ancestry
update) and ``fwt.decode.step`` (the decoder step's launches), on the
program's clock over the slice run untraced, over the count of
``fwt.decode.step``. The stop read (``fwt.decode.stop``), where the host
waits for the card, is left out: what is left is the host's own side of a
step."""


def read(ctx):
    spans = getattr(ctx, "spans", None)
    if ctx.driver != "batched" or not spans or "fwt.decode.step" not in spans:
        return None
    steps, step_s = spans["fwt.decode.step"]
    return 1e3 * (step_s + spans.get("fwt.decode.select", (0, 0.0))[1]) / steps

"""Device ms of the logits head per decode step of the batched path: the
operations launched inside the program's ``fwt.decode.logits`` spans (the
final layer norm and the product over the vocabulary) in the profiled
slice, over the profile's count of ``fwt.decode.step`` ranges."""


def read(ctx):
    tr = ctx.trace
    if ctx.driver != "batched" or not hasattr(tr, "span_count"):
        return None
    steps = tr.span_count("fwt.decode.step")
    if not steps or not tr.span_count("fwt.decode.logits"):
        return None
    return 1e3 * tr.span_device_seconds(["fwt.decode.logits"]) / steps

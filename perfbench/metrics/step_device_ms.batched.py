"""Device ms per decode step of the batched path: the device time of the
operations launched inside the program's ``fwt.decode.select`` and
``fwt.decode.step`` spans (at any depth) in the profiled slice, over the
profile's count of ``fwt.decode.step`` ranges: the card's side of a step."""


def read(ctx):
    tr = ctx.trace
    if ctx.driver != "batched" or not hasattr(tr, "span_count"):
        return None
    steps = tr.span_count("fwt.decode.step")
    if not steps:
        return None
    return 1e3 * tr.span_device_seconds(["fwt.decode.select", "fwt.decode.step"]) / steps

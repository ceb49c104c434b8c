"""Device ms of the W8A8 products per decode step of the batched path: the
operations launched inside the program's ``fwt.int8_dense`` spans nested in
``fwt.decode.step`` (each product's int8 GEMM with its row quantization,
padding and rescale, the logits head's too) in the profiled slice, over
the profile's count of ``fwt.decode.step`` ranges. None in a cell with no
int8 products."""


def read(ctx):
    tr = ctx.trace
    if ctx.driver != "batched" or not hasattr(tr, "span_count"):
        return None
    steps = tr.span_count("fwt.decode.step")
    if not steps or not tr.span_count("fwt.int8_dense"):
        return None
    return 1e3 * tr.span_device_seconds(["fwt.int8_dense"], within=["fwt.decode.step"]) / steps

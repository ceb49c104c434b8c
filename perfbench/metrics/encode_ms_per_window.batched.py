"""Device ms of the encoder (the kernels launched inside the engine's
``encode`` calls) per 30 s window the slice transcribed."""


def read(ctx):
    if ctx.driver != "batched" or not ctx.windows:
        return None
    sec = ctx.trace.device_seconds("bench.encode")
    return 1e3 * sec / ctx.windows if sec else None

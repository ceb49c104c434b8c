"""Device ms of the batched pipeline's front end (the VAD's forward and the
chunked log-mel: the kernels launched inside the ``bench.vad`` and
``bench.mel`` ranges) per minute of audio in the slice."""


def read(ctx):
    if ctx.driver != "batched" or not ctx.audio_s:
        return None
    sec = ctx.trace.device_seconds("bench.vad") + ctx.trace.device_seconds("bench.mel")
    return 1e3 * sec / (ctx.audio_s / 60.0) if sec else None

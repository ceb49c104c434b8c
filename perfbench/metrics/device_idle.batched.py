"""Share of the batched path's slice in which no kernel, copy or fill ran
on the card: the device's busy time from the profile of the slice, over
the wall time of the same slice run untraced just before (the profiler
slows the host, so its own window would read the card idler than it is)."""


def read(ctx):
    if ctx.driver != "batched" or not ctx.wall_s:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.wall_s)

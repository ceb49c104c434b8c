"""Wall ms per decode step of the batched path: the host time inside the
engine's decode calls over the slice run untraced (the Recorder's own
clock, one ``perf_counter`` a call), over their steps (the program's K1/K2
launch counters over the decoder's layers)."""


def read(ctx):
    steps = sum(d["steps"] for d in ctx.decodes)
    if ctx.driver != "batched" or not steps:
        return None
    return 1e3 * ctx.range_wall["bench.decode"] / steps

"""CUDA runtime kernel launches per decode-loop iteration of the batched
path: the profiler's launch calls (``cudaLaunchKernel`` and its kin) inside
the engine's decode calls, over their steps."""


def read(ctx):
    steps = sum(d["steps"] for d in ctx.decodes)
    if ctx.driver != "batched" or not steps:
        return None
    return ctx.trace.launches_in("bench.decode") / steps

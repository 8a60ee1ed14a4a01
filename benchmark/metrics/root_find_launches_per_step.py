"""Kernel launches a training step inside the root find (`ntt.cast.*` spans:
UNISURF's march and secant steps, `models/ray_casting.py`): the host runtime
calls of `spans.LAUNCHES` (cudaLaunchKernel, cudaLaunchKernelExC,
cuLaunchKernel, cuLaunchKernelEx) that lie inside such a span, per step.
What CUDA graphs or a fused secant would move. Reads nothing (None) from a
program without the `ntt.cast.*` spans."""

import bisect

from benchmark import spans

LAYER = "models/ray_casting.py (the root find)"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
CAST = spans.PREFIX + "cast."


def read(ctx):
    trace = ctx.trace
    cast = sorted((a, b) for n, a, b in trace.host if n.startswith(CAST))
    if not cast:
        return None
    starts = [a for a, _ in cast]
    n = 0
    for name, a, b in trace.host:
        if name in spans.LAUNCHES:
            k = bisect.bisect_right(starts, a) - 1
            n += k >= 0 and b <= cast[k][1]
    return n / trace.units

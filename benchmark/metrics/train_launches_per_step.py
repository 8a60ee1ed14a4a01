"""Kernel launches a training step (cudaLaunchKernel, cudaLaunchKernelExC,
cuLaunchKernel, cuLaunchKernelEx) inside the program's `ntt.step` spans
(benchmark/spans.py)."""

from benchmark import spans

LAYER = "training.py (the step)"
UNIT = "count"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return spans.calls_per_step(ctx.trace, spans.LAUNCHES)

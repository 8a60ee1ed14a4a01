"""Kernel 1's share of its roofline in training: the least time the step's
forward-with-nablas work needs, over the device time of its kernel."""

LAYER = "ops/fused_nablas.py (kernel 1)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
PATTERNS = (r"ntt::nablas_forward_kernel",)


def read(ctx):
    return ctx.roofline("fused_nablas", PATTERNS)

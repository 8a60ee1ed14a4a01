"""Kernel 3's share of its roofline: the least time the eikonal backward needs
(without recomputing the forward), over the device time of its tile pass and
its reductions."""

LAYER = "ops/fused_nablas_vjp.py (kernel 3)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
PATTERNS = (r"ntt::(backward_tile|outer_sum|colsum|split_sum)_kernel",)


def read(ctx):
    return ctx.roofline("fused_nablas_vjp", PATTERNS)

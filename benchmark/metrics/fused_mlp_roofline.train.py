"""Kernel 4's share of its roofline: the least time the VolSDF sampler's sdf
queries need, over the device time of its kernel."""

LAYER = "ops/fused_mlp.py (kernel 4)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
PATTERNS = (r"ntt::sdf_forward_kernel",)


def read(ctx):
    return ctx.roofline("fused_mlp", PATTERNS)

"""Kernel 2's share of its roofline in the render: the least time the NeuS
upsampler's sdf queries need, over the device time of its kernel."""

LAYER = "ops/fused_upsample.py (kernel 2)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"
PATTERNS = (r"ntt::neus_upsample_kernel",)


def read(ctx):
    return ctx.roofline("fused_upsample", PATTERNS)

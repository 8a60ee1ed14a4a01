"""Device milliseconds a training step spends in the VolSDF fine sampler: its
kernels (a)-(c) and its kernel-4 queries."""

LAYER = "ops/fused_fine_sample.py (the VolSDF sampler)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
PATTERNS = (r"ntt::vfs::(init|draw|checkpoint)_kernel", r"ntt::sdf_forward_kernel")


def read(ctx):
    return ctx.ms_per_unit(PATTERNS)

"""The render's share of the card's TF32 peak: every MLP query the frames of
the traced stretch need (the upsampler's sdf, sdf with nablas, radiance),
each once, over the stretch's length."""

LAYER = "training.py (render_full_image)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"


def read(ctx):
    return ctx.mfu()

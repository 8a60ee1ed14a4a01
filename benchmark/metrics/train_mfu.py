"""The training step's share of the card's TF32 peak: every MLP query the steps
of the traced stretch need (forward, nablas, eikonal backward, radiance
forward and backward, the sampler's queries), each once, over the stretch's
length."""

LAYER = "training.py (the step)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return ctx.mfu()

"""Device-idle milliseconds a training step while the host was in the step's
own code (`ntt.step*` spans: the draw, the backward, the update): the
stretch's idle gaps by the innermost span at each gap's middle
(benchmark/spans.py)."""

from benchmark import spans

LAYER = "training.py (the step)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return spans.idle_part(ctx.trace, "training")

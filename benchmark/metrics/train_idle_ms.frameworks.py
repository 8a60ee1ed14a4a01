"""Device-idle milliseconds a training step while the host was in the
frameworks (`ntt.neus.*`, `ntt.volsdf.*`, `ntt.unisurf.*` spans: sampler,
render, loss): the stretch's idle gaps by the innermost span at each gap's
middle (benchmark/spans.py)."""

from benchmark import spans

LAYER = "frameworks"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return spans.idle_part(ctx.trace, "frameworks")

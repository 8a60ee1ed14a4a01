"""Device-idle milliseconds a training step while the host was in the host side
of the kernel wrappers (`ntt.op.*` spans): the stretch's idle gaps by the
innermost span at each gap's middle (benchmark/spans.py)."""

from benchmark import spans

LAYER = "ops (host side of the kernel wrappers)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"


def read(ctx):
    return spans.idle_part(ctx.trace, "ops")

"""Device-idle milliseconds a rendered frame while the host was in no span of
the program (the caller's loop between calls): the stretch's idle gaps by
the innermost span at each gap's middle (benchmark/spans.py)."""

from benchmark import spans

LAYER = "entry"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"


def read(ctx):
    return spans.idle_part(ctx.trace, "unspanned")

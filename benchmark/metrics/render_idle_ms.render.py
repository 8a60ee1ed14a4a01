"""Device-idle milliseconds a rendered frame while the host was in
render_full_image's own code (`ntt.render*` spans: the chunk loop, the
copies to the host): the stretch's idle gaps by the innermost span at each
gap's middle (benchmark/spans.py)."""

from benchmark import spans

LAYER = "training.py (render_full_image)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"


def read(ctx):
    return spans.idle_part(ctx.trace, "training")

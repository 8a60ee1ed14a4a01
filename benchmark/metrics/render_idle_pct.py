"""The device's idle share over the traced stretch of rendered frames: one
minus the union of its kernels, copies and sets over the stretch's length."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "render_rays_per_s"


def read(ctx):
    return ctx.idle_pct()

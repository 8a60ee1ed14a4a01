"""Device-idle milliseconds a training step while the host was in the root
find's own code (UNISURF's march and secant steps, `models/ray_casting.py`):
the gaps of `train_idle_ms.frameworks` whose middle also lies under an
`ntt.cast.*` span, on any host thread. A part of `train_idle_ms.frameworks`:
a gap goes to the innermost span of a known layer at its middle
(benchmark/spans.py), which `ntt.cast.*` is not, so a gap under kernel 4's
wrapper inside the root find (`ntt.op.sdf_forward`) stays with
`train_idle_ms.ops`. Reads nothing (None) from a program without the
`ntt.cast.*` spans."""

from benchmark import spans

LAYER = "models/ray_casting.py (the root find)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "train_rays_per_s"
CAST = spans.PREFIX + "cast."


def read(ctx):
    trace = ctx.trace
    sp = sorted(((n.startswith(CAST), spans.layer(n), a, b) for n, a, b in trace.host
                 if n.startswith(spans.PREFIX)), key=lambda s: s[2])
    sp = [s for s in sp if s[0] or s[1] is not None]
    if not any(s[0] for s in sp):
        return None
    total, active, i = 0.0, [], 0
    for (_, end), (start, _) in zip(trace.busy, trace.busy[1:]):
        mid = 0.5 * (end + start)  # the gaps come in time order
        while i < len(sp) and sp[i][2] <= mid:
            active.append(sp[i])
            i += 1
        active = [s for s in active if s[3] >= mid]
        known = [s for s in active if not s[0]]
        inner = min(known, key=lambda s: s[3] - s[2])[1] if known else None
        if inner == "frameworks" and any(s[0] for s in active):
            total += start - end
    return total / 1e3 / trace.units

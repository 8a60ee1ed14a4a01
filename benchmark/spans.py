"""The program's own spans in a traced stretch (`neurecon_tpu_torch/utils/
trace.py`: host annotations named `ntt.*`, on the device trace's clock).

`idle_ms` gives every idle gap between the device's busy intervals
(`Trace.busy`, the gaps `Trace.breakdown` labels) to the innermost `ntt.*`
span covering the gap's middle, the shortest one, on whatever host thread it
runs (kernel 3's wrapper runs on the autograd engine's thread), and sums the
gaps by that span's layer: the step and the render (`step*`, `render*`,
training.py), the frameworks (`neus.*`, `volsdf.*`, `unisurf.*`), the
kernel wrappers (`op.*`), or `unspanned` where no span covers the middle.
The parts add up to the stretch's summed gaps; a span of no known layer is
passed over. `calls_per_step` counts named host runtime calls inside
`ntt.step` spans. Both read nothing (None) from a program without spans.
"""
from __future__ import annotations

import bisect

PREFIX = "ntt."
LAYERS = (("step", "training"), ("render", "training"), ("neus.", "frameworks"),
          ("volsdf.", "frameworks"), ("unisurf.", "frameworks"), ("op.", "ops"))
PARTS = ("training", "frameworks", "ops", "unspanned")
# blocking host-device syncs (cudaMemcpyAsync does not block)
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def layer(name: str) -> str | None:
    """The layer of a span named `ntt.<name>` (None for a name of no layer,
    which the attribution passes over)."""
    short = name[len(PREFIX):]
    return next((part for prefix, part in LAYERS if short.startswith(prefix)), None)


def idle_ms(trace) -> dict | None:
    """{part: device-idle ms per unit while the host was in that layer}."""
    sp = sorted(((layer(n), a, b) for n, a, b in trace.host if n.startswith(PREFIX)),
                key=lambda h: h[1])
    sp = [h for h in sp if h[0] is not None]
    if not sp:
        return None
    out = dict.fromkeys(PARTS, 0.0)
    active, i = [], 0
    for (_, end), (start, _) in zip(trace.busy, trace.busy[1:]):
        mid = 0.5 * (end + start)  # the gaps come in time order
        while i < len(sp) and sp[i][1] <= mid:
            active.append(sp[i])
            i += 1
        active = [s for s in active if s[2] >= mid]
        part = min(active, key=lambda s: s[2] - s[1])[0] if active else "unspanned"
        out[part] += (start - end) / 1e3
    return {k: v / trace.units for k, v in out.items()}


def idle_part(trace, part: str) -> float | None:
    parts = idle_ms(trace)
    return None if parts is None else parts[part]


def calls_per_step(trace, names) -> float | None:
    """Host events named in `names` that lie inside an `ntt.step` span, per
    unit of the stretch."""
    steps = sorted((a, b) for n, a, b in trace.host if n == PREFIX + "step")
    if not steps:
        return None
    starts = [a for a, _ in steps]
    n = 0
    for name, a, b in trace.host:
        if name in names:
            k = bisect.bisect_right(starts, a) - 1
            n += k >= 0 and b <= steps[k][1]
    return n / trace.units

"""Time the surface kernels of several copies of the port in turns, on one
CUDA card, so that two versions are compared within one run:

    python -m neurecon_tpu_torch.tools.ab_kernels OLD NEW NEW OLD

Each argument is the root of a checkout (the directory that holds
`neurecon_tpu_torch/`). For each, in order, a fresh process builds that
copy's kernels and prints one JSON line: the median of 10 CUDA-event runs
after warm-up of the forward+nablas kernel at 130,560 and 1,044,480 points
(one training step, one render chunk) and, where the copy has it, the
eikonal backward at 130,560 and 197,632 points (a NeuS and a VolSDF step)
with its CUDA kernels' device times (torch.profiler) and, at 130,560, its
largest leaf error against its plain version, and,
where the copy has it, the sdf-only kernel at 2^20 points, the host time of
one of its 4,096-point calls (what a sphere-tracing step makes), and the
host time of sphere tracing 19,200 rays in chunks of 4,096 (one 120x160
frame's casts). The flagship surface (D=8, W=256) with seeded noise on
every weight, points and cotangents from `--seed`.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CODE = r'''
import json, sys
import numpy as np, torch
sys.path.insert(0, ROOT)
from neurecon_tpu_torch.ops import _build, fused_nablas
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
if not fused_nablas.__file__.startswith(ROOT):
    raise SystemExit(f"imported {fused_nablas.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
s = ImplicitSurface(W=256, D=8, skips=(4,), W_geo_feat=256, embed_multires=6)
s.reset_parameters(torch.Generator().manual_seed(SEED))
perturb_parameters(s, torch.Generator().manual_seed(SEED + 1))
s = s.to(dev)
g = torch.Generator(dev).manual_seed(SEED + 2)

def ms(fn, reps=10):
    fn(); torch.cuda.synchronize(); out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize(); out.append(a.elapsed_time(b))
    return float(np.median(out))

res = {"root": ROOT, "card": torch.cuda.get_device_name(0)}
for M in (130560, 1044480):
    x = torch.randn(M, 3, device=dev, generator=g) * 0.5
    res[f"nablas_forward_ms_{M}"] = ms(lambda: fused_nablas.fused_forward_with_nablas(s, x))
try:
    from neurecon_tpu_torch.ops import fused_nablas_vjp
except ImportError:
    fused_nablas_vjp = None
if fused_nablas_vjp is not None:
    from torch.profiler import ProfilerActivity, profile
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(s)]
    for M in (130560, 197632):
        x = torch.randn(M, 3, device=dev, generator=g) * 0.5
        cots = (torch.randn(M, device=dev, generator=g),
                torch.randn(M, 3, device=dev, generator=g),
                torch.randn(M, s.W_geo_feat, device=dev, generator=g))
        run = lambda: fused_nablas_vjp.fused_nablas_vjp(s, x, ws, bs, *cots)
        if M == 130560:
            got, ref = run(), fused_nablas_vjp.nablas_vjp_plain(s, x, ws, bs, *cots)
            res["nablas_backward_max_rel_err"] = max(
                float((a - b).abs().max() / b.abs().max())
                for a, b in zip([got[0], *got[1], *got[2]], [ref[0], *ref[1], *ref[2]]))
            del got, ref
        res[f"nablas_backward_ms_{M}"] = ms(run)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(); torch.cuda.synchronize()
        res[f"nablas_backward_kernels_ms_{M}"] = {
            e.key.split("(")[0]: e.device_time_total / 1e3 for e in prof.key_averages()
            if e.device_time_total > 0 and "ntt::" in e.key}
        del x, cots
try:
    from neurecon_tpu_torch.ops import fused_mlp
    from neurecon_tpu_torch.models.ray_casting import sphere_tracing_surface_points
except ImportError:
    fused_mlp = None
if fused_mlp is not None:
    import time

    def wall_ms(fn, reps=50):
        fn(); torch.cuda.synchronize(); out = []
        for _ in range(reps):
            t0 = time.perf_counter(); fn(); torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(out))

    x = torch.rand(2 ** 20, 3, device=dev, generator=g) * 2 - 1
    res["sdf_forward_ms_1048576"] = ms(lambda: fused_mlp.fused_sdf_forward(s, x))
    x4 = x[:4096].contiguous()
    res["sdf_forward_call_wall_ms_4096"] = wall_ms(lambda: fused_mlp.fused_sdf_forward(s, x4))
    o = torch.tensor([0.0, 0.0, -3.0], device=dev).expand(19200, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.randn(19200, 3, device=dev, generator=g) * 0.15
        + torch.tensor([0.0, 0.0, 1.0], device=dev), dim=-1)

    def cast():
        for c in range(0, 19200, 4096):
            sphere_tracing_surface_points(s.forward_query, o[c:c + 4096], d[c:c + 4096],
                                          near=0.0, far=4.8)
    res["sphere_trace_wall_ms_19200_rays"] = wall_ms(cast, reps=10)
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, timed in this order")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rc = 0
    for root in map(os.path.abspath, args.roots):
        out = subprocess.run([sys.executable, "-c",
                              f"ROOT = {root!r}\nSEED = {args.seed}\n" + _CODE],
                             capture_output=True, text=True, timeout=900)
        if out.returncode == 0:
            print(out.stdout.strip().splitlines()[-1])
        else:
            print(json.dumps({"root": root, "error": out.stderr[-2000:]}))
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Time the surface kernels of several copies of the port in turns, on one
CUDA card, so that two versions are compared within one run:

    python -m neurecon_tpu_torch.tools.ab_kernels OLD NEW NEW OLD

Each argument is the root of a checkout (the directory that holds
`neurecon_tpu_torch/`). For each, in order, a fresh process builds that
copy's kernels and prints one JSON line: the median of 10 CUDA-event runs
after warm-up of the forward+nablas kernel at 130,560 and 1,044,480 points
(one training step, one render chunk) and, where the copy has it, the
eikonal backward at 130,560 points with its CUDA kernels' device times
(torch.profiler) and its largest leaf error against its plain version. The
flagship surface (D=8, W=256) with seeded noise on every weight, points and
cotangents from `--seed`.
"""
from __future__ import annotations

import argparse
import json
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
    M = 130560
    x = torch.randn(M, 3, device=dev, generator=g) * 0.5
    cots = (torch.randn(M, device=dev, generator=g), torch.randn(M, 3, device=dev, generator=g),
            torch.randn(M, s.W_geo_feat, device=dev, generator=g))
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(s)]
    run = lambda: fused_nablas_vjp.fused_nablas_vjp(s, x, ws, bs, *cots)
    got, ref = run(), fused_nablas_vjp.nablas_vjp_plain(s, x, ws, bs, *cots)
    res["nablas_backward_max_rel_err"] = max(
        float((a - b).abs().max() / b.abs().max())
        for a, b in zip([got[0], *got[1], *got[2]], [ref[0], *ref[1], *ref[2]]))
    del got, ref
    res["nablas_backward_ms_130560"] = ms(run)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(); torch.cuda.synchronize()
    res["nablas_backward_kernels_ms"] = {
        e.key.split("(")[0]: e.device_time_total / 1e3 for e in prof.key_averages()
        if e.device_time_total > 0 and "ntt::" in e.key}
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, timed in this order")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rc = 0
    for root in args.roots:
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

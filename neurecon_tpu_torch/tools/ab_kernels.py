"""Time the surface kernels of several copies of the port in turns, on one
CUDA card, so that two versions are compared within one run:

    python -m neurecon_tpu_torch.tools.ab_kernels OLD NEW NEW OLD

Each argument is the root of a checkout (the directory that holds
`neurecon_tpu_torch/`). For each, in order, a fresh process builds that
copy's kernels and prints one JSON line: the median of 10 CUDA-event runs
after warm-up of the forward+nablas kernel at 130,560, 197,632 and
1,044,480 points (a NeuS step, a VolSDF step, one render chunk), the NeuS
upsampler at 512 and 4,096 rays (a step, a render chunk; rays from (0, 0,
-3) into the unit sphere, det uniforms), both kernels' sine branch on a
SIREN surface (configs/volsdf_siren.yaml's D=5, W=256; kernel 1 at a
SIREN step's 197,632 points in [-3, 3]^3, kernel 2 at 4,096 rays into the
sphere of radius 2), where the copy picks the upsampler's block shape
(`fused_upsample.block_shape`), the upsampler at each of four shapes (rays
a block x points a tile) in turns, and, where the copy has it, the
eikonal backward at 130,560 and 197,632 points (a NeuS and a VolSDF step)
with its CUDA kernels' device times (torch.profiler) and, at 130,560, its
largest leaf error against its plain version, and,
where the copy has it, the sdf-only kernel at 2^20 points, the host time of
one of its 4,096-point calls (what a sphere-tracing step makes), and the
host time of sphere tracing 19,200 rays in chunks of 4,096 (one 120x160
frame's casts), and, where the copy has it, the VolSDF fine sampler's
kernels (a), (b) and (c), each summed over one call (CUDA events around
each launch, median of 5 calls) on 1,024 rays at beta_net 0.1 and 0.001
and on 4,096 rays at 0.001 (rays from (0, 0, -3) into the background
sphere of radius 3, n0 = n_up = 512, 6 rounds, 64 fine samples, perturb
uniforms from the seed), and, where the copy takes the width, kernels 4,
1, 3 and 2 at W=512 (the wide tile) and W=1024 (the cluster tile; a copy
that refuses it says so) at 2^20 points, 130,560 points, 130,560 points and
512 rays. The flagship surface (D=8, W=256) with seeded noise on every
weight, points and cotangents from `--seed`; the wider surfaces are the
flagship's at those hidden widths.

The sampler's outputs (fine depths, beta map, iter_usage), every output
of kernel (a) launched alone on the same rays (round-0 depths and sdf,
bounds, beta+, converged, iter_usage, the checkpoint-0 draws; case
`<case>_init`), and the outputs of the surface kernels on the flagship
surface (case `surface_kernels`: kernel 1's sdf, nablas and h at 130,560
points, kernel 2's depths at 512 and 4,096 rays, kernel 3's x_bar and
every weight and bias gradient at 130,560 points, kernel 4's sdf at 2^20
points; the same at W=512 and 1,024 on 16,384 points and 128 rays, cases
`surface_kernels_w512` and `surface_kernels_w1024`) of every copy are then
held to the first copy's on the same
inputs: one JSON line per case and copy with, for each output, the largest
difference and the share of entries that differ (0 when two copies' kernels
round alike, as a change that leaves the W <= 256 instantiations alone must).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

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
outputs = {}  # the surface kernels' outputs, held to the first copy's
for M in (130560, 197632, 1044480):
    x = torch.randn(M, 3, device=dev, generator=g) * 0.5
    res[f"nablas_forward_ms_{M}"] = ms(lambda: fused_nablas.fused_forward_with_nablas(s, x))
    if M == 130560:
        outputs.update(zip(("k1_sdf", "k1_nablas", "k1_h"),
                           (t.cpu() for t in fused_nablas.fused_forward_with_nablas(s, x))))
from neurecon_tpu_torch.models.frameworks.neus import _uniforms
from neurecon_tpu_torch.ops import fused_upsample
from neurecon_tpu_torch.ops.ray import near_far_from_sphere

def rays(n, r):
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, device=dev, generator=g) * 0.1
        + torch.tensor([0.0, 0.0, 1.0], device=dev), dim=-1)
    o = torch.tensor([0.0, 0.0, -3.0], device=dev).expand(n, 3).contiguous()
    near, far = near_far_from_sphere(o, d, r=r)
    t = torch.linspace(0, 1, 64, device=dev)
    return o, d, (near * (1 - t) + far * t).contiguous(), _uniforms(n, 4, 16, False, None, dev)

def upsample(surf, args):
    return fused_upsample.fused_neus_upsample(surf, *args, n_iters=4, n_per_iter=16)

for N in (512, 4096):
    args = rays(N, 1.0)
    res[f"neus_upsample_ms_{N}_rays"] = ms(lambda: upsample(s, args))
    outputs[f"k2_d_all_{N}"] = upsample(s, args).cpu()
if hasattr(fused_upsample, "block_shape"):  # each block shape in turns, A B C D D C B A
    chosen, shapes = fused_upsample.block_shape, [(64, 4), (128, 8), (128, 4), (64, 8)]
    cases = {N: rays(N, 1.0) for N in (512, 4096)}
    for shape in shapes + shapes[::-1]:
        fused_upsample.block_shape = lambda n, sms, *_, shape=shape: shape
        for N, args in cases.items():
            res.setdefault(f"neus_upsample_ms_{N}_rays_P{shape[0]}_R{shape[1]}", []).append(
                ms(lambda: upsample(s, args)))
    fused_upsample.block_shape = chosen
sine = ImplicitSurface(W=256, D=5, skips=(), W_geo_feat=256, radius_init=1.0,
                       embed_multires=-1, use_siren=True)
sine.reset_parameters(torch.Generator().manual_seed(SEED))
perturb_parameters(sine, torch.Generator().manual_seed(SEED + 1))
sine = sine.to(dev)
x = (torch.rand(197632, 3, device=dev, generator=g) * 2 - 1) * 3.0
res["sine_nablas_forward_ms_197632"] = ms(lambda: fused_nablas.fused_forward_with_nablas(sine, x))
args = rays(4096, 2.0)
res["sine_neus_upsample_ms_4096_rays"] = ms(lambda: upsample(sine, args))
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
            outputs["k3_xbar"] = got[0].cpu()
            outputs.update({f"k3_wbar_{l}": t.cpu() for l, t in enumerate(got[1])})
            outputs.update({f"k3_bbar_{l}": t.cpu() for l, t in enumerate(got[2])})
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
    outputs["k4_sdf_1048576"] = fused_mlp.fused_sdf_forward(s, x).cpu()
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
wider = {}  # the wide and cluster tiles' outputs, held to the first copy's
for W in (512, 1024):
    sw = ImplicitSurface(W=W, D=8, skips=(4,), W_geo_feat=256, embed_multires=6)
    sw.reset_parameters(torch.Generator().manual_seed(SEED))
    perturb_parameters(sw, torch.Generator().manual_seed(SEED + 1))
    sw = sw.to(dev)
    gw = torch.Generator(dev).manual_seed(SEED + 2)
    x = torch.randn(130560, 3, device=dev, generator=gw) * 0.5
    x4 = torch.rand(2 ** 20, 3, device=dev, generator=gw) * 2 - 1
    cots = (torch.randn(130560, device=dev, generator=gw),
            torch.randn(130560, 3, device=dev, generator=gw),
            torch.randn(130560, 256, device=dev, generator=gw))
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(sw)]
    args = rays(512, 1.0)
    try:
        k1 = fused_nablas.fused_forward_with_nablas(sw, x[:16384])
    except NotImplementedError:
        res[f"w{W}"] = "refused"
        continue
    out = dict(zip(("k1_sdf", "k1_nablas", "k1_h"), (t.cpu() for t in k1)))
    k3 = fused_nablas_vjp.fused_nablas_vjp(sw, x[:16384], ws, bs, *[c[:16384] for c in cots])
    out.update({"k3_xbar": k3[0].cpu(), **{f"k3_wbar_{l}": t.cpu() for l, t in enumerate(k3[1])},
                **{f"k3_bbar_{l}": t.cpu() for l, t in enumerate(k3[2])}})
    out["k4_sdf"] = fused_mlp.fused_sdf_forward(sw, x4[:16384]).cpu()
    out["k2_d_all"] = upsample(sw, [a[:128].contiguous() for a in args]).cpu()
    wider[f"surface_kernels_w{W}"] = out
    res[f"sdf_forward_ms_1048576_w{W}"] = ms(lambda: fused_mlp.fused_sdf_forward(sw, x4))
    res[f"nablas_forward_ms_130560_w{W}"] = ms(
        lambda: fused_nablas.fused_forward_with_nablas(sw, x))
    res[f"nablas_backward_ms_130560_w{W}"] = ms(
        lambda: fused_nablas_vjp.fused_nablas_vjp(sw, x, ws, bs, *cots))
    res[f"neus_upsample_ms_512_rays_w{W}"] = ms(lambda: upsample(sw, args))
    del sw, x, x4, cots, k1, k3
try:
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.sampling import linspace01
except ImportError:
    ffs = None
if ffs is not None:
    import functools
    from unittest import mock

    def spans(name, log):
        fn = getattr(ffs, name)

        @functools.wraps(fn)
        def wrapper(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record(); out = fn(*a, **k); ev[1].record(); log.append(ev)
            return out
        return mock.patch.object(ffs, name, wrapper)

    kernels = {"volsdf_init": "launch_init", "volsdf_draw": "launch_draw",
               "volsdf_checkpoint": "launch_checkpoint"}
    saved = {"surface_kernels": outputs, **wider}
    for N, beta in ((1024, 0.1), (1024, 0.001), (4096, 0.001)):
        th = (torch.rand(N, 2, device=dev, generator=torch.Generator(dev).manual_seed(SEED))
              * 0.6 - 0.3)
        d = torch.stack([torch.sin(th[:, 0]), torch.sin(th[:, 1]) * torch.cos(th[:, 0]),
                         torch.cos(th[:, 1]) * torch.cos(th[:, 0])], -1).contiguous()
        o = torch.tensor([0.0, 0.0, -3.0], device=dev).expand(N, 3).contiguous()
        far = torch.full((N, 1), 6.0, device=dev)
        d_init = (far * linspace01(512, dev)).contiguous()
        u = torch.rand(N, 8 * 64, device=dev, generator=torch.Generator(dev).manual_seed(SEED + 3))
        args = (s, o, d, d_init, far, torch.tensor(1.0 / beta, device=dev),
                torch.tensor(beta, device=dev), u)
        kw = dict(eps=0.1, max_iter=6, max_bisection=10, n_final=64, n_up=512, sphere_bg_r=3.0)
        out = ffs.fused_fine_sample(*args, **kw)
        runs = []
        for _ in range(5):
            logs = {k: [] for k in kernels}
            with spans("launch_init", logs["volsdf_init"]), \
                    spans("launch_draw", logs["volsdf_draw"]), \
                    spans("launch_checkpoint", logs["volsdf_checkpoint"]):
                ffs.fused_fine_sample(*args, **kw)
            torch.cuda.synchronize()
            runs.append({k: sum(a.elapsed_time(b) for a, b in v) for k, v in logs.items()})
        case = f"{N}_rays_beta_{beta:g}"
        for k in kernels:
            res[f"{k}_ms_per_call_{case}"] = float(np.median([r[k] for r in runs]))
        res[f"sampler_ms_per_call_{case}"] = ms(lambda: ffs.fused_fine_sample(*args, **kw), reps=5)
        saved[case] = dict(zip(("fine", "beta_out", "iter_usage"), (t.cpu() for t in out)))
        # kernel (a) alone on the same rays: every output
        ws = ffs.workspace(N, 512 + 6 * 512, 64, dev)
        pts = (o[:, None] + d[:, None] * d_init[..., None]).reshape(-1, 3)
        ffs.launch_init(ws, o, d, d_init, fused_mlp.fused_sdf_forward(s, pts), far,
                        torch.stack(args[5:7]).float(), u, n_final=64, u_stride=u.shape[1],
                        eps=0.1, beta_c=ffs.beta_plus_denominator(512, 0.1),
                        prior_r=float(s.radius_init) if s.sphere_residual else -1.0, bg_r=3.0)
        saved[f"{case}_init"] = {
            "d_buf": ws["d"][0][:, :512].cpu(), "s_buf": ws["s"][0][:, :512].cpu(),
            "bounds": ws["bounds"][:, :511].cpu(),
            **{k: ws[k].cpu() for k in ("beta", "converged", "iter_usage", "fine")}}
    torch.save(saved, OUT)
print(json.dumps(res))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", help="checkout roots, timed in this order")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rc = 0
    with tempfile.TemporaryDirectory(prefix="ntt_ab_") as tmp:
        outs = []
        for i, root in enumerate(map(os.path.abspath, args.roots)):
            dump = os.path.join(tmp, f"{i}.pt")
            out = subprocess.run([sys.executable, "-c", f"ROOT = {root!r}\nSEED = {args.seed}\n"
                                  f"OUT = {dump!r}\n" + _CODE],
                                 capture_output=True, text=True, timeout=900)
            if out.returncode == 0:
                print(out.stdout.strip().splitlines()[-1], flush=True)
                if os.path.exists(dump):
                    outs.append((root, dump))
            else:
                print(json.dumps({"root": root, "error": out.stderr[-2000:]}), flush=True)
                rc = 1
        if len(outs) > 1:
            _compare_outputs(outs)
    return rc


def _compare_outputs(outs):
    """The kept outputs (sampler, kernel (a), surface kernels) of each copy
    against the first copy's."""
    import torch

    (root0, dump0), rest = outs[0], outs[1:]
    ref = torch.load(dump0)
    for root, dump in rest:
        got = torch.load(dump)
        for case, want in ref.items():
            line = {"outputs_vs": root0, "root": root, "case": case}
            for name, b in want.items():
                if name not in got.get(case, {}):
                    line[f"{name}_missing"] = True
                    continue
                a = got[case][name]
                diff = (a.double() - b.double()).abs()
                line[f"{name}_max_diff"] = float(diff.max())
                line[f"{name}_share_differing"] = float((a != b).double().mean())
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())

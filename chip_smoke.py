#!/usr/bin/env python3
"""The port's smoke run on one CUDA card (an H100):
`python3 chip_smoke.py [--seed N]`.

Phases, in order; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch's count); build both
   CUDA kernels from neurecon_tpu_torch/csrc with nvcc (sm_90a).
2. kernel 1 (`nablas_forward`) against its plain version on the points of
   one render chunk at the flagship widths (4,096 rays x 255 points along real
   rays): sdf and geometry features atol 1e-4, nablas rtol 2e-3 / atol 2e-4.
3. kernel 2 (`neus_upsample`) against its plain version on 4,096 rays, det
   and perturb uniforms: |d_all diff| <= 1e-3 (far - near) on >= 99.9% of
   entries (the s = 512 sigmoid can move a sample when an fp32 sum order
   changes). In det mode, per ray, up to one entry per round in the last
   coarse section is exempt: the u = 1.0 sample, which ties with cdf[-1] = 1.
   Phases 2 and 3 (and the patch of phase 4) run on the flagship surface with
   seeded noise on every weight (`perturb_parameters`): the geometric init
   zeroes the octave columns, so it could not show an error in the
   positional encoding or its pullback.
4. the slice through the port's render_view frame function: a flagship NeuS
   from the port's geometric init, saved with the port's CheckpointIO, two
   120x160 views of the synthetic sphere scene at rayschunk 4096; both kernel
   counters must rise (5 launches each per frame), every output must be
   finite, and a 2,048-ray patch must match a render through the plain
   versions (rgb atol 2e-3).
5. times from CUDA events (median of 10 after warm-up) of each kernel and its
   plain version; seconds per frame; one frame split into the two kernels,
   the radiance MLP and the rest, by CUDA events around each; all with the
   card's name and power limit.

Prints one JSON line of per-kernel results, then, as the last line,
{"ok": true, "device": {...}}. Needs the repository checkout beside it; it
imports no JAX.
"""
import argparse
import copy
import functools
import json
import math
import subprocess
import sys
import tempfile
import traceback
from unittest import mock

import numpy as np
import torch

FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
HBM_RATE = 3.35e12  # H100 SXM bytes/s

FLAGSHIP = {
    "expname": "chip_smoke",
    "data": {"type": "synthetic", "downscale": 1, "n_images": 16, "H": 120,
             "W": 160, "val_rayschunk": 4096, "obj_bounding_radius": 1.0},
    "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
              "variance_init": 0.05, "N_samples": 64, "N_importance": 64,
              "N_upsample_iters": 4, "upsample_algo": "official_solution",
              "surface": {"D": 8, "W": 256, "skips": [4], "radius_init": 0.5,
                          "embed_multires": 6},
              "radiance": {"D": 4, "W": 256, "skips": [], "embed_multires": -1,
                           "embed_multires_view": 4}},
    "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                 "speed_factor": 10.0, "lr": 5e-4, "num_iters": 300000},
}


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps=10):
    """Median ms of `fn` over `reps` runs after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / FP32_PEAK, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _surface_macs(surface, sdf_only):
    """Multiply-adds per point: the forward (all final rows, or the sdf row
    only) plus, for nablas, the reverse sweep through the hidden layers."""
    hidden = sum(i * o for i, o in surface.dims[:-1])
    i_D, o_D = surface.dims[-1]
    if sdf_only:
        return hidden + i_D
    return hidden + i_D * o_D + hidden


def _octave_effect(surface, x):
    """Largest change of (sdf, nablas, h) at x when the octave columns of
    layer 0 and of the skip layers are zeroed: what an error in the encoding
    could move, beside the tolerances."""
    from neurecon_tpu_torch.ops import fused_nablas

    bare = copy.deepcopy(surface)
    with torch.no_grad():
        for l in (0, *surface.skips):
            bare.layers[l].v[:, -(surface.input_ch - 3):] = 0.0
        a = fused_nablas.forward_with_nablas_plain(surface, x)
        b = fused_nablas.forward_with_nablas_plain(bare, x)
    return [float((p - q).abs().max()) for p, q in zip(a, b)]


def _frame_split(render_frames, vargs, n_chunks):
    """Render two frames with CUDA events around each call of the two kernel
    wrappers and of the radiance MLP; return the second frame's wall ms and
    the device ms of each part."""
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.ops import fused_nablas, fused_upsample

    spans = {}

    def timed(name, fn):
        @functools.wraps(fn)  # carries the launch counter the wrapper bumps
        def wrapper(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.setdefault(name, []).append(ev)
            return out
        return wrapper

    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           timed("nablas_forward", fused_nablas.fused_forward_with_nablas)), \
            mock.patch.object(fused_upsample, "fused_neus_upsample",
                              timed("neus_upsample", fused_upsample.fused_neus_upsample)), \
            mock.patch.object(RadianceNet, "forward",
                              timed("radiance_net", RadianceNet.forward)):
        frames = render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    ms = {k: sum(a.elapsed_time(b) for a, b in v[n_chunks:]) for k, v in spans.items()}
    return 1e3 * frames["seconds"][1], ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights (init, and the checked copy's noise)")
    seed = ap.parse_args(argv).seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import (_prepare_rays, _uniforms,
                                                           make_volume_render_fn)
    from neurecon_tpu_torch.ops import _build, fused_nablas, fused_upsample, get_rays
    from neurecon_tpu_torch.tools import render_view
    from neurecon_tpu_torch.training import render_full_image
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO

    dev = torch.device("cuda")
    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    tag = f"[{card}]"
    print(card)
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{count} device(s): {kind}")
    secs = _build.build_all(force=True)
    print(f"phase 1: built {', '.join(_build.SOURCES)} with nvcc in {secs:.2f} s")
    for name in _build.SOURCES:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")

    args = ConfigDict(FLAGSHIP)
    model, _, kw_test, _ = get_model(args, dev, seed=seed)
    # the kernels are checked on a copy with noise on every weight
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    surface = checked.implicit_surface
    scene = make_synthetic_scene(n_images=1, H=120, W=160)
    o_all, d_all_dirs, _ = get_rays(torch.tensor(scene["c2w"][0], device=dev),
                                    torch.tensor(scene["intrinsics"][0], device=dev),
                                    120, 160)
    # 4,096 rays spread over the frame (every ~4.7th pixel)
    idx = torch.linspace(0, 120 * 160 - 1, 4096, device=dev).long()
    rays_o, rays_d, near, far = _prepare_rays(o_all[idx], d_all_dirs[idx], 1.0)
    t = torch.linspace(0, 1, 64, device=dev)
    d_coarse = (near * (1 - t) + far * t).contiguous()

    # ---- phase 2: kernel 1 on one render chunk's points (sections + mids)
    u_det = _uniforms(4096, 4, 16, False, None, dev)
    d_sec = fused_upsample.neus_upsample_plain(surface, rays_o, rays_d, d_coarse,
                                               u_det, n_iters=4, n_per_iter=16)
    d_mid = 0.5 * (d_sec[:, 1:] + d_sec[:, :-1])
    pts = torch.cat([rays_o[:, None] + rays_d[:, None] * d_sec[..., None],
                     rays_o[:, None] + rays_d[:, None] * d_mid[..., None]], 1)
    x = pts.reshape(-1, 3).contiguous()
    got = fused_nablas.fused_forward_with_nablas(surface, x)
    with torch.no_grad():
        ref = fused_nablas.forward_with_nablas_plain(surface, x)
    torch.cuda.synchronize()
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    nab_ok = bool(((got[1] - ref[1]).abs() <= 2e-4 + 2e-3 * ref[1].abs()).all())
    print(f"phase 2: nablas_forward on {x.shape[0]} points: max|diff| sdf {errs[0]:.3e}, "
          f"nablas {errs[1]:.3e}, h {errs[2]:.3e}")
    octave = _octave_effect(surface, x[:65536])
    print("phase 2: zeroing the octave columns would move sdf, nablas, h by up to "
          + ", ".join(f"{v:.3e}" for v in octave))
    if not (errs[0] <= 1e-4 and errs[2] <= 1e-4 and nab_ok
            and all(torch.isfinite(g).all() for g in got)):
        print("FAIL phase 2: nablas_forward disagrees with its plain version", file=sys.stderr)
        return 1
    del ref, got

    # ---- phase 3: kernel 2 against its plain version, det and perturb
    ok = True
    u_pert = _uniforms(4096, 4, 16, True, torch.Generator(dev).manual_seed(seed), dev)
    span = (far - near)
    k2_err = {}
    for mode, u in (("det", u_det), ("perturb", u_pert)):
        got = fused_upsample.fused_neus_upsample(surface, rays_o, rays_d, d_coarse, u,
                                                 n_iters=4, n_per_iter=16)
        ref = fused_upsample.neus_upsample_plain(surface, rays_o, rays_d, d_coarse, u,
                                                 n_iters=4, n_per_iter=16)
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        off = diff > 1e-3 * span
        frac = float(off.float().mean())
        p999 = float(torch.quantile(diff.flatten(), 0.999))
        # The det uniforms end in u = 1.0, which meets cdf[-1] = 1 +- an ulp:
        # when the last cdf step is below the 1e-5 eps, whether that sample
        # lands at `far` or just past the second-to-last sample flips with
        # the fp32 summation order. So in det mode, per ray, up to one entry
        # per round that lies in the last coarse section on both sides is
        # exempt; every other entry is held to the share.
        tie = off & (got >= d_coarse[:, -2:-1]) & (ref >= d_coarse[:, -2:-1])
        exempt = (tie & (tie.sum(1, keepdim=True) <= 4) if mode == "det"
                  else torch.zeros_like(off))
        frac_rest = float((off & ~exempt).float().mean())
        inside = bool(((got >= near - 1e-6) & (got <= far + 1e-6)).all())
        k2_err[mode] = float(diff.max())
        print(f"phase 3: neus_upsample {mode}: max|diff| {float(diff.max()):.3e}, "
              f"p99.9 {p999:.3e}, share beyond 1e-3(far-near) {frac:.5f}, "
              f"{int(exempt.sum())} u=1.0 tie entries exempt on "
              f"{int(exempt.any(1).sum())} rays, share of the rest {frac_rest:.5f}")
        if frac_rest > 1e-3 or not inside or not torch.isfinite(got).all():
            ok = False
    if not ok:
        print("FAIL phase 3: neus_upsample disagrees with its plain version", file=sys.stderr)
        return 1

    # ---- phase 4: the slice through render_view's frame function
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ckpt = CheckpointIO(tmp).save("latest.pt", 0, model=bridge.model_to_tree(model))
        vargs = ConfigDict(FLAGSHIP)
        vargs.update({"load_pt": ckpt, "num_views": 2, "camera_path": "interpolation",
                      "rayschunk": 4096})
        fused_nablas.fused_forward_with_nablas.launches = 0
        fused_upsample.fused_neus_upsample.launches = 0
        frames = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        launches = {"nablas_forward": fused_nablas.fused_forward_with_nablas.launches,
                    "neus_upsample": fused_upsample.fused_neus_upsample.launches}
    print(f"phase 4: render_view 2 x 120x160: launches {launches}, "
          f"s/frame {[round(s, 4) for s in frames['seconds']]} {tag}")
    finite = all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))
    # 5 chunks of 4,096 rays per frame, one launch of each kernel per chunk
    if (launches != {"nablas_forward": 10, "neus_upsample": 10} or not finite
            or frames["rgb"].shape != (2, 120, 160, 3)):
        print("FAIL phase 4: render did not run through both kernels, or "
              "produced non-finite output", file=sys.stderr)
        return 1

    # 2,048-ray patch: kernels vs the plain versions called by name
    render_fn = make_volume_render_fn(checked, detailed_output=False, calc_normal=True,
                                      **kw_test)
    patch = torch.arange(60 * 160 - 1024, 60 * 160 + 1024, device=dev)
    out_k = render_full_image(render_fn, o_all[patch], d_all_dirs[patch], rayschunk=4096)
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           fused_nablas.forward_with_nablas_plain), \
            mock.patch.object(fused_upsample, "fused_neus_upsample",
                              fused_upsample.neus_upsample_plain):
        out_p = render_full_image(render_fn, o_all[patch], d_all_dirs[patch],
                                  rayschunk=4096)
    e = {k: float(np.abs(out_k[k] - out_p[k]).max())
         for k in ("rgb", "depth_volume", "normals_volume", "mask_volume")}
    print(f"phase 4: 2048-ray patch, kernels vs plain: max|diff| {e}")
    if e["rgb"] > 2e-3:
        print("FAIL phase 4: patch rgb disagrees with the plain render", file=sys.stderr)
        return 1

    # ---- phase 5: times on the card at the main path's shapes
    M = x.shape[0]
    ms1 = _time_ms(lambda: fused_nablas.fused_forward_with_nablas(surface, x))
    with torch.no_grad():
        pms1 = _time_ms(lambda: fused_nablas.forward_with_nablas_plain(surface, x))
    flops1 = 2.0 * _surface_macs(surface, sdf_only=False) * M
    bytes1 = 4.0 * (M * 3 + M * (1 + 3 + surface.W_geo_feat)
                    + sum(p.numel() for p in surface.parameters()))
    b1, by1 = _bound_ms(flops1, bytes1)
    ms2 = _time_ms(lambda: fused_upsample.fused_neus_upsample(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    pms2 = _time_ms(lambda: fused_upsample.neus_upsample_plain(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    flops2 = 2.0 * _surface_macs(surface, sdf_only=True) * 4096 * 128
    bytes2 = 4.0 * (4096 * (6 + 64 + 64 + 128)
                    + sum(p.numel() for p in surface.parameters()))
    b2, by2 = _bound_ms(flops2, bytes2)
    print(f"phase 5: nablas_forward {M} points: {ms1:.3f} ms (plain {pms1:.3f} ms, "
          f"fp32 bound {b1:.3f} ms, {flops1 / 1e9:.1f} GFLOP) {tag}")
    print(f"phase 5: neus_upsample 4096 rays: {ms2:.3f} ms (plain {pms2:.3f} ms, "
          f"fp32 bound {b2:.3f} ms, {flops2 / 1e9:.1f} GFLOP) {tag}")
    print(f"phase 5: render_view s/frame {frames['seconds']} {tag}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vargs["load_pt"] = CheckpointIO(tmp).save("latest.pt", 0,
                                                  model=bridge.model_to_tree(model))
        n_chunks = math.ceil(120 * 160 / 4096)
        frame_ms, split = _frame_split(render_view.render_frames, vargs, n_chunks)
    rest = frame_ms - sum(split.values())
    print(f"phase 5: one 120x160 frame ({n_chunks} chunks) {frame_ms:.2f} ms wall: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", everything else (rays, glue, compositing, host copies) {rest:.2f} ms "
          f"({100 * rest / frame_ms:.1f}%) {tag}")

    results = [
        {"name": "nablas_forward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/nablas_forward.cu",
         "replaces": "neurecon_tpu/ops/fused_nablas.py:74",
         "launches": launches["nablas_forward"], "max_abs_err": max(errs),
         "ms": ms1, "plain_ms": pms1, "bound_ms": b1, "bound_by": by1,
         "library_ms": None},
        {"name": "neus_upsample", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/neus_upsample.cu",
         "replaces": "neurecon_tpu/ops/fused_upsample.py:272",
         "launches": launches["neus_upsample"], "max_abs_err": k2_err["det"],
         "ms": ms2, "plain_ms": pms2, "bound_ms": b2, "bound_by": by2,
         "library_ms": None},
    ]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:  # any phase failing: report and exit non-zero
        traceback.print_exc()
        rc = 1
    sys.exit(rc)

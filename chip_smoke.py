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
6. kernel 3 (`nablas_backward`, the eikonal backward) against its plain
   version at one training step's shapes: 512 rays x 255 points = 130,560
   points of the synthetic scene on the perturbed flagship surface, seeded
   cotangents; every weight and bias grad and x_bar within 5e-4 max|ref| of
   its leaf (the JAX package's own bound is 2e-4 on 64 points; here the sums
   run over 130k points in another order).
7. the whole-step gradient: the NeuS ray loss on 512 rays with one fixed
   d_all, backward through the kernels and through the plain versions
   (called by name, as phase 4 does): loss to rel 1e-5, every parameter's
   grad within 5e-4 max|ref| (the JAX package's full-step bound).
8. the training slice through the port's train.py `main_function`: the
   flagship NeuS on 8 synthetic 120x160 images, 512 rays per step, 60 steps
   (warm-up 10), validation at steps 0 and 30; kernels 1-3 must each launch
   at least 60 times in it, every logged loss be finite, the last 10 steps'
   mean loss be below the first 10's, and the final checkpoint render
   through render_view; median ms per step over steps 6-60, and rays/s.
9. kernel 3's time at 130,560 points beside its plain version's and its
   bound, its workspace bytes, its four CUDA kernels' device times from
   torch.profiler, one training step split by CUDA events into kernel 2,
   kernel 1, kernel 3, the radiance forward, the Adam step and the rest, and
   the device's busy share over three steps (torch.profiler).

Prints one JSON line of per-kernel results (launches from phase 8's run,
the training slice), then, as the last line,
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


def _surface_macs(surface, sdf_only=False, backward=False):
    """Multiply-adds per point: the forward (all final rows, or the sdf row
    only) plus, for nablas, the reverse sweep through the hidden layers.
    `backward`: what the eikonal backward needs, six passes over the hidden
    weights (forward, nablas sweep, the pushed-forward nablas cotangent, the
    down-sweep, and the two weight-gradient outer products) plus the final
    layer's weight gradient and down-sweep; its forward is not needed."""
    hidden = sum(i * o for i, o in surface.dims[:-1])
    i_D, o_D = surface.dims[-1]
    if backward:
        return 6 * hidden + 2 * i_D * o_D
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


def _leaf_ratios(got, ref):
    """max|diff| / max|ref| per leaf of (x_bar, [W_bar], [b_bar])."""
    names = (["x"] + [f"W{l}" for l in range(len(got[1]))]
             + [f"b{l}" for l in range(len(got[2]))])
    pairs = [(got[0], ref[0])] + list(zip(got[1], ref[1])) + list(zip(got[2], ref[2]))
    return {n: float((g.double() - r.double()).abs().max() / r.double().abs().max())
            for n, (g, r) in zip(names, pairs)}


def _profile_kernels(fn):
    """Device ms per CUDA kernel name over one call of `fn`, from
    torch.profiler; "not measured" where it records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = {e.key.split("(")[0]: e.device_time_total / 1e3 for e in prof.key_averages()
                if e.device_time_total > 0 and "ntt::" in e.key}
    except Exception as e:  # the profiler is untried on some machines
        return f"not measured ({type(e).__name__}: {e})"
    return {k: round(v, 3) for k, v in rows.items()} or "not measured (no device time)"


def _train_config(tmp, seed):
    cfg = copy.deepcopy(FLAGSHIP)
    cfg["expname"] = "chip_smoke_train"
    cfg["seed"] = seed
    cfg["data"].update({"n_images": 8, "N_rays": 512, "val_downscale": 4})
    cfg["training"].update({
        "num_iters": 60, "scheduler": {"type": "warmupcosine", "warmup_steps": 10},
        "i_val": 30, "i_log": 10, "i_val_mesh": -1, "i_backup": -1, "i_save": 900,
        "monitoring": "none", "log_root_dir": tmp,
        "exp_dir": f"{tmp}/chip_smoke_train"})
    return cfg


def _step_split(args, dev, n_warm=3):
    """One flagship training step (512 rays) split by CUDA events around
    each call of the three kernel wrappers, the radiance forward and the
    Adam step, then the device's busy share over three more steps; returns
    (step ms, {part: ms}, busy share)."""
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import RadianceNet, make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import make_trainer
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, fused_upsample
    from neurecon_tpu_torch.training import make_train_step

    ds = get_data(args)
    model, kw, _, _ = get_model(args, dev, seed=0)
    kw["H"], kw["W"] = ds.H, ds.W
    opt, sched = make_optimizer(args, model)
    step = make_train_step(make_trainer(model, args, kw), model, opt, sched)
    batch = {"c2w": torch.tensor(ds.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(ds.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(ds.rgb_images[:1], device=dev).reshape(1, -1, 3),
             "object_mask": torch.tensor(ds.object_masks[:1], device=dev).reshape(1, -1)}
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(n_warm):
        step(batch, gen, i)
    spans = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans.setdefault(name, []).append(ev)
            return out
        return wrapper

    opt.step = timed("adam_step", opt.step)
    with mock.patch.object(fused_upsample, "fused_neus_upsample",
                           timed("neus_upsample", fused_upsample.fused_neus_upsample)), \
            mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                              timed("nablas_forward", fused_nablas.fused_forward_with_nablas)), \
            mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp",
                              timed("nablas_backward", fused_nablas_vjp.fused_nablas_vjp)), \
            mock.patch.object(RadianceNet, "forward",
                              timed("radiance_forward", RadianceNet.forward)):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(batch, gen, n_warm)
        b.record()
        torch.cuda.synchronize()
    parts = {k: sum(x.elapsed_time(y) for x, y in v) for k, v in spans.items()}
    # the device's busy share over three steps: the summed device time of
    # everything it ran (one stream, so nothing overlaps) over their span
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            c, d = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            c.record()
            for i in range(3):
                step(batch, gen, n_warm + 1 + i)
            d.record()
            torch.cuda.synchronize()
        busy = sum(e.device_time_total for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3 / c.elapsed_time(d)
    except Exception as e:  # the profiler is untried on some machines
        busy = f"not measured ({type(e).__name__}: {e})"
    return a.elapsed_time(b), parts, busy


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
    from neurecon_tpu_torch import train
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.ops import (_build, fused_nablas, fused_nablas_vjp,
                                        fused_upsample, get_rays)
    from neurecon_tpu_torch.tools import render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
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
        fused_nablas_vjp.fused_nablas_vjp.launches = 0
        frames = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        launches = {"nablas_forward": fused_nablas.fused_forward_with_nablas.launches,
                    "neus_upsample": fused_upsample.fused_neus_upsample.launches,
                    "nablas_backward": fused_nablas_vjp.fused_nablas_vjp.launches}
    print(f"phase 4: render_view 2 x 120x160: launches {launches}, "
          f"s/frame {[round(s, 4) for s in frames['seconds']]} {tag}")
    finite = all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))
    # 5 chunks of 4,096 rays per frame, one launch of each forward kernel per
    # chunk; the render builds no graph, so the backward kernel never runs
    if (launches != {"nablas_forward": 10, "neus_upsample": 10, "nablas_backward": 0}
            or not finite
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

    # ---- phase 6: kernel 3 against its plain version at a step's shapes
    sub = torch.linspace(0, 120 * 160 - 1, 512, device=dev).long()
    r_o, r_d, nr, fr = _prepare_rays(o_all[sub], d_all_dirs[sub], 1.0)
    d_c = (nr * (1 - t) + fr * t).contiguous()
    d_step = fused_upsample.neus_upsample_plain(surface, r_o, r_d, d_c, u_det[:512],
                                                n_iters=4, n_per_iter=16)
    d_mid = 0.5 * (d_step[:, 1:] + d_step[:, :-1])
    x3 = torch.cat([r_o[:, None] + r_d[:, None] * d_step[..., None],
                    r_o[:, None] + r_d[:, None] * d_mid[..., None]], 1).reshape(-1, 3).contiguous()
    M3 = x3.shape[0]
    g3 = torch.Generator(dev).manual_seed(seed + 2)
    cots = (torch.randn(M3, device=dev, generator=g3),
            torch.randn(M3, 3, device=dev, generator=g3),
            torch.randn(M3, surface.W_geo_feat, device=dev, generator=g3))
    ws3, bs3 = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    got3 = fused_nablas_vjp.fused_nablas_vjp(surface, x3, ws3, bs3, *cots)
    ref3 = fused_nablas_vjp.nablas_vjp_plain(surface, x3, ws3, bs3, *cots)
    torch.cuda.synchronize()
    ratios = _leaf_ratios(got3, ref3)
    k3_err = max(float((g - r).abs().max()) for g, r in
                 zip([got3[0], *got3[1], *got3[2]], [ref3[0], *ref3[1], *ref3[2]]))
    ws_bytes = fused_nablas_vjp.fused_nablas_vjp.workspace_bytes
    print(f"phase 6: nablas_backward on {M3} points (workspace {ws_bytes} bytes): "
          "max|diff| / max|ref| per leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items()))
    finite3 = all(bool(torch.isfinite(g).all()) for g in [got3[0], *got3[1], *got3[2]])
    if max(ratios.values()) > 5e-4 or not finite3:
        # a witness before any loosening: kernel and fp32 plain, each against
        # the plain version in float64, on the first 4,096 points
        xs = x3[:4096]
        cs = [c[:4096] for c in cots]
        k_sub = fused_nablas_vjp.fused_nablas_vjp(surface, xs, ws3, bs3, *cs)
        p_sub = fused_nablas_vjp.nablas_vjp_plain(surface, xs, ws3, bs3, *cs)
        w64 = fused_nablas_vjp.nablas_vjp_plain(
            surface, xs.double(), [w.double() for w in ws3], [b.double() for b in bs3],
            *[c.double() for c in cs])
        print("phase 6 witness (4,096 points, vs float64): kernel "
              + str({k: f"{v:.2e}" for k, v in _leaf_ratios(k_sub, w64).items()})
              + ", plain fp32 " + str({k: f"{v:.2e}" for k, v in _leaf_ratios(p_sub, w64).items()}))
        print("FAIL phase 6: nablas_backward disagrees with its plain version", file=sys.stderr)
        return 1
    del got3, ref3

    # ---- phase 7: the whole-step gradient, kernels vs plain versions
    targs = ConfigDict(_train_config("unused", seed))
    ray_loss = get_ray_loss_fn(targs, checked, kw_test)
    scene8 = make_synthetic_scene(n_images=1, H=120, W=160)
    batch = {"c2w": torch.tensor(scene8["c2w"][:1], device=dev),
             "intrinsics": torch.tensor(scene8["intrinsics"][:1], device=dev),
             "rgb": torch.tensor(scene8["rgb"][:1], device=dev).reshape(1, -1, 3),
             "object_mask": torch.tensor(scene8["object_mask"][:1], device=dev).reshape(1, -1)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, 120, 160, 512)
    r7o, r7d, n7, f7 = _prepare_rays(rb["rays_o"], rb["rays_d"], 1.0)
    d7 = fused_upsample.fused_neus_upsample(surface, r7o, r7d, (n7 * (1 - t) + f7 * t).contiguous(),
                                            u_det[:512], n_iters=4, n_per_iter=16)

    def step_grads():
        checked.zero_grad(set_to_none=True)
        total, _ = ray_loss(rb, d_all=d7)
        total.backward()
        return total.item(), [p.grad.clone() for p in checked.parameters()]

    loss_k, grads_k = step_grads()
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           fused_nablas.forward_with_nablas_plain), \
            mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp",
                              fused_nablas_vjp.nablas_vjp_plain):
        loss_p, grads_p = step_grads()
    names = [n for n, _ in checked.named_parameters()]
    step_ratios = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(step_ratios, key=step_ratios.get)
    print(f"phase 7: step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad leaf "
          f"{worst} {step_ratios[worst]:.2e} over {len(names)} leaves")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or step_ratios[worst] > 5e-4:
        print("FAIL phase 7: the step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1
    checked.zero_grad(set_to_none=True)

    # ---- phase 8: the training slice through train.py
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        targs = ConfigDict(_train_config(tmp, seed))
        starts = []
        real_make_step = train.make_train_step

        def make_step_timed(*a, **k):
            step = real_make_step(*a, **k)

            def timed_step(*sa, **sk):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
                return step(*sa, **sk)
            return timed_step

        for fn in (fused_nablas.fused_forward_with_nablas, fused_upsample.fused_neus_upsample,
                   fused_nablas_vjp.fused_nablas_vjp):
            fn.launches = 0
        with mock.patch.object(train, "make_train_step", make_step_timed):
            out = train.main_function(targs, device="cuda")
        torch.cuda.synchronize()
        launches = {"nablas_forward": fused_nablas.fused_forward_with_nablas.launches,
                    "neus_upsample": fused_upsample.fused_neus_upsample.launches,
                    "nablas_backward": fused_nablas_vjp.fused_nablas_vjp.launches}
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        evs = starts + [end]
        step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(starts))]
        ms_step = float(np.median(step_ms[5:]))
        totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
        logged = [v for _, v in out["stats"]["losses"]["total"]]
        vargs = ConfigDict(FLAGSHIP)
        vargs.update({"load_pt": out["final_ckpt"], "num_views": 1,
                      "camera_path": "interpolation", "rayschunk": 4096})
        view = render_view.render_frames(vargs, device="cuda")
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    finite_view = all(np.isfinite(view[k]).all() for k in ("rgb", "depth", "normal"))
    print(f"phase 8: train.py 60 flagship steps at 512 rays: launches {launches}; "
          f"loss mean of steps 1-10 {first:.5f}, of steps 51-60 {last:.5f}; "
          f"logged totals {[round(v, 5) for v in logged]}; final checkpoint rendered "
          f"{view['rgb'].shape}, finite {finite_view}")
    print(f"phase 8: median {ms_step:.2f} ms/step over steps 6-60 "
          f"({512e3 / ms_step:.0f} rays/s); all steps ms "
          f"{[round(v, 1) for v in step_ms]} {tag}")
    if (min(launches.values()) < 60 or len(totals) != 60 or not np.isfinite(totals).all()
            or not np.isfinite(logged).all() or not last < first or not finite_view):
        print("FAIL phase 8: training did not run through the kernels, diverged, "
              "or did not lower the loss", file=sys.stderr)
        return 1

    # ---- phase 9: kernel 3's time, and one step split
    def run3():
        fused_nablas_vjp.fused_nablas_vjp(surface, x3, ws3, bs3, *cots)
    ms3 = _time_ms(run3)
    pms3 = _time_ms(lambda: fused_nablas_vjp.nablas_vjp_plain(surface, x3, ws3, bs3, *cots))
    flops3 = 2.0 * _surface_macs(surface, backward=True) * M3
    bytes3 = 4.0 * (M3 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                    + 2 * sum(p.numel() for p in surface.parameters()))
    b3, by3 = _bound_ms(flops3, bytes3)
    print(f"phase 9: nablas_backward {M3} points: {ms3:.3f} ms (plain {pms3:.3f} ms, "
          f"fp32 bound {b3:.3f} ms, {flops3 / 1e9:.1f} GFLOP, workspace {ws_bytes} bytes) {tag}")
    print(f"phase 9: nablas_backward's CUDA kernels (torch.profiler, one call): "
          f"{_profile_kernels(run3)} {tag}")
    step_total, split, busy = _step_split(targs, dev)
    rest = step_total - sum(split.values())
    print(f"phase 9: one flagship step (512 rays) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, glue, loss) {rest:.2f} ms {tag}")
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 9: device over three steps under torch.profiler: {busy} {tag}")

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
        {"name": "nablas_backward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/nablas_backward.cu",
         "replaces": "neurecon_tpu/ops/fused_nablas_vjp.py:120",
         "launches": launches["nablas_backward"], "max_abs_err": k3_err,
         "ms": ms3, "plain_ms": pms3, "bound_ms": b3, "bound_by": by3,
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

#!/usr/bin/env python3
"""The port's smoke run on one CUDA card (an H100):
`python3 chip_smoke.py [--seed N]`.

Phases, in order; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch's count); build the
   five CUDA sources from neurecon_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all at once.
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
   counters must rise (5 launches each per frame; the sdf-only kernel none),
   every output must be
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
   The loop also extracts a mesh at step 30 (`i_val_mesh` 30, a 256^3
   grid): `meshes/00000030.ply` must be non-empty, written through kernel 4,
   and its seconds are printed on a line of their own.
9. kernel 3's time at 130,560 points beside its plain version's and its
   fp32 and 3xTF32 bounds, its workspace bytes, its four CUDA kernels' device
   times from torch.profiler, the same at a VolSDF step's 197,632 points,
   one training step split by CUDA events into kernel 2,
   kernel 1, kernel 3, the radiance forward, the Adam step and the rest, and
   the device's busy share over three steps (torch.profiler).
10. kernel 4 (`sdf_forward`, the sdf-only forward) against its plain version
   on the perturbed flagship surface: 2^20 points uniform in [-1, 1]^3 from
   the seed, and 4,099 more (a ragged last tile); max|diff| <= 1e-5
   max|sdf|, beside what zeroing the octave columns would move; times of
   the kernel and its plain version at 2^20 points; one 4,096-point call
   split into weight packing, the kept pack's lookup, the occupancy query
   and the launch (a repeated call with unchanged weights must not pack).
11. `extract_surface` through its `main_function` on the flagship
   geometric-init checkpoint at the CLI default N = 512: grid, triangulation
   and write seconds, kernel 4's launches and summed device ms, vertex and
   face counts, vertex radii; the mesh must be non-empty and closed, and the
   checkpoint's sdf at its vertices within a tenth of a grid cell of 0 (the
   geometric init is a lumpy sphere: on the CPU at N = 40 its vertex radii
   run from 0.41 to 1.01, so their mean is no check). At N = 256 the kernel's
   grid against the plain grid (values within 1e-5 of max, sign flips
   counted) and the two meshes by Chamfer (below 1e-3 of volume_size).
12. `render_view --use_surface_render` through `render_frames`: two 120x160
   frames each with sphere_tracing and root_finding, kernels 4 and 1 both
   launched; a 2,048-ray patch on the perturbed model against the plain
   versions (hit masks agree but for at most 0.1% of rays, depth and rgb
   within 2e-3 where both hit); and a `--render_mesh` frame of phase 11's
   mesh, which must not be blank.
13. `eval_staged` on phase 8's checkpoints at steps 30 and 60 against a GT
   mesh of the training scene's sphere made by `make_gt_mesh`: PSNR and
   Chamfer, both finite.

14. kernels (a)-(c) of the VolSDF fine sampler (`volsdf_fine_sample`, with
   kernel 4 for its queries) against the plain sampler on 1,024 rays of the
   synthetic scene at configs/volsdf.yaml's widths (n0 = n_up = 512, 6
   rounds, 3,584 depths a ray), perturbed surface, beta_net 0.1, 0.01 and
   0.001, det and perturb uniforms: <= 2% of the fine depths beyond 1e-4 of the span,
   beta maps within rtol 1e-3 / atol 1e-5 on >= 99% of the rays, iter_usage
   equal on >= 90% (the JAX package's own bounds). Then each kernel on its
   plain stage's inputs, in lockstep: merged depths equal, every state and
   bounds share off at most 1%, the det draws sorted.
15. `render_view` on a VolSDF checkpoint saved by the port: two 120x160
   frames at rayschunk 4,096 through (a)-(c), kernel 4 and kernel 1 (exact
   launch counts), finite; a 2,048-ray patch on the perturbed model against
   a render through the plain versions (rgb atol 2e-3).
16. the VolSDF step's gradient on 1,024 rays with fixed fine samples and
   eikonal points, through the kernels and through the plain versions: loss
   to rel 1e-5, every grad leaf (ln_beta included) within 5e-4 max|ref|.
   Then `train.py` at configs/volsdf.yaml's widths on 8 synthetic images, 1,024
   rays, 40 steps (cut from 100,000), a 128^3 mesh at step 20 (written,
   possibly empty: its faces and the grid's sdf range are printed): every
   loss finite, the last 10 steps' mean below the first 10's, kernels 1, 3
   and (a)-(c) launched every step; median ms per step and rays/s.
17. times of (a)-(c) summed over one sampler call beside their plain stages
   and bounds; one VolSDF step split into the sampler (kernel 4, (a)-(c),
   its glue), kernel 1, kernel 3, the radiance forward, Adam and the rest;
   the device's busy share; one VolSDF frame split the same way.

Every path above is driven with the kernels' launch counters set to 0 just
before it and read just after. Prints one JSON line of per-kernel results
(`launches` from each slice's training run: phase 8 for kernels 1-4, phase
16 for (a)-(c); `launches_by_path` for each path), then, as the last line,
{"ok": true, "device": {...}}. Needs the repository checkout beside it; it
imports no JAX.
"""
import argparse
import contextlib
import copy
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)
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


def _wall_ms(fn, reps=50):
    """Median host ms of `fn` followed by a device sync, over `reps` runs
    after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _bound_ms(flops, nbytes, peak=FP32_PEAK):
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _bounds(flops, nbytes):
    """The fp32 bound (CUDA cores) and the split-fp32 tensor-core bound (three
    TF32 MMAs a multiply-add) of the same work, each (ms, bound_by)."""
    return _bound_ms(flops, nbytes), _bound_ms(3.0 * flops, nbytes, TF32_PEAK)


def _bound_fields(fp32, tf32, held_to):
    """The kernels line's bound keys: `bound_ms` is the bound the kernel is
    held to (its arithmetic's type), beside both."""
    held = tf32 if held_to == "3xtf32" else fp32
    return {"bound_ms": held[0], "bound_by": held[1], "bound_held_to": held_to,
            "bound_ms_fp32": fp32[0], "bound_ms_3xtf32": tf32[0]}


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


@contextlib.contextmanager
def _spans(module, name, spans):
    """Patch `module.name` (a kernel wrapper, a method) with a wrapper that
    records CUDA events around each call into `spans`. While the patch
    holds, a kernel wrapper bumps its launch counter on the wrapper (it
    finds itself by its module name); the count is carried back after."""
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapper(*a, **k):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = fn(*a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    with mock.patch.object(module, name, wrapper):
        yield
    if hasattr(fn, "launches"):
        fn.launches = wrapper.launches


def _frame_split(render_frames, vargs, parts):
    """Render two frames with CUDA events around each call of the `parts`
    ({name: (module or class, attribute)}: kernel wrappers, the radiance
    MLP); return the second frame's wall ms and the device ms of each part."""
    spans = {k: [] for k in parts}
    with contextlib.ExitStack() as stack:
        for k, (mod, attr) in parts.items():
            stack.enter_context(_spans(mod, attr, spans[k]))
        frames = render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    skip = {k: len(v) // 2 for k, v in spans.items()}  # the first frame's calls
    ms = {k: sum(a.elapsed_time(b) for a, b in v[skip[k]:]) for k, v in spans.items()}
    return 1e3 * frames["seconds"][1], ms


def _closed(faces: torch.Tensor) -> bool:
    """Every undirected edge of the triangle mesh is shared by two faces."""
    f = faces.long()
    e = torch.sort(torch.cat([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), dim=1).values
    _, counts = torch.unique(e[:, 0] * (int(f.max()) + 1) + e[:, 1], return_counts=True)
    return bool((counts == 2).all())


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
    cfg["data"].update({"n_images": 8, "N_rays": 512, "val_downscale": 4, "mesh_N": 256})
    cfg["training"].update({
        "num_iters": 60, "scheduler": {"type": "warmupcosine", "warmup_steps": 10},
        "i_val": 30, "i_log": 10, "i_val_mesh": 30, "i_backup": 30, "i_save": 900,
        "monitoring": "none", "log_root_dir": tmp,
        "exp_dir": f"{tmp}/chip_smoke_train"})
    return cfg


def _step_split(args, dev, parts, n_warm=3):
    """One flagship training step split by CUDA events around each call of
    the `parts` ({name: (module or class, attribute)}; "adam_step" is the
    optimizer's step), then the device's busy share over three more steps;
    returns (step ms, {part: ms}, busy share)."""
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_model, make_trainer
    from neurecon_tpu_torch.training import make_train_step

    ds = get_data(args)
    model, kw, _, _ = get_model(args, dev, seed=0)
    kw["H"], kw["W"] = ds.H, ds.W
    opt, sched = make_optimizer(args, model)
    step = make_train_step(make_trainer(args, model, kw), model, opt, sched)
    batch = {"c2w": torch.tensor(ds.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(ds.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(ds.rgb_images[:1], device=dev).reshape(1, -1, 3)}
    if args.training.get("with_mask", False):
        batch["object_mask"] = torch.tensor(ds.object_masks[:1], device=dev).reshape(1, -1)
    gen = torch.Generator(device=dev).manual_seed(0)
    for i in range(n_warm):
        step(batch, gen, i)
    spans = {k: [] for k in (*parts, "adam_step")}
    with contextlib.ExitStack() as stack:
        for k, (mod, attr) in parts.items():
            stack.enter_context(_spans(mod, attr, spans[k]))
        stack.enter_context(_spans(opt, "step", spans["adam_step"]))
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        step(batch, gen, n_warm)
        b.record()
        torch.cuda.synchronize()
    parts_ms = {k: sum(x.elapsed_time(y) for x, y in v) for k, v in spans.items()}
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
    return a.elapsed_time(b), parts_ms, busy


def _lockstep(surface, rays_o, rays_d, d_init, far, ab, u, *, n_up, max_iter, n_final,
              bg_r=3.0, eps=0.1, max_bisection=10):
    """Each of kernels (a)-(c) against its plain version on the same inputs:
    the plain sampler runs stage by stage (`init_plain`, `draw_plain`,
    `checkpoint_plain`), and before each stage the kernel gets the plain
    state as its input. Returns {kernel: {output: worst error}} over the
    call (fine depths and new depths as max|diff|, new depths also as the
    share beyond 1e-4 of the span, bounds as the share of entries beyond
    rtol 1e-3 / atol 1e-6, beta as the share of rays beyond
    rtol 1e-3 / atol 1e-5, the state flags as the share of rays that
    differ), and whether the merged depths equal the plain sort's."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.fused_mlp import sdf_forward_plain

    N, n0 = d_init.shape
    kw = {"n_final": n_final, "u_stride": u.shape[1], "eps": eps, "prior_r": -1.0,
          "bg_r": bg_r}
    if surface.sphere_residual:
        kw["prior_r"] = float(surface.radius_init)
    ws = ffs.workspace(N, n0 + max_iter * n_up, n_final, d_init.device)
    err = {k: {} for k in ("volsdf_init", "volsdf_draw", "volsdf_checkpoint")}

    def worst(name, key, v):
        err[name][key] = max(err[name].get(key, 0.0), float(v))

    def share_off(a, b, rtol, atol):
        return ((a - b).abs() > atol + rtol * b.abs()).float().mean()

    def compare(name, state, bounds_n):
        worst(name, "fine", (ws["fine"] - state["fine"]).abs().max())
        worst(name, "beta_share", share_off(ws["beta"], state["beta"][:, 0], 1e-3, 1e-5))
        worst(name, "converged_share",
              (ws["converged"].bool() != state["converged"]).float().mean())
        worst(name, "iter_usage_share", (ws["iter_usage"] != state["iter_usage"]).float().mean())
        if bounds_n:
            worst(name, "bounds_share", share_off(ws["bounds"][:, :bounds_n],
                                                  state["bounds"], 1e-3, 1e-6))

    def query_raw(d):
        """(the MLP's raw sdf [N * P], the kernels' input; the plain query's
        sdf [N, P])"""
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        raw = sdf_forward_plain(surface, pts.reshape(-1, 3)).contiguous()
        return raw, ffs.background_min(surface.forward(pts), pts, bg_r)

    raw, sdf = query_raw(d_init)
    state = ffs.init_plain(d_init, sdf, far, ab[0], ab[1], u[:, :n_final], eps=eps)
    ffs.launch_init(ws, rays_o, rays_d, d_init, raw, far, torch.stack(ab), u,
                    beta_c=ffs.beta_plus_denominator(n0, eps), **kw)
    worst("volsdf_init", "sdf", (ws["s"][0][:, :n0] - sdf).abs().max())
    compare("volsdf_init", state, n0 - 1)
    d, merged_equal = d_init, True
    for it in range(1, max_iter + 1):
        s_in, last = d.shape[1], it == max_iter
        ws["d"][0][:, :s_in] = d
        ws["s"][0][:, :s_in] = sdf
        ws["bounds"][:, :s_in - 1] = state["bounds"]
        nd, pts = ffs.launch_draw(ws, rays_o, rays_d, 0, s_in, n_up)
        up = ffs.draw_plain(d, state["bounds"], n_up)
        worst("volsdf_draw", "depths", (nd - up).abs().max())
        worst("volsdf_draw", "depths_share", ((nd - up).abs() > 1e-4 * far).float().mean())
        worst("volsdf_draw", "unsorted_rays", (nd[:, 1:] < nd[:, :-1]).any(1).float().mean())
        raw_new, sdf_new = query_raw(up)
        ws["beta"].copy_(state["beta"][:, 0])
        ws["converged"].copy_(state["converged"].int())
        ws["iter_usage"].copy_(state["iter_usage"])
        ws["fine"].copy_(state["fine"])
        ffs.launch_checkpoint(ws, rays_o, rays_d, 0, s_in, up, raw_new, torch.stack(ab), u,
                              it=it, max_iter=max_iter, max_bisection=max_bisection, **kw)
        d, sdf = ffs.checkpoint_plain(
            d, sdf, up, sdf_new, state, ab[0], ab[1], u[:, it * n_final:(it + 1) * n_final],
            u[:, (max_iter + 1) * n_final:], it=it, last=last, eps=eps,
            max_bisection=max_bisection)
        P = d.shape[1]
        if not last:
            merged_equal &= bool(torch.equal(ws["d"][1][:, :P], d))
            worst("volsdf_checkpoint", "sdf", (ws["s"][1][:, :P] - sdf).abs().max())
        compare("volsdf_checkpoint", state, 0 if last else P - 1)
    worst("volsdf_checkpoint", "beta_out_share", share_off(ws["beta_out"], state["beta_out"],
                                                           1e-3, 1e-5))
    torch.cuda.synchronize()
    return err, merged_equal


def _sampler_bounds(surface, N, n0, n_up, max_iter, n_final, iter_usage):
    """The least time of kernels (a), (b) and (c) over one sampler call, in
    ms, from the bytes each must move and the fp32 operations this call's
    data needs (about 30 per interval per error-bound sweep, 12 per opacity
    sweep; a round's sweeps: the net-beta check, 10 bisection steps on each
    ray not yet converged, the new bounds, a draw for each ray that
    converges): {kernel: (ms, "bytes" or "operations")}."""
    iu = iter_usage.long()
    draws_d = math.log2(n0) + 10
    out = {"volsdf_init": _bound_ms(
        N * ((n0 - 1) * (2 * 30 + 12) + n_final * draws_d),
        4.0 * N * (2 * n0 + n_final + 7 + 3 * n0 + n_final + 3))}
    ops_b = bytes_b = ops_c = bytes_c = 0.0
    for it in range(1, max_iter + 1):
        s_in, P, last = n0 + (it - 1) * n_up, n0 + it * n_up, it == max_iter
        ops_b += N * ((s_in - 1) * 6 + n_up * (2 * math.log2(s_in) + 10))
        bytes_b += 4.0 * N * (2 * s_in + 6 + 4 * n_up)
        bisect = int(((iu == -1) | (iu > it)).sum())
        draws = int((iu == it).sum()) + (int((iu == -1).sum()) if last else 0)
        sweeps = N * (1 + (0 if last else 1)) * 30 + bisect * 10 * 30 + draws * 12
        ops_c += (P - 1) * sweeps + draws * n_final * (math.log2(P) + 10)
        bytes_c += 4.0 * N * (2 * s_in + 2 * n_up + n_final + 7 + (0 if last else 3 * P)
                              + n_final + 3)
    out["volsdf_draw"] = _bound_ms(ops_b, bytes_b)
    out["volsdf_checkpoint"] = _bound_ms(ops_c, bytes_c)
    return out


# configs/volsdf.yaml's model and training sections (the card machine has no
# PyYAML; tests/test_torch_volsdf_train.py holds them equal to the file), on
# the synthetic scene scaled as configs/synthetic_quality_volsdf.yaml scales
# it (cameras inside the background sphere of radius 3).
VOLSDF = {
    "expname": "chip_smoke_volsdf", "device_ids": -1,
    "data": {"type": "synthetic", "downscale": 1, "n_images": 8, "H": 120, "W": 160,
             "scale_radius": 2.6, "near": 0.0, "far": 6.0, "N_rays": 1024,
             "val_downscale": 8, "val_rayschunk": 256, "volume_size": 3.0},
    "model": {"W_geometry_feature": 256, "framework": "VolSDF", "max_upsample_iter": 6,
              "obj_bounding_radius": 3.0, "outside_scene": "builtin",
              "radiance": {"D": 4, "embed_multires": -1, "embed_multires_view": -1,
                           "skips": []},
              "surface": {"D": 8, "embed_multires": 6, "radius_init": 1.0, "skips": [4]}},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "overlap_sampler": False,
                 "fused_samplers": True, "fused_nablas_vjp": True,
                 "monitoring": "tensorboard", "num_iters": 100000,
                 "scheduler": {"min_factor": 0.1, "type": "exponential_step"},
                 "speed_factor": 10.0, "w_eikonal": 0.1},
}
VOLSDF_STEPS = 40  # phase 16's cut of configs/volsdf.yaml's 100,000 steps


def _volsdf_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 14-17 (the VolSDF slice); returns (rc, kernel rows, train launches)."""
    from neurecon_tpu_torch import bridge, train
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import RadianceNet, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, volsdf
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, get_rays
    from neurecon_tpu_torch.ops.sampling import linspace01
    from neurecon_tpu_torch.tools import render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO, load_checkpoint

    args = ConfigDict(copy.deepcopy(VOLSDF))
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    surface = checked.implicit_surface
    ds = get_data(args)
    o_all, d_all, _ = get_rays(torch.tensor(ds.c2w_all[0], device=dev),
                               torch.tensor(ds.intrinsics_all[0], device=dev), 120, 160)
    idx = torch.linspace(0, 120 * 160 - 1, 1024, device=dev).long()
    rays_o, rays_d, _, far = volsdf._ray_bounds(o_all[idx], d_all[idx], 0.0, 6.0)
    N, n0, n_up, max_iter, n_final = 1024, 512, 512, 6, 64
    d_init = (far * linspace01(n0, dev)).contiguous()
    kw = {"eps": 0.1, "max_iter": max_iter, "max_bisection": 10, "n_final": n_final,
          "n_up": n_up, "sphere_bg_r": 3.0}
    span = 6.0

    # ---- phase 14: kernels (a)-(c) against the plain sampler
    k_err, ok, last_u = {}, True, None
    # the init's beta; a sharper one (rays converge in round 2); one so sharp
    # that no ray converges (six rounds of bisection, then the fallback draw)
    for beta in (0.1, 0.01, 0.001):
        ab = (torch.tensor(1.0 / beta, device=dev), torch.tensor(beta, device=dev))
        for mode in ("det", "perturb"):
            u = (ffs.det_uniforms(n_final, max_iter + 2, N, dev) if mode == "det"
                 else torch.rand(N, (max_iter + 2) * n_final, device=dev,
                                 generator=torch.Generator(dev).manual_seed(seed + 3)))
            got = ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far, *ab, u, **kw)
            ref = ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far, *ab, u, **kw)
            torch.cuda.synchronize()
            (gd, gb, gi), (rd, rb, ri) = got, ref
            dd = (gd - rd).abs()
            fine_share = float((dd > 1e-4 * span).float().mean())
            beta_off = int(((gb - rb).abs() > 1e-5 + 1e-3 * rb.abs()).sum())
            iter_eq = float((gi == ri).float().mean())
            rounds = torch.bincount((ri + 1).long(), minlength=max_iter + 2).tolist()
            lock, merged_equal = _lockstep(surface, rays_o, rays_d, d_init, far, ab, u,
                                           n_up=n_up, max_iter=max_iter, n_final=n_final)
            was = " (the CUDA-core fp32 kernel 4 read 3)" if beta == 0.001 else ""
            print(f"phase 14: sampler beta_net {beta} {mode}, 1,024 flagship rays, 3,584 depths: "
                  f"fine max|diff| {float(dd.max()):.3e}, share beyond 1e-4 span "
                  f"{fine_share:.5f}; beta map off on {beta_off} rays{was}; iter_usage equal on "
                  f"{iter_eq:.4f}; rounds (-1, 0..6) {rounds}")
            print(f"phase 14: lockstep (each kernel on the plain stage's inputs): "
                  f"{json.dumps(lock)}; merged depths equal {merged_equal}")
            for name, e in lock.items():
                k_err[name] = max(k_err.get(name, 0.0),
                                  e.get("fine", 0.0), e.get("depths", 0.0))
            finite = all(bool(torch.isfinite(t).all()) for t in (gd, gb))
            shares = [v for e in lock.values() for k, v in e.items() if k.endswith("share")]
            if (fine_share > 0.02 or beta_off > 0.01 * N or iter_eq < 0.9 or not finite
                    or not merged_equal or max(shares) > 0.01
                    or lock["volsdf_draw"]["unsorted_rays"] > 0):
                ok = False
            last_u, last_ab = u, ab
    if not ok:
        print("FAIL phase 14: the fine-sampler kernels disagree with their plain versions",
              file=sys.stderr)
        return 1, None, None

    # ---- phase 15: render_view on a VolSDF checkpoint saved by the port
    ckpt = CheckpointIO(workdir).save("volsdf_init.pt", 0, model=bridge.model_to_tree(model))
    vargs = ConfigDict(copy.deepcopy(VOLSDF))
    vargs.update({"load_pt": ckpt, "num_views": 2, "camera_path": "interpolation",
                  "rayschunk": 4096})
    zero_counts()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    launches = by_path["volsdf_render_view"] = read_counts()
    print(f"phase 15: render_view VolSDF 2 x 120x160: launches {launches}, s/frame "
          f"{[round(v, 4) for v in frames['seconds']]} {tag}")
    # 5 chunks of 4,096 rays per frame: per chunk one sampler call (1 + 6 + 6
    # launches of (a)-(c), 7 of kernel 4) and one forward+nablas query
    want = {"nablas_forward": 10, "neus_upsample": 0, "nablas_backward": 0,
            "sdf_forward": 70, "volsdf_init": 10, "volsdf_draw": 60, "volsdf_checkpoint": 60}
    if (launches != want or frames["rgb"].shape != (2, 120, 160, 3)
            or not all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))):
        print("FAIL phase 15: the VolSDF render missed a kernel or is not finite",
              file=sys.stderr)
        return 1, None, None
    render_fn = volsdf.make_volume_render_fn(checked, detailed_output=False, calc_normal=True,
                                             **kw_test)
    patch = torch.arange(60 * 160 - 1024, 60 * 160 + 1024, device=dev)
    out_k = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           fused_nablas.forward_with_nablas_plain), \
            mock.patch.object(ffs, "fused_fine_sample", ffs.fine_sample_plain):
        out_p = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
    e = {k: float(np.abs(out_k[k] - out_p[k]).max())
         for k in ("rgb", "depth_volume", "normals_volume", "mask_volume", "beta_map")}
    e["iter_usage_equal"] = float((out_k["iter_usage"] == out_p["iter_usage"]).mean())
    print(f"phase 15: 2048-ray patch, kernels vs plain: max|diff| {e}")
    if e["rgb"] > 2e-3:
        print("FAIL phase 15: the VolSDF patch disagrees with the plain render", file=sys.stderr)
        return 1, None, None

    # ---- phase 16: the step's gradient through the kernels against the plain
    # versions (fixed fine samples and eikonal points), then train.py
    batch = {"c2w": torch.tensor(ds.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(ds.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(ds.rgb_images[:1], device=dev).reshape(1, -1, 3)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, 120, 160, 1024)
    eik = (torch.rand(1, 1024, 1, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed + 4)) * 2 - 1) * 3.0
    fine = volsdf.compute_ray_samples(checked, rb["rays_o"], rb["rays_d"],
                                      **{**kw_train, "perturb": False})
    ray_loss = get_ray_loss_fn(args, checked, kw_train)

    def step_grads():
        checked.zero_grad(set_to_none=True)
        total, _ = ray_loss(rb, fine_override=fine, eik_pts=eik)
        total.backward()
        return total.item(), [p.grad.clone() for p in checked.parameters()]

    loss_k, grads_k = step_grads()
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           fused_nablas.forward_with_nablas_plain), \
            mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp",
                              fused_nablas_vjp.nablas_vjp_plain):
        loss_p, grads_p = step_grads()
    checked.zero_grad(set_to_none=True)
    names = [n for n, _ in checked.named_parameters()]
    ratios = {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for n, a, b in zip(names, grads_k, grads_p)}
    worst = max(ratios, key=ratios.get)
    print(f"phase 16: VolSDF step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad "
          f"leaf {worst} {ratios[worst]:.2e} over {len(names)} leaves (ln_beta "
          f"{ratios['ln_beta']:.2e})")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or ratios[worst] > 5e-4:
        print("FAIL phase 16: the VolSDF step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1, None, None
    targs = ConfigDict(copy.deepcopy(VOLSDF))
    targs["expname"] = "chip_smoke_volsdf_train"
    targs["seed"] = seed
    targs.data["mesh_N"] = 128
    tdir = os.path.join(workdir, "volsdf_train")
    targs.training.update({"num_iters": VOLSDF_STEPS, "i_val": 20, "i_log": 10,
                           "i_val_mesh": 20, "i_backup": 20, "monitoring": "none",
                           "log_root_dir": tdir, "exp_dir": os.path.join(tdir, "run")})
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

    zero_counts()
    with mock.patch.object(train, "make_train_step", make_step_timed):
        out = train.main_function(targs, device="cuda")
    torch.cuda.synchronize()
    t_launches = by_path["volsdf_train"] = read_counts()
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    evs = starts + [end]
    step_ms = [evs[i].elapsed_time(evs[i + 1]) for i in range(len(starts))]
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    mesh20 = os.path.join(out["exp_dir"], "meshes", "00000020.ply")
    n_f20 = len(mesh_util.read_ply(mesh20)[1]) if os.path.exists(mesh20) else -1
    # the sdf range of step 20's surface over the mesh's grid, beside its face count
    m20, *_ = get_model(ConfigDict(copy.deepcopy(VOLSDF)), dev)
    bridge.load_tree(m20, load_checkpoint(os.path.join(out["exp_dir"], "ckpts",
                                                       "00000020.pt"))["model"])
    g20 = mesh_util.query_grid(m20.implicit_surface.forward_query, 128, 3.0, device=dev)
    betas = [round(v, 5) for _, v in out["stats"]["scalars"]["beta"]]
    print(f"phase 16: train.py {VOLSDF_STEPS} steps at configs/volsdf.yaml widths, 1,024 rays: "
          f"launches {t_launches}; loss mean of steps 1-10 {first:.5f}, of the last 10 "
          f"{last:.5f}; beta at the logs {betas}; in-loop 128^3 mesh at step 20 {n_f20} faces, "
          f"{out['stats']['perf'].get('mesh_sec')} s, the grid's sdf from {float(g20.min()):.4f} "
          f"to {float(g20.max()):.4f}")
    print(f"phase 16: median {ms_step:.2f} ms/step over steps 6-{VOLSDF_STEPS} "
          f"({1024e3 / ms_step:.0f} rays/s); all steps ms {[round(v, 1) for v in step_ms]} {tag}")
    S = VOLSDF_STEPS
    if (min(t_launches["nablas_forward"], t_launches["nablas_backward"],
            t_launches["volsdf_init"]) < S
            or min(t_launches["volsdf_draw"], t_launches["volsdf_checkpoint"]) < 6 * S
            or len(totals) != S or not np.isfinite(totals).all() or not last < first
            or n_f20 < 0):
        print("FAIL phase 16: VolSDF training missed a kernel, diverged, did not lower the "
              "loss, or meshed no surface file", file=sys.stderr)
        return 1, None, None

    # ---- phase 17: the kernels' times, and a step and a frame split
    parts = {"volsdf_init": (ffs, "launch_init"), "volsdf_draw": (ffs, "launch_draw"),
             "volsdf_checkpoint": (ffs, "launch_checkpoint"),
             "sdf_forward (sampler)": (ffs, "launch_sdf_forward")}
    plain_parts = {"volsdf_init": (ffs, "init_plain"), "volsdf_draw": (ffs, "draw_plain"),
                   "volsdf_checkpoint": (ffs, "checkpoint_plain")}

    def per_call(fn, targets, reps=5):
        fn()
        runs = []
        for _ in range(reps):
            spans = {k: [] for k in targets}
            with contextlib.ExitStack() as stack:
                for k, (mod, attr) in targets.items():
                    stack.enter_context(_spans(mod, attr, spans[k]))
                res = fn()
            torch.cuda.synchronize()
            runs.append({k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()})
        return res, {k: float(np.median([r[k] for r in runs])) for k in targets}

    res, k_ms = per_call(lambda: ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far,
                                                       *last_ab, last_u, **kw), parts)
    _, p_ms = per_call(lambda: ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far,
                                                     *last_ab, last_u, **kw), plain_parts,
                       reps=3)
    whole = _time_ms(lambda: ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far,
                                                   *last_ab, last_u, **kw), reps=5)
    whole_p = _time_ms(lambda: ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far,
                                                     *last_ab, last_u, **kw), reps=3)
    bounds = _sampler_bounds(surface, N, n0, n_up, max_iter, n_final, res[2])
    mlp_flops = 2.0 * _surface_macs(surface, sdf_only=True) * N * (n0 + max_iter * n_up)
    ws_bytes = sum(t.nbytes for t in ffs.workspace(N, n0 + max_iter * n_up, n_final,
                                                   dev).values() if torch.is_tensor(t))
    print(f"phase 17: one sampler call, 1,024 flagship rays (beta_net {float(last_ab[1]):g}, "
          f"perturb): "
          f"{whole:.3f} ms (plain {whole_p:.3f} ms); per kernel, summed over the call "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in k_ms.items())
          + "; plain stages " + ", ".join(f"{k} {v:.3f} ms" for k, v in p_ms.items())
          + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})" for k, v in bounds.items())
          + f"; the sampler's MLP {mlp_flops / 1e12:.3f} TFLOP (fp32 bound "
          f"{1e3 * mlp_flops / FP32_PEAK:.2f} ms, 3xTF32 bound "
          f"{3e3 * mlp_flops / TF32_PEAK:.2f} ms); workspace "
          f"{ws_bytes} bytes {tag}")
    sampler_parts = {"sampler (whole)": (ffs, "fused_fine_sample"), **parts}
    step_total, split, busy = _step_split(
        targs, dev, {**sampler_parts,
                     "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward")})
    sampler_rest = split["sampler (whole)"] - sum(split[k] for k in parts)
    rest = step_total - sum(v for k, v in split.items() if k not in parts)
    print(f"phase 17: one VolSDF step (1,024 rays) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the sampler's own glue (packing, points, workspace) {sampler_rest:.2f} ms, "
          f"the rest (radiance backward, loss, glue) {rest:.2f} ms {tag}")
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 17: device over three VolSDF steps under torch.profiler: {busy} {tag}")
    vargs["load_pt"] = out["final_ckpt"]
    frame_ms, fsplit = _frame_split(
        render_view.render_frames, vargs,
        {**sampler_parts, "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
         "radiance_net": (RadianceNet, "forward")})
    frest = frame_ms - sum(v for k, v in fsplit.items() if k not in parts)
    print(f"phase 17: one 120x160 VolSDF frame (5 chunks, phase 16's final checkpoint) "
          f"{frame_ms:.2f} ms wall: " + ", ".join(f"{k} {v:.2f} ms" for k, v in fsplit.items())
          + f", everything else {frest:.2f} ms {tag}")

    rows = []
    for name, line in (("volsdf_init", 118), ("volsdf_draw", 171), ("volsdf_checkpoint", 211)):
        rows.append({"name": name, "route": "cuda",
                     "source": "neurecon_tpu_torch/csrc/volsdf_fine_sample.cu",
                     "replaces": f"neurecon_tpu/ops/fused_fine_sample.py:{line}",
                     "launches": t_launches[name], "max_abs_err": k_err[name],
                     "ms": k_ms[name], "plain_ms": p_ms[name], "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "bound_held_to": "fp32", "library_ms": None,
                     "per": "one sampler call of 1,024 flagship rays"})
    return 0, rows, t_launches


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
    from neurecon_tpu_torch.models.base import RadianceNet, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import (_prepare_rays, _uniforms,
                                                           make_volume_render_fn)
    from neurecon_tpu_torch import train
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.ops import (_build, fused_fine_sample, fused_mlp, fused_nablas,
                                        fused_nablas_vjp, fused_upsample, get_rays,
                                        surface_pack)
    from neurecon_tpu_torch.models.ray_casting import make_surface_render_fn
    from neurecon_tpu_torch.tools import extract_surface, render_view
    from neurecon_tpu_torch.tools.eval_mesh import chamfer_distance
    from neurecon_tpu_torch.tools.eval_staged import evaluate_ckpts
    from neurecon_tpu_torch.tools.make_gt_mesh import make_gt_mesh
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO

    dev = torch.device("cuda")
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # removed at exit
    counters = {"nablas_forward": fused_nablas.fused_forward_with_nablas,
                "neus_upsample": fused_upsample.fused_neus_upsample,
                "nablas_backward": fused_nablas_vjp.fused_nablas_vjp,
                "sdf_forward": fused_mlp.fused_sdf_forward,
                "volsdf_init": fused_fine_sample.launch_init,
                "volsdf_draw": fused_fine_sample.launch_draw,
                "volsdf_checkpoint": fused_fine_sample.launch_checkpoint}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def read_counts():
        return {k: fn.launches for k, fn in counters.items()}

    by_path = {}
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
        zero_counts()
        frames = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        launches = by_path["render_view"] = read_counts()
    print(f"phase 4: render_view 2 x 120x160: launches {launches}, "
          f"s/frame {[round(s, 4) for s in frames['seconds']]} {tag}")
    finite = all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))
    # 5 chunks of 4,096 rays per frame, one launch of each forward kernel per
    # chunk; the render builds no graph, so the backward kernel never runs,
    # and the volume render makes no gradient-free point query
    if (launches != {"nablas_forward": 10, "neus_upsample": 10, "nablas_backward": 0,
                     "sdf_forward": 0, "volsdf_init": 0, "volsdf_draw": 0,
                     "volsdf_checkpoint": 0}
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
    bb1 = _bounds(flops1, bytes1)
    b1 = bb1[0][0]
    ms2 = _time_ms(lambda: fused_upsample.fused_neus_upsample(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    pms2 = _time_ms(lambda: fused_upsample.neus_upsample_plain(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    flops2 = 2.0 * _surface_macs(surface, sdf_only=True) * 4096 * 128
    bytes2 = 4.0 * (4096 * (6 + 64 + 64 + 128)
                    + sum(p.numel() for p in surface.parameters()))
    b2, by2 = _bound_ms(flops2, bytes2)
    print(f"phase 5: nablas_forward {M} points: {ms1:.3f} ms (plain {pms1:.3f} ms, "
          f"fp32 bound {b1:.3f} ms, 3xTF32 bound {bb1[1][0]:.3f} ms, {flops1 / 1e9:.1f} "
          f"GFLOP) {tag}")
    print(f"phase 5: neus_upsample 4096 rays: {ms2:.3f} ms (plain {pms2:.3f} ms, "
          f"fp32 bound {b2:.3f} ms, {flops2 / 1e9:.1f} GFLOP) {tag}")
    print(f"phase 5: render_view s/frame {frames['seconds']} {tag}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vargs["load_pt"] = CheckpointIO(tmp).save("latest.pt", 0,
                                                  model=bridge.model_to_tree(model))
        n_chunks = math.ceil(120 * 160 / 4096)
        frame_ms, split = _frame_split(
            render_view.render_frames, vargs,
            {"neus_upsample": (fused_upsample, "fused_neus_upsample"),
             "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
             "radiance_net": (RadianceNet, "forward")})
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

    # ---- phase 8: the training slice through train.py (its directory stays
    # for phase 13)
    targs = ConfigDict(_train_config(os.path.join(work.name, "train"), seed))
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

    zero_counts()
    with mock.patch.object(train, "make_train_step", make_step_timed):
        out = train.main_function(targs, device="cuda")
    torch.cuda.synchronize()
    launches = by_path["train"] = read_counts()
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
    mesh30 = os.path.join(out["exp_dir"], "meshes", "00000030.ply")
    n_f30 = len(mesh_util.read_ply(mesh30)[1]) if os.path.exists(mesh30) else 0
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    finite_view = all(np.isfinite(view[k]).all() for k in ("rgb", "depth", "normal"))
    print(f"phase 8: train.py 60 flagship steps at 512 rays: launches {launches}; "
          f"loss mean of steps 1-10 {first:.5f}, of steps 51-60 {last:.5f}; "
          f"logged totals {[round(v, 5) for v in logged]}; final checkpoint rendered "
          f"{view['rgb'].shape}, finite {finite_view}")
    print(f"phase 8: median {ms_step:.2f} ms/step over steps 6-60 "
          f"({512e3 / ms_step:.0f} rays/s); all steps ms "
          f"{[round(v, 1) for v in step_ms]} {tag}")
    print(f"phase 8: in-loop mesh at step 30 (256^3 grid, kernel 4): "
          f"{out['stats']['perf'].get('mesh_sec')} s (grid + triangulation + write), "
          f"{n_f30} faces {tag}")
    if (min(launches[k] for k in ("nablas_forward", "neus_upsample", "nablas_backward")) < 60
            or launches["sdf_forward"] == 0 or n_f30 == 0
            or len(totals) != 60 or not np.isfinite(totals).all()
            or not np.isfinite(logged).all() or not last < first or not finite_view):
        print("FAIL phase 8: training did not run through the kernels, diverged, "
              "did not lower the loss, or wrote no mesh", file=sys.stderr)
        return 1

    # ---- phase 9: kernel 3's time, and one step split
    def run3():
        fused_nablas_vjp.fused_nablas_vjp(surface, x3, ws3, bs3, *cots)
    ms3 = _time_ms(run3)
    pms3 = _time_ms(lambda: fused_nablas_vjp.nablas_vjp_plain(surface, x3, ws3, bs3, *cots))
    flops3 = 2.0 * _surface_macs(surface, backward=True) * M3
    bytes3 = 4.0 * (M3 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                    + 2 * sum(p.numel() for p in surface.parameters()))
    bb3 = _bounds(flops3, bytes3)
    print(f"phase 9: nablas_backward {M3} points: {ms3:.3f} ms (plain {pms3:.3f} ms, "
          f"fp32 bound {bb3[0][0]:.3f} ms, 3xTF32 bound {bb3[1][0]:.3f} ms, "
          f"{flops3 / 1e9:.1f} GFLOP, workspace {ws_bytes} bytes) {tag}")
    print(f"phase 9: nablas_backward's CUDA kernels (torch.profiler, one call): "
          f"{_profile_kernels(run3)} {tag}")
    # a VolSDF step's 197,632 points (1,024 rays x 193, phase 16's shapes): the
    # step's points and cotangents, then the first 67,072 of them again
    M9 = 197632
    x9 = torch.cat([x3, x3[:M9 - M3]])
    cots9 = [torch.cat([c, c[:M9 - M3]]) for c in cots]

    def run9():
        fused_nablas_vjp.fused_nablas_vjp(surface, x9, ws3, bs3, *cots9)
    ms9 = _time_ms(run9)
    bb9 = _bounds(2.0 * _surface_macs(surface, backward=True) * M9,
                  4.0 * (M9 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                         + 2 * sum(p.numel() for p in surface.parameters())))
    print(f"phase 9: nablas_backward {M9} points: {ms9:.3f} ms (fp32 bound {bb9[0][0]:.3f} ms, "
          f"3xTF32 bound {bb9[1][0]:.3f} ms, workspace "
          f"{fused_nablas_vjp.fused_nablas_vjp.workspace_bytes} bytes); CUDA kernels "
          f"{_profile_kernels(run9)} {tag}")
    del x9, cots9
    step_total, split, busy = _step_split(
        targs, dev, {"neus_upsample": (fused_upsample, "fused_neus_upsample"),
                     "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward")})
    rest = step_total - sum(split.values())
    print(f"phase 9: one flagship step (512 rays) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, glue, loss) {rest:.2f} ms {tag}")
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 9: device over three steps under torch.profiler: {busy} {tag}")

    # ---- phase 10: kernel 4 against its plain version
    g10 = torch.Generator(dev).manual_seed(seed)
    x10 = torch.rand(2 ** 20, 3, device=dev, generator=g10) * 2 - 1
    x10_tail = torch.rand(4099, 3, device=dev, generator=g10) * 2 - 1
    errs4, rel4, finite4 = [], [], True
    for xs in (x10, x10_tail):
        got4 = fused_mlp.fused_sdf_forward(surface, xs)
        ref4 = fused_mlp.sdf_forward_plain(surface, xs)
        torch.cuda.synchronize()
        errs4.append(float((got4 - ref4).abs().max()))
        rel4.append(errs4[-1] / float(ref4.abs().max()))
        finite4 = finite4 and bool(torch.isfinite(got4).all())
    print(f"phase 10: sdf_forward on 2^20 and 4,099 points: max|diff| {errs4[0]:.3e}, "
          f"{errs4[1]:.3e} ({rel4[0]:.2e}, {rel4[1]:.2e} of max|sdf|); zeroing the octave "
          f"columns would move sdf by up to {_octave_effect(surface, x10[:65536])[0]:.3e}")
    if max(rel4) > 1e-5 or not finite4:
        print("FAIL phase 10: sdf_forward disagrees with its plain version", file=sys.stderr)
        return 1
    M4 = x10.shape[0]
    n_params = sum(p.numel() for p in surface.parameters())
    ms4 = _time_ms(lambda: fused_mlp.fused_sdf_forward(surface, x10))
    pms4 = _time_ms(lambda: fused_mlp.sdf_forward_plain(surface, x10))
    flops4 = 2.0 * _surface_macs(surface, sdf_only=True) * M4
    bb4 = _bounds(flops4, 4.0 * (M4 * (3 + 1) + n_params))
    print(f"phase 10: sdf_forward {M4} points: {ms4:.3f} ms (plain {pms4:.3f} ms, "
          f"fp32 bound {bb4[0][0]:.3f} ms, 3xTF32 bound {bb4[1][0]:.3f} ms, "
          f"{flops4 / 1e9:.1f} GFLOP) {tag}")
    # one call at a sphere-tracing step's size (a 4,096-ray chunk) split into
    # the weight packing (a pack made anew, which the wrapper keeps while the
    # weights are unchanged), the kept pack's lookup, the occupancy query
    # (asked once and kept), and the launch with packed weights
    x4k = x10[:4096].contiguous()
    packed = surface_pack.packed_surface(surface)
    query = _build.load("sdf_forward").ntt_sdf_forward_resident
    packs0 = surface_pack.packed_surface.packs
    split4 = {"whole call (host)": _wall_ms(lambda: fused_mlp.fused_sdf_forward(surface, x4k)),
              "pack, made anew (host)": _wall_ms(lambda: surface_pack.pack(surface)),
              "kept pack's lookup (host)": _wall_ms(
                  lambda: surface_pack.packed_surface(surface)),
              "occupancy query (host)": _wall_ms(lambda: query(packed.c_pad, packed.rows)),
              "launch, packed (host)": _wall_ms(
                  lambda: fused_mlp.launch_sdf_forward(surface, x4k, packed)),
              "kernel (device)": _time_ms(
                  lambda: fused_mlp.launch_sdf_forward(surface, x4k, packed), reps=50)}
    repacks = surface_pack.packed_surface.packs - packs0
    print("phase 10: sdf_forward on 4,096 points, median ms per call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split4.items())
          + f"; packs made by the wrapper during the split: {repacks} {tag}")
    if repacks:
        print("FAIL phase 10: a repeated call with unchanged weights packed them again",
              file=sys.stderr)
        return 1

    # ---- phase 11: extract_surface through its main_function, N = 512
    ckpt0 = CheckpointIO(work.name).save("geometric_init.pt", 0,
                                         model=bridge.model_to_tree(model))
    ply512 = os.path.join(work.name, "surface_512.ply")
    eargs = extract_surface.make_parser().parse_args(
        ["--load_pt", ckpt0, "--out", ply512, "--init_r", "0.5"])
    spans4 = []
    zero_counts()
    with _spans(fused_mlp, "fused_sdf_forward", spans4):
        ext = extract_surface.main_function(eargs)
    torch.cuda.synchronize()
    by_path["extract_surface"] = read_counts()
    ms4_grid = sum(a.elapsed_time(b) for a, b in spans4)
    bb4_grid = _bounds(2.0 * _surface_macs(surface, sdf_only=True) * 512 ** 3,
                       4.0 * (512 ** 3 * (3 + 1) + n_params))
    b4_grid = bb4_grid[1][0]
    v512, f512 = mesh_util.read_ply(ply512)
    radii = np.linalg.norm(v512, axis=-1) if len(v512) else np.zeros(1)
    closed = len(f512) > 0 and _closed(torch.as_tensor(f512, device=dev))
    surf0 = model.implicit_surface
    cell = 2.0 / 511
    on_surface = float(surf0.forward_query(torch.as_tensor(v512, device=dev)).abs().max(
    )) if len(v512) else float("inf")
    print(f"phase 11: extract_surface N=512: grid {ext['grid_s']:.3f} s, triangulation "
          f"{ext['triangulate_s']:.3f} s, write {ext['write_s']:.3f} s; launches "
          f"{by_path['extract_surface']}; sdf_forward device time {ms4_grid:.1f} ms over "
          f"{len(spans4)} calls (fp32 bound {bb4_grid[0][0]:.1f} ms, 3xTF32 bound "
          f"{b4_grid:.1f} ms); {len(v512)} verts, "
          f"{len(f512)} faces, closed {closed}; vertex radius mean {radii.mean():.5f} "
          f"std {radii.std():.5f}, min {radii.min():.5f}, max {radii.max():.5f}; max|sdf| at "
          f"the vertices {on_surface:.3e} ({on_surface / cell:.3f} cells) {tag}")
    g_k = mesh_util.query_grid(surf0.forward_query, 256, 2.0, device=dev)
    g_p = mesh_util.query_grid(lambda x: fused_mlp.sdf_forward_plain(surf0, x), 256, 2.0,
                               device=dev)
    rel_g = float((g_k - g_p).abs().max() / g_p.abs().max())
    flips = int((torch.sign(g_k) != torch.sign(g_p)).sum())
    # Chamfer over the two meshes' vertices (world coordinates): sampling
    # each mesh anew would add its own sampling distance
    verts = [(mesh_util.marching_tetrahedra(g)[0] * (2.0 / 255) - 1.0).cpu().numpy()
             for g in (g_k, g_p)]
    cd = chamfer_distance(*verts)[0] if min(map(len, verts)) else float("inf")
    print(f"phase 11: 256^3 grid, kernel vs plain: max|diff| {rel_g:.2e} of max, {flips} "
          f"sign flips (the CUDA-core fp32 kernel 4 read 3); meshes {len(verts[0])} / "
          f"{len(verts[1])} verts, Chamfer {cd:.3e}")
    del g_k, g_p
    if (rel_g > 1e-5 or cd >= 1e-3 * 2.0 or not closed or on_surface > 0.1 * cell
            or by_path["extract_surface"]["sdf_forward"] == 0):
        print("FAIL phase 11: extract_surface's mesh or grid is off", file=sys.stderr)
        return 1

    # ---- phase 12: render_view --use_surface_render, and --render_mesh
    surface_frames = {}
    for algo in ("sphere_tracing", "root_finding"):
        vargs = ConfigDict(FLAGSHIP)
        vargs.update({"load_pt": ckpt0, "num_views": 2, "camera_path": "interpolation",
                      "rayschunk": 4096, "use_surface_render": algo})
        if algo == "sphere_tracing":
            vargs["render_mesh"] = ply512
        spans12 = {"sdf_forward (cast)": [], "nablas_forward (hit point)": []}
        zero_counts()
        with _spans(fused_mlp, "fused_sdf_forward", spans12["sdf_forward (cast)"]), \
                _spans(fused_nablas, "fused_forward_with_nablas",
                       spans12["nablas_forward (hit point)"]):
            fr = surface_frames[algo] = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        counts = by_path[f"surface_render_{algo}"] = read_counts()
        print(f"phase 12: render_view --use_surface_render {algo} 2 x 120x160: launches "
              f"{counts}, s/frame {[round(v, 4) for v in fr['seconds']]}; device ms per "
              "frame " + ", ".join(f"{k} {sum(a.elapsed_time(b) for a, b in v) / 2:.2f}"
                                   for k, v in spans12.items()) + f" {tag}")
        if (counts["sdf_forward"] == 0 or counts["nablas_forward"] == 0
                or fr["rgb"].shape != (2, 120, 160, 3)
                or not all(np.isfinite(fr[k]).all() for k in ("rgb", "depth", "normal"))):
            print(f"FAIL phase 12: the {algo} render missed a kernel or is not finite",
                  file=sys.stderr)
            return 1
    cast = {"near": 0.0, "far": 1.2 * (float(np.linalg.norm(scene["c2w"][0][:3, 3])) + 1.0)}
    for algo in ("sphere_tracing", "root_finding"):
        fn = make_surface_render_fn(checked, algo,
                                    dict(cast, **({"N_steps": 128} if algo == "root_finding"
                                                  else {})))
        out_k = render_full_image(fn, o_all[patch], d_all_dirs[patch], rayschunk=4096)
        with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain), \
                mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                                  fused_nablas.forward_with_nablas_plain):
            out_p = render_full_image(fn, o_all[patch], d_all_dirs[patch], rayschunk=4096)
        mk, mp = out_k["mask_surface"], out_p["mask_surface"]
        both = mk & mp
        e_d, e_c = (float(np.abs(out_k[k][both] - out_p[k][both]).max(initial=0))
                    for k in ("depth_volume", "rgb"))  # misses hold inf
        n_off = int((mk != mp).sum())
        print(f"phase 12: 2048-ray patch {algo}, kernels vs plain: {int(both.sum())} rays hit "
              f"in both, masks differ on {n_off}; max|diff| depth {e_d:.3e}, rgb {e_c:.3e}")
        if n_off > 0.001 * len(mk) or not both.any() or e_d > 2e-3 or e_c > 2e-3:
            print(f"FAIL phase 12: the {algo} patch disagrees with the plain path",
                  file=sys.stderr)
            return 1
    mesh_img = surface_frames["sphere_tracing"]["mesh"]
    covered = float((mesh_img < 0.999).any(-1).mean())
    print(f"phase 12: --render_mesh frames {mesh_img.shape}: mesh covers {100 * covered:.1f}% "
          f"of the pixels")
    if covered < 0.01:
        print("FAIL phase 12: the rasterized mesh frame is blank", file=sys.stderr)
        return 1

    # ---- phase 13: eval_staged on phase 8's checkpoints
    gt = os.path.join(work.name, "gt_sphere.ply")
    make_gt_mesh("sphere", 0.5, 256, 1.5, gt, device="cuda")
    zero_counts()
    rows = evaluate_ckpts(targs, [os.path.join(out["exp_dir"], "ckpts", "00000030.pt"),
                                  out["final_ckpt"]],
                          gt_mesh=gt, n_eval=4, rayschunk=4096, mesh_N=256, device="cuda")
    torch.cuda.synchronize()
    by_path["eval_staged"] = read_counts()
    for r in rows:
        print(f"phase 13: eval_staged {r['ckpt']} (step {r['step']}): psnr {r['psnr']:.4f} "
              f"(min {r['psnr_min']:.4f}, max {r['psnr_max']:.4f}), chamfer {r.get('chamfer')}")
    print(f"phase 13: launches {by_path['eval_staged']}")
    if len(rows) != 2 or not all(np.isfinite(r["psnr"]) and r.get("chamfer") is not None
                                 and np.isfinite(r["chamfer"]) for r in rows):
        print("FAIL phase 13: eval_staged gave no finite PSNR or Chamfer", file=sys.stderr)
        return 1

    rc, vol_rows, _ = _volsdf_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                     work.name)
    if rc:
        return rc

    def per_path(name):
        return {p: c[name] for p, c in by_path.items()}

    results = [
        {"name": "nablas_forward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/nablas_forward.cu",
         "replaces": "neurecon_tpu/ops/fused_nablas.py:74",
         "launches": launches["nablas_forward"], "max_abs_err": max(errs),
         "ms": ms1, "plain_ms": pms1, **_bound_fields(*bb1, "fp32"),
         "library_ms": None},
        {"name": "neus_upsample", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/neus_upsample.cu",
         "replaces": "neurecon_tpu/ops/fused_upsample.py:272",
         "launches": launches["neus_upsample"], "max_abs_err": k2_err["det"],
         "ms": ms2, "plain_ms": pms2, "bound_ms": b2, "bound_by": by2,
         "bound_held_to": "fp32", "library_ms": None},
        {"name": "nablas_backward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/nablas_backward.cu",
         "replaces": "neurecon_tpu/ops/fused_nablas_vjp.py:120",
         "launches": launches["nablas_backward"], "max_abs_err": k3_err,
         "ms": ms3, "plain_ms": pms3, **_bound_fields(*bb3, "3xtf32"),
         "library_ms": None, "ms_197632": ms9, "bound_ms_197632": bb9[1][0]},
        {"name": "sdf_forward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/sdf_forward.cu",
         "replaces": "neurecon_tpu/ops/fused_mlp.py:125",
         "launches": launches["sdf_forward"], "max_abs_err": max(errs4),
         "ms": ms4, "plain_ms": pms4, **_bound_fields(*bb4, "3xtf32"),
         "library_ms": None, "points": M4, "ms_grid512": ms4_grid,
         "bound_ms_grid512": b4_grid, "ms_split_4096": split4},
    ] + vol_rows
    for r in results:
        r["launches_by_path"] = per_path(r["name"])
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

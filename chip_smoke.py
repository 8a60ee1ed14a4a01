#!/usr/bin/env python3
"""The port's smoke run on one CUDA card (an H100):
`python3 chip_smoke.py [--seed N]`.

Phases, in order; any failure exits non-zero:

1. the card (nvidia-smi name and power limit, torch's count); build the
   five CUDA sources from neurecon_tpu_torch/csrc with nvcc (sm_90a), one
   nvcc per source, all at once.
2. kernel 1 (`nablas_forward`) against its plain version on the points of
   one render chunk at the flagship widths (4,096 rays x 255 points along real
   rays) and on 4,099 points of [-1, 1]^3 (a ragged last tile), each output
   filled with NaN beforehand (`nablas_check`): sdf and geometry features
   atol 1e-4, nablas rtol 2e-3 / atol 2e-4.
3. kernel 2 (`neus_upsample`) against its plain version on 4,096 rays, and on
   512 of them (a training step's count, on the kernel's 4-ray blocks) with
   the sphere_residual prior on (`upsample_checks`), det and perturb
   uniforms: |d_all diff| <= 1e-3 (far - near) on >= 99.9% of
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
9. kernel 1's time at 130,560 points and kernel 2's at 512 rays (a step's
   shapes) beside their bounds; kernel 3's time at 130,560 points beside its
   plain version's and its fp32 and 3xTF32 bounds, its workspace bytes, its four CUDA kernels' device
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
   plain stage's inputs, in lockstep (kernel (b) on every round's bounds,
   kernel (c)'s draw of the next round against `draw_plain` on the plain
   stage's bounds): merged depths equal, merged sdf within 1e-5, every
   state, bounds and depth share off at most 1% (a NaN counts as off), the
   det draws sorted. Then the edges the rays seldom reach
   (`_sampler_edges`): a merge at exact old / new ties with another sdf
   there (sdf within 1e-5 of the stable sort's), det draws at exact cdf ties
   (bit-equal to `draw_plain`) and in flat cdf segments (at most 1% beyond
   1e-4 of the span).
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
   and bounds (bytes, fp32 operations and the special-function unit's
   ex2 / rcp, at the card's highest SM clock); one VolSDF step split into
   the sampler (kernel 4, (a)-(c), its glue), kernel 1, kernel 3, the
   radiance forward, Adam and the rest; the device's busy share; one VolSDF
   frame split the same way.

18. the sine branch of kernels 4, 1, 3 and 2 against their plain versions
   (`sine_kernel_checks`), on configs/volsdf_siren.yaml's surface (D=5,
   W=256 sine layers, no skips, no encoding; `VOLSDF_SIREN`, held equal to
   the file by tests/test_torch_siren_train.py) pretrained to the sphere for
   1,000 iterations, then seeded noise on every weight: kernel 4 on 2^20
   points in [-3, 3]^3 and 4,099 more, kernel 1 and kernel 3 on a SIREN
   step's 197,632 points, kernel 2 on 4,096 rays of the SIREN scene, det and
   perturb; the gates of phases 10, 2, 6 and 3.
19. `pretrain_siren_sdf` on the card at the JAX package's defaults (5,000
   iterations x 5,000 points, lr_pretrain): the final L1 below 0.08 (the
   JAX package's own test bound), and its seconds.
20. the SIREN step's gradient through the kernels against the plain versions
   (loss rel 1e-5, every leaf within 5e-4 max|ref|); kernels (a)-(c) on the
   SIREN surface against the plain sampler at beta_net 0.1 and 0.01, det and
   perturb, end to end and in lockstep (phase 14's gates); `train.py` at
   configs/volsdf_siren.yaml's widths on 8 synthetic images (scaled as
   configs/synthetic_quality_siren.yaml scales them), 1,024 rays, 40 steps
   (cut from 150,000) with the sphere pretrain first: kernels 1, 3, 4 and
   (a)-(c) launched every step, every loss finite, the last 10 steps' mean
   below the first 10's; the surface's sdf range and mesh faces on a 128^3
   grid after the pretrain, at step 20 and at step 40 (printed); two 120x160
   frames of the final checkpoint through `render_view` (exact launch
   counts, finite) and a 2,048-ray patch against the plain render (rgb atol
   2e-3); a 256^3 `extract_surface --use_siren` of the pretrained surface,
   non-empty and closed.
21. times of each sine kernel and its plain version beside the fp32 and
   3xTF32 bounds; ms per SIREN step and rays/s (median over steps 6-40); s
   per SIREN frame; one SIREN step and one frame split as phase 17 splits
   them.

22. the file loaders: the synthetic sphere scene written in the DTU layout
   (8 views at DTU's 1200x1600, cameras.npz with a scale_mat of a scale and a
   shift), the BlendedMVS and the custom layouts (8 views at 300x400; the
   BlendedMVS images as PNG, where real scans ship JPEG, which needs
   imageio), its PNGs by `write_png`, which cycles the five row filters over the rows so
   that the reader's every filter runs; each loaded through `get_data` at
   downscale 1 and at configs/unisurf.yaml's val_downscale 8: every rgb
   within 1/255 of the analytic render resized by the area rule written
   apart from the loader's `area_resize` (`_area_mean`), masks equal (the
   same mean > 127.5), intrinsics within 1e-5 of max|K| and poses within 1e-5 of the
   scene's own (after scale_mat); seconds a load.
23. `train.py` on configs/unisurf.yaml (`UNISURF`, held equal to the file
   by tests/test_torch_unisurf.py) read from the DTU scene, with the cuts it
   prints (data_dir, 40 steps of 450,000, i_val and i_val_mesh 20, mesh_N
   128, the run's directories and logging): the launches exact (9 of kernel
   4 and one each of kernels 1 and 3 a step, the two validations' chunks,
   the step-20 mesh's 8 kernel-4 launches), every loss finite, the last 10
   steps' mean below the first 10's, the logged interval within 1e-6 of
   `interval_at`; median ms per step over steps 6-40 and rays/s. Then the
   same 40 steps again with kernels 4, 1 and 3 replaced by their plain
   versions (same init, batches and draws; no kernel launched): every
   step's loss within rel 1e-3 of the kernel run's, the min and max logit
   on a 128^3 grid at steps 20 and 40 within 1e-2 of the plain range, and
   a zero set at the same checkpoints in both runs.
24. on two sets of weights, the geometric init with seeded noise (every
   weight seen) and phase 23's step-20 checkpoint (trained, with a
   surface), 1,024 rays of the DTU scene: the root find through kernel 4
   against the plain query (hit masks agree on >= 99.9% of the rays, depth
   within 1e-4 of the span where both hit); the step's gradient with the
   plain root find's output as surface_override and the same uniforms,
   through kernels 1 and 3 against their plain versions (loss rel 1e-5,
   every leaf within 5e-4 max|ref|); the final weights' hits (printed).
25. two 120x160 frames of the final checkpoint through `render_view` (DTU
   scene at --downscale 10, volume mode, the checkpoint's interval): exact
   launches (kernel 4 9 and kernel 1 one a chunk, no kernel 3), finite; on
   each of phase 24's two sets of weights a 2,048-ray patch against the
   plain render (some rays hit, surface masks agree on >= 99.9%, rgb within
   2e-3 where they agree); `extract_surface` of the step-20 checkpoint (the
   final one has no zero set) at 256^3 over volume 3.0, non-empty and
   closed, and the final weights' logit range on a 128^3 grid (printed).
26. kernels 4 (the 262,144 points of a step's march), 1 and 3 (a step's
   100,352 points) beside their plain versions and bounds; ms per step,
   rays/s, s per frame, the DTU load's seconds; one step split into the
   root find (kernel 4 and its glue), kernel 1, kernel 3, the radiance
   forward, Adam and the rest, the device's busy share; one frame split the
   same way.

Every path above is driven with the kernels' launch counters set to 0 just
before it and read just after. Prints one JSON line of per-kernel results
(`launches` from each slice's training run: phase 8 for kernels 1-4, phase
16 for (a)-(c), phase 20 for the sine branch, whose rows are named
`<kernel>[sine]`; `launches_by_path` for each path, `unisurf_train` and
`unisurf_render` among them; the surface-MLP rows held to their 3xTF32
bounds, `bound_held_to`; kernel 1's `ms_130560` and kernel 2's `ms_512_rays`
at a training step's shapes; kernels 4, 1 and 3's `ms_unisurf` at UNISURF's),
then, as the last line, {"ok": true, "device": {...}}. Needs the repository
checkout beside it; it imports no JAX.
"""
import argparse
import contextlib
import copy
import functools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import zlib
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


def _upsample_check(surface, rays_o, rays_d, near, far, d_coarse, uniforms, label,
                    report=print):
    """Kernel 2 against its plain version on the rays given, for each mode's
    uniforms ({"det": u, "perturb": u}, 4 rounds of 16): |d_all diff| <=
    1e-3 (far - near) on >= 99.9% of the entries, every sample inside [near,
    far], finite. Reports a line per mode; returns (ok, {mode: max|diff|})."""
    from neurecon_tpu_torch.ops import fused_upsample

    ok, errs = True, {}
    span = far - near
    for mode, u in uniforms.items():
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
        errs[mode] = float(diff.max())
        report(f"{label}: neus_upsample {mode}: max|diff| {float(diff.max()):.3e}, "
              f"p99.9 {p999:.3e}, share beyond 1e-3(far-near) {frac:.5f}, "
              f"{int(exempt.sum())} u=1.0 tie entries exempt on "
              f"{int(exempt.any(1).sum())} rays, share of the rest {frac_rest:.5f}")
        if frac_rest > 1e-3 or not inside or not torch.isfinite(got).all():
            ok = False
    return ok, errs


def render_chunk_inputs(seed, dev):
    """Phases 2-7's inputs: the flagship NeuS from the port's geometric init
    (`seed`), its copy with seeded noise on every weight (`checked`, seed +
    1: the geometric init zeroes the octave columns), and one render chunk
    of the synthetic scene: 4,096 rays spread over a 120x160 frame (every
    ~4.7th pixel), their 64 coarse depths and the det and perturb uniforms
    of 4 rounds of 16."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, _uniforms
    from neurecon_tpu_torch.ops import get_rays

    model, _, kw_test, _ = get_model(ConfigDict(FLAGSHIP), dev, seed=seed)
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    scene = make_synthetic_scene(n_images=1, H=120, W=160)
    o_all, d_all_dirs, _ = get_rays(torch.tensor(scene["c2w"][0], device=dev),
                                    torch.tensor(scene["intrinsics"][0], device=dev),
                                    120, 160)
    idx = torch.linspace(0, 120 * 160 - 1, 4096, device=dev).long()
    rays_o, rays_d, near, far = _prepare_rays(o_all[idx], d_all_dirs[idx], 1.0)
    t = torch.linspace(0, 1, 64, device=dev)
    return {"model": model, "checked": checked, "kw_test": kw_test, "scene": scene, "o_all": o_all,
            "d_all_dirs": d_all_dirs, "rays_o": rays_o, "rays_d": rays_d, "near": near,
            "far": far, "t": t, "d_coarse": (near * (1 - t) + far * t).contiguous(),
            "u_det": _uniforms(4096, 4, 16, False, None, dev),
            "u_pert": _uniforms(4096, 4, 16, True, torch.Generator(dev).manual_seed(seed),
                                dev)}


def kernel1_points(surface, c):
    """Kernel 1's points in one render chunk (`render_chunk_inputs`): each
    ray's 128 depths from the plain upsampler and the 127 mids between
    them, 1,044,480 points."""
    from neurecon_tpu_torch.ops import fused_upsample

    d_sec = fused_upsample.neus_upsample_plain(surface, c["rays_o"], c["rays_d"],
                                               c["d_coarse"], c["u_det"], n_iters=4,
                                               n_per_iter=16)
    d_mid = 0.5 * (d_sec[:, 1:] + d_sec[:, :-1])
    o, d = c["rays_o"][:, None], c["rays_d"][:, None]
    pts = torch.cat([o + d * d_sec[..., None], o + d * d_mid[..., None]], 1)
    return pts.reshape(-1, 3).contiguous()


def nablas_check(surface, x, label, report=print):
    """Phase 2: kernel 1 against its plain version on x and on 4,099 points
    uniform in [-1, 1]^3 (a ragged last tile); before each call, NaN fills
    blocks of the outputs' sizes, which the outputs are likely to be given,
    so an unwritten entry cannot pass for a right one. sdf and h within
    1e-4, nablas within 2e-4 + 2e-3 |ref|, all finite. Returns (ok,
    [max|diff| of sdf, nablas, h] over both)."""
    from neurecon_tpu_torch.ops import fused_nablas

    g = torch.Generator(x.device).manual_seed(11)
    ragged = torch.rand(4099, 3, device=x.device, generator=g) * 2 - 1
    ok, errs = True, [0.0, 0.0, 0.0]
    for pts in (x, ragged):
        M = pts.shape[0]
        nan = [torch.full(shape, float("nan"), device=x.device)
               for shape in ((M,), (M, 3), (M, surface.W_geo_feat))]
        del nan
        got = fused_nablas.fused_forward_with_nablas(surface, pts)
        with torch.no_grad():
            ref = fused_nablas.forward_with_nablas_plain(surface, pts)
        torch.cuda.synchronize()
        e = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        nab_ok = bool(((got[1] - ref[1]).abs() <= 2e-4 + 2e-3 * ref[1].abs()).all())
        report(f"{label}: nablas_forward on {M} points: max|diff| sdf {e[0]:.3e}, "
               f"nablas {e[1]:.3e}, h {e[2]:.3e}")
        ok = ok and (e[0] <= 1e-4 and e[2] <= 1e-4 and nab_ok
                     and all(bool(torch.isfinite(t).all()) for t in got))
        errs = [max(a, b) if b == b else float("nan") for a, b in zip(errs, e)]
        del got, ref
    return ok, errs


def upsample_checks(surface, c, label, report=print):
    """Phase 3: `_upsample_check` on the chunk's 4,096 rays, then on 512 of
    them (every 8th: a training step's count, which the kernel takes in
    blocks of 4 rays, where 4,096 rays go 8 to a block) with the
    sphere_residual prior switched on. Returns (ok, {mode: max|diff|} of the
    4,096 rays)."""
    ok, errs = _upsample_check(surface, c["rays_o"], c["rays_d"], c["near"], c["far"],
                               c["d_coarse"], {"det": c["u_det"], "perturb": c["u_pert"]},
                               label, report)
    prior = copy.deepcopy(surface)
    prior.sphere_residual = True
    every = slice(None, None, 8)
    ok512, _ = _upsample_check(
        prior, c["rays_o"][every].contiguous(), c["rays_d"][every].contiguous(),
        c["near"][every], c["far"][every], c["d_coarse"][every].contiguous(),
        {"det": c["u_det"][:512], "perturb": c["u_pert"][:512]},
        f"{label} (512 rays, sphere prior)", report)
    return ok and ok512, errs


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


def _train_timed(targs, zero_counts, read_counts):
    """train.py's `main_function` on `targs` on the card, with a CUDA event
    recorded at the start of every step, the kernels' launch counters set to
    0 just before and read just after. Returns (its result, the launch
    counts, each step's ms up to the next step's start or the run's end, the
    run's wall seconds)."""
    from neurecon_tpu_torch import train

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
    t0 = time.perf_counter()
    with mock.patch.object(train, "make_train_step", make_step_timed):
        out = train.main_function(targs, device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    evs = starts + [end]
    return out, launches, [evs[i].elapsed_time(evs[i + 1]) for i in range(len(starts))], secs


def _plain1(surface, x, weights=None, packed=None):
    """Kernel 1's plain version in its wrapper's place (the pack unread)."""
    from neurecon_tpu_torch.ops import fused_nablas
    return fused_nablas.forward_with_nablas_plain(surface, x, weights)


def _plain3(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h, packed=None):
    """Kernel 3's plain version in its wrapper's place (the pack unread)."""
    from neurecon_tpu_torch.ops import fused_nablas_vjp
    return fused_nablas_vjp.nablas_vjp_plain(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h)


def _step_grad_check(model, ray_loss, *args, **kwargs):
    """`ray_loss(*args, **kwargs)` and every parameter's gradient through the
    kernels and through the plain versions of kernels 1 and 3 (called by
    name): returns (loss through the kernels, plain loss, {parameter:
    max|diff| / max|ref|})."""
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp

    def step_grads():
        model.zero_grad(set_to_none=True)
        total, _ = ray_loss(*args, **kwargs)
        total.backward()
        return total.item(), [p.grad.clone() for p in model.parameters()]

    loss_k, grads_k = step_grads()
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas", _plain1), \
            mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp", _plain3):
        loss_p, grads_p = step_grads()
    model.zero_grad(set_to_none=True)
    names = [n for n, _ in model.named_parameters()]
    return loss_k, loss_p, {n: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                            for n, a, b in zip(names, grads_k, grads_p)}


def _step_split(args, dev, parts, n_warm=3, tree=None):
    """One training step split by CUDA events around each call of the
    `parts` ({name: (module or class, attribute)}; "adam_step" is the
    optimizer's step), then the device's busy share over three more steps;
    the model from seed 0, or with the weights of `tree` (a JAX pytree of
    numpy arrays); returns (step ms, {part: ms}, busy share)."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_model, make_trainer
    from neurecon_tpu_torch.training import make_train_step

    ds = get_data(args)
    model, kw, _, _ = get_model(args, dev, seed=0)
    if tree is not None:
        bridge.load_tree(model, tree)
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
    state as its input. Kernel (b) runs on every round's plain bounds (the
    sampler launches it for round 1 only); kernel (c)'s det draw of the next
    round is held to `draw_plain` on the plain stage's merged depths and
    bounds. Returns {kernel: {output: worst error}} over the call (fine
    depths and new depths as max|diff|, new depths and kernel (a)'s fine
    depths also as the share beyond 1e-4 of the span, bounds as the share of
    entries and the share of rays with an entry beyond rtol 1e-3 / atol
    1e-6, beta as the share of rays beyond rtol 1e-3 / atol 1e-5, the state
    flags as the share of rays that differ; the workspace starts as NaN, and
    a NaN counts as off), and whether kernel (a)'s round-0 depths and (c)'s
    merged depths equal the plain ones."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.fused_mlp import sdf_forward_plain

    N, n0 = d_init.shape
    kw = {"n_final": n_final, "u_stride": u.shape[1], "eps": eps, "prior_r": -1.0,
          "bg_r": bg_r}
    if surface.sphere_residual:
        kw["prior_r"] = float(surface.radius_init)
    ws = ffs.workspace(N, n0 + max_iter * n_up, n_final, d_init.device)
    for t in ws.values():  # an entry a kernel leaves unwritten cannot pass
        if torch.is_tensor(t) and t.is_floating_point():
            t.fill_(math.nan)
    err = {k: {} for k in ("volsdf_init", "volsdf_draw", "volsdf_checkpoint")}

    def worst(name, key, v):
        v = float(v)
        err[name][key] = max(err[name].get(key, 0.0), v if v == v else math.inf)

    def share_off(a, b, rtol, atol):
        return (~((a - b).abs() <= atol + rtol * b.abs())).float().mean()

    def compare(name, state, bounds_n):
        worst(name, "fine", (ws["fine"] - state["fine"]).abs().max())
        worst(name, "beta_share", share_off(ws["beta"], state["beta"][:, 0], 1e-3, 1e-5))
        worst(name, "converged_share",
              (ws["converged"].bool() != state["converged"]).float().mean())
        worst(name, "iter_usage_share", (ws["iter_usage"] != state["iter_usage"]).float().mean())
        if bounds_n:
            want = state["bounds"]
            off = ~((ws["bounds"][:, :bounds_n] - want).abs() <= 1e-6 + 1e-3 * want.abs())
            worst(name, "bounds_share", off.float().mean())
            worst(name, "bounds_rays_share", off.any(1).float().mean())

    def draws(name, key, got, want):
        worst(name, key, (got - want).abs().max())
        worst(name, f"{key}_share", share_off(got, want, 0.0, 1e-4 * far))
        worst(name, "unsorted_rays", (~(got[:, 1:] >= got[:, :-1])).any(1).float().mean())

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
    worst("volsdf_init", "fine_share", share_off(ws["fine"], state["fine"], 0.0, 1e-4 * far))
    compare("volsdf_init", state, n0 - 1)
    d, buffers_equal = d_init, torch.equal(ws["d"][0][:, :n0], d_init)
    up = ffs.draw_plain(d, state["bounds"], n_up)
    for it in range(1, max_iter + 1):
        s_in, last = d.shape[1], it == max_iter
        ws["d"][0][:, :s_in] = d
        ws["s"][0][:, :s_in] = sdf
        ws["bounds"][:, :s_in - 1] = state["bounds"]
        nd, _ = ffs.launch_draw(ws, rays_o, rays_d, 0, s_in, n_up)
        draws("volsdf_draw", "depths", nd, up)
        raw_new, sdf_new = query_raw(up)
        ws["beta"].copy_(state["beta"][:, 0])
        ws["converged"].copy_(state["converged"].int())
        ws["iter_usage"].copy_(state["iter_usage"])
        ws["fine"].copy_(state["fine"])
        nd_next, _ = ffs.launch_checkpoint(ws, rays_o, rays_d, 0, s_in, up, raw_new,
                                           torch.stack(ab), u, it=it, max_iter=max_iter,
                                           max_bisection=max_bisection, **kw)
        d, sdf = ffs.checkpoint_plain(
            d, sdf, up, sdf_new, state, ab[0], ab[1], u[:, it * n_final:(it + 1) * n_final],
            u[:, (max_iter + 1) * n_final:], it=it, last=last, eps=eps,
            max_bisection=max_bisection)
        P = d.shape[1]
        compare("volsdf_checkpoint", state, 0)
        if not last:
            buffers_equal &= bool(torch.equal(ws["d"][1][:, :P], d))
            worst("volsdf_checkpoint", "sdf", (ws["s"][1][:, :P] - sdf).abs().max())
            up = ffs.draw_plain(d, state["bounds"], n_up)
            draws("volsdf_checkpoint", "next_depths", nd_next, up)
    worst("volsdf_checkpoint", "beta_out_share", share_off(ws["beta_out"], state["beta_out"],
                                                           1e-3, 1e-5))
    torch.cuda.synchronize()
    return err, buffers_equal


MUFU_PER_SM_CLOCK = 16  # ex2, rcp, rsqrt a clock per SM, cc 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table)
SMS = 132  # H100 SXM


def _sm_clock_hz():
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60)
    return 1e6 * float(out.stdout.strip().splitlines()[0])


def _sampler_edges(surface, rays_o, rays_d, d_init, far, ab, u, *, n_final, bg_r=3.0,
                   eps=0.1):
    """Kernels (b) and (c) where the rays' own data seldom go:

      * the merge's tie order: new depths equal to every other old depth,
        their sdf 0.25 above the old one's (round 1 of a 2-round call); the
        merged depths and sdf against `checkpoint_plain`'s stable sort;
      * det draws at exact cdf ties: all bounds 1e5 on 512 intervals, 511
        draws, so that every u_j = (j + 1) / 512 equals a cdf entry (every
        sum is exact); against `draw_plain`, bit for bit;
      * det draws in flat cdf segments: zero bounds beside one of 1.0
        (3,583 intervals, 512 draws), so that ~3% of the draws fall in
        intervals whose cdf step is below 1e-5 (the denominator rule);
        against `draw_plain`, the share beyond 1e-4 of the span.

    Returns {check: error}: the merge's sdf max|diff| (the depths must be
    equal: inf otherwise), the ties' max|diff|, the flat segments' share."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.fused_mlp import sdf_forward_plain

    N, n0 = d_init.shape
    dev = d_init.device
    kw = {"n_final": n_final, "u_stride": u.shape[1], "eps": eps, "bg_r": bg_r,
          "prior_r": float(surface.radius_init) if surface.sphere_residual else -1.0}
    out = {}

    pts0 = rays_o[:, None, :] + rays_d[:, None, :] * d_init[..., None]
    sdf0 = ffs.background_min(surface.forward(pts0), pts0, bg_r)
    state = ffs.init_plain(d_init, sdf0, far, ab[0], ab[1], u[:, :n_final], eps=eps)
    up = d_init[:, ::2].contiguous()
    pts = rays_o[:, None, :] + rays_d[:, None, :] * up[..., None]
    raw = (sdf_forward_plain(surface, pts.reshape(-1, 3)) + 0.25).contiguous()
    ws = ffs.workspace(N, n0 + 2 * up.shape[1], n_final, dev)
    ws["d"][0][:, :n0] = d_init
    ws["s"][0][:, :n0] = sdf0
    ws["beta"].copy_(state["beta"][:, 0])
    ws["converged"].copy_(state["converged"].int())
    ws["iter_usage"].copy_(state["iter_usage"])
    ws["fine"].copy_(state["fine"])
    ffs.launch_checkpoint(ws, rays_o, rays_d, 0, n0, up, raw, torch.stack(ab), u, it=1,
                          max_iter=2, max_bisection=10, **kw)
    d, sdf = ffs.checkpoint_plain(
        d_init, sdf0, up, ffs.background_min(surface.forward(pts) + 0.25, pts, bg_r), state,
        ab[0], ab[1], u[:, n_final:2 * n_final], u[:, 3 * n_final:], it=1, last=False, eps=eps,
        max_bisection=10)
    P = d.shape[1]
    same = torch.equal(ws["d"][1][:, :P], d)
    e = float((ws["s"][1][:, :P] - sdf).abs().max())
    out["merge_ties_sdf"] = e if same and e == e else math.inf

    def draw(s_in, n_up, bounds):
        wsd = ffs.workspace(N, s_in, n_final, dev)
        wsd["d"][0].copy_((far * torch.linspace(0, 1, s_in, device=dev)).contiguous())
        wsd["bounds"][:, :s_in - 1] = bounds
        nd, _ = ffs.launch_draw(wsd, rays_o, rays_d, 0, s_in, n_up)
        return nd, ffs.draw_plain(wsd["d"][0], bounds, n_up)

    nd, want = draw(513, 511, torch.full((N, 512), 1e5, device=dev))
    e = float((nd - want).abs().max())
    out["draw_ties"] = e if e == e else math.inf
    bounds = torch.zeros(N, 3583, device=dev)
    bounds[torch.arange(N, device=dev), torch.arange(N, device=dev) * 7 % 3583] = 1.0
    nd, want = draw(3584, 512, bounds)
    out["draw_flat_share"] = float((~((nd - want).abs() <= 1e-4 * far)).float().mean())
    torch.cuda.synchronize()
    return out


def _sampler_bounds(N, n0, n_up, max_iter, n_final, iter_usage, sm_clock_hz):
    """The least time of kernels (a), (b) and (c) over one sampler call, in
    ms, from the bytes each must move, the fp32 operations and the
    special-function (MUFU) operations this call's data needs:

      * an error-bound sweep, per interval: ~30 fp32 operations; four expf
        (ex2) and two IEEE divisions (rcp), 6 MUFU;
      * an opacity sweep (a draw's cdf), per interval: ~12 fp32, 3 MUFU;
        kernel (a) takes its cdf from the net sweep's exp(-R) instead, one
        fp32 operation an interval;
      * a det draw: per interval ~6 fp32 and a division, per draw a search
        (log2 of the entries, ~10 fp32) and a division; an opacity draw the
        same per draw; a new sample's sdf ~12 fp32 and one sqrt;
      * a round of (c): the net-beta check, 10 bisection steps on each ray
        not yet converged, the new bounds and the next round's det draw (not
        on the last round), a draw for each ray that converges (or, on the
        last round, that never did).

    Kernel (b) draws round 1; kernel (c) of rounds 1..max_iter-1 draws the
    next round. Returns {kernel: (ms, "bytes" or "operations", the resource
    that binds: "bytes", "fp32" or "sfu", ms without the MUFU count)}."""
    iu = iter_usage.long()
    mufu_rate = MUFU_PER_SM_CLOCK * SMS * sm_clock_hz

    def bound(fp32, mufu, nbytes):
        t = {"bytes": nbytes / HBM_RATE, "fp32": fp32 / FP32_PEAK, "sfu": mufu / mufu_rate}
        held = max(t, key=t.get)
        old = max(t["bytes"], t["fp32"])
        return (1e3 * t[held], "bytes" if held == "bytes" else "operations", held, 1e3 * old)

    def det_draw(s, n):  # fp32, MUFU of one ray's det draw of n from s entries
        return (s - 1) * 6 + n * (math.log2(s) + 10), (s - 1) + n

    search = math.log2(n0) + 10
    out = {"volsdf_init": bound(
        N * ((n0 - 1) * (2 * 30 + 1) + n_final * search + n0 * 12),
        N * ((n0 - 1) * 2 * 6 + n_final + n0),
        4.0 * N * (2 * n0 + n_final + 7 + 3 * n0 + n_final + 3))}
    f, m = det_draw(n0, n_up)
    out["volsdf_draw"] = bound(N * f, N * m, 4.0 * N * (2 * n0 + 6 + 4 * n_up))
    fp32 = mufu = nbytes = 0.0
    for it in range(1, max_iter + 1):
        s_in, P, last = n0 + (it - 1) * n_up, n0 + it * n_up, it == max_iter
        bisect = int(((iu == -1) | (iu > it)).sum())
        draws = int((iu == it).sum()) + (int((iu == -1).sum()) if last else 0)
        sweeps = N * (1 + (0 if last else 1)) + bisect * 10
        fp32 += ((P - 1) * (sweeps * 30 + draws * 12) + draws * n_final * (math.log2(P) + 10)
                 + N * n_up * 12)
        mufu += (P - 1) * (sweeps * 6 + draws * 3) + draws * n_final + N * n_up
        nbytes += 4.0 * (N * (2 * s_in + 2 * n_up + 6 + 3 + 3 + (0 if last else 2 * P + 4 * n_up))
                         + draws * 2 * n_final + (N if last else 0))
        if not last:
            f, m = det_draw(P, n_up)
            fp32 += N * f
            mufu += N * m
    out["volsdf_checkpoint"] = bound(fp32, mufu, nbytes)
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

# configs/volsdf_siren.yaml's model and training sections (held equal to the
# file by tests/test_torch_siren_train.py): VolSDF with D=5, W=256 sine nets
# (no skips, no encoding), the sphere pretrain at lr_pretrain, on the
# synthetic scene scaled as configs/synthetic_quality_siren.yaml scales it.
VOLSDF_SIREN = {
    "expname": "chip_smoke_volsdf_siren", "device_ids": -1,
    "data": {"type": "synthetic", "downscale": 1, "n_images": 8, "H": 120, "W": 160,
             "scale_radius": 2.6, "near": 0.0, "far": 6.0, "N_rays": 1024,
             "val_downscale": 8, "val_rayschunk": 256, "volume_size": 3.0},
    "model": {"W_geometry_feature": 256, "framework": "VolSDF", "max_upsample_iter": 5,
              "obj_bounding_radius": 3.0, "outside_scene": "builtin",
              "radiance": {"D": 5, "embed_multires": -1, "embed_multires_view": 4,
                           "skips": [], "use_siren": True},
              "surface": {"D": 5, "embed_multires": -1, "radius_init": 1.0, "skips": [],
                          "use_siren": True}},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0001, "lr_pretrain": 0.00015,
                 "monitoring": "tensorboard", "num_iters": 150000,
                 "scheduler": {"gamma": 0.5, "milestones": [40000, 80000, 120000],
                               "type": "multistep"},
                 "w_eikonal": 0.1},
}
SIREN_STEPS = 40  # phase 20's cut of configs/volsdf_siren.yaml's 150,000 steps
SINE_POINTS = 2 ** 20  # phase 18's kernel-4 points
SINE_RAYS = 4096  # phase 18's kernel-2 rays (a render chunk)


def volsdf_check_inputs(seed, dev):
    """Phase 14's inputs: the VOLSDF model from the seed, a copy with seeded
    noise on every weight (seed + 1), the synthetic scene, its first view's
    rays, and 1,024 of them spread over the view with their far bounds.
    Returns (args, model, checked copy, (kw_train, kw_test), dataset,
    (o_all, d_all), (rays_o, rays_d, far))."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, volsdf
    from neurecon_tpu_torch.ops import get_rays

    args = ConfigDict(copy.deepcopy(VOLSDF))
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    ds = get_data(args)
    o_all, d_all, _ = get_rays(torch.tensor(ds.c2w_all[0], device=dev),
                               torch.tensor(ds.intrinsics_all[0], device=dev), 120, 160)
    idx = torch.linspace(0, 120 * 160 - 1, 1024, device=dev).long()
    rays_o, rays_d, _, far = volsdf._ray_bounds(o_all[idx], d_all[idx], 0.0, 6.0)
    return args, model, checked, (kw_train, kw_test), ds, (o_all, d_all), (rays_o, rays_d, far)


def _volsdf_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 14-17 (the VolSDF slice); returns (rc, kernel rows, train launches)."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, volsdf
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp
    from neurecon_tpu_torch.ops.sampling import linspace01
    from neurecon_tpu_torch.tools import render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO, load_checkpoint

    args, model, checked, (kw_train, kw_test), ds, (o_all, d_all), (rays_o, rays_d, far) = (
        volsdf_check_inputs(seed, dev))
    surface = checked.implicit_surface
    N, n0, n_up, max_iter, n_final = 1024, 512, 512, 6, 64
    d_init = (far * linspace01(n0, dev)).contiguous()
    kw = {"eps": 0.1, "max_iter": max_iter, "max_bisection": 10, "n_final": n_final,
          "n_up": n_up, "sphere_bg_r": 3.0}

    # ---- phase 14: kernels (a)-(c) against the plain sampler: the init's
    # beta; a sharper one (rays converge in round 2); one so sharp that no
    # ray converges (six rounds of bisection, then the fallback draw)
    ok, k_err, (last_ab, last_u) = _sampler_check(
        surface, rays_o, rays_d, far, (0.1, 0.01, 0.001), n0, n_up, max_iter, seed,
        "phase 14 (flagship rays)")
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
    # 5 chunks of 4,096 rays per frame: per chunk one sampler call (1 + 1 + 6
    # launches of (a)-(c), 7 of kernel 4) and one forward+nablas query
    want = {"nablas_forward": 10, "neus_upsample": 0, "nablas_backward": 0,
            "sdf_forward": 70, "volsdf_init": 10, "volsdf_draw": 10, "volsdf_checkpoint": 60}
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

    loss_k, loss_p, ratios = _step_grad_check(checked, ray_loss, rb, fine_override=fine,
                                              eik_pts=eik)
    worst = max(ratios, key=ratios.get)
    print(f"phase 16: VolSDF step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad "
          f"leaf {worst} {ratios[worst]:.2e} over {len(ratios)} leaves (ln_beta "
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
    out, t_launches, step_ms, _ = _train_timed(targs, zero_counts, read_counts)
    by_path["volsdf_train"] = t_launches
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
            t_launches["volsdf_init"], t_launches["volsdf_draw"]) < S
            or t_launches["volsdf_checkpoint"] < 6 * S
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

    def per_call(fn, targets, reps=5, fold=None):
        """Median over `reps` calls of each target's ms summed over a call
        (`fold` maps the per-call span lists to ms instead)."""
        fn()
        runs = []
        for _ in range(reps):
            spans = {k: [] for k in targets}
            with contextlib.ExitStack() as stack:
                for k, (mod, attr) in targets.items():
                    stack.enter_context(_spans(mod, attr, spans[k]))
                res = fn()
            torch.cuda.synchronize()
            ms = {k: [a.elapsed_time(b) for a, b in v] for k, v in spans.items()}
            runs.append(fold(ms) if fold else {k: sum(v) for k, v in ms.items()})
        return res, {k: float(np.median([r[k] for r in runs])) for k in runs[0]}

    def plain_fold(ms):
        """The plain stages as the kernels split them: round 1's det draw
        is (b)'s, the later ones are (c)'s tail."""
        return {"volsdf_init": sum(ms["volsdf_init"]), "volsdf_draw": ms["volsdf_draw"][0],
                "volsdf_checkpoint": sum(ms["volsdf_checkpoint"]) + sum(ms["volsdf_draw"][1:])}

    res, k_ms = per_call(lambda: ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far,
                                                       *last_ab, last_u, **kw), parts)
    _, p_ms = per_call(lambda: ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far,
                                                     *last_ab, last_u, **kw), plain_parts,
                       reps=3, fold=plain_fold)
    whole = _time_ms(lambda: ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far,
                                                   *last_ab, last_u, **kw), reps=5)
    whole_p = _time_ms(lambda: ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far,
                                                     *last_ab, last_u, **kw), reps=3)
    bounds = _sampler_bounds(N, n0, n_up, max_iter, n_final, res[2], _sm_clock_hz())
    mlp_flops = 2.0 * _surface_macs(surface, sdf_only=True) * N * (n0 + max_iter * n_up)
    ws_bytes = sum(t.nbytes for t in ffs.workspace(N, n0 + max_iter * n_up, n_final,
                                                   dev).values() if torch.is_tensor(t))
    print(f"phase 17: one sampler call, 1,024 flagship rays (beta_net {float(last_ab[1]):g}, "
          f"perturb): "
          f"{whole:.3f} ms (plain {whole_p:.3f} ms); per kernel, summed over the call "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in k_ms.items())
          + "; plain stages " + ", ".join(f"{k} {v:.3f} ms" for k, v in p_ms.items())
          + "; bounds " + ", ".join(f"{k} {v[0]:.4f} ms ({v[2]}; {v[3]:.4f} ms without the "
                                    f"MUFU count)" for k, v in bounds.items())
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
                     "bound_by": bounds[name][1], "bound_held_to": bounds[name][2],
                     "bound_ms_without_sfu": bounds[name][3], "library_ms": None,
                     "per": "one sampler call of 1,024 flagship rays"})
    return 0, rows, t_launches


def _siren_models(seed, dev, pretrain_iters=1000):
    """The VOLSDF_SIREN model from the seed (SIREN init), and the checked
    copy: its surface pretrained to the sphere (`pretrain_iters` iterations
    at the config's lr_pretrain, seed + 7), then seeded noise on every weight
    (seed + 1), the stand-in for trained SIREN weights."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import perturb_parameters, pretrain_siren_sdf
    from neurecon_tpu_torch.models.frameworks import get_model

    args = ConfigDict(copy.deepcopy(VOLSDF_SIREN))
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    checked = copy.deepcopy(model)
    s = checked.implicit_surface
    pretrain_siren_sdf(s, num_iters=pretrain_iters, lr=float(args.training.lr_pretrain),
                       target_radius=s.radius_init, obj_bounding_size=s.obj_bounding_size,
                       generator=torch.Generator(dev).manual_seed(seed + 7))
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    return args, model, checked, kw_train, kw_test


def sine_kernel_checks(seed, dev, report=print):
    """Phase 18: the sine branch of kernels 4, 1, 3 and 2 against their
    plain versions on the pretrained-then-perturbed SIREN surface
    (`_siren_models`), at the SIREN path's shapes, with the gates of phases
    10, 2, 6 and 3: kernel 4 on 2^20 points uniform in [-3, 3]^3 (the
    scene's bounding box, where 30 a reaches tens of radians on the first
    layer) and 4,099 more, max|diff| <= 1e-5 max|sdf|; kernel 1 on a SIREN
    step's 197,632 points (1,024 rays x (128 coarse + 64 fine depths from the
    kernels' sampler) + 1,024 eikonal points), sdf and h atol 1e-4, nablas
    rtol 2e-3 / atol 2e-4; kernel 3 on the same points with seeded
    cotangents, every leaf within 5e-4 of its max|ref|; kernel 2 on 4,096
    rays of the SIREN scene (near / far on the bounding sphere of radius 3),
    det and perturb, as phase 3. Returns (ok, {kernel: error in its gate's
    measure}, {kernel: max|diff|}, the inputs for phase 21's times)."""
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.frameworks import volsdf
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, _uniforms
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, get_rays
    from neurecon_tpu_torch.ops.sampling import linspace01

    args, model, checked, kw_train, kw_test = _siren_models(seed, dev)
    surface = checked.implicit_surface
    ok, err, abs_err = True, {}, {}
    g = torch.Generator(dev).manual_seed(seed)
    x4 = (torch.rand(SINE_POINTS, 3, device=dev, generator=g) * 2 - 1) * 3.0
    x4_tail = (torch.rand(4099, 3, device=dev, generator=g) * 2 - 1) * 3.0
    rel4, abs4 = [], []
    for xs in (x4, x4_tail):
        got = fused_mlp.fused_sdf_forward(surface, xs)
        ref = fused_mlp.sdf_forward_plain(surface, xs)
        torch.cuda.synchronize()
        abs4.append(float((got - ref).abs().max()))
        rel4.append(abs4[-1] / float(ref.abs().max())
                    if bool(torch.isfinite(got).all()) else float("inf"))
    err["sdf_forward"] = max(rel4)
    abs_err["sdf_forward"] = max(abs4)
    report(f"phase 18: sdf_forward (sine) on {SINE_POINTS} and 4,099 points in [-3, 3]^3: "
           f"max|diff| "
           f"{rel4[0]:.2e}, {rel4[1]:.2e} of max|sdf| (gate 1e-5)")
    ok &= err["sdf_forward"] <= 1e-5

    ds = get_data(args)
    H, W, N = ds.H, ds.W, int(args.data.N_rays)
    o_all, d_all, _ = get_rays(torch.tensor(ds.c2w_all[0], device=dev),
                               torch.tensor(ds.intrinsics_all[0], device=dev), H, W)
    idx = torch.linspace(0, H * W - 1, N, device=dev).long()
    rays_o, rays_d, _, far = volsdf._ray_bounds(o_all[idx], d_all[idx], 0.0, 6.0)
    fine = volsdf.compute_ray_samples(checked, rays_o, rays_d,
                                      **{**kw_train, "perturb": False})
    d_step = torch.sort(torch.cat([far * linspace01(int(kw_train["N_samples"]), dev),
                                   fine[0]], -1), -1).values
    eik = (torch.rand(N, 1, 3, device=dev, generator=g) * 2 - 1) * 3.0
    x1 = torch.cat([rays_o[:, None] + rays_d[:, None] * d_step[..., None], eik],
                   1).reshape(-1, 3).contiguous()
    got = fused_nablas.fused_forward_with_nablas(surface, x1)
    ref = fused_nablas.forward_with_nablas_plain(surface, x1)
    torch.cuda.synchronize()
    e1 = [float((a - b).abs().max()) for a, b in zip(got, ref)]
    nab_ok = bool(((got[1] - ref[1]).abs() <= 2e-4 + 2e-3 * ref[1].abs()).all())
    nab_rel = float(((got[1] - ref[1]).abs() / (2e-4 + 2e-3 * ref[1].abs())).max())
    err["nablas_forward"] = max(e1[0] / 1e-4, e1[2] / 1e-4, nab_rel)
    abs_err["nablas_forward"] = max(e1)
    report(f"phase 18: nablas_forward (sine) on {x1.shape[0]} points: max|diff| sdf "
           f"{e1[0]:.3e}, nablas {e1[1]:.3e} (max|nablas| {float(ref[1].abs().max()):.3f}), "
           f"h {e1[2]:.3e}; the worst entry at {nab_rel:.3f} of the nablas gate")
    ok &= (e1[0] <= 1e-4 and e1[2] <= 1e-4 and nab_ok
           and all(bool(torch.isfinite(t).all()) for t in got))
    del got, ref

    g3 = torch.Generator(dev).manual_seed(seed + 2)
    M1 = x1.shape[0]
    cots = (torch.randn(M1, device=dev, generator=g3),
            torch.randn(M1, 3, device=dev, generator=g3),
            torch.randn(M1, surface.W_geo_feat, device=dev, generator=g3))
    ws, bs = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    got3 = fused_nablas_vjp.fused_nablas_vjp(surface, x1, ws, bs, *cots)
    ref3 = fused_nablas_vjp.nablas_vjp_plain(surface, x1, ws, bs, *cots)
    torch.cuda.synchronize()
    ratios = _leaf_ratios(got3, ref3)
    finite3 = all(bool(torch.isfinite(t).all()) for t in [got3[0], *got3[1], *got3[2]])
    err["nablas_backward"] = max(ratios.values()) if finite3 else float("inf")
    abs_err["nablas_backward"] = max(float((a - b).abs().max()) for a, b in
                                     zip([got3[0], *got3[1], *got3[2]],
                                         [ref3[0], *ref3[1], *ref3[2]]))
    report(f"phase 18: nablas_backward (sine) on {M1} points: max|diff| / max|ref| per leaf "
           + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items()) + " (gate 5e-4)")
    ok &= err["nablas_backward"] <= 5e-4
    del got3, ref3

    sub = torch.linspace(0, H * W - 1, SINE_RAYS, device=dev).long()
    r2o, r2d, near2, far2 = _prepare_rays(o_all[sub], d_all[sub], 3.0)
    t = torch.linspace(0, 1, 64, device=dev)
    dc2 = (near2 * (1 - t) + far2 * t).contiguous()
    u2 = {"det": _uniforms(SINE_RAYS, 4, 16, False, None, dev),
          "perturb": _uniforms(SINE_RAYS, 4, 16, True, torch.Generator(dev).manual_seed(seed),
                               dev)}
    ok2, e2 = _upsample_check(surface, r2o, r2d, near2, far2, dc2, u2,
                              f"phase 18 (sine, {SINE_RAYS} rays of the SIREN scene)")
    err["neus_upsample"] = abs_err["neus_upsample"] = max(e2.values())
    ok &= ok2
    ctx = {"args": args, "model": model, "checked": checked, "kw_train": kw_train,
           "kw_test": kw_test, "x4": x4, "x1": x1, "cots": cots, "ws": ws, "bs": bs,
           "up": (r2o, r2d, dc2, u2["det"]), "rays": (rays_o, rays_d, far), "ds": ds,
           "o_all": o_all, "d_all": d_all}
    return bool(ok), err, abs_err, ctx


def _sampler_check(surface, rays_o, rays_d, far, betas, n0, n_up, max_iter, seed, label,
                   n_final=64):
    """Kernels (a)-(c) with kernel 4 against the plain sampler, end to end
    and each kernel in lockstep on its plain stage's inputs, with phase 14's
    gates, at each beta_net of `betas`, det and perturb uniforms. Returns
    (ok, {kernel: worst depth error}, (the last (alpha, beta), its uniforms))."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.sampling import linspace01

    dev = rays_o.device
    N = rays_o.shape[0]
    d_init = (far * linspace01(n0, dev)).contiguous()
    kw = {"eps": 0.1, "max_iter": max_iter, "max_bisection": 10, "n_final": n_final,
          "n_up": n_up, "sphere_bg_r": 3.0}
    ok, k_err = True, {}
    ab = (torch.tensor(1.0 / betas[0], device=dev), torch.tensor(betas[0], device=dev))
    with torch.no_grad():
        edges = _sampler_edges(surface, rays_o, rays_d, d_init, far, ab,
                               ffs.det_uniforms(n_final, 4, N, dev), n_final=n_final)
    print(f"{label}: merge ties and det-draw edges (kernels vs plain): {json.dumps(edges)}")
    if edges["merge_ties_sdf"] > 1e-5 or edges["draw_ties"] > 0 or edges["draw_flat_share"] > 0.01:
        ok = False
    for beta in betas:
        ab = (torch.tensor(1.0 / beta, device=dev), torch.tensor(beta, device=dev))
        for mode in ("det", "perturb"):
            u = (ffs.det_uniforms(n_final, max_iter + 2, N, dev) if mode == "det"
                 else torch.rand(N, (max_iter + 2) * n_final, device=dev,
                                 generator=torch.Generator(dev).manual_seed(seed + 3)))
            (gd, gb, gi) = ffs.fused_fine_sample(surface, rays_o, rays_d, d_init, far, *ab, u,
                                                 **kw)
            (rd, rb, ri) = ffs.fine_sample_plain(surface, rays_o, rays_d, d_init, far, *ab, u,
                                                 **kw)
            torch.cuda.synchronize()
            dd = (gd - rd).abs()
            fine_share = float((dd > 1e-4 * 6.0).float().mean())
            beta_off = int(((gb - rb).abs() > 1e-5 + 1e-3 * rb.abs()).sum())
            iter_eq = float((gi == ri).float().mean())
            with torch.no_grad():
                lock, merged_equal = _lockstep(surface, rays_o, rays_d, d_init, far, ab, u,
                                               n_up=n_up, max_iter=max_iter, n_final=n_final)
            rounds = torch.bincount((ri + 1).long(), minlength=max_iter + 2).tolist()
            print(f"{label}: sampler beta_net {beta} {mode}, {N} rays, "
                  f"{n0 + max_iter * n_up} depths: fine max|diff| {float(dd.max()):.3e}, share "
                  f"beyond 1e-4 span {fine_share:.5f}; beta map off on {beta_off} rays; "
                  f"iter_usage equal on {iter_eq:.4f}; rounds (-1, 0..{max_iter}) {rounds}; "
                  f"lockstep (each kernel on the plain stage's inputs) {json.dumps(lock)}; "
                  f"round-0 and merged depths equal {merged_equal}")
            for name, e in lock.items():
                k_err[name] = max(k_err.get(name, 0.0), e.get("fine", 0.0), e.get("depths", 0.0),
                                  e.get("next_depths", 0.0))
            shares = [v for e in lock.values() for k, v in e.items() if k.endswith("share")]
            finite = all(bool(torch.isfinite(t_).all()) for t_ in (gd, gb))
            if (fine_share > 0.02 or beta_off > 0.01 * N or iter_eq < 0.9 or not finite
                    or not merged_equal or max(shares) > 0.01
                    or max(e.get("sdf", 0.0) for e in lock.values()) > 1e-5
                    or max(e.get("unsorted_rays", 0.0) for e in lock.values()) > 0):
                ok = False
            last = (ab, u)
    return ok, k_err, last


def _siren_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 18-21 (VolSDF with SIREN nets); returns (rc, kernel rows)."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import RadianceNet, pretrain_siren_sdf
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, volsdf
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops import (fused_mlp, fused_nablas, fused_nablas_vjp,
                                        fused_upsample)
    from neurecon_tpu_torch.tools import extract_surface, render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    # ---- phase 18: the sine kernels against their plain versions
    ok, _, s_abs, ctx = sine_kernel_checks(seed, dev)
    if not ok:
        print("FAIL phase 18: a sine kernel disagrees with its plain version", file=sys.stderr)
        return 1, None
    args, checked = ctx["args"], ctx["checked"]
    surface = checked.implicit_surface

    # ---- phase 19: the SIREN sphere pretrain on the card (JAX's defaults)
    fresh = copy.deepcopy(ctx["model"].implicit_surface)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = pretrain_siren_sdf(fresh, lr=float(args.training.lr_pretrain),
                                target_radius=fresh.radius_init,
                                obj_bounding_size=fresh.obj_bounding_size,
                                generator=torch.Generator(dev).manual_seed(seed + 7))
    l1 = float(losses[-1])
    pre_s = time.perf_counter() - t0
    print(f"phase 19: pretrain_siren_sdf 5,000 iterations x 5,000 points: final L1 {l1:.5f} "
          f"(gate 0.08), {pre_s:.2f} s, L1 at iterations 1 / 1,000 / 5,000 "
          f"{float(losses[0]):.4f} / {float(losses[min(999, len(losses) - 1)]):.4f} / "
          f"{l1:.4f} {tag}")
    if not l1 < 0.08:
        print("FAIL phase 19: the SIREN pretrain did not fit the sphere", file=sys.stderr)
        return 1, None
    del fresh

    # ---- phase 20: the whole-step gradient, the sampler, then train.py
    ds = ctx["ds"]
    batch = {"c2w": torch.tensor(ds.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(ds.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(ds.rgb_images[:1], device=dev).reshape(1, -1, 3)}
    kw_train = ctx["kw_train"]
    H, W, N = ds.H, ds.W, int(args.data.N_rays)
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, H, W, N)
    eik = (torch.rand(1, N, 1, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed + 4)) * 2 - 1) * 3.0
    fine = volsdf.compute_ray_samples(checked, rb["rays_o"], rb["rays_d"],
                                      **{**kw_train, "perturb": False})
    ray_loss = get_ray_loss_fn(args, checked, kw_train)

    loss_k, loss_p, ratios = _step_grad_check(checked, ray_loss, rb, fine_override=fine,
                                              eik_pts=eik)
    worst = max(ratios, key=ratios.get)
    print(f"phase 20: SIREN step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad "
          f"leaf {worst} {ratios[worst]:.2e} over {len(ratios)} leaves (ln_beta "
          f"{ratios['ln_beta']:.2e})")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or ratios[worst] > 5e-4:
        print("FAIL phase 20: the SIREN step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1, None
    rays_o, rays_d, far = ctx["rays"]
    n0 = int(kw_train["N_samples"]) * int(kw_train["fine_sample_mul"])
    max_iter = int(kw_train["max_upsample_steps"])
    ok, _, _ = _sampler_check(
        surface, rays_o, rays_d, far, (0.1, 0.01), n0, n0, max_iter, seed,
        "phase 20 (SIREN surface)")
    if not ok:
        print("FAIL phase 20: the fine-sampler kernels disagree with the plain sampler on "
              "the SIREN surface", file=sys.stderr)
        return 1, None

    targs = ConfigDict(copy.deepcopy(VOLSDF_SIREN))
    targs["expname"] = "chip_smoke_volsdf_siren_train"
    targs["seed"] = seed
    targs.data["mesh_N"] = 128
    tdir = os.path.join(workdir, "siren_train")
    S, half = SIREN_STEPS, SIREN_STEPS // 2
    targs.training.update({"num_iters": S, "i_val": half, "i_log": 10,
                           "i_val_mesh": half, "i_backup": half, "monitoring": "none",
                           "log_root_dir": tdir, "exp_dir": os.path.join(tdir, "run")})
    out, t_launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path["volsdf_siren_train"] = t_launches
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    ckpt_dir = os.path.join(out["exp_dir"], "ckpts")
    pre_tree = load_checkpoint(os.path.join(ckpt_dir, "latest.pt"))
    fates = {}
    for name, tree in (("pretrained", pre_tree["model"]),
                       (f"step {half}", load_checkpoint(
                           os.path.join(ckpt_dir, f"{half:08d}.pt"))["model"]),
                       (f"step {S}", load_checkpoint(out["final_ckpt"])["model"])):
        m, *_ = get_model(ConfigDict(copy.deepcopy(VOLSDF_SIREN)), dev)
        bridge.load_tree(m, tree)
        grid = mesh_util.query_grid(m.implicit_surface.forward_query, 128, 3.0, device=dev)
        n_faces = len(mesh_util.marching_tetrahedra(grid)[1])
        fates[name] = (float(grid.min()), float(grid.max()), n_faces,
                       float(np.exp(float(tree["ln_beta"][0]))))
        del grid
    betas = [round(v, 5) for _, v in out["stats"]["scalars"]["beta"]]
    print(f"phase 20: train.py {S} SIREN steps at configs/volsdf_siren.yaml widths, 1,024 rays, "
          f"pretrain included, {run_s:.1f} s in all: launches {t_launches}; loss mean of "
          f"steps 1-10 {first:.5f}, of the last 10 {last:.5f}; beta at the logs {betas}")
    print("phase 20: the surface on a 128^3 grid over [-1.5, 1.5]^3 (sdf min, max, "
          "marching-tetrahedra faces, beta): "
          + "; ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} / {v[2]} faces / {v[3]:.5f}"
                      for k, v in fates.items()))
    print(f"phase 20: median {ms_step:.2f} ms per SIREN step over steps 6-{S} "
          f"({N * 1e3 / ms_step:.0f} rays/s); all steps ms {[round(v, 1) for v in step_ms]} {tag}")
    if (min(t_launches["nablas_forward"], t_launches["nablas_backward"],
            t_launches["volsdf_init"], t_launches["volsdf_draw"]) < S
            or t_launches["sdf_forward"] < (1 + max_iter) * S
            or t_launches["volsdf_checkpoint"] < max_iter * S
            or len(totals) != S or not np.isfinite(totals).all() or not last < first):
        print("FAIL phase 20: SIREN training missed a kernel, diverged or did not lower "
              "the loss", file=sys.stderr)
        return 1, None

    vargs = ConfigDict(copy.deepcopy(VOLSDF_SIREN))
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 2, "camera_path": "interpolation",
                  "rayschunk": 4096})
    zero_counts()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    launches = by_path["volsdf_siren_render_view"] = read_counts()
    print(f"phase 20: render_view SIREN 2 x {H}x{W}: launches {launches}, s/frame "
          f"{[round(v, 4) for v in frames['seconds']]} {tag}")
    chunks = 2 * math.ceil(H * W / 4096)  # one sampler call and one kernel-1 launch each
    want = {"nablas_forward": chunks, "neus_upsample": 0, "nablas_backward": 0,
            "sdf_forward": chunks * (1 + max_iter), "volsdf_init": chunks,
            "volsdf_draw": chunks, "volsdf_checkpoint": chunks * max_iter}
    if (launches != want or frames["rgb"].shape != (2, H, W, 3)
            or not all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))):
        print("FAIL phase 20: the SIREN render missed a kernel or is not finite",
              file=sys.stderr)
        return 1, None
    render_fn = volsdf.make_volume_render_fn(checked, detailed_output=False, calc_normal=True,
                                             **ctx["kw_test"])
    o_all, d_all = ctx["o_all"], ctx["d_all"]
    patch = torch.arange(H * W // 2 - 1024, H * W // 2 + 1024, device=dev).clamp(0, H * W - 1)
    out_k = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
    with mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                           fused_nablas.forward_with_nablas_plain), \
            mock.patch.object(ffs, "fused_fine_sample", ffs.fine_sample_plain):
        out_p = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
    e = {k: float(np.abs(out_k[k] - out_p[k]).max())
         for k in ("rgb", "depth_volume", "normals_volume", "mask_volume", "beta_map")}
    print(f"phase 20: 2,048-ray SIREN patch, kernels vs plain: max|diff| {e}")
    if e["rgb"] > 2e-3:
        print("FAIL phase 20: the SIREN patch disagrees with the plain render", file=sys.stderr)
        return 1, None
    ply = os.path.join(workdir, "siren_pretrained_256.ply")
    eargs = extract_surface.make_parser().parse_args(
        ["--load_pt", os.path.join(ckpt_dir, "latest.pt"), "--out", ply, "--N", "256",
         "--volume_size", "3.0", "--D", "5", "--skip", "-1", "--embed_multires", "-1",
         "--init_r", "1.0", "--use_siren"])
    zero_counts()
    ext = extract_surface.main_function(eargs)
    torch.cuda.synchronize()
    by_path["volsdf_siren_extract_surface"] = read_counts()
    v256, f256 = mesh_util.read_ply(ply)
    closed = len(f256) > 0 and _closed(torch.as_tensor(f256, device=dev))
    radii = np.linalg.norm(v256, axis=-1) if len(v256) else np.zeros(1)
    print(f"phase 20: extract_surface 256^3 of the pretrained SIREN surface: grid "
          f"{ext['grid_s']:.3f} s; {len(v256)} verts, {len(f256)} faces, closed {closed}; "
          f"vertex radius mean {radii.mean():.5f}, min {radii.min():.5f}, max "
          f"{radii.max():.5f} {tag}")
    if not closed or by_path["volsdf_siren_extract_surface"]["sdf_forward"] == 0:
        print("FAIL phase 20: the pretrained SIREN surface meshes empty or open",
              file=sys.stderr)
        return 1, None

    # ---- phase 21: times of the sine kernels, the SIREN step and frame
    x4, x1, cots, ws, bs = ctx["x4"], ctx["x1"], ctx["cots"], ctx["ws"], ctx["bs"]
    n_par = sum(p.numel() for p in surface.parameters())
    M4, M1 = x4.shape[0], x1.shape[0]
    r2o, r2d, dc2, u2 = ctx["up"]
    sines = 5 * surface.W  # sin (and cos) evaluations a point
    rows, times = [], {}
    specs = {
        "sdf_forward": (lambda: fused_mlp.fused_sdf_forward(surface, x4),
                        lambda: fused_mlp.sdf_forward_plain(surface, x4),
                        _bounds(2.0 * _surface_macs(surface, sdf_only=True) * M4,
                                4.0 * (M4 * 4 + n_par)), "3xtf32", f"{M4} points",
                        "neurecon_tpu/ops/fused_mlp.py:125"),
        "nablas_forward": (lambda: fused_nablas.fused_forward_with_nablas(surface, x1),
                           lambda: fused_nablas.forward_with_nablas_plain(surface, x1),
                           _bounds(2.0 * _surface_macs(surface) * M1,
                                   4.0 * (M1 * (3 + 4 + surface.W_geo_feat) + n_par)),
                           "3xtf32", f"{M1} points", "neurecon_tpu/ops/fused_nablas.py:74"),
        "nablas_backward": (lambda: fused_nablas_vjp.fused_nablas_vjp(surface, x1, ws, bs, *cots),
                            lambda: fused_nablas_vjp.nablas_vjp_plain(surface, x1, ws, bs, *cots),
                            _bounds(2.0 * _surface_macs(surface, backward=True) * M1,
                                    4.0 * (M1 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                                           + 2 * n_par)),
                            "3xtf32", f"{M1} points", "neurecon_tpu/ops/fused_nablas_vjp.py:120"),
        "neus_upsample": (lambda: fused_upsample.fused_neus_upsample(
                              surface, r2o, r2d, dc2, u2, n_iters=4, n_per_iter=16),
                          lambda: fused_upsample.neus_upsample_plain(
                              surface, r2o, r2d, dc2, u2, n_iters=4, n_per_iter=16),
                          _bounds(2.0 * _surface_macs(surface, sdf_only=True) * SINE_RAYS * 128,
                                  4.0 * (SINE_RAYS * (6 + 64 + 64 + 128) + n_par)),
                          "3xtf32", f"{SINE_RAYS} rays", "neurecon_tpu/ops/fused_upsample.py:272"),
    }
    for name, (fn, plain, bb, held, per, replaces) in specs.items():
        ms = _time_ms(fn)
        with torch.no_grad():
            pms = _time_ms(plain, reps=3)
        times[name] = ms
        print(f"phase 21: {name} (sine) {per}: {ms:.3f} ms (plain {pms:.3f} ms, fp32 bound "
              f"{bb[0][0]:.3f} ms, 3xTF32 bound {bb[1][0]:.3f} ms; {sines} sin / cos a point "
              f"beside the multiply-adds) {tag}")
        rows.append({"name": f"{name}[sine]", "branch": "sine", "route": "cuda",
                     "source": f"neurecon_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                     "launches": t_launches[name], "max_abs_err": s_abs[name], "ms": ms,
                     "plain_ms": pms, **_bound_fields(*bb, held), "library_ms": None,
                     "per": per})
    print(f"phase 21: median {ms_step:.2f} ms per SIREN step over steps 6-{S}, "
          f"{N * 1e3 / ms_step:.0f} rays/s; s per SIREN {H}x{W} frame "
          f"{[round(v, 4) for v in frames['seconds']]}; pretrain {pre_s:.2f} s {tag}")
    parts = {"volsdf_init": (ffs, "launch_init"), "volsdf_draw": (ffs, "launch_draw"),
             "volsdf_checkpoint": (ffs, "launch_checkpoint"),
             "sdf_forward (sampler)": (ffs, "launch_sdf_forward")}
    step_total, split, busy = _step_split(
        targs, dev, {"sampler (whole)": (ffs, "fused_fine_sample"), **parts,
                     "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward")},
        tree=load_checkpoint(out["final_ckpt"])["model"])
    sampler_rest = split["sampler (whole)"] - sum(split[k] for k in parts)
    rest = step_total - sum(v for k, v in split.items() if k not in parts)
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 21: one SIREN step ({N} rays, phase 20's final weights) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the sampler's own glue {sampler_rest:.2f} ms, the rest (radiance backward, "
          f"loss, glue) {rest:.2f} ms; device over three steps {busy} {tag}")
    frame_ms, fsplit = _frame_split(
        render_view.render_frames, vargs,
        {"sampler (whole)": (ffs, "fused_fine_sample"), **parts,
         "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
         "radiance_net": (RadianceNet, "forward")})
    frest = frame_ms - sum(v for k, v in fsplit.items() if k not in parts)
    print(f"phase 21: one {H}x{W} SIREN frame (phase 20's final checkpoint) "
          f"{frame_ms:.2f} ms wall: " + ", ".join(f"{k} {v:.2f} ms" for k, v in fsplit.items())
          + f", everything else {frest:.2f} ms {tag}")
    for r in rows:
        r["launches_by_path"] = {p: c[r["name"].split("[")[0]] for p, c in by_path.items()
                                 if p.startswith("volsdf_siren")}
    return 0, rows


# ---- UNISURF and the file loaders (phases 22-26) ----

# configs/unisurf.yaml as the file holds it (the card machine has no PyYAML
# to read it; tests/test_torch_unisurf.py holds the two equal)
UNISURF = {
    "data": {"N_rays": 1024, "batch_size": 1, "data_dir": "./data/DTU/scan65",
             "downscale": 1, "pin_memory": True, "val_downscale": 8, "val_rayschunk": 256},
    "device_ids": -1,
    "expname": "unisurf_65",
    "model": {"W_geometry_feature": 256, "framework": "UNISURF", "obj_bounding_radius": 4.0,
              "radiance": {"D": 4, "embed_multires": -1, "embed_multires_view": -1,
                           "skips": []},
              "surface": {"D": 8, "embed_multires": 6, "radius_init": 1.0, "skips": [4]},
              "tau": 0.5},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "delta_beta": 1.5e-05, "delta_max": 1.0, "delta_min": 0.05,
                 "i_backup": 50000, "i_save": 900, "i_val": 1000, "i_val_mesh": 20000,
                 "log_root_dir": "./logs", "lr": 0.0001, "overlap_sampler": False,
                 "fused_nablas_vjp": True, "monitoring": "tensorboard", "num_iters": 450000,
                 "perturb_surface_pts": 0.01,
                 "scheduler": {"gamma": 0.5, "milestones": [200000, 400000],
                               "type": "multistep"},
                 "w_reg": 0.01},
}
UNISURF_STEPS = 40  # phase 23's cut of configs/unisurf.yaml's 450,000 steps
DTU_SHAPE = (8, 1200, 1600)  # views, H, W: DTU's image size, 8 of its 49-64 views
SMALL_SHAPE = (8, 300, 400)  # the BlendedMVS and custom scenes
# the DTU scene's scale_mat: normalized coordinates -> world, x_w = s x_n + c
DTU_SCALE, DTU_SHIFT = 2.5, (0.3, -0.2, 0.5)


def unisurf_train_config(data_dir, exp_root, seed):
    """configs/unisurf.yaml with phase 23's cuts, and the cuts as
    (dotted key, value) pairs (printed by the phase)."""
    cuts = [("data.data_dir", data_dir), ("training.num_iters", UNISURF_STEPS),
            ("training.i_val", UNISURF_STEPS // 2), ("training.i_val_mesh", UNISURF_STEPS // 2),
            ("data.mesh_N", 128), ("training.exp_dir", os.path.join(exp_root, "run")),
            ("training.log_root_dir", exp_root), ("training.i_log", 10),
            ("training.i_backup", UNISURF_STEPS // 2), ("training.monitoring", "none"),
            ("expname", "chip_smoke_unisurf"), ("seed", seed)]
    cfg = copy.deepcopy(UNISURF)
    for key, value in cuts:
        *path, last = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[last] = value
    return cfg, cuts


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, img, filters=(0, 1, 2, 3, 4), palette=None, trns=None):
    """Write `img` as a PNG with the standard library and numpy: uint8 or
    uint16, [H, W] (grey) or [H, W, C] (C = 1 grey, 2 grey + alpha, 3 RGB,
    4 RGBA), or uint8 palette indices [H, W] with `palette` [n, 3] (and
    `trns`, the palette's alpha). Row r takes filter filters[r % len]: the
    default cycles None, Sub, Up, Average and Paeth over the rows, so that a
    reader's every filter runs."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    H, W = img.shape[:2]
    C = 1 if img.ndim == 2 else img.shape[-1]
    ctype = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[C]
    depth = 16 if img.dtype == np.uint16 else 8
    if depth == 8 and img.dtype != np.uint8:
        raise ValueError(f"write_png: {img.dtype} pixels, want uint8 or uint16")
    raw = (img.astype(">u2") if depth == 16 else img).tobytes()
    x = np.frombuffer(raw, np.uint8).reshape(H, -1).astype(np.int16)
    bpp = C * depth // 8
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]  # the byte one pixel to the left
    b = np.zeros_like(x)
    b[1:] = x[:-1]  # the byte above
    c = np.zeros_like(x)
    c[1:] = a[:-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ft = np.asarray(filters, np.int16)[np.arange(H) % len(filters)][:, None]
    pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
    rows = np.concatenate([ft, (x - pred) & 0xFF], 1).astype(np.uint8)
    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0))]
    if palette is not None:
        chunks.append(_png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
        if trns is not None:
            chunks.append(_png_chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes()))
    chunks += [_png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)), _png_chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))


def _to_u8(x):
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_scene(root, layout, n_images, H, W, radius=0.5, cam_radius=3.0):
    """The synthetic sphere scene (`make_synthetic_scene`) on disk in one of
    the loaders' layouts, its images and masks as PNGs by `write_png`:

      * "DTU": image/, mask/, cameras.npz with world_mat_i = K [R|t] in a
        world frame x_w = DTU_SCALE x_n + DTU_SHIFT and scale_mat_i mapping
        the normalized frame to it;
      * "BlendedMVS": blended_images/ (and a `*_masked.png` the loader skips)
        with cams_normalized/<name>_cam.txt;
      * "custom": images/, mask/, mask_out/ (read as `masks_ignore`: a band
        along the left edge) and cam.json with P and SCALE.

    Returns the scene's normalized cameras and analytic images: {"c2w",
    "intrinsics" [n, 4, 4], "rgb" [n, H, W, 3] float, "mask" [n, H, W] bool,
    "mask_out" [n, H, W] bool or None}."""
    from neurecon_tpu_torch.dataio.blendedmvs import write_cam
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_images=n_images, H=H, W=W, radius=radius,
                                 cam_radius=cam_radius)
    c2w, K = scene["c2w"].astype(np.float64), scene["intrinsics"][0].astype(np.float64)
    rgb = scene["rgb"].reshape(n_images, H, W, 3)
    mask = scene["object_mask"].reshape(n_images, H, W)
    mask_out = None
    S = np.diag([DTU_SCALE] * 3 + [1.0])
    S[:3, 3] = DTU_SHIFT
    names = [f"{i:06d}" for i in range(n_images)]
    dirs = {"DTU": ("image", "mask"), "BlendedMVS": ("blended_images", None),
            "custom": ("images", "mask")}[layout]
    for d in dirs:
        if d:
            os.makedirs(os.path.join(root, d), exist_ok=True)
    world_mats = []
    for i, name in enumerate(names):
        c2w_w = c2w[i].copy()
        c2w_w[:3, 3] = DTU_SCALE * c2w[i][:3, 3] + np.asarray(DTU_SHIFT)
        world_mats.append(K @ np.linalg.inv(c2w_w))
        write_png(os.path.join(root, dirs[0], f"{name}.png"), _to_u8(rgb[i]))
        if dirs[1]:
            write_png(os.path.join(root, dirs[1], f"{name}.png"),
                      mask[i].astype(np.uint8) * 255)
    if layout == "DTU":
        np.savez(os.path.join(root, "cameras.npz"),
                 **{f"world_mat_{i}": w for i, w in enumerate(world_mats)},
                 **{f"scale_mat_{i}": S for i in range(n_images)})
    elif layout == "BlendedMVS":
        os.makedirs(os.path.join(root, "cams_normalized"), exist_ok=True)
        for i, name in enumerate(names):
            cam = np.zeros((2, 4, 4))
            cam[0] = np.linalg.inv(c2w[i])
            cam[1][:3, :3] = K[:3, :3]
            cam[1][3] = (0.5, 0.01, 256, 3.06)
            write_cam(os.path.join(root, "cams_normalized", f"{name}_cam.txt"), cam)
        write_png(os.path.join(root, dirs[0], f"{names[0]}_masked.png"), _to_u8(rgb[0] * 0))
    else:
        mask_out = np.zeros_like(mask)
        mask_out[:, :, : W // 8] = True
        os.makedirs(os.path.join(root, "mask_out"), exist_ok=True)
        for i, name in enumerate(names):
            write_png(os.path.join(root, "mask_out", f"{name}.png"),
                      mask_out[i].astype(np.uint8) * 255)
        with open(os.path.join(root, "cam.json"), "w") as f:
            json.dump({f"{name}.png": {"P": world_mats[i].tolist(), "SCALE": S.tolist()}
                       for i, name in enumerate(names)}, f)
    return {"c2w": c2w.astype(np.float32), "intrinsics": K.astype(np.float32),
            "rgb": rgb, "mask": mask, "mask_out": mask_out}


def _area_matrix(n_in, n_out):
    """[n_out, n_in]: the share of source pixel j in output pixel i, the
    overlap of [j, j + 1) with [i s, (i + 1) s) over s = n_in / n_out."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    j = np.arange(n_in)[None, :]
    return np.clip(np.minimum(lo + s, j + 1) - np.maximum(lo, j), 0.0, None) / s


def _area_mean(img, h, w):
    """`img` [H, W, ...] shrunk to [h, w, ...] by the area rule written as two
    overlap matrices in float64, apart from the loaders' `area_resize` (a
    block mean where the sizes divide)."""
    out = np.tensordot(_area_matrix(img.shape[0], h), np.asarray(img, np.float64), (1, 0))
    return np.moveaxis(np.tensordot(_area_matrix(img.shape[1], w), out, (1, 1)), 0, 1)


def _loader_phase(workdir):
    """Phase 22: the synthetic scene written in the three layouts, loaded
    through `get_data` at downscale 1 and at unisurf.yaml's val_downscale,
    held to the scene's own images, masks and cameras. Returns (ok, the DTU
    scene's root, its dataset at downscale 1, {layout: seconds of the load
    at both scales})."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.utils import io as io_util

    route = "imageio" if io_util._imageio() is not None else "the port's PNG reader"
    print(f"phase 22: images decoded by {route}; resized by utils/io.py::area_resize")
    val_ds = float(UNISURF["data"]["val_downscale"])
    ok, dtu_root, dtu_full, load_s = True, None, None, {}
    for layout, (n, H, W) in (("DTU", DTU_SHAPE), ("BlendedMVS", SMALL_SHAPE),
                              ("custom", SMALL_SHAPE)):
        root = os.path.join(workdir, f"scene_{layout.lower()}")
        t0 = time.perf_counter()
        scene = write_scene(root, layout, n, H, W)
        write_s = time.perf_counter() - t0
        # as train.py loads a scene: at downscale 1 and its val_downscale copy,
        # from one decode of each file
        args = ConfigDict({"data": {"type": layout, "data_dir": root, "downscale": 1.0}})
        t0 = time.perf_counter()
        both = get_data(args, return_val=True, val_downscale=val_ds)
        secs = load_s[layout] = time.perf_counter() - t0
        for ds, dset in zip((1.0, val_ds), both):
            h, w = int(H / ds), int(W / ds)

            def resized(img):
                return img if ds == 1 else _area_mean(img, h, w)
            rgb_ref = np.stack([resized(scene["rgb"][i]) for i in range(n)]).reshape(n, -1, 3)
            e_rgb = float(np.abs(dset.rgb_images - rgb_ref).max())
            masks_ok = True
            for got, want in ((dset.object_masks, scene["mask"] if layout != "BlendedMVS"
                               else None),
                              (getattr(dset, "masks_ignore", None), scene["mask_out"])):
                if want is None:
                    masks_ok &= got is None
                    continue
                ref = np.stack([resized(m.astype(np.float32) * 255.0) > 127.5 for m in want])
                masks_ok &= got is not None and np.array_equal(got, ref.reshape(n, -1))
            K = scene["intrinsics"].astype(np.float64).copy()
            K[0, 0], K[1, 1], K[0, 2], K[1, 2] = (K[0, 0] / ds, K[1, 1] / ds, K[0, 2] / ds,
                                                  K[1, 2] / ds)
            e_K = float(np.abs(dset.intrinsics_all - K).max() / np.abs(K).max())
            e_pose = float(np.abs(dset.c2w_all - scene["c2w"]).max())
            good = (len(dset) == n and (dset.H, dset.W) == (h, w) and e_rgb <= 1.0 / 255
                    and masks_ok and e_K <= 1e-5 and e_pose <= 1e-5)
            name = "BlendedMVS (as PNG; real scans are JPEG)" if layout == "BlendedMVS" else layout
            print(f"phase 22: {name} {n} x {H}x{W} (written in {write_s:.2f} s, loaded at "
                  f"downscale 1 and {val_ds:g} in {secs:.3f} s) at downscale "
                  f"{ds:g}: {len(dset)} views of {dset.H}x{dset.W}; rgb "
                  f"max|diff| {e_rgb:.2e} (gate 1/255), masks equal {masks_ok}, intrinsics "
                  f"{e_K:.2e} of max|K|, poses {e_pose:.2e} (gates 1e-5)")
            ok &= good
            if layout == "DTU" and ds == 1.0:
                dtu_root, dtu_full = root, dset
        del both, dset
    return ok, dtu_root, dtu_full, load_s


def _unisurf_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 22-26 (the file loaders, UNISURF); returns (rc, {kernel name:
    extra fields of its kernels-line row at UNISURF's shapes})."""
    from neurecon_tpu_torch import bridge, train
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import RadianceNet, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, unisurf
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, get_rays
    from neurecon_tpu_torch.ops.sampling import linspace01
    from neurecon_tpu_torch.tools import extract_surface, render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    # ---- phase 22: the loaders
    ok, dtu_root, dtu, load_s = _loader_phase(workdir)
    print(f"phase 22: seconds a load at downscale 1 and {UNISURF['data']['val_downscale']} "
          "(get_data as train.py calls it): "
          + ", ".join(f"{k} {v:.3f}" for k, v in load_s.items()) + f" {tag}")
    if not ok:
        print("FAIL phase 22: a loader disagrees with the scene it read", file=sys.stderr)
        return 1, None

    # ---- phase 23: train.py on configs/unisurf.yaml, read from the DTU scene
    cfg, cuts = unisurf_train_config(dtu_root, os.path.join(workdir, "unisurf_train"), seed)
    print("phase 23: configs/unisurf.yaml with the cuts " + ", ".join(f"{k}={v}"
                                                                      for k, v in cuts))
    targs = ConfigDict(copy.deepcopy(cfg))
    S, N = UNISURF_STEPS, int(cfg["data"]["N_rays"])
    n_steps = int(targs.model.get("N_steps", 256))
    out, t_launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path["unisurf_train"] = t_launches
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    logged = out["stats"]["scalars"]["interval"]
    e_int = max((abs(v - unisurf.interval_at(targs, it - 1)) for it, v in logged),
                default=float("inf"))
    ply20 = os.path.join(out["exp_dir"], "meshes", f"{S // 2:08d}.ply")
    v20, f20 = mesh_util.read_ply(ply20) if os.path.exists(ply20) else ([], [])
    # the loop's launches: 1 march + 8 secant kernel-4 launches and one each of
    # kernels 1 and 3 a step; two validations at val_downscale in chunks of
    # val_rayschunk (kernel 4 x 9 and kernel 1 a chunk); the step-20 mesh's
    # 128^3 grid in chunks of 262,144 points through kernel 4
    vd, vchunk = float(cfg["data"]["val_downscale"]), int(cfg["data"]["val_rayschunk"])
    val_chunks = 2 * math.ceil(int(DTU_SHAPE[1] / vd) * int(DTU_SHAPE[2] / vd) / vchunk)
    want = {"sdf_forward": 9 * S + 9 * val_chunks + math.ceil(128 ** 3 / 262144),
            "nablas_forward": S + val_chunks, "nablas_backward": S}
    print(f"phase 23: train.py {S} UNISURF steps at configs/unisurf.yaml widths, {N} rays, "
          f"{run_s:.1f} s in all: launches {t_launches} (want {want}); loss mean of steps "
          f"1-10 {first:.5f}, of the last 10 {last:.5f}; interval logged {logged} "
          f"(max|diff| to interval_at {e_int:.2e}); step-{S // 2} mesh {len(v20)} verts, "
          f"{len(f20)} faces")
    print(f"phase 23: median {ms_step:.2f} ms per UNISURF step over steps 6-{S} "
          f"({N * 1e3 / ms_step:.0f} rays/s); all steps ms {[round(v, 1) for v in step_ms]} "
          f"{tag}")
    if (any(t_launches[k] != v for k, v in want.items())
            or any(t_launches[k] for k in t_launches if k not in want)
            or len(totals) != S or not np.isfinite(totals).all() or not last < first
            or not logged or e_int > 1e-6 or not os.path.exists(ply20)):
        print("FAIL phase 23: UNISURF training missed a kernel, diverged, did not lower "
              "the loss, logged the wrong interval or wrote no mesh", file=sys.stderr)
        return 1, None
    # the same run with kernels 4, 1 and 3 replaced by their plain versions,
    # from the same init on the same batches and draws (the run's seed): the
    # course of the run (the surface it keeps or loses) is then the model's,
    # not the kernels'
    pcfg, _ = unisurf_train_config(dtu_root, os.path.join(workdir, "unisurf_plain"), seed)
    zero_counts()
    with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain), \
            mock.patch.object(fused_nablas, "fused_forward_with_nablas", _plain1), \
            mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp", _plain3):
        out_plain = train.main_function(ConfigDict(copy.deepcopy(pcfg)), device="cuda")
    torch.cuda.synchronize()
    p_launches = read_counts()
    totals_p = [v for _, v in out_plain["stats"]["losses"]["total_per_step"]]
    e_loss = max((abs(a - b) / abs(b) for a, b in zip(totals, totals_p)), default=float("inf"))
    probe, _, _, _ = get_model(ConfigDict(copy.deepcopy(cfg)), dev)

    def logit_range(ckpt):  # on a 128^3 grid over volume 3.0, plain query
        bridge.load_tree(probe, load_checkpoint(ckpt)["model"])
        with torch.no_grad():
            g = mesh_util.query_grid(
                lambda x: fused_mlp.sdf_forward_plain(probe.implicit_surface, x), 128, 3.0,
                device=dev)
        return float(g.min()), float(g.max())
    ranges = {run: [logit_range(os.path.join(o["exp_dir"], "ckpts", f"{S // 2:08d}.pt")),
                    logit_range(o["final_ckpt"])]
              for run, o in (("kernels", out), ("plain", out_plain))}
    e_range = max(max(abs(a - c), abs(b - d)) / (d - c)
                  for (a, b), (c, d) in zip(ranges["kernels"], ranges["plain"]))
    crossings = {run: [lo < 0 < hi for lo, hi in r] for run, r in ranges.items()}
    print(f"phase 23: the same {S} steps with kernels 4, 1 and 3 replaced by their plain "
          f"versions (launches {p_launches}): loss per step max rel diff {e_loss:.2e} (gate "
          f"1e-3), loss of steps 1, {S // 2}, {S}: kernels "
          f"{[round(totals[i], 6) for i in (0, S // 2 - 1, S - 1)]} plain "
          f"{[round(totals_p[i], 6) for i in (0, S // 2 - 1, S - 1)] if len(totals_p) == S else totals_p}; "
          f"logits on a 128^3 grid at steps {S // 2} and {S}: kernels "
          f"{[[round(v, 4) for v in r] for r in ranges['kernels']]} plain "
          f"{[[round(v, 4) for v in r] for r in ranges['plain']]} (max diff {e_range:.2e} of "
          f"the plain range, gate 1e-2); a zero set at steps {S // 2} and {S}: {crossings}")
    if (any(p_launches.values()) or len(totals_p) != S or e_loss > 1e-3 or e_range > 1e-2
            or crossings["kernels"] != crossings["plain"]):
        print("FAIL phase 23: the run through the kernels and the run through their plain "
              "versions part", file=sys.stderr)
        return 1, None

    # ---- phase 24: the root find and the step's gradient, kernels vs plain,
    # on two sets of weights: the geometric init with seeded noise (every
    # weight seen) and the step-20 checkpoint (trained; it still has a surface)
    final_tree = load_checkpoint(out["final_ckpt"])["model"]
    ckpt20 = os.path.join(out["exp_dir"], "ckpts", f"{S // 2:08d}.pt")
    noisy, kw_train, kw_test, _ = get_model(ConfigDict(copy.deepcopy(cfg)), dev, seed=seed)
    perturb_parameters(noisy, torch.Generator().manual_seed(seed + 1))
    trained, _, _, _ = get_model(ConfigDict(copy.deepcopy(cfg)), dev)
    bridge.load_tree(trained, load_checkpoint(ckpt20)["model"])
    checked = {"the init with seeded noise": noisy, f"the step-{S // 2} checkpoint": trained}
    kw_train["H"], kw_train["W"] = dtu.H, dtu.W
    batch = {"c2w": torch.tensor(dtu.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(dtu.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(dtu.rgb_images[:1], device=dev).reshape(1, -1, 3)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, dtu.H, dtu.W, N)
    sample_kw = {k: v for k, v in kw_train.items() if k not in ("H", "W")}
    _, _, near, far = unisurf._prepare_rays(rb["rays_o"], rb["rays_d"],
                                            kw_train["radius_of_interest"])
    g_u = torch.Generator(dev).manual_seed(seed + 5)
    uniforms = tuple(torch.rand(N, n, device=dev, generator=g_u)
                     for n in (int(kw_train["N_query"]), int(kw_train["N_freespace"]), 3))
    for label, net in checked.items():
        surf_k = unisurf.compute_ray_samples(net, rb["rays_o"], rb["rays_d"], **sample_kw)
        with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain):
            surf_p = unisurf.compute_ray_samples(net, rb["rays_o"], rb["rays_d"], **sample_kw)
        both = surf_k[2] & surf_p[2]
        agree = float((surf_k[2] == surf_p[2]).float().mean())
        e_depth = float(((surf_k[0] - surf_p[0]).abs() / (far - near))[both].max()) \
            if bool(both.any()) else float("inf")
        print(f"phase 24: root find on {N} rays, {label} (1 march of {n_steps} + 8 secant "
              f"kernel-4 launches): hit masks agree on {100 * agree:.2f}% (gate 99.9%), "
              f"{int(both.sum())} hit in both, depth max|diff| {e_depth:.2e} of the span "
              f"(gate 1e-4)")
        if agree < 0.999 or not bool(both.any()) or e_depth > 1e-4:
            print("FAIL phase 24: the kernel-4 root find disagrees with the plain query",
                  file=sys.stderr)
            return 1, None
        ray_loss = get_ray_loss_fn(targs, net, kw_train)
        loss_k, loss_p, ratios = _step_grad_check(net, ray_loss, rb, it=S,
                                                  surface_override=surf_p, uniforms=uniforms)
        worst = max(ratios, key=ratios.get)
        print(f"phase 24: UNISURF step, {label}: loss kernels {loss_k:.8f} plain "
              f"{loss_p:.8f}; worst grad leaf {worst} {ratios[worst]:.2e} over {len(ratios)} "
              "leaves")
        if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or ratios[worst] > 5e-4:
            print("FAIL phase 24: the UNISURF step's gradient through the kernels disagrees",
                  file=sys.stderr)
            return 1, None
    model, _, _, _ = get_model(ConfigDict(copy.deepcopy(cfg)), dev)
    bridge.load_tree(model, final_tree)
    surf_final = unisurf.compute_ray_samples(model, rb["rays_o"], rb["rays_d"], **sample_kw)
    print(f"phase 24: on phase 23's final weights {int(surf_final[2].sum())} of the {N} rays "
          f"hit ({int(surf_final[3].sum())} change sign)")

    # ---- phase 25: render_view on the final checkpoint, a patch, a mesh
    vargs = ConfigDict(copy.deepcopy(cfg))
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 2,
                  "camera_path": "interpolation", "rayschunk": 4096, "downscale": 10})
    zero_counts()
    frames = render_view.render_frames(vargs, device=dev)
    torch.cuda.synchronize()
    launches = by_path["unisurf_render"] = read_counts()
    H, W = int(DTU_SHAPE[1] / 10), int(DTU_SHAPE[2] / 10)
    chunks = 2 * math.ceil(H * W / 4096)
    want = {k: 0 for k in launches}
    want.update({"sdf_forward": 9 * chunks, "nablas_forward": chunks})
    interval = unisurf.interval_at(vargs, S)
    print(f"phase 25: render_view UNISURF 2 x {H}x{W} at interval {interval:.6f}: launches "
          f"{launches}, s/frame {[round(v, 4) for v in frames['seconds']]} {tag}")
    if (launches != want or frames["rgb"].shape != (2, H, W, 3)
            or not all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))):
        print("FAIL phase 25: the UNISURF render missed a kernel or is not finite",
              file=sys.stderr)
        return 1, None
    # the patch on phase 24's two sets of weights, whose surfaces the rays
    # cross (the final weights have lost theirs: phase 23's lines)
    o_all, d_all, _ = get_rays(torch.tensor(dtu.c2w_all[0], device=dev),
                               torch.tensor(dtu.intrinsics_all[0], device=dev), dtu.H, dtu.W)
    patch = torch.arange(dtu.H * dtu.W // 2 - 1024, dtu.H * dtu.W // 2 + 1024, device=dev)
    for label, net in checked.items():
        render_fn = unisurf.make_volume_render_fn(
            net, detailed_output=False, calc_normal=True, interval=interval,
            **{k: v for k, v in kw_test.items() if k not in ("H", "W")})
        out_k = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
        with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain), \
                mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                                  fused_nablas.forward_with_nablas_plain):
            out_p = render_full_image(render_fn, o_all[patch], d_all[patch], rayschunk=4096)
        same = out_k["mask_surface"] == out_p["mask_surface"]
        e = {k: float(np.abs(out_k[k] - out_p[k])[same].max(initial=0))
             for k in ("rgb", "depth_volume", "normals_volume", "mask_volume", "depth_surface")}
        e_all = float(np.abs(out_k["rgb"] - out_p["rgb"]).max())
        print(f"phase 25: 2,048-ray UNISURF patch, {label}, kernels vs plain: surface masks "
              f"agree on {int(same.sum())} rays ({int(out_k['mask_surface'].sum())} hit), "
              f"max|diff| there {e}; rgb over all rays {e_all:.2e}")
        if same.mean() < 0.999 or e["rgb"] > 2e-3 or not out_k["mask_surface"].any():
            print("FAIL phase 25: the UNISURF patch disagrees with the plain render",
                  file=sys.stderr)
            return 1, None
    # the mesh of the step-20 checkpoint: the run empties its scene between
    # steps 20 and 40 (phase 23's lines), so the final one has no zero set
    ply = os.path.join(workdir, "unisurf_256.ply")
    sc = cfg["model"]["surface"]
    eargs = extract_surface.make_parser().parse_args(
        ["--load_pt", ckpt20, "--out", ply, "--N", "256", "--volume_size", "3.0",
         "--D", str(sc["D"]), "--W", str(sc.get("W", 256)), "--skip", str(sc["skips"][0]),
         "--embed_multires", str(sc["embed_multires"]), "--init_r", str(sc["radius_init"]),
         "--W_geo_feat", str(cfg["model"]["W_geometry_feature"]), "--device", str(dev)])
    zero_counts()
    ext = extract_surface.main_function(eargs)
    torch.cuda.synchronize()
    by_path["unisurf_extract_surface"] = read_counts()
    v256, f256 = mesh_util.read_ply(ply)
    closed = len(f256) > 0 and _closed(torch.as_tensor(f256, device=dev))
    radii = np.linalg.norm(v256, axis=-1) if len(v256) else np.zeros(1)
    grid = mesh_util.query_grid(model.implicit_surface.forward_query, 128, 3.0, device=dev)
    final_faces = len(mesh_util.marching_tetrahedra(grid)[1])
    print(f"phase 25: extract_surface 256^3 over volume 3.0 of the step-{S // 2} UNISURF "
          f"checkpoint (level 0 of the logits): grid {ext['grid_s']:.3f} s; {len(v256)} verts, "
          f"{len(f256)} faces, closed {closed}; vertex radius mean {radii.mean():.4f}, "
          f"min {radii.min():.4f}, max {radii.max():.4f}; the step-{S} weights on a 128^3 "
          f"grid: logits {float(grid.min()):.4f} to {float(grid.max()):.4f}, {final_faces} "
          f"faces {tag}")
    del grid
    if not closed or by_path["unisurf_extract_surface"]["sdf_forward"] == 0:
        print("FAIL phase 25: the UNISURF checkpoint meshes empty or open", file=sys.stderr)
        return 1, None

    # ---- phase 26: kernels 4, 1 and 3 at UNISURF's shapes; a step and a frame split
    surface = model.implicit_surface
    n_par = sum(p.numel() for p in surface.parameters())
    r_o, r_d, near, far = unisurf._prepare_rays(rb["rays_o"], rb["rays_d"],
                                                kw_train["radius_of_interest"])
    t = linspace01(n_steps, dev)
    x4 = (r_o[:, None] + r_d[:, None] * (near[:, None] * (1 - t) + far[:, None] * t)[..., None]
          ).reshape(-1, 3).contiguous()
    captured = []
    real_vjp = fused_nablas_vjp.forward_with_nablas_vjp

    def capture(surf, x):
        captured.append(x.detach().clone())
        return real_vjp(surf, x)
    model.zero_grad(set_to_none=True)
    with mock.patch.object(fused_nablas_vjp, "forward_with_nablas_vjp", capture):
        get_ray_loss_fn(targs, model, kw_train)(rb, torch.Generator(dev).manual_seed(seed),
                                                it=S)[0].backward()
    model.zero_grad(set_to_none=True)
    x1 = captured[0]
    M4, M1 = x4.shape[0], x1.shape[0]
    g3 = torch.Generator(dev).manual_seed(seed + 2)
    cots = (torch.randn(M1, device=dev, generator=g3), torch.randn(M1, 3, device=dev, generator=g3),
            torch.randn(M1, surface.W_geo_feat, device=dev, generator=g3))
    ws, bs = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    specs = {
        "sdf_forward": (lambda: fused_mlp.fused_sdf_forward(surface, x4),
                        lambda: fused_mlp.sdf_forward_plain(surface, x4),
                        _bounds(2.0 * _surface_macs(surface, sdf_only=True) * M4,
                                4.0 * (M4 * 4 + n_par)), M4),
        "nablas_forward": (lambda: fused_nablas.fused_forward_with_nablas(surface, x1),
                           lambda: fused_nablas.forward_with_nablas_plain(surface, x1),
                           _bounds(2.0 * _surface_macs(surface) * M1,
                                   4.0 * (M1 * (3 + 4 + surface.W_geo_feat) + n_par)), M1),
        "nablas_backward": (lambda: fused_nablas_vjp.fused_nablas_vjp(surface, x1, ws, bs, *cots),
                            lambda: fused_nablas_vjp.nablas_vjp_plain(surface, x1, ws, bs, *cots),
                            _bounds(2.0 * _surface_macs(surface, backward=True) * M1,
                                    4.0 * (M1 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                                           + 2 * n_par)), M1),
    }
    fields = {}
    for name, (fn, plain, bb, M) in specs.items():
        ms = _time_ms(fn)
        with torch.no_grad():
            pms = _time_ms(plain, reps=3)
        fields[name] = {"ms_unisurf": ms, "plain_ms_unisurf": pms,
                        "bound_ms_unisurf": bb[1][0], "bound_by_unisurf": bb[1][1],
                        "points_unisurf": M}
        print(f"phase 26: {name} {M} points (UNISURF step): {ms:.3f} ms (plain {pms:.3f} ms, "
              f"fp32 bound {bb[0][0]:.3f} ms, 3xTF32 bound {bb[1][0]:.3f} ms) {tag}")
    print(f"phase 26: median {ms_step:.2f} ms per UNISURF step over steps 6-{S}, "
          f"{N * 1e3 / ms_step:.0f} rays/s; s per UNISURF {H}x{W} frame "
          f"{[round(v, 4) for v in frames['seconds']]}; seconds to load the "
          f"{DTU_SHAPE[0]}-view {DTU_SHAPE[1]}x{DTU_SHAPE[2]} DTU scene and its val copy "
          f"{load_s['DTU']:.3f} {tag}")
    parts = {"root find (whole)": (unisurf, "root_finding_surface_points"),
             "sdf_forward (root find)": (fused_mlp, "fused_sdf_forward")}
    step_total, split, busy = _step_split(
        targs, dev, {**parts, "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward")}, tree=final_tree)
    glue = split["root find (whole)"] - split["sdf_forward (root find)"]
    rest = step_total - sum(v for k, v in split.items() if k != "sdf_forward (root find)")
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 26: one UNISURF step ({N} rays, phase 23's final weights) {step_total:.2f} "
          "ms: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the root find's glue {glue:.2f} ms, the rest (radiance backward, compositing, "
          f"loss, glue) {rest:.2f} ms; device over three steps {busy} {tag}")
    frame_ms, fsplit = _frame_split(
        render_view.render_frames, vargs,
        {**parts, "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
         "radiance_net": (RadianceNet, "forward")})
    frest = frame_ms - sum(v for k, v in fsplit.items() if k != "sdf_forward (root find)")
    print(f"phase 26: one {H}x{W} UNISURF frame (phase 23's final checkpoint) {frame_ms:.2f} "
          "ms wall: " + ", ".join(f"{k} {v:.2f} ms" for k, v in fsplit.items())
          + f", everything else {frest:.2f} ms {tag}")
    return 0, fields


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
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, make_volume_render_fn
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.ops import (_build, fused_fine_sample, fused_mlp, fused_nablas,
                                        fused_nablas_vjp, fused_upsample, surface_pack)
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

    # the kernels are checked on a copy with noise on every weight
    c = render_chunk_inputs(seed, dev)
    model, checked, kw_test = c["model"], c["checked"], c["kw_test"]
    scene, o_all, d_all_dirs, t, u_det = (c["scene"], c["o_all"], c["d_all_dirs"], c["t"],
                                          c["u_det"])
    rays_o, rays_d, d_coarse = c["rays_o"], c["rays_d"], c["d_coarse"]
    surface = checked.implicit_surface

    # ---- phase 2: kernel 1 on one render chunk's points (sections + mids)
    x = kernel1_points(surface, c)
    ok, errs = nablas_check(surface, x, "phase 2")
    octave = _octave_effect(surface, x[:65536])
    print("phase 2: zeroing the octave columns would move sdf, nablas, h by up to "
          + ", ".join(f"{v:.3e}" for v in octave))
    if not ok:
        print("FAIL phase 2: nablas_forward disagrees with its plain version", file=sys.stderr)
        return 1

    # ---- phase 3: kernel 2 against its plain version, det and perturb
    ok, k2_err = upsample_checks(surface, c, "phase 3")
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
    ms2 = _time_ms(lambda: fused_upsample.fused_neus_upsample(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    pms2 = _time_ms(lambda: fused_upsample.neus_upsample_plain(
        surface, rays_o, rays_d, d_coarse, u_det, n_iters=4, n_per_iter=16))
    flops2 = 2.0 * _surface_macs(surface, sdf_only=True) * 4096 * 128
    bytes2 = 4.0 * (4096 * (6 + 64 + 64 + 128)
                    + sum(p.numel() for p in surface.parameters()))
    bb2 = _bounds(flops2, bytes2)
    print(f"phase 5: nablas_forward {M} points: {ms1:.3f} ms (plain {pms1:.3f} ms, "
          f"fp32 bound {bb1[0][0]:.3f} ms, 3xTF32 bound {bb1[1][0]:.3f} ms, {flops1 / 1e9:.1f} "
          f"GFLOP) {tag}")
    print(f"phase 5: neus_upsample 4096 rays: {ms2:.3f} ms (plain {pms2:.3f} ms, "
          f"fp32 bound {bb2[0][0]:.3f} ms, 3xTF32 bound {bb2[1][0]:.3f} ms, "
          f"{flops2 / 1e9:.1f} GFLOP) {tag}")
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

    loss_k, loss_p, step_ratios = _step_grad_check(checked, ray_loss, rb, d_all=d7)
    worst = max(step_ratios, key=step_ratios.get)
    print(f"phase 7: step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad leaf "
          f"{worst} {step_ratios[worst]:.2e} over {len(step_ratios)} leaves")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or step_ratios[worst] > 5e-4:
        print("FAIL phase 7: the step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1

    # ---- phase 8: the training slice through train.py (its directory stays
    # for phase 13)
    targs = ConfigDict(_train_config(os.path.join(work.name, "train"), seed))
    out, launches, step_ms, _ = _train_timed(targs, zero_counts, read_counts)
    by_path["train"] = launches
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

    # ---- phase 9: kernels 1 and 2 at a step's shapes, kernel 3's time, one step split
    ms1_step = _time_ms(lambda: fused_nablas.fused_forward_with_nablas(surface, x3))
    bb1_step = _bounds(2.0 * _surface_macs(surface) * M3,
                       4.0 * (M3 * (3 + 1 + 3 + surface.W_geo_feat)
                              + sum(p.numel() for p in surface.parameters())))
    ms2_step = _time_ms(lambda: fused_upsample.fused_neus_upsample(
        surface, r_o, r_d, d_c, u_det[:512], n_iters=4, n_per_iter=16))
    bb2_step = _bounds(2.0 * _surface_macs(surface, sdf_only=True) * 512 * 128,
                       4.0 * (512 * (6 + 64 + 64 + 128)
                              + sum(p.numel() for p in surface.parameters())))
    print(f"phase 9: nablas_forward {M3} points: {ms1_step:.3f} ms (fp32 bound "
          f"{bb1_step[0][0]:.3f} ms, 3xTF32 bound {bb1_step[1][0]:.3f} ms); neus_upsample 512 "
          f"rays: {ms2_step:.3f} ms (fp32 bound {bb2_step[0][0]:.3f} ms, 3xTF32 bound "
          f"{bb2_step[1][0]:.3f} ms) {tag}")

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
    rc, siren_rows = _siren_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                   work.name)
    if rc:
        return rc
    rc, unisurf_fields = _unisurf_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                         work.name)
    if rc:
        return rc

    results = [
        {"name": "nablas_forward", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/nablas_forward.cu",
         "replaces": "neurecon_tpu/ops/fused_nablas.py:74",
         "launches": launches["nablas_forward"], "max_abs_err": max(errs),
         "ms": ms1, "plain_ms": pms1, **_bound_fields(*bb1, "3xtf32"),
         "library_ms": None, "ms_130560": ms1_step, "bound_ms_130560": bb1_step[1][0]},
        {"name": "neus_upsample", "route": "cuda",
         "source": "neurecon_tpu_torch/csrc/neus_upsample.cu",
         "replaces": "neurecon_tpu/ops/fused_upsample.py:272",
         "launches": launches["neus_upsample"], "max_abs_err": k2_err["det"],
         "ms": ms2, "plain_ms": pms2, **_bound_fields(*bb2, "3xtf32"),
         "library_ms": None, "ms_512_rays": ms2_step, "bound_ms_512_rays": bb2_step[1][0]},
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
        r["branch"] = "softplus" if r["name"] in counters and "volsdf" not in r["name"] else "-"
        # a Softplus row counts no launch of its kernel's sine instantiation
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()
                                 if r["branch"] != "softplus" or not p.startswith("volsdf_siren")}
        r.update(unisurf_fields.get(r["name"], {}))
    results += siren_rows
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

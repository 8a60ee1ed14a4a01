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

27. NeuS without a mask at configs/synthetic_quality_nomask.yaml's widths
   (`NEUS_NOMASK`, held equal to the file by tests/test_torch_nerfpp.py; the
   NeRF++ background net, D=8 W=256, on the midpoints and 32 samples beyond
   the sphere), seeded noise on every weight, the background's included: a
   2,048-ray patch of the 240x320 envmap view through kernels 1 and 2
   against the plain versions (rgb and acc within 2e-3, the background's
   sigma and rgb at the samples beyond the sphere within 1e-5); the step's
   loss and every gradient leaf on 512 rays with fixed d_all and outside
   jitter (loss rel 1e-5, each leaf within `NOMASK_GRAD_GATE` of its
   max|ref|); a ray through the exact origin (a midpoint at |x| = 0), every
   gradient finite.
28. `train.py` on the same config (cuts printed: 60 steps, warm-up 10,
   validation at steps 0 and 30 at the file's val_downscale 2, a 256^3
   mesh at step 30): kernels 1-3 once a step (and kernels 1 and 2 per
   validation chunk) exactly, every loss finite, the last 10 steps' mean
   below the first 10's; median ms per step over steps 6-60, rays/s; two
   240x320 frames through `render_view` (exact launches, finite); one step
   split by CUDA events with the background net's forward and backward as
   their own parts, beside its fp32 bound, and the device's busy share.
29. VolSDF with nerf++ (`VOLSDF_NERFPP`, configs/volsdf_nerfpp.yaml as the
   file holds it) read from the synthetic envmap scene written in DTU's
   layout (8 views at 1200x1600, scale_radius 3.0): kernels (a)-(c) against
   the plain sampler on 1,024 rays whose fars come from the sphere (768 of
   view 0, far 3-5.7; 128 leaving it, far ~0.3-1; 128 from outside it that
   miss it, far 0), beta_net 0.1 / 0.01 / 0.001, det and perturb, end to end
   per far band at phase 14's gates and in lockstep; the step's gradient on
   1,024 rays with fixed fine samples, eikonal points and outside jitter
   (phase 16's gates); `train.py` 40 steps (cut from 100,000; validation and
   a 128^3 mesh at step 20) with exact launches (a step: 1 + 1 + 5 of
   (a)-(c), 6 of kernel 4, one of kernels 1 and 3), finite losses that fall;
   median ms per step; two 120x160 frames (`--downscale 10`, exact
   launches); one step split as phase 28's.
30. Ray-parallel training (`neurecon_tpu_torch/parallel/`): `train.py` run
   as ranks of this script (`--rank-job`), started by the port's launcher
   under torchrun's variables, each rank with its own launch counters,
   every group with a time limit (`DDP_TIMEOUT`). (1) One rank over NCCL at
   phase 8's config and seed, with a profiler window over steps 10-11:
   every step's loss within rel 1e-5 of phase 8's and each parameter leaf
   as the tests hold Adam runs (at most 1% of its elements beyond 1e-3 of
   its move, none beyond 0.1; bit-equality is printed), kernels 1-3 on
   every step and kernel 4 for the mesh; its median ms per step against
   phase 8's (the one-rank group's cost) and the window's device idle
   share. (2) Two ranks on the one card over gloo, 10 NeuS steps at 512
   rays (a mesh at step 5): each rank launches kernels 1-3 every step,
   only rank 0 kernel 4; rank 1 starts from other weights, and after the
   first broadcast both ranks hold the same surface pack, made anew and
   equal to a fresh pack; the ranks' global losses are equal and within
   `DDP_LOSS_REL` of the one-rank run's first 10. (3) In the same ranks,
   5 VolSDF steps at `VOLSDF`'s widths and 1,024 rays: kernel 4 and
   (a)-(c) on every step of each rank. (4) Where more than one card is
   visible, one rank a card over NCCL, 10 steps, the same checks (not
   reached on a one-card machine).
31. The sharded validation render: the same two ranks render a 120x160
   NeuS frame (the flagship net with seeded noise, det, rayschunk 4,096)
   split by pixel; the gathered frame against the one-rank frame (every
   output within `FRAME_ATOL`), kernels 1 and 2 launched on each rank.

32. The pipelined trainer (`training.overlap_sampler`, steps_per_call
   `PIPE_K`) at phase 8's config, seed and cuts: `PIPE_LR0_STEPS` steps at
   lr 0 pipelined and standard through train.py, every step's loss and
   every final parameter bit-equal; then the 60 trained steps with a
   profiler window over steps 12-13 (`PIPE_WINDOW`): the launches of phase
   8's run exactly, kernel 2 on the side stream in the trace
   (`stream_overlap`) and no sampler kernel on the main stream, finite losses whose last 10 steps' mean is below the
   first 10's; the median ms per step against phase 8's, and the device
   time in which the side stream's kernels overlap the main stream's.
33. The same at phase 16's VolSDF config and cuts (kernel 4 and (a)-(c) on
   the side stream; the sampler's overlapped share).
34. The same at phase 23's UNISURF config and cuts, read from phase 22's
   DTU-layout scene (the root find's march and eight secant launches of
   kernel 4 on the side stream; the window's idle share).
35. NeuS's `direct_use` and `direct_more` upsamplers on the flagship NeuS
   with seeded noise: d_all through kernel 4 against the plain query on
   4,096 rays, det and perturb, at phase 3's gate (one kernel-4 launch a
   call); a 2,048-ray patch against the plain render (rgb 2e-3);
   `DIRECT_STEPS` training steps each through train.py (kernels 4, 1 and 3
   once a step, kernel 2 never; a falling loss) and a 120x160 frame of the
   result (5 chunks: kernels 4 and 1 five times); ms per step and s per
   frame.
36. The tools' card paths: `vis_surface_and_cam`'s mesh of phase 8's final
   checkpoint (128^3 through kernel 4) against the plain grid's (Chamfer
   below 1e-3 of the volume); `test_volsdf_algo --load_pt` on phase 16's
   final checkpoint, the probe ray's fine samples through kernel 4 and
   (a)-(c) against the plain sampler at phase 14's gates; `supervise`
   around a 4-step pipelined train.py run in a child process, which must
   exit 0 with its final checkpoint; the number halves of the other tools on
   the card (`test_volsdf_algo`'s closed-form oracle: the bound above the
   error, 64 finite fine depths; `plot_neus_bias`'s NeuS peaks within a
   sample spacing of the first surface; `vis_ray`'s probe rays from the
   camera centres, of unit length); the figures are not drawn (the card
   machine has no matplotlib: a figure raises an error that says so).

37. JPEG scans: the BlendedMVS-layout envmap scene (`BLENDED_SHAPE`: 8
   views at BlendedMVS's 576x768) and a custom-layout one (images/*.jpg,
   cam.json, PNG masks), each written as JPEG by `write_jpeg` (q95, 4:2:0)
   and as PNG; both loaded through `get_data` by the port's readers: the
   decoded rgb's PSNR against the arrays written at least
   `JPEG_PSNR_GATE`, cameras and masks equal to the PNG scene's, the log
   naming utils/jpeg.py's route and no imageio, PIL or cv2 in sys.modules;
   the decode ms of a frame; then `train.py` on configs/neus_nomask_blended
   .yaml and configs/volsdf_nerfpp_blended.yaml as the files hold them
   (`NEUS_NOMASK_BLENDED`, `VOLSDF_NERFPP_BLENDED`, held equal to the files
   by tests/test_torch_jpeg.py) read from the JPEG scene, cuts printed
   (`BLENDED_STEPS` steps, one validation at the files' val_downscale 4, a
   64^3 mesh; NeuS's warm-up 10 steps): exact launches, finite losses that
   fall; ms per step and rays/s.
38. The NeRF-like head (`W_geometry_feature` -1) on the flagship NeuS:
   kernels 2 and 4 against their plain versions on a perturbed copy
   (phase 3's and phase 10's gates), kernels 1 and 3 refusing it; 20 steps
   through train.py (kernel 2 once a step, kernels 1 and 3 never: the
   nablas and the eikonal run on autograd; kernel 4 for a 64^3 mesh),
   finite losses that fall; one 120x160 frame through render_view;
   `ScalarField` on the card within 1e-5 of its CPU result.
39. The seven probes under neurecon_tpu_torch/tools/ (`bench_ablate`,
   `bench_volsdf_ablate`, `bench_render_cull`, `bench_fused_upsample`,
   `bench_gradblock`, `bench_roadmap`, `probe_lax_map`) through their `main`
   at a cut --K: their JSON rows, and their correctness rows as gates
   (kernel 2's agreement at phase 3's bound, the culled frame's PSNR, the
   microchunk walk bit-equal).
40. Surfaces wider than 256 (the kernels' wide tile, csrc/surface_mma.cuh):
   kernels 1, 2, 3 and 4 on the flagship NeuS at IDR's widths (`IDR_CHIP`:
   surface and radiance W = 512) with seeded noise on every weight, against
   their plain versions at the gates of phases 2 (on the chunk's first
   `WIDE_K1_RAYS` rays' points: the plain version's autograd at 1,044,480
   points would hold ~80 GB), 3, 6 and 10 (also at W = 300 and 384,
   `WIDTHS_K4`, whose column groups are partly or wholly empty); the whole
   step's gradient at phase 7's gates; the VolSDF sampler on
   configs/volsdf.yaml with surface W 512 (1,024 rays): at beta_net 0.1
   phase 14's gates, at 0.01 and 0.001 each kernel in lockstep at phase
   14's gates and the end to end against the plain sampler with a float64
   sdf query (`_sampler_witness`: at this width two fp32 routes part by
   more than phase 14's end-to-end gates at a sharp beta, so the kernels may
   be farther from the float64 witness than the plain fp32 sampler is by
   at most those gates); each kernel's time beside its plain version's and
   its bounds at the shapes of PERF.md's table (`_surface_times`). (A W =
   520 surface, refused here before the cluster tile, now runs on it; phase
   42 holds the refusal past 1024.)
41. configs/neus_w512.yaml (`NEUS_W512`, held equal to the file by
   tests/test_torch_wide.py) through train.py on the synthetic scene, cuts
   printed (`WIDE_STEPS` steps, validation at step 0, a 128^3 mesh at step
   20, warm-up 10 steps): launches, finite losses that fall, ms per step and
   rays/s, one step split by CUDA events around kernels 1-3 and the
   radiance net and the device's busy share; one 120x160 frame of the final checkpoint through render_view and
   a 256^3 `extract_surface`, closed, with s per frame and s per mesh.
42. surfaces wider than 512, on the kernels' cluster tile (a pair of wide
   blocks on one tile, each holding half of every layer's rows;
   `cluster_kernel_checks`, which tools/mutants.py's `cluster` group runs):
   the flagship chip config with the surface at 1024 and the radiance net
   at 512 (`W1024_CHIP`, configs/neus_w1024.yaml's widths), perturbed,
   against the plain versions at phase 2's gates on the whole render chunk
   (1,044,480 points; the plain version in pieces of 65,280), phase 3's
   (and phase 3's on all 4,096 rays with the sphere prior: the perturbed
   surface meets no zero on them without it), phase 6's at a step's 130,560
   points and phase 10's at 2^20 points; the
   same kernels at W=640 (two blocks of 320 rows) at smaller shapes;
   kernels 1 and 3 on 256 hidden columns and 520 geometry features (the
   final layer's rows past 512 in block 1); the step gradient at phase 7's
   gates; a W = 1032 surface refused by all four kernels with no launch
   counted; each kernel's time beside its plain version's and its bounds at
   the shapes of PERF.md's table (`_surface_times`). No VolSDF sampler check
   at this width: kernel 4, which the sampler queries, is checked here, and
   phase 40 holds the sampler at 512.
43. configs/neus_w1024.yaml (`NEUS_W1024`, held equal to the file by
   tests/test_torch_cluster.py) through train.py on the synthetic scene,
   cuts printed (`CLUSTER_STEPS` steps, validation at step 0, a 128^3 mesh
   at step 10, warm-up 10 steps): launches, finite losses that fall, ms per
   step and rays/s, one step split as phase 41 splits it; one 120x160 frame
   of the final checkpoint through render_view with `--microchunk`
   (`CLUSTER_MICROCHUNK` rays a block of each 4,096-ray chunk), its peak
   device memory, and a 256^3 `extract_surface`, closed.

Phases 1-29 and 32-43 run in this process on one card (no launcher: a
world of one); phases 30-31 set CUDA_VISIBLE_DEVICES to its first card, but
for (4).

Every path above is driven with the kernels' launch counters set to 0 just
before it and read just after. Prints one JSON line of per-kernel results
(`launches` from each slice's training run: phase 8 for kernels 1-4, phase
16 for (a)-(c), phase 20 for the sine branch, whose rows are named
`<kernel>[sine]`; `launches_by_path` for each path, `unisurf_train`,
`unisurf_render`, `nomask_train`, `volsdf_nerfpp_train`, and phases 30-31's
`ddp1_train`, `ddp2_train_rank<r>`, `ddp2_volsdf_rank<r>` and
`sharded_render_rank<r>` among them, and phases 32-36's
`pipelined_<framework>_train`, `pipelined_<framework>_lr0`,
`direct_<use|more>_train`, `direct_<use|more>_render`,
`vis_surface_and_cam` and `test_volsdf_algo`, and phases 37-39's
`jpeg_<config>_train`, `nerf_head_train`, `nerf_head_render_view` and
`probes`, and phase 41's `wide_train`, `wide_render_view` and
`wide_extract_surface`, which only the wide rows `<kernel>[wide]` count
(their `launches` from phase 41's training run), and phase 43's
`cluster_train`, `cluster_render_view` and `cluster_extract_surface`, which
only the cluster rows `<kernel>[cluster]` count (their `launches` from phase
43's training run); the surface-MLP rows held to their 3xTF32
bounds, `bound_held_to`; kernel 1's `ms_130560` and kernel 2's `ms_512_rays`
at a training step's shapes; kernels 4, 1 and 3's `ms_unisurf` at UNISURF's),
then the run's wall seconds, then, as the last line, {"ok": true, "device":
{...}}. Needs the repository
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


def _queued_ms(fn, calls, reps=10):
    """Device ms of `calls` calls of `fn`, averaged over `reps` groups of
    them, all queued behind a spin kernel so that the card, not the host,
    paces them; after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e7))
    a.record()
    for _ in range(reps * calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


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


def render_chunk_inputs(seed, dev, cfg=FLAGSHIP):
    """Phases 2-7's inputs: the flagship NeuS (or the NeuS of `cfg`) from the
    port's geometric init (`seed`), its copy with seeded noise on every
    weight (`checked`, seed + 1: the geometric init zeroes the octave
    columns), and one render chunk
    of the synthetic scene: 4,096 rays spread over a 120x160 frame (every
    ~4.7th pixel), their 64 coarse depths and the det and perturb uniforms
    of 4 rounds of 16."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, _uniforms
    from neurecon_tpu_torch.ops import get_rays

    model, _, kw_test, _ = get_model(ConfigDict(cfg), dev, seed=seed)
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


def nablas_check(surface, x, label, report=print, piece=None):
    """Phase 2: kernel 1 against its plain version on x and on 4,099 points
    uniform in [-1, 1]^3 (a ragged last tile); before each call, NaN fills
    blocks of the outputs' sizes, which the outputs are likely to be given,
    so an unwritten entry cannot pass for a right one. sdf and h within
    1e-4, nablas within 2e-4 + 2e-3 |ref|, all finite; and the mean |diff|
    of sdf and of h each within 1e-5 of the plain values' mean |value|: the
    split-fp32 product's precision (the wgmma tile with one truncating
    accumulator over each layer, never promoted into the fp32 sums, reads
    3.6e-5 and 2.3e-5 there on the render chunk, the kernel 2.4e-6 and
    1.6e-6, while its largest |diff| stays under 1e-4). `piece`: the plain
    version runs on that many points at a time (its autograd holds every
    layer's activations), the kernel on all of x. Returns (ok, [max|diff| of
    sdf, nablas, h] over both)."""
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
            if piece is None:
                ref = fused_nablas.forward_with_nablas_plain(surface, pts)
            else:
                ref = [torch.cat(parts) for parts in zip(*(
                    fused_nablas.forward_with_nablas_plain(surface, pts[i:i + piece])
                    for i in range(0, M, piece)))]
        torch.cuda.synchronize()
        e = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        nab_ok = bool(((got[1] - ref[1]).abs() <= 2e-4 + 2e-3 * ref[1].abs()).all())
        mean = [float((got[i] - ref[i]).abs().mean() / ref[i].abs().mean()) for i in (0, 2)]
        report(f"{label}: nablas_forward on {M} points: max|diff| sdf {e[0]:.3e}, "
               f"nablas {e[1]:.3e}, h {e[2]:.3e}; mean|diff| / mean|ref| sdf {mean[0]:.2e}, "
               f"h {mean[1]:.2e} (gate 1e-5)")
        ok = ok and (e[0] <= 1e-4 and e[2] <= 1e-4 and nab_ok and max(mean) <= 1e-5
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


def _launch_counters():
    """({kernel: its wrapper, whose `launches` counts its launches}, a
    function that sets every count to 0, one that reads them)."""
    from neurecon_tpu_torch.ops import (fused_fine_sample, fused_mlp, fused_nablas,
                                        fused_nablas_vjp, fused_upsample)
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
    return counters, zero_counts, read_counts


def _kernel1_narrow(label, narrow0, launches):
    """Phases 4, 8, 15, 16 and 23 (the surface widths of the benchmark's five
    cells): every kernel-1 launch of the run took the narrow tile's wgmma
    pipeline (`fused_forward_with_nablas.launches_by_tile["narrow"]`, read
    against `narrow0`, its count before the run). Returns whether it did."""
    from neurecon_tpu_torch.ops import fused_nablas

    narrow = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"] - narrow0
    print(f"{label}: kernel 1's launches on the narrow tile's wgmma pipeline {narrow} of "
          f"{launches['nablas_forward']}")
    return narrow == launches["nablas_forward"] > 0


def _train_timed(targs, zero_counts, read_counts, around_make=None, order="side"):
    """train.py's `main_function` on `targs` on the card, with a CUDA event
    recorded at the start of every step, the kernels' launch counters set to
    0 just before and read just after (`around_make(make_pipelined_train_step,
    *args)`, if given, makes train.py's step in place of
    `make_pipelined_train_step`). `order`: "side", as train.py runs (the
    pipelined step's sampler on a second stream); "serial", the sampler on
    the current stream, in the same host order; "stress", every sampler
    call held back by a spin kernel of `STRESS_SPIN` cycles ahead of it on
    its stream, so that on the side stream the backward, Adam and the next
    forward run first, and an ordering the step leaves out shows in its
    numbers. Returns (its result, the launch counts, each step's ms up to
    the next step's start or the run's end, the run's wall seconds)."""
    from neurecon_tpu_torch import train, training

    starts = []
    real_make_step = train.make_pipelined_train_step

    def make_step_timed(*a, **k):
        if order == "stress":
            fns = dict(a[0])
            sample = fns["depth_sample"]

            def held_back(rb, draws):
                torch.cuda._sleep(STRESS_SPIN)
                return sample(rb, draws)
            fns["depth_sample"] = held_back
            a = (fns,) + a[1:]
        step = (around_make(real_make_step, *a, **k) if around_make
                else real_make_step(*a, **k))

        def timed_step(*sa, **sk):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            starts.append(ev)
            return step(*sa, **sk)
        return timed_step

    new_stream = torch.cuda.current_stream if order == "serial" else training._new_stream
    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(train, "make_pipelined_train_step", make_step_timed), \
            mock.patch.object(training, "_new_stream", new_stream):
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


@contextlib.contextmanager
def _backward_span(net, spans):
    """CUDA events around `net`'s share of each backward: from the first
    cotangent that reaches one of its forward's outputs to the accumulation
    of its first point layer's weight gradient, the last one its backward
    computes (other backward work queued in between counts too)."""
    cls = type(net)
    fwd = cls.forward
    pending = []

    def forward(self, *a, **k):
        out = fwd(self, *a, **k)
        if self is net and torch.is_grad_enabled():
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            started = []

            def start(grad):
                if not started:
                    ev[0].record()
                    started.append(True)
            for t in out:
                t.register_hook(start)
            pending.append(ev)
        return out

    def done(param):
        if pending:
            ev = pending.pop(0)
            ev[1].record()
            spans.append(ev)

    handle = net.pts_linears[0].w.register_post_accumulate_grad_hook(done)
    try:
        with mock.patch.object(cls, "forward", forward):
            yield
    finally:
        handle.remove()


def _step_split(args, dev, parts, n_warm=3, tree=None, backward_of=None):
    """One training step split by CUDA events around each call of the
    `parts` ({name: (module or class, attribute)}; "adam_step" is the
    optimizer's step) and around the backward of each net of `backward_of`
    ({name: the model's attribute}, `_backward_span`), then the device's
    busy share over three more steps; the model from seed 0, or with the
    weights of `tree` (a JAX pytree of numpy arrays); returns (step ms,
    {part: ms}, busy share)."""
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
    backward_of = backward_of or {}
    spans = {k: [] for k in (*parts, *backward_of, "adam_step")}
    with contextlib.ExitStack() as stack:
        for k, (mod, attr) in parts.items():
            stack.enter_context(_spans(mod, attr, spans[k]))
        for k, attr in backward_of.items():
            stack.enter_context(_backward_span(getattr(model, attr), spans[k]))
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
          "bg_r": -1.0 if bg_r is None else bg_r}  # None: no background sphere (NeRF++)
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
    kw = {"n_final": n_final, "u_stride": u.shape[1], "eps": eps,
          "bg_r": -1.0 if bg_r is None else bg_r,
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


def volsdf_check_inputs(seed, dev, cfg=VOLSDF):
    """Phase 14's inputs: the VOLSDF model (or that of `cfg`) from the seed,
    a copy with seeded noise on every weight (seed + 1), the synthetic
    scene, its first view's rays, and 1,024 of them spread over the view
    with their far bounds.
    Returns (args, model, checked copy, (kw_train, kw_test), dataset,
    (o_all, d_all), (rays_o, rays_d, far))."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, volsdf
    from neurecon_tpu_torch.ops import get_rays

    args = ConfigDict(copy.deepcopy(cfg))
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    ds = get_data(args)
    o_all, d_all, _ = get_rays(torch.tensor(ds.c2w_all[0], device=dev),
                               torch.tensor(ds.intrinsics_all[0], device=dev), 120, 160)
    idx = torch.linspace(0, 120 * 160 - 1, 1024, device=dev).long()
    rays_o, rays_d, _, far = volsdf._ray_bounds(o_all[idx], d_all[idx], 0.0, 6.0)
    return args, model, checked, (kw_train, kw_test), ds, (o_all, d_all), (rays_o, rays_d, far)


def _volsdf_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir, record=None):
    """Phases 14-17 (the VolSDF slice); returns (rc, kernel rows, train launches).
    `record` (a dict) gets phase 16's median ms per step and final
    checkpoint."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, volsdf
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp
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
    k1_narrow0 = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"]
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    launches = by_path["volsdf_render_view"] = read_counts()
    print(f"phase 15: render_view VolSDF 2 x 120x160: launches {launches}, s/frame "
          f"{[round(v, 4) for v in frames['seconds']]} {tag}")
    if not _kernel1_narrow("phase 15", k1_narrow0, launches):
        print("FAIL phase 15: a VolSDF kernel-1 launch left the narrow tile", file=sys.stderr)
        return 1, None, None
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
    narrow0 = fused_mlp.fused_sdf_forward.launches_by_tile["narrow"]
    k1_narrow0 = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"]
    out, t_launches, step_ms, _ = _train_timed(targs, zero_counts, read_counts)
    by_path["volsdf_train"] = t_launches
    if not _kernel1_narrow("phase 16", k1_narrow0, t_launches):
        print("FAIL phase 16: a VolSDF kernel-1 launch left the narrow tile", file=sys.stderr)
        return 1, None, None
    narrow = fused_mlp.fused_sdf_forward.launches_by_tile["narrow"] - narrow0
    print(f"phase 16: kernel 4's launches on the narrow tile's wgmma pipeline {narrow} of "
          f"{t_launches['sdf_forward']}")
    if narrow != t_launches["sdf_forward"]:
        print("FAIL phase 16: a flagship VolSDF sdf query left the narrow tile", file=sys.stderr)
        return 1, None, None
    ms_step = float(np.median(step_ms[5:]))
    if record is not None:
        record.update(volsdf_ms=ms_step, volsdf_ckpt=out["final_ckpt"])
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
                   n_final=64, bg_r=3.0, bands=None):
    """Kernels (a)-(c) with kernel 4 against the plain sampler, end to end
    and each kernel in lockstep on its plain stage's inputs, with phase 14's
    gates, at each beta_net of `betas`, det and perturb uniforms; the
    background sphere of radius `bg_r` (None: none, as under NeRF++). Per
    ray band ({name: ray mask}; default all rays) the end-to-end gates: the
    share of fine depths beyond 1e-4 of the ray's far (a ray of far 0
    counts any difference), of beta maps off (rtol 1e-3, atol 1e-5) and of
    equal iter_usage. Returns (ok, {kernel: worst depth error}, (the last
    (alpha, beta), its uniforms))."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.sampling import linspace01

    dev = rays_o.device
    N = rays_o.shape[0]
    bands = bands or {"all": torch.ones(N, dtype=torch.bool, device=dev)}
    d_init = (far * linspace01(n0, dev)).contiguous()
    kw = {"eps": 0.1, "max_iter": max_iter, "max_bisection": 10, "n_final": n_final,
          "n_up": n_up, "sphere_bg_r": bg_r}
    ok, k_err = True, {}
    ab = (torch.tensor(1.0 / betas[0], device=dev), torch.tensor(betas[0], device=dev))
    with torch.no_grad():
        edges = _sampler_edges(surface, rays_o, rays_d, d_init, far, ab,
                               ffs.det_uniforms(n_final, 4, N, dev), n_final=n_final, bg_r=bg_r)
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
            off = ~(dd <= 1e-4 * far)
            beta_off = ~((gb - rb).abs() <= 1e-5 + 1e-3 * rb.abs())
            per_band = {name: {"rays": int(m.sum()),
                               "fine_share": float(off[m].float().mean()),
                               "beta_off_share": float(beta_off[m].float().mean()),
                               "iter_usage_equal": float((gi[m] == ri[m]).float().mean()),
                               "rounds (-1, 0..)": torch.bincount(
                                   (ri[m] + 1).long(), minlength=max_iter + 2).tolist()}
                        for name, m in bands.items()}
            with torch.no_grad():
                lock, merged_equal = _lockstep(surface, rays_o, rays_d, d_init, far, ab, u,
                                               n_up=n_up, max_iter=max_iter, n_final=n_final,
                                               bg_r=bg_r)
            print(f"{label}: sampler beta_net {beta} {mode}, {N} rays, "
                  f"{n0 + max_iter * n_up} depths: fine max|diff| {float(dd.max()):.3e}; "
                  f"per band {json.dumps(per_band)}; "
                  f"lockstep (each kernel on the plain stage's inputs) {json.dumps(lock)}; "
                  f"round-0 and merged depths equal {merged_equal}")
            for name, e in lock.items():
                k_err[name] = max(k_err.get(name, 0.0), e.get("fine", 0.0), e.get("depths", 0.0),
                                  e.get("next_depths", 0.0))
            finite = all(bool(torch.isfinite(t_).all()) for t_ in (gd, gb))
            if (any(b["fine_share"] > 0.02 or b["beta_off_share"] > 0.01
                    or b["iter_usage_equal"] < 0.9 for b in per_band.values())
                    or not finite or not _lockstep_ok(lock, merged_equal)):
                ok = False
            last = (ab, u)
    return ok, k_err, last


def _lockstep_ok(lock, merged_equal):
    """Phase 14's gates on `_lockstep`'s readings: every share within 0.01,
    sdf within 1e-5, no unsorted ray, the merged depths equal."""
    shares = [v for e in lock.values() for k, v in e.items() if k.endswith("share")]
    return (merged_equal and max(shares) <= 0.01
            and max(e.get("sdf", 0.0) for e in lock.values()) <= 1e-5
            and max(e.get("unsorted_rays", 0.0) for e in lock.values()) == 0)


def _end_shares(got, ref, far):
    """Phase 14's end-to-end readings of sampler outputs `got` against `ref`
    (fine depths, beta map, iter_usage): the share of fine depths beyond
    1e-4 of the ray's far, of rays whose beta map is off (rtol 1e-3, atol
    1e-5), of rays with equal iter_usage."""
    return {"fine_share": float((~((got[0] - ref[0]).abs() <= 1e-4 * far)).float().mean()),
            "beta_off_share": float(
                (~((got[1] - ref[1]).abs() <= 1e-5 + 1e-3 * ref[1].abs())).float().mean()),
            "iter_usage_equal": float((got[2] == ref[2]).float().mean())}


def _sampler_witness(surface, rays_o, rays_d, far, betas, n0, n_up, max_iter, seed, label,
                     n_final=64, bg_r=3.0):
    """Phase 14's check where fp32 does not reproduce itself. At a sharp
    beta_net the sampler turns ~1e-6 sdf differences into other fine depths
    (the 1 / beta scaling of its density), so two fp32 routes of one
    surface can part by more than phase 14's end-to-end gates (at IDR's
    W=512: PERF.md section 6, PR 15). Each kernel is held in lockstep on its
    plain stage's inputs at phase 14's gates, as `_sampler_check` holds it;
    and the end-to-end outputs of the kernels and of the plain sampler are
    each held against the plain sampler with a float64 sdf query rounded to
    fp32 (the witness): the kernels' readings may be worse than the plain
    fp32 sampler's own by at most phase 14's gates (0.02 of the fine
    depths, 0.01 of the beta maps, 0.1 of iter_usage). Det and perturb
    uniforms at each beta_net of `betas`. Returns (ok, [readings])."""
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops.sampling import linspace01

    dev, N = rays_o.device, rays_o.shape[0]
    d_init = (far * linspace01(n0, dev)).contiguous()
    kw = {"eps": 0.1, "max_iter": max_iter, "max_bisection": 10, "n_final": n_final,
          "n_up": n_up, "sphere_bg_r": bg_r}
    s64 = copy.deepcopy(surface).double()
    ok, rows = True, []
    for beta in betas:
        ab = (torch.tensor(1.0 / beta, device=dev), torch.tensor(beta, device=dev))
        for mode in ("det", "perturb"):
            u = (ffs.det_uniforms(n_final, max_iter + 2, N, dev) if mode == "det"
                 else torch.rand(N, (max_iter + 2) * n_final, device=dev,
                                 generator=torch.Generator(dev).manual_seed(seed + 3)))
            args = (surface, rays_o, rays_d, d_init, far, *ab, u)
            got = ffs.fused_fine_sample(*args, **kw)
            plain = ffs.fine_sample_plain(*args, **kw)
            with mock.patch.object(surface, "forward",
                                   lambda x: s64.forward(x.double()).float()):
                wit = ffs.fine_sample_plain(*args, **kw)
            torch.cuda.synchronize()
            with torch.no_grad():
                lock, merged_equal = _lockstep(surface, rays_o, rays_d, d_init, far, ab, u,
                                               n_up=n_up, max_iter=max_iter, n_final=n_final,
                                               bg_r=bg_r)
            k, p_ = _end_shares(got, wit, far), _end_shares(plain, wit, far)
            row = {"beta_net": beta, "uniforms": mode, "kernels_vs_plain": _end_shares(
                got, plain, far), "kernels_vs_witness": k, "plain_vs_witness": p_,
                "lockstep": lock, "merged_depths_equal": merged_equal}
            print(f"{label}: sampler beta_net {beta} {mode}, {N} rays: {json.dumps(row)}")
            rows.append(row)
            finite = all(bool(torch.isfinite(t_).all()) for t_ in got[:2])
            if (not finite or not _lockstep_ok(lock, merged_equal)
                    or k["fine_share"] > p_["fine_share"] + 0.02
                    or k["beta_off_share"] > p_["beta_off_share"] + 0.01
                    or k["iter_usage_equal"] < p_["iter_usage_equal"] - 0.1):
                ok = False
    return ok, rows


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


def _with_cuts(base, cuts):
    """A deep copy of the config `base` with each (dotted key, value) of
    `cuts` set."""
    cfg = copy.deepcopy(base)
    for key, value in cuts:
        *path, last = key.split(".")
        node = cfg
        for p in path:
            node = node[p]
        node[last] = value
    return cfg


def unisurf_train_config(data_dir, exp_root, seed):
    """configs/unisurf.yaml with phase 23's cuts, and the cuts as
    (dotted key, value) pairs (printed by the phase)."""
    cuts = [("data.data_dir", data_dir), ("training.num_iters", UNISURF_STEPS),
            ("training.i_val", UNISURF_STEPS // 2), ("training.i_val_mesh", UNISURF_STEPS // 2),
            ("data.mesh_N", 128), ("training.exp_dir", os.path.join(exp_root, "run")),
            ("training.log_root_dir", exp_root), ("training.i_log", 10),
            ("training.i_backup", UNISURF_STEPS // 2), ("training.monitoring", "none"),
            ("expname", "chip_smoke_unisurf"), ("seed", seed)]
    return _with_cuts(UNISURF, cuts), cuts


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


# the example tables of ITU-T T.81 Annex K (libjpeg's defaults): quantisation
# at quality 50 in natural order, and the Huffman tables as (counts of codes
# of each length 1-16, the symbols in code order); of the AC tables only the
# symbols of codes shorter than 16 bits are listed, the 16-bit codes take
# the remaining symbols in increasing order
_JPEG_QT = (np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                      14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                      18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                      49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
            np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                      24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                     + [99] * 32))
_JPEG_DC = (([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
            ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))))
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16) for s in range(1, 11)]


def _ac_table(counts, short):
    short = list(bytes.fromhex(short))
    return counts, short + sorted(set(_AC_SYMBOLS) - set(short))


_JPEG_AC = (_ac_table([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
                      "010203000411051221314106135161072271143281"
                      "91a10823 42b1c11552d1f024336272 82".replace(" ", "")),
            _ac_table([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
                      "00010203110405213106124151076171132232810814"
                      "4291a1b1c109233352f0156272d10a162434e125f1"))
_JPEG_SUBSAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2)}


def _zigzag():
    return np.array(sorted(range(64), key=lambda i: (i // 8 + i % 8,
                                                     i // 8 if (i // 8 + i % 8) % 2 else i % 8)))


def _huff_codes(counts, symbols):
    """{symbol: (code, length)} of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _category(v):
    """JPEG's magnitude category of int array v (bits of |v|) and the extra
    bits that follow its code (v, or v - 1 masked, for v < 0)."""
    mag = np.abs(v)
    s = np.zeros(v.shape, np.int64)
    nz = mag > 0
    s[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def _pack_bits(vals, nbits):
    """Items of `nbits` bits (MSB first) -> bytes, padded with 1 bits to a
    byte, 0xFF stuffed with 0x00."""
    total = int(nbits.sum())
    start = np.cumsum(nbits) - nbits
    item = np.repeat(np.arange(len(vals)), nbits)
    j = np.arange(total) - start[item]
    bits = (vals[item] >> (nbits[item] - 1 - j)) & 1
    bits = np.concatenate([bits, np.ones((-total) % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def write_jpeg(path, img, quality=95, subsampling="4:2:0", restart=0):
    """Write uint8 `img` ([H, W, 3] RGB, or [H, W] grey) as a baseline JPEG
    with numpy and the standard library: the Annex K quantisation tables
    scaled by `quality` as libjpeg scales them, YCbCr with the chroma
    box-averaged to `subsampling` ("4:4:4", "4:2:2", "4:2:0", "4:4:0"; the
    luma factors 1x1, 2x1, 2x2, 1x2), an orthonormal float FDCT, the
    standard Huffman tables, one interleaved scan, and a restart marker
    every `restart` MCUs (0: none). Edges are padded by replication."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                           and img.shape[-1] != 3):
        raise ValueError(f"write_jpeg: want uint8 [H, W] or [H, W, 3], got {img.dtype} "
                         f"{img.shape}")
    H, W = img.shape[:2]
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qts = [np.clip((t * scale + 50) // 100, 1, 255) for t in _JPEG_QT]
    x = img.astype(np.float64)
    if img.ndim == 2:
        planes, factors, tables = [x], [(1, 1)], [0]
    else:
        R, G, B = x[..., 0], x[..., 1], x[..., 2]
        planes = [0.299 * R + 0.587 * G + 0.114 * B,
                  128 - 0.168736 * R - 0.331264 * G + 0.5 * B,
                  128 + 0.5 * R - 0.418688 * G - 0.081312 * B]
        factors = [_JPEG_SUBSAMPLING[subsampling], (1, 1), (1, 1)]
        tables = [0, 1, 1]
    hmax, vmax = factors[0]
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    zz = _zigzag()
    n = np.arange(8)
    C = np.sqrt(np.where(n[:, None] == 0, 1 / 8, 2 / 8)) * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    coefs, shapes = [], []
    for plane, (h, v), t in zip(planes, factors, tables):
        plane = np.pad(plane, ((0, my * 8 * vmax - H), (0, mx * 8 * hmax - W)), mode="edge")
        fy, fx = vmax // v, hmax // h
        plane = plane.reshape(plane.shape[0] // fy, fy, plane.shape[1] // fx, fx).mean((1, 3))
        by, bx = plane.shape[0] // 8, plane.shape[1] // 8
        blk = plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3) - 128.0
        F = np.einsum("ux,abxy,vy->abuv", C, blk, C).reshape(by, bx, 64)
        q = np.round(F / qts[t]).astype(np.int64)
        coefs.append(np.clip(q[..., zz], -1023, 1023))
        shapes.append((v, h))
    # blocks in scan order: MCU by MCU, in each the components' v x h blocks
    seq_blocks, seq_comp = [], []
    for k, (c, (v, h)) in enumerate(zip(coefs, shapes)):
        b = c.reshape(my, v, mx, h, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, v * h, 64)
        seq_blocks.append(b)
        seq_comp.append(np.full((my * mx, v * h), k))
    Z = np.concatenate(seq_blocks, 1).reshape(-1, 64)
    comp = np.concatenate(seq_comp, 1).reshape(-1)
    per_mcu = comp.size // (my * mx)
    mcu = np.arange(comp.size) // per_mcu
    interval = mcu // restart if restart else np.zeros_like(mcu)
    # DC differences, the prediction reset at each restart interval
    diff = np.empty(len(Z), np.int64)
    for k in range(len(coefs)):
        idx = np.nonzero(comp == k)[0]
        prev = np.concatenate([[0], Z[idx[:-1], 0]])
        prev[np.concatenate([[True], interval[idx[1:]] != interval[idx[:-1]]])] = 0
        diff[idx] = Z[idx, 0] - prev
    def lut(tables_):  # [table, symbol] -> code, length
        codes = [_huff_codes(*t) for t in tables_]
        c, ln = np.zeros((2, 256), np.int64), np.zeros((2, 256), np.int64)
        for t, cd in enumerate(codes):
            for sym, (code, length) in cd.items():
                c[t, sym], ln[t, sym] = code, length
        return c, ln

    dc_codes, ac_codes = lut(_JPEG_DC), lut(_JPEG_AC)
    tab = np.asarray(tables)[comp]
    keys, vals, nbits = [], [], []

    def emit(key, table_idx, symbol, s, extra, codes):
        """Items (sort key, the symbol's code followed by s extra bits)."""
        cc, ll = codes[0][table_idx, symbol], codes[1][table_idx, symbol]
        keys.append(key)
        vals.append((cc << s) | (extra & ((1 << s) - 1)))
        nbits.append(ll + s)

    s_dc, e_dc = _category(diff)
    emit(np.arange(len(Z)) * 1024, tab, s_dc, s_dc, e_dc, dc_codes)
    rows, cols = np.nonzero(Z[:, 1:])
    kpos = cols + 1
    first = np.concatenate([[True], rows[1:] != rows[:-1]])
    prev_k = np.where(first, 0, np.concatenate([[0], kpos[:-1]]))
    run = kpos - prev_k - 1
    s_ac, e_ac = _category(Z[rows, kpos])
    emit(rows * 1024 + 4 * kpos + 3, tab[rows], (run % 16) << 4 | s_ac, s_ac, e_ac, ac_codes)
    n_zrl = run // 16
    zr = np.repeat(np.arange(len(rows)), n_zrl)
    zj = np.arange(len(zr)) - np.repeat(np.cumsum(n_zrl) - n_zrl, n_zrl)
    zero = np.zeros(len(zr), np.int64)
    emit(rows[zr] * 1024 + 4 * kpos[zr] + zj, tab[rows[zr]], zero + 0xF0, zero, zero,
         ac_codes)
    last = np.zeros(len(Z), np.int64)
    last[rows] = kpos  # the last nonzero position of each block (rows ascend)
    eob = np.nonzero(last < 63)[0]
    zero = np.zeros(len(eob), np.int64)
    emit(eob * 1024 + 256, tab[eob], zero, zero, zero, ac_codes)
    keys, vals, nbits = (np.concatenate(a) for a in (keys, vals, nbits))
    order = np.argsort(keys, kind="stable")
    vals, nbits, block = vals[order], nbits[order], keys[order] // 1024
    item_interval = interval[block]
    scan = b""
    for i in range(int(interval[-1]) + 1):
        sel = item_interval == i
        if i:
            scan += bytes([0xFF, 0xD0 + (i - 1) % 8])
        scan += _pack_bits(vals[sel], nbits[sel])

    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in sorted(set(tables)):
        out += seg(0xDB, bytes([t]) + bytes(qts[t][zz].astype(np.uint8)))
    ncomp = len(planes)
    sof = struct.pack(">BHHB", 8, H, W, ncomp) + b"".join(
        bytes([k + 1, h << 4 | v, t]) for k, ((h, v), t) in enumerate(zip(factors, tables)))
    out += seg(0xC0, sof)
    for t in sorted(set(tables)):
        for cls, (counts, symbols) in ((0, _JPEG_DC[t]), (1, _JPEG_AC[t])):
            out += seg(0xC4, bytes([cls << 4 | t] + list(counts) + list(symbols)))
    if restart:
        out += seg(0xDD, struct.pack(">H", restart))
    out += seg(0xDA, bytes([ncomp]) + b"".join(bytes([k + 1, t << 4 | t])
                                               for k, t in enumerate(tables)) + b"\x00\x3f\x00")
    with open(path, "wb") as f:
        f.write(out + scan + b"\xff\xd9")


def _to_u8(x):
    return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_scene(root, layout, n_images, H, W, radius=0.5, cam_radius=3.0, background="black",
                fmt="png"):
    """The synthetic sphere scene (`make_synthetic_scene`) on disk in one of
    the loaders' layouts, its masks as PNGs by `write_png` and its images as
    PNGs too, or, with `fmt` "jpg", as JPEGs by `write_jpeg` (quality 95,
    4:2:0: OpenCV's `imwrite` defaults, what BlendedMVS scans carry):

      * "DTU": image/, mask/, cameras.npz with world_mat_i = K [R|t] in a
        world frame x_w = DTU_SCALE x_n + DTU_SHIFT and scale_mat_i mapping
        the normalized frame to it;
      * "BlendedMVS": blended_images/ (and a `*_masked.png` the loader skips)
        with cams_normalized/<name>_cam.txt;
      * "custom": images/, mask/, mask_out/ (read as `masks_ignore`: a band
        along the left edge) and cam.json with P and SCALE.

    `background`: "black" or "envmap" (make_synthetic_scene's).

    Returns the scene's normalized cameras and analytic images: {"c2w",
    "intrinsics" [n, 4, 4], "rgb" [n, H, W, 3] float, "mask" [n, H, W] bool,
    "mask_out" [n, H, W] bool or None, "encoded" [n, H, W, 3] uint8, the
    arrays the image files were written from}."""
    if fmt not in ("png", "jpg"):
        raise ValueError(f"write_scene: fmt {fmt!r}, want 'png' or 'jpg'")

    def write_image(path, img):
        if fmt == "jpg":
            write_jpeg(path, img)
        else:
            write_png(path, img)
    from neurecon_tpu_torch.dataio.blendedmvs import write_cam
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene

    scene = make_synthetic_scene(n_images=n_images, H=H, W=W, radius=radius,
                                 cam_radius=cam_radius, background=background)
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
        write_image(os.path.join(root, dirs[0], f"{name}.{fmt}"), _to_u8(rgb[i]))
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
        write_image(os.path.join(root, dirs[0], f"{names[0]}_masked.{fmt}"), _to_u8(rgb[0] * 0))
    else:
        mask_out = np.zeros_like(mask)
        mask_out[:, :, : W // 8] = True
        os.makedirs(os.path.join(root, "mask_out"), exist_ok=True)
        for i, name in enumerate(names):
            write_png(os.path.join(root, "mask_out", f"{name}.png"),
                      mask_out[i].astype(np.uint8) * 255)
        with open(os.path.join(root, "cam.json"), "w") as f:
            json.dump({f"{name}.{fmt}": {"P": world_mats[i].tolist(), "SCALE": S.tolist()}
                       for i, name in enumerate(names)}, f)
    return {"c2w": c2w.astype(np.float32), "intrinsics": K.astype(np.float32),
            "rgb": rgb, "mask": mask, "mask_out": mask_out, "encoded": _to_u8(rgb)}


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


def _unisurf_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir, record=None):
    """Phases 22-26 (the file loaders, UNISURF); returns (rc, {kernel name:
    extra fields of its kernels-line row at UNISURF's shapes}). `record` (a
    dict) gets phase 23's median ms per step and phase 22's DTU-layout
    scene."""
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
    k1_narrow0 = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"]
    out, t_launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path["unisurf_train"] = t_launches
    if not _kernel1_narrow("phase 23", k1_narrow0, t_launches):
        print("FAIL phase 23: a UNISURF kernel-1 launch left the narrow tile", file=sys.stderr)
        return 1, None
    ms_step = float(np.median(step_ms[5:]))
    if record is not None:
        record.update(unisurf_ms=ms_step, dtu_root=dtu_root)
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


# configs/synthetic_quality_nomask.yaml as the file holds it (held equal to the
# file by tests/test_torch_nerfpp.py): NeuS without a mask, the NeRF++
# background (N_outside 32) on the synthetic sphere with its envmap
# background, 16 views at 240x320, 512 rays a step.
NEUS_NOMASK = {
    "expname": "synthetic_quality_nomask", "device_ids": -1,
    "data": {"type": "synthetic", "background": "envmap", "batch_size": 1, "data_dir": None,
             "downscale": 1, "n_images": 16, "H": 240, "W": 320, "N_rays": 512,
             "val_rayschunk": 8192, "val_downscale": 2},
    "model": {"framework": "NeuS", "N_outside": 32, "obj_bounding_radius": 1.0,
              "variance_init": 0.05, "upsample_algo": "official_solution",
              "N_upsample_iters": 4, "N_samples": 64, "N_importance": 64,
              "surface": {"D": 8, "W": 256, "skips": [4], "radius_init": 0.5,
                          "embed_multires": 6},
              "radiance": {"D": 4, "W": 256, "skips": [], "embed_multires": -1,
                           "embed_multires_view": 4}},
    "training": {"lr": 0.0005, "speed_factor": 10.0, "with_mask": False, "w_eikonal": 0.1,
                 "w_mask": 1.0, "log_root_dir": "logs",
                 "scheduler": {"type": "warmupcosine", "warmup_steps": 200},
                 "num_iters": 4000, "steps_per_call": 50, "ckpt_file": None,
                 "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "monitoring": "tensorboard", "i_save": 900, "i_backup": -1, "i_val": 2000,
                 "i_val_mesh": -1, "i_log": 50},
}
NOMASK_STEPS = 60  # phase 28's cut of the file's 4,000 steps
# phase 27's gate on the no-mask step's gradient through the kernels, each
# leaf's max|diff| over its max|ref|, the JAX package's full-step bound.
# `tools/step_grad_sensitivity.py --nomask` read (H100, PR 11) kernel 1's
# route at 7.6e-5 (its sdf off the plain one's by std 1.9e-7, 65 alpha clamps
# flipped), the plain route with sdf noise of std 3e-7 at <= 1.3e-5 and of
# 1e-6 at 1.1e-4-5.5e-4: the background's alpha takes the midpoints outside
# the sphere, so this step turns on the clamps less than phase 7's does
NOMASK_GRAD_GATE = 5e-4

# configs/volsdf_nerfpp.yaml as the file holds it (held equal to the file by
# tests/test_torch_nerfpp.py): VolSDF with the NeRF++ background read from a
# DTU scan (phase 29 writes the synthetic envmap scene in DTU's layout).
VOLSDF_NERFPP = {
    "data": {"N_rays": 1024, "batch_size": 1, "data_dir": "./data/DTU/scan40", "downscale": 1,
             "far": 6.0, "near": 0.0, "pin_memory": True, "scale_radius": 3.0,
             "val_downscale": 8, "val_rayschunk": 256},
    "device_ids": -1, "expname": "volsdf_nerf++_40",
    "model": {"W_geometry_feature": 256, "framework": "VolSDF", "max_upsample_iter": 5,
              "obj_bounding_radius": 3.0, "outside_scene": "nerf++",
              "radiance": {"D": 4, "embed_multires": -1, "embed_multires_view": -1,
                           "skips": []},
              "surface": {"D": 8, "embed_multires": 6, "radius_init": 1.0, "skips": [4]}},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "monitoring": "tensorboard",
                 "num_iters": 100000, "scheduler": {"type": "warmupcosine", "warmup_steps": 0},
                 "speed_factor": 10.0, "w_eikonal": 0.1},
}
NERFPP_STEPS = 40  # phase 29's cut of the file's 100,000 steps


def nomask_inputs(seed, dev):
    """Phase 27's inputs: the NEUS_NOMASK model from the seed and its copy
    with seeded noise on every weight, the background net's included (seed
    + 1); the envmap scene's first view at 240x320 and its rays; a training
    step's 512 rays drawn from the seed with their d_all from kernel 2 (det
    uniforms) and the outside samples' jitter uniforms (seed + 5)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, _uniforms
    from neurecon_tpu_torch.ops import fused_upsample, get_rays
    from neurecon_tpu_torch.training import sample_ray_batch

    args = ConfigDict(copy.deepcopy(NEUS_NOMASK))
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    checked = copy.deepcopy(model)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    H, W = NEUS_NOMASK["data"]["H"], NEUS_NOMASK["data"]["W"]
    scene = make_synthetic_scene(n_images=1, H=H, W=W, background="envmap")
    c2w = torch.tensor(scene["c2w"][:1], device=dev)
    K = torch.tensor(scene["intrinsics"][:1], device=dev)
    o_all, d_all_dirs, _ = get_rays(c2w[0], K[0], H, W)
    batch = {"c2w": c2w, "intrinsics": K,
             "rgb": torch.tensor(scene["rgb"][:1], device=dev).reshape(1, -1, 3)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, H, W, 512)
    o, d, near, far = _prepare_rays(rb["rays_o"], rb["rays_d"], 1.0)
    t = torch.linspace(0, 1, 64, device=dev)
    d_all = fused_upsample.fused_neus_upsample(
        checked.implicit_surface, o, d, (near * (1 - t) + far * t).contiguous(),
        _uniforms(512, 4, 16, False, None, dev), n_iters=4, n_per_iter=16)
    u_out = torch.rand(512, 32, device=dev, generator=torch.Generator(dev).manual_seed(seed + 5))
    return {"args": args, "model": model, "checked": checked, "kw_train": kw_train,
            "kw_test": kw_test, "o_all": o_all, "d_all_dirs": d_all_dirs, "rb": rb,
            "rays_o": o, "rays_d": d, "d_all": d_all, "u_out": u_out}


def _net_bound_ms(net, points):
    """The fp32 bound of a plain MLP's forward and backward (input and
    weight gradients, twice the forward's work) on `points` points: its
    multiply-adds a point over 67 TFLOP/s; its bytes (the inputs and outputs,
    a few words a point) bound nothing."""
    from neurecon_tpu_torch.models.base import DenseLayer

    macs = sum(m.in_dim * m.out_dim for m in net.modules() if isinstance(m, DenseLayer))
    fwd = 1e3 * 2.0 * macs * points / FP32_PEAK
    return macs, fwd, 2.0 * fwd


def _nerfpp_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 27-29 (the NeRF++ background: NeuS without a mask, VolSDF with
    outside_scene nerf++); returns rc."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.models.base import NeRF, RadianceNet, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn, neus, volsdf
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, fused_upsample, get_rays
    from neurecon_tpu_torch.ops.sampling import linspace01
    from neurecon_tpu_torch.tools import render_view
    from neurecon_tpu_torch.training import render_full_image, sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util

    plain_routes = (
        (fused_nablas, "fused_forward_with_nablas", fused_nablas.forward_with_nablas_plain),
        (fused_upsample, "fused_neus_upsample", fused_upsample.neus_upsample_plain),
        (ffs, "fused_fine_sample", ffs.fine_sample_plain))

    def plain_patch(render_fn, o, d):
        with contextlib.ExitStack() as stack:
            for mod, name, plain in plain_routes:
                stack.enter_context(mock.patch.object(mod, name, plain))
            return render_full_image(render_fn, o, d, rayschunk=4096)

    bg_parts = {"background forward": (NeRF, "forward")}
    bg_backward = {"background backward": "nerf_outside"}

    # ---- phase 27: NeuS without a mask at synthetic_quality_nomask.yaml's widths
    c = nomask_inputs(seed, dev)
    checked, kw_test = c["checked"], c["kw_test"]
    H, W = NEUS_NOMASK["data"]["H"], NEUS_NOMASK["data"]["W"]
    patch = torch.arange(H // 2 * W - 1024, H // 2 * W + 1024, device=dev)
    render_fn = neus.make_volume_render_fn(checked, detailed_output=True, calc_normal=True,
                                           **kw_test)
    out_k = render_full_image(render_fn, c["o_all"][patch], c["d_all_dirs"][patch],
                              rayschunk=4096)
    out_p = plain_patch(render_fn, c["o_all"][patch], c["d_all_dirs"][patch])
    n_out = NEUS_NOMASK["model"]["N_outside"]
    e = {k: float(np.abs(out_k[k] - out_p[k]).max())
         for k in ("rgb", "depth_volume", "mask_volume", "normals_volume", "sigma_out",
                   "radiance_out")}
    e["sigma_out beyond the sphere"] = float(np.abs(out_k["sigma_out"][:, -n_out:]
                                                    - out_p["sigma_out"][:, -n_out:]).max())
    e["radiance_out beyond the sphere"] = float(np.abs(out_k["radiance_out"][:, -n_out:]
                                                       - out_p["radiance_out"][:, -n_out:]).max())
    finite = all(np.isfinite(out_k[k]).all() for k in ("rgb", "depth_volume", "sigma_out"))
    print(f"phase 27: 2,048-ray no-mask patch of the 240x320 envmap view, kernels vs plain: "
          f"max|diff| {e}; finite {finite}")
    if (e["rgb"] > 2e-3 or e["mask_volume"] > 2e-3 or e["sigma_out beyond the sphere"] > 1e-5
            or e["radiance_out beyond the sphere"] > 1e-5 or not finite):
        print("FAIL phase 27: the no-mask patch disagrees with the plain render",
              file=sys.stderr)
        return 1
    ray_loss = get_ray_loss_fn(c["args"], checked, c["kw_train"])
    loss_k, loss_p, ratios = _step_grad_check(checked, ray_loss, c["rb"], d_all=c["d_all"],
                                              u_out=c["u_out"])
    worst = max(ratios, key=ratios.get)
    bg = {k: v for k, v in ratios.items() if k.startswith("nerf_outside")}
    bg_worst = max(bg, key=bg.get)
    print(f"phase 27: no-mask step (512 rays, perturb with fixed outside jitter) loss kernels "
          f"{loss_k:.8f} plain {loss_p:.8f}; worst grad leaf {worst} {ratios[worst]:.2e} over "
          f"{len(ratios)} leaves, of the background's {len(bg)} {bg_worst} {bg[bg_worst]:.2e} "
          f"(gate {NOMASK_GRAD_GATE:g})")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or ratios[worst] > NOMASK_GRAD_GATE:
        print("FAIL phase 27: the no-mask step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1
    # the origin ray: a midpoint at exactly r = 0 (sections at 3 -+ 2^-7 on a
    # ray from (0, 0, -3) along +z), through kernels 1 and 3
    o = torch.tensor([[0.0, 0.0, -3.0], [0.1, 0.0, -3.0]], device=dev)
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], device=dev)
    d_origin = (2.0 + 2.0 * linspace01(128, dev)).repeat(2, 1)
    d_origin[0, 63], d_origin[0, 64] = 3.0 - 2.0 ** -7, 3.0 + 2.0 ** -7
    checked.zero_grad(set_to_none=True)
    ret = neus.volume_render_rays(checked, o, d, d_all_override=d_origin,
                                  u_out=torch.full((2, n_out), 0.5, device=dev),
                                  **c["kw_train"])
    r_min = float(torch.linalg.norm(o[0] + d[0] * ret["d_final"][0, 63]))
    torch.mean(torch.abs(ret["rgb"])).backward()
    finite_grads = all(bool(torch.isfinite(p.grad).all()) for p in checked.parameters())
    checked.zero_grad(set_to_none=True)
    print(f"phase 27: the origin ray (a midpoint at |x| = {r_min:g}): every gradient finite "
          f"{finite_grads}")
    if r_min != 0.0 or not finite_grads:
        print("FAIL phase 27: the origin ray's gradients are not finite", file=sys.stderr)
        return 1

    # ---- phase 28: train.py on the same config
    tdir = os.path.join(workdir, "nomask_train")
    cuts = [("training.num_iters", NOMASK_STEPS), ("training.scheduler.warmup_steps", 10),
            ("training.i_val", NOMASK_STEPS // 2), ("training.i_val_mesh", NOMASK_STEPS // 2),
            ("data.mesh_N", 256), ("training.i_log", 10), ("training.i_backup", -1),
            ("training.monitoring", "none"), ("training.log_root_dir", tdir),
            ("training.exp_dir", os.path.join(tdir, "run")),
            ("expname", "chip_smoke_nomask_train"), ("seed", seed)]
    print("phase 28: configs/synthetic_quality_nomask.yaml with the cuts "
          + ", ".join(f"{k}={v}" for k, v in cuts))
    targs = ConfigDict(_with_cuts(NEUS_NOMASK, cuts))
    S = NOMASK_STEPS
    out, launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path["nomask_train"] = launches
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    mesh30 = os.path.join(out["exp_dir"], "meshes", f"{S // 2:08d}.ply")
    n_f30 = len(mesh_util.read_ply(mesh30)[1]) if os.path.exists(mesh30) else -1
    # two validations at 120x160 in chunks of 8,192 rays: 3 launches each of kernels 1 and 2
    val_chunks = 2 * math.ceil((H // 2) * (W // 2) / NEUS_NOMASK["data"]["val_rayschunk"])
    want = {"nablas_forward": S + val_chunks, "neus_upsample": S + val_chunks,
            "nablas_backward": S}
    print(f"phase 28: train.py {S} no-mask steps at 512 rays, {run_s:.1f} s in all: launches "
          f"{launches} (kernels 1-3 want {want}: one each a step, two validations of "
          f"{val_chunks // 2} chunks); loss mean of steps 1-10 {first:.5f}, of the last 10 "
          f"{last:.5f}; in-loop 256^3 mesh at step {S // 2}: {n_f30} faces, "
          f"{out['stats']['perf'].get('mesh_sec')} s")
    print(f"phase 28: median {ms_step:.2f} ms/step over steps 6-{S} ({512e3 / ms_step:.0f} "
          f"rays/s); all steps ms {[round(v, 1) for v in step_ms]} {tag}")
    if (any(launches[k] != v for k, v in want.items()) or launches["sdf_forward"] == 0
            or len(totals) != S or not np.isfinite(totals).all() or not last < first
            or n_f30 < 0):
        print("FAIL phase 28: no-mask training missed a kernel, diverged, did not lower the "
              "loss, or wrote no mesh", file=sys.stderr)
        return 1
    vargs = ConfigDict(copy.deepcopy(NEUS_NOMASK))
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 2, "camera_path": "interpolation",
                  "rayschunk": 4096})
    zero_counts()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    f_launches = by_path["nomask_render_view"] = read_counts()
    n_chunks = 2 * math.ceil(H * W / 4096)
    print(f"phase 28: render_view no-mask 2 x {H}x{W}: launches {f_launches} (kernels 1 and 2 "
          f"want {n_chunks} each), s/frame {[round(v, 4) for v in frames['seconds']]} {tag}")
    if (f_launches["nablas_forward"] != n_chunks or f_launches["neus_upsample"] != n_chunks
            or not all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))):
        print("FAIL phase 28: the no-mask render missed a kernel or is not finite",
              file=sys.stderr)
        return 1
    step_total, split, busy = _step_split(
        targs, dev, {"neus_upsample": (fused_upsample, "fused_neus_upsample"),
                     "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward"), **bg_parts},
        backward_of=bg_backward)
    rest = step_total - sum(split.values())
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    bg_points = 512 * (127 + n_out)
    macs, b_fwd, b_bwd = _net_bound_ms(checked.nerf_outside, bg_points)
    print(f"phase 28: one no-mask step (512 rays; the background net on {bg_points} points, "
          f"{macs} multiply-adds a point, fp32 bound forward {b_fwd:.3f} ms, backward "
          f"{b_bwd:.3f} ms) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, compositing, loss, glue) {rest:.2f} ms; device "
          f"over three steps {busy} {tag}")

    # ---- phase 29: VolSDF with NeRF++ (configs/volsdf_nerfpp.yaml) read from a DTU scene
    root = os.path.join(workdir, "scene_dtu_envmap")
    t0 = time.perf_counter()
    write_scene(root, "DTU", *DTU_SHAPE, background="envmap")
    write_s = time.perf_counter() - t0
    n0 = 128 * 4
    max_iter = VOLSDF_NERFPP["model"]["max_upsample_iter"]
    args = ConfigDict(_with_cuts(VOLSDF_NERFPP, [("data.data_dir", root)]))
    t0 = time.perf_counter()
    ds = get_data(args)
    load_s = time.perf_counter() - t0
    model, kw_train, kw_test, _ = get_model(args, dev, seed=seed)
    vchecked = copy.deepcopy(model)
    perturb_parameters(vchecked, torch.Generator().manual_seed(seed + 1))
    Hd, Wd = ds.H, ds.W
    c2w = torch.tensor(ds.c2w_all[0], device=dev)
    K = torch.tensor(ds.intrinsics_all[0], device=dev)
    o_all, d_all, _ = get_rays(c2w, K, Hd, Wd)
    # the sampler's far bands: 768 rays of view 0 (cameras inside the sphere,
    # rays crossing it: far ~3-5.7), 128 from view 0's camera pointing away
    # from the centre (far ~0.27-1), 128 from cameras at twice the distance,
    # outside the sphere, that miss it (far 0)
    idx = torch.linspace(0, Hd * Wd - 1, 768, device=dev).long()
    cam = c2w[:3, 3]
    g = torch.Generator(dev).manual_seed(seed + 6)
    away = cam / torch.linalg.norm(cam) + 0.3 * torch.randn(128, 3, device=dev, generator=g)
    side = torch.linalg.cross(cam.expand(128, 3), torch.randn(128, 3, device=dev, generator=g))
    o_b = torch.cat([o_all[idx], cam.expand(128, 3), 2.0 * cam.expand(128, 3)])
    d_b = torch.cat([d_all[idx], away, side])
    r_o, r_d, _, far = volsdf._ray_bounds(o_b, d_b, 0.0, 6.0, 3.0, True)
    bands = {"full (far > 2)": far[:, 0] > 2.0,
             "short (0 < far <= 2)": (far[:, 0] > 0) & (far[:, 0] <= 2.0),
             "zero (far = 0)": far[:, 0] == 0}
    print(f"phase 29: the DTU-layout envmap scene, {DTU_SHAPE[0]} views at {DTU_SHAPE[1]}x"
          f"{DTU_SHAPE[2]}: written in {write_s:.2f} s, loaded in {load_s:.3f} s; sampler rays "
          f"per far band " + ", ".join(f"{k} {int(m.sum())}" for k, m in bands.items())
          + f", fars {float(far.min()):.4f}-{float(far.max()):.4f}")
    ok, _, _ = _sampler_check(vchecked.implicit_surface, r_o, r_d, far.contiguous(),
                              (0.1, 0.01, 0.001), n0, n0, max_iter, seed, "phase 29",
                              bg_r=None, bands=bands)
    if not ok or min(int(m.sum()) for m in bands.values()) < 64:
        print("FAIL phase 29: the fine-sampler kernels disagree with their plain versions in "
              "a far band", file=sys.stderr)
        return 1
    batch = {"c2w": torch.tensor(ds.c2w_all[:1], device=dev),
             "intrinsics": torch.tensor(ds.intrinsics_all[:1], device=dev),
             "rgb": torch.tensor(ds.rgb_images[:1], device=dev).reshape(1, -1, 3)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, Hd, Wd, 1024)
    eik = (torch.rand(1, 1024, 1, 3, device=dev,
                      generator=torch.Generator(dev).manual_seed(seed + 4)) * 2 - 1) * 3.0
    u_out = torch.rand(1024, 32, device=dev, generator=torch.Generator(dev).manual_seed(seed + 5))
    fine = volsdf.compute_ray_samples(vchecked, rb["rays_o"], rb["rays_d"],
                                      **{**kw_train, "perturb": False})
    v_loss = get_ray_loss_fn(args, vchecked, kw_train)
    loss_k, loss_p, ratios = _step_grad_check(vchecked, v_loss, rb, fine_override=fine,
                                              eik_pts=eik, u_out=u_out)
    worst = max(ratios, key=ratios.get)
    bg = {k: v for k, v in ratios.items() if k.startswith("nerf_outside")}
    bg_worst = max(bg, key=bg.get)
    print(f"phase 29: VolSDF nerf++ step (1,024 rays) loss kernels {loss_k:.8f} plain "
          f"{loss_p:.8f}; worst grad leaf {worst} {ratios[worst]:.2e} over {len(ratios)} "
          f"leaves, of the background's {bg_worst} {bg[bg_worst]:.2e} (phase 16's gate 5e-4)")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or ratios[worst] > 5e-4:
        print("FAIL phase 29: the nerf++ step's gradient through the kernels disagrees",
              file=sys.stderr)
        return 1
    tdir = os.path.join(workdir, "nerfpp_train")
    S = NERFPP_STEPS
    cuts = [("data.data_dir", root), ("training.num_iters", S), ("training.i_val", S // 2),
            ("training.i_val_mesh", S // 2), ("data.mesh_N", 128), ("data.volume_size", 3.0),
            ("training.i_log", 10), ("training.i_backup", S // 2),
            ("training.monitoring", "none"), ("training.log_root_dir", tdir),
            ("training.exp_dir", os.path.join(tdir, "run")),
            ("expname", "chip_smoke_volsdf_nerfpp"), ("seed", seed)]
    print("phase 29: configs/volsdf_nerfpp.yaml with the cuts "
          + ", ".join(f"{k}={v}" for k, v in cuts))
    targs = ConfigDict(_with_cuts(VOLSDF_NERFPP, cuts))
    out, launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path["volsdf_nerfpp_train"] = launches
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    # a step: 1 + 1 + max_iter of (a)-(c), 1 + max_iter of kernel 4, one of
    # kernels 1 and 3; a validation chunk the same but kernel 3
    vd, vchunk = float(VOLSDF_NERFPP["data"]["val_downscale"]), 256
    val_chunks = 2 * math.ceil(int(DTU_SHAPE[1] / vd) * int(DTU_SHAPE[2] / vd) / vchunk)
    calls = S + val_chunks
    want = {"volsdf_init": calls, "volsdf_draw": calls, "volsdf_checkpoint": max_iter * calls,
            "nablas_forward": calls, "nablas_backward": S}
    print(f"phase 29: train.py {S} VolSDF nerf++ steps at 1,024 rays, {run_s:.1f} s in all: "
          f"launches {launches} (want {want} and kernel 4 {(1 + max_iter) * calls} plus the "
          f"step-{S // 2} mesh's: a step {1} + {1} + {max_iter} of (a)-(c), {1 + max_iter} of "
          f"kernel 4, one of kernels 1 and 3; {val_chunks // 2} chunks a validation); loss mean "
          f"of steps 1-10 {first:.5f}, of the last 10 {last:.5f}; beta at the logs "
          f"{[round(v, 5) for _, v in out['stats']['scalars']['beta']]}")
    print(f"phase 29: median {ms_step:.2f} ms/step over steps 6-{S} ({1024e3 / ms_step:.0f} "
          f"rays/s); all steps ms {[round(v, 1) for v in step_ms]} {tag}")
    if (any(launches[k] != v for k, v in want.items())
            or launches["sdf_forward"] < (1 + max_iter) * calls
            or len(totals) != S or not np.isfinite(totals).all() or not last < first):
        print("FAIL phase 29: nerf++ training missed a kernel, diverged or did not lower the "
              "loss", file=sys.stderr)
        return 1
    vargs = ConfigDict(_with_cuts(VOLSDF_NERFPP, [("data.data_dir", root)]))
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 2, "camera_path": "interpolation",
                  "rayschunk": 4096, "downscale": 10})
    zero_counts()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    f_launches = by_path["volsdf_nerfpp_render_view"] = read_counts()
    fh, fw = frames["rgb"].shape[1:3]
    chunks = 2 * math.ceil(fh * fw / 4096)
    f_want = {"nablas_forward": chunks, "neus_upsample": 0, "nablas_backward": 0,
              "sdf_forward": (1 + max_iter) * chunks, "volsdf_init": chunks,
              "volsdf_draw": chunks, "volsdf_checkpoint": max_iter * chunks}
    print(f"phase 29: render_view VolSDF nerf++ 2 x {fh}x{fw}: launches {f_launches} (want "
          f"{f_want}), s/frame {[round(v, 4) for v in frames['seconds']]} {tag}")
    if f_launches != f_want or not all(np.isfinite(frames[k]).all()
                                       for k in ("rgb", "depth", "normal")):
        print("FAIL phase 29: the nerf++ render missed a kernel or is not finite",
              file=sys.stderr)
        return 1
    sampler = {"sampler (whole)": (ffs, "fused_fine_sample"),
               "sdf_forward (sampler)": (ffs, "launch_sdf_forward"),
               "volsdf_init": (ffs, "launch_init"), "volsdf_draw": (ffs, "launch_draw"),
               "volsdf_checkpoint": (ffs, "launch_checkpoint")}
    inner = ("sdf_forward (sampler)", "volsdf_init", "volsdf_draw", "volsdf_checkpoint")
    step_total, split, busy = _step_split(
        targs, dev, {**sampler, "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
                     "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
                     "radiance_forward": (RadianceNet, "forward"), **bg_parts},
        backward_of=bg_backward)
    rest = step_total - sum(v for k, v in split.items() if k not in inner)
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    _, b_fwd, b_bwd = _net_bound_ms(vchecked.nerf_outside, 1024 * 32)
    print(f"phase 29: one VolSDF nerf++ step (1,024 rays; the background net on {1024 * 32} "
          f"points, fp32 bound forward {b_fwd:.3f} ms, backward {b_bwd:.3f} ms) "
          f"{step_total:.2f} ms: " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, compositing, loss, glue) {rest:.2f} ms; device "
          f"over three steps {busy} {tag}")
    return 0


# ---- phases 30-31: ray-parallel training and the sharded validation render
# over several ranks (neurecon_tpu_torch/parallel/), each rank a process of
# this script (`--rank-job`) started under torchrun's variables by the port's
# launcher

DDP_TIMEOUT = 300  # seconds a group of ranks may take before it is ended
DDP_LOSS_REL = 1e-3  # two ranks' step losses against one rank's, 10 Adam steps
FRAME_ATOL = 1e-5  # the sharded frame against the one-rank frame


def _digest(t) -> str:
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _rank_train(task, rank, zero_counts, read_counts):
    """train.py on this rank (`_train_timed`), with the surface pack read
    before and after the step's first broadcast; ranks other than 0 first
    perturb their weights when the task asks, so the broadcast must replace
    them and the pack must be made anew from rank 0's values."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.ops.surface_pack import pack, packed_surface

    info = {}

    def around_make(real, pipeline_fns, model, optimizer, scheduler, group=None):
        surface = model.implicit_surface
        if task.get("perturb_others") and rank != 0:
            perturb_parameters(model, torch.Generator().manual_seed(99))
        info["before"] = _digest(packed_surface(surface).params)
        n0 = packed_surface.packs
        step = real(pipeline_fns, model, optimizer, scheduler, group=group)
        info["after"] = _digest(packed_surface(surface).params)
        info["packs_made"] = packed_surface.packs - n0
        info["fresh"] = _digest(pack(surface).params)
        return step

    targs = ConfigDict(copy.deepcopy(task["config"]))
    if task.get("profile"):
        targs.training["profile_steps"] = task["profile"]
    out, launches, step_ms, secs = _train_timed(targs, zero_counts, read_counts, around_make)
    return {"launches": launches, "step_ms": step_ms, "secs": secs, "pack": info,
            "totals": [v for _, v in out["stats"]["losses"]["total_per_step"]],
            "final_ckpt": out["final_ckpt"], "exp_dir": out["exp_dir"]}


def sharded_frame_inputs(seed, dev):
    """Phase 31's frame: the flagship NeuS from the seed with seeded noise
    (seed + 1), its det render fn with normals, and the 19,200 rays of a
    120x160 view of the synthetic scene."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.ops import get_rays

    model, _, kw_test, factory = get_model(ConfigDict(copy.deepcopy(FLAGSHIP)), dev, seed=seed)
    perturb_parameters(model, torch.Generator().manual_seed(seed + 1))
    scene = make_synthetic_scene(n_images=1, H=120, W=160)
    o, d, _ = get_rays(torch.tensor(scene["c2w"][0], device=dev),
                       torch.tensor(scene["intrinsics"][0], device=dev), 120, 160)
    kw = {k: v for k, v in kw_test.items() if k not in ("H", "W", "rayschunk")}
    return factory(detailed_output=False, calc_normal=True, **kw), o, d


def _rank_render(task, rank, zero_counts, read_counts):
    """Phase 31's frame split over the ranks by pixel; rank 0 keeps it."""
    from neurecon_tpu_torch.parallel import process_group
    from neurecon_tpu_torch.training import render_full_image

    fn, o, d = sharded_frame_inputs(task["seed"], torch.device("cuda"))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    ret = render_full_image(fn, o, d, rayschunk=4096, group=process_group())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    if rank == 0:
        np.savez(os.path.join(task["out"], "frame.npz"), **ret)
    return {"launches": launches, "secs": secs}


def _rank_job(job_file) -> int:
    """One rank of phases 30-31: join the group from the launcher's
    variables, run the job's tasks, write this rank's results as JSON."""
    from neurecon_tpu_torch.parallel import distributed

    with open(job_file) as f:
        job = json.load(f)
    rank, _, world = distributed.init_env(device="cuda")
    _counters, zero_counts, read_counts = _launch_counters()
    out = {"rank": rank, "world": world, "card": torch.cuda.current_device(),
           "backend": torch.distributed.get_backend(), "tasks": {}}
    for task in job["tasks"]:
        run = {"train": _rank_train, "render": _rank_render}[task["kind"]]
        out["tasks"][task["name"]] = run(task, rank, zero_counts, read_counts)
    torch.distributed.barrier()
    with open(os.path.join(job["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    distributed.release()
    return 0


def _run_ranks(workdir, name, world, tasks, cards):
    """`world` ranks of this script's `--rank-job` on the cards `cards`
    (CUDA_VISIBLE_DEVICES), started by the port's launcher with a time limit;
    each rank's results, or None (the log's tail printed) when a rank failed
    or the group ran past DDP_TIMEOUT."""
    from neurecon_tpu_torch.parallel.launch import run_local

    d = os.path.join(workdir, name)
    os.makedirs(d, exist_ok=True)
    for t in tasks:
        t["out"] = d
    job = os.path.join(d, "job.json")
    with open(job, "w") as f:
        json.dump({"tasks": tasks, "out": d}, f)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=cards)
    log_path = os.path.join(d, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as logf:
        codes = run_local([sys.executable, os.path.abspath(__file__), "--rank-job", job],
                          world, env=env, timeout=DDP_TIMEOUT, stdout=logf,
                          stderr=subprocess.STDOUT)
    secs = time.perf_counter() - t0
    if any(codes):
        with open(log_path) as f:
            print(f.read()[-6000:], file=sys.stderr)
        print(f"{name}: rank exit codes {codes} (124: past {DDP_TIMEOUT} s)", file=sys.stderr)
        return None, secs
    res = []
    for r in range(world):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            res.append(json.load(f))
    return res, secs


def _trace_busy(profile_dir):
    """The device's busy share over the profiler window's trace: the summed
    time of its kernels, copies and sets (one stream) over the window's
    span, from its first event to its last."""
    names = sorted(os.listdir(profile_dir)) if os.path.isdir(profile_dir) else []
    if not names:
        return "not measured (no trace)"
    with open(os.path.join(profile_dir, names[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    devs = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    if not devs:
        return "not measured (no device events in the trace)"
    busy, end = 0.0, -float("inf")
    for a, b in devs:  # the union of the device intervals
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    return busy / span


def _tree_gap(got, ref, p0):
    """(bit-equal, the largest |diff|, the worst leaf's share of elements
    beyond 1e-3 of how far the leaf moved from p0, the worst max|diff| over
    that distance)."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [np.asarray(t, np.float64)]
    equal, worst, share, ratio = True, 0.0, 0.0, 0.0
    for g, r, a in zip(leaves(got), leaves(ref), leaves(p0)):
        diff = np.abs(g - r)
        moved = np.abs(r - a).max() + 1e-30
        equal &= bool(np.array_equal(g, r))
        worst = max(worst, float(diff.max()))
        share = max(share, float((diff > 1e-3 * moved).mean()))
        ratio = max(ratio, float(diff.max() / moved))
    return equal, worst, share, ratio


def _ddp_phases(seed, dev, tag, by_path, workdir, phase8):
    """Phases 30-31 (see the module docstring). `phase8`: phase 8's step
    totals, median ms per step and final checkpoint. Returns 0 or 1."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.training import render_full_image
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    kernels13 = ("nablas_forward", "neus_upsample", "nablas_backward")
    sampler = ("sdf_forward", "volsdf_init", "volsdf_draw", "volsdf_checkpoint")
    one_card = (os.environ.get("CUDA_VISIBLE_DEVICES") or "0").split(",")[0]

    # ---- phase 30 (1): one rank over NCCL at phase 8's cuts and seed, with a
    # 2-step profiler window
    cfg1 = _train_config(os.path.join(workdir, "ddp1"), seed)
    res, secs = _run_ranks(workdir, "ddp1", 1, [
        {"kind": "train", "name": "neus", "config": cfg1, "profile": "10:12"}], one_card)
    if res is None:
        print("FAIL phase 30: the one-rank NCCL run failed", file=sys.stderr)
        return 1
    r1 = res[0]["tasks"]["neus"]
    by_path["ddp1_train"] = r1["launches"]
    p0 = bridge.model_to_tree(get_model(ConfigDict(copy.deepcopy(FLAGSHIP)), dev, seed=seed)[0])
    equal, worst, share, ratio = _tree_gap(load_checkpoint(r1["final_ckpt"])["model"],
                                           load_checkpoint(phase8["final_ckpt"])["model"], p0)
    t1, t8 = np.asarray(r1["totals"]), np.asarray(phase8["totals"])
    loss_rel = float(np.max(np.abs(t1 - t8) / np.abs(t8))) if len(t1) == len(t8) else float("inf")
    ms1 = float(np.median(r1["step_ms"][5:]))
    busy = _trace_busy(os.path.join(r1["exp_dir"], "profile"))
    busy_s = (f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
              if isinstance(busy, float) else busy)
    print(f"phase 30: one rank over {res[0]['backend']} (train.py under torchrun's variables, "
          f"phase 8's config and seed, {secs:.1f} s with the process's start): launches "
          f"{r1['launches']}; step losses {'bit-equal to' if loss_rel == 0 else 'against'} "
          f"phase 8's (max rel {loss_rel:.3e}); final parameters "
          f"{'bit-equal' if equal else 'not bit-equal'} (max|diff| {worst:.3e}, worst leaf "
          f"{ratio:.3e} of its move, {share:.4f} of a leaf's elements beyond 1e-3 of it)")
    print(f"phase 30: median {ms1:.2f} ms/step over steps 6-60 against phase 8's "
          f"{phase8['ms_step']:.2f} ({100 * (ms1 / phase8['ms_step'] - 1):+.2f}%: the one-rank "
          f"group's all-reduces) {tag}")
    print(f"phase 30: profiler window steps 10-11 on rank 0: device {busy_s} {tag}")
    if (len(t1) != 60 or loss_rel > 1e-5 or share > 0.01 or ratio > 0.1
            or min(r1["launches"][k] for k in kernels13) < 60 or r1["launches"]["sdf_forward"] == 0):
        print("FAIL phase 30: the one-rank run missed a kernel or left phase 8's run",
              file=sys.stderr)
        return 1

    # ---- phase 30 (2)-(3) and 31: two ranks on the one card over gloo
    cfg2 = _train_config(os.path.join(workdir, "ddp2"), seed)
    cfg2["data"]["mesh_N"] = 64
    cfg2["training"].update({"num_iters": 10, "i_val": 5, "i_val_mesh": 5, "i_log": 5})
    vcfg = copy.deepcopy(VOLSDF)
    vdir = os.path.join(workdir, "ddp2", "volsdf")
    vcfg.update({"expname": "chip_smoke_ddp_volsdf", "seed": seed})
    vcfg["training"].update({"num_iters": 5, "i_log": 5, "i_val_mesh": -1, "monitoring": "none",
                             "log_root_dir": vdir, "exp_dir": os.path.join(vdir, "run")})
    res, secs = _run_ranks(workdir, "ddp2", 2, [
        {"kind": "train", "name": "neus", "config": cfg2, "perturb_others": True},
        {"kind": "train", "name": "volsdf", "config": vcfg},
        {"kind": "render", "name": "frame", "seed": seed}], one_card)
    if res is None:
        print("FAIL phase 30: the two-rank run failed", file=sys.stderr)
        return 1
    ok = [x["backend"] for x in res] == ["gloo", "gloo"]
    for r, x in enumerate(res):
        n, v, f = x["tasks"]["neus"], x["tasks"]["volsdf"], x["tasks"]["frame"]
        by_path[f"ddp2_train_rank{r}"] = n["launches"]
        by_path[f"ddp2_volsdf_rank{r}"] = v["launches"]
        by_path[f"sharded_render_rank{r}"] = f["launches"]
        print(f"phase 30: rank {r} of 2 (card {x['card']}, {x['backend']}): NeuS 10 steps at 512 "
              f"rays (256 a rank) launches {n['launches']}; VolSDF 5 steps at 1,024 rays launches "
              f"{v['launches']}; pack before the broadcast {n['pack']['before']}, after "
              f"{n['pack']['after']} ({n['pack']['packs_made']} made; a fresh pack "
              f"{n['pack']['fresh']})")
        ok &= min(n["launches"][k] for k in kernels13) >= 10
        ok &= (n["launches"]["sdf_forward"] > 0) == (r == 0)  # the in-loop mesh: rank 0
        ok &= min(v["launches"][k] for k in sampler) >= 5 and v["launches"]["nablas_backward"] >= 5
        ok &= min(f["launches"][k] for k in ("nablas_forward", "neus_upsample")) > 0
        ok &= n["pack"]["after"] == res[0]["tasks"]["neus"]["pack"]["after"] == n["pack"]["fresh"]
        ok &= n["pack"]["packs_made"] >= 1
        ok &= n["totals"] == res[0]["tasks"]["neus"]["totals"] and len(n["totals"]) == 10
        ok &= v["totals"] == res[0]["tasks"]["volsdf"]["totals"] and len(v["totals"]) == 5
        ok &= bool(np.isfinite(v["totals"]).all())
    ok &= res[1]["tasks"]["neus"]["pack"]["before"] != res[0]["tasks"]["neus"]["pack"]["before"]
    t2 = np.asarray(res[0]["tasks"]["neus"]["totals"])
    rels = np.abs(t2 - t1[:10]) / np.abs(t1[:10])
    rel2 = float(np.max(rels))
    ms2 = float(np.median(res[0]["tasks"]["neus"]["step_ms"][5:]))
    print(f"phase 30: two ranks' global step losses against the one-rank run's first 10: max rel "
          f"{rel2:.3e} (gate {DDP_LOSS_REL:g}; by step {', '.join(f'{r:.1e}' for r in rels)}); "
          f"rank 1 started from other weights and after the "
          f"broadcast packs rank 0's; median {ms2:.2f} ms/step over steps 6-10 (two processes "
          f"on one card, gloo through the host) {tag}")
    if not ok or rel2 > DDP_LOSS_REL:
        print("FAIL phase 30: a rank missed a kernel, the ranks disagree, the pack kept a "
              "rank's own weights, or two ranks left the one-rank run", file=sys.stderr)
        return 1

    # ---- phase 30 (4): one rank a card over NCCL, where the machine has several
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cfgn = _train_config(os.path.join(workdir, "ddpn"), seed)
        cfgn["training"].update({"num_iters": 10, "i_val": 5, "i_val_mesh": -1, "i_log": 5})
        resn, secs = _run_ranks(workdir, "ddpn", n_cards, [
            {"kind": "train", "name": "neus", "config": cfgn}],
            os.environ.get("CUDA_VISIBLE_DEVICES") or ",".join(map(str, range(n_cards))))
        if resn is None:
            print("FAIL phase 30: the one-rank-a-card run failed", file=sys.stderr)
            return 1
        tn = np.asarray(resn[0]["tasks"]["neus"]["totals"])
        reln = float(np.max(np.abs(tn - t1[:10]) / np.abs(t1[:10])))
        for r, x in enumerate(resn):
            by_path[f"ddp{n_cards}_train_rank{r}"] = x["tasks"]["neus"]["launches"]
        print(f"phase 30: {n_cards} ranks, one a card ({[x['card'] for x in resn]}, "
              f"{resn[0]['backend']}): launches {[x['tasks']['neus']['launches'] for x in resn]}; "
              f"losses against one rank's max rel {reln:.3e}; median "
              f"{float(np.median(resn[0]['tasks']['neus']['step_ms'][5:])):.2f} ms/step {tag}")
        if reln > DDP_LOSS_REL or any(min(x["tasks"]["neus"]["launches"][k] for k in kernels13)
                                      < 10 for x in resn):
            print("FAIL phase 30: the one-rank-a-card run missed a kernel or left the "
                  "one-rank run", file=sys.stderr)
            return 1
    else:
        print("phase 30: one card visible: the branch of one rank a card over NCCL is not "
              "reached")

    # ---- phase 31: the sharded frame against the one-rank frame
    fn, o, d = sharded_frame_inputs(seed, dev)
    want = render_full_image(fn, o, d, rayschunk=4096)
    got = dict(np.load(os.path.join(workdir, "ddp2", "frame.npz")))
    gaps = {k: float(np.abs(got[k].astype(np.float64) - want[k]).max()) for k in want}
    fin = all(np.isfinite(v).all() for v in got.values())
    print(f"phase 31: a 120x160 NeuS frame (rayschunk 4,096, 19,200 rays) split by pixel over "
          f"2 ranks: max|diff| from the one-rank frame {gaps}; "
          f"{[round(x['tasks']['frame']['secs'], 3) for x in res]} s a rank {tag}")
    if set(got) != set(want) or not fin or max(gaps.values()) > FRAME_ATOL:
        print("FAIL phase 31: the sharded frame differs from the one-rank frame",
              file=sys.stderr)
        return 1
    return 0


PIPE_K = 10  # phases 32-34's steps_per_call: the first step of every 10 samples fresh
PIPE_LR0_STEPS = 20  # the lr-0 runs of phases 32-34, pipelined against standard
PIPE_WINDOW = "12:14"  # two pipelined steps (12 and 13 of the group 10-19)
DIRECT_STEPS = 20  # phase 35's training steps for each of direct_use / direct_more
_SIDE_KERNELS = ("neus_upsample_kernel", "sdf_forward_kernel", "init_kernel", "draw_kernel",
                 "checkpoint_kernel")


def _union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_ms(u, v):
    """The length of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(u) and j < len(v):
        total += max(0.0, min(u[i][1], v[j][1]) - max(u[i][0], v[j][0]))
        if u[i][1] < v[j][1]:
            i += 1
        else:
            j += 1
    return total


def stream_overlap(profile_dir):
    """From a profiler window's Chrome trace: the device time of the main
    stream (the one with the most kernels, copies and sets: the forward,
    the backward and Adam run there) and of the others (the side stream),
    the device time in which the side stream's work overlaps the main
    stream's, the window's span and busy share, and the side stream's
    kernels by name, with the host's synchronising CUDA calls in the window
    by the CPU op they ran in (the window's own close makes one). None
    without a trace or device events."""
    names = sorted(os.listdir(profile_dir)) if os.path.isdir(profile_dir) else []
    if not names:
        return None
    with open(os.path.join(profile_dir, names[0])) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    streams = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            s = (e.get("args") or {}).get("stream", e.get("tid"))
            streams.setdefault(s, []).append((e["ts"], e["ts"] + e["dur"], e.get("name", "")))
    if not streams:
        return None
    length = lambda u: sum(b - a for a, b in u)  # noqa: E731
    unions = {s: _union([(a, b) for a, b, _ in iv]) for s, iv in streams.items()}
    main = max(streams, key=lambda s: len(streams[s]))
    side = _union([(a, b) for s, iv in streams.items() if s != main for a, b, _ in iv])
    kernels = {}
    for s, iv in streams.items():
        if s != main:
            for _, _, n in iv:
                k = next((k for k in _SIDE_KERNELS if k in n), "other")
                kernels[k] = kernels.get(k, 0) + 1
    main_kernels = {}
    for _, _, n in streams[main]:
        k = next((k for k in _SIDE_KERNELS if k in n), None)
        if k:
            main_kernels[k] = main_kernels.get(k, 0) + 1
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy = length(_union([(a, b) for iv in streams.values() for a, b, _ in iv]))
    # each synchronising CUDA call, by the innermost CPU op around it
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    syncs = {}
    for e in events:
        if e.get("name", "") in ("cudaDeviceSynchronize", "cudaStreamSynchronize",
                                 "cudaEventSynchronize"):
            around = [o for o in ops if o["ts"] <= e["ts"] <= o["ts"] + o["dur"]]
            k = min(around, key=lambda o: o["dur"])["name"] if around else e["name"]
            syncs[k] = syncs.get(k, 0) + 1
    return {"main_ms": length(unions[main]) / 1e3, "side_ms": length(side) / 1e3,
            "overlap_ms": _overlap_ms(unions[main], side) / 1e3, "span_ms": span / 1e3,
            "busy": busy / span, "streams": len(streams), "side_kernels": kernels,
            "main_sampler_kernels": main_kernels, "host_syncs": syncs}


def _fmt_overlap(ov):
    if ov is None:
        return "not measured (no device events in the trace)"
    return (f"main stream {ov['main_ms']:.2f} ms, side stream {ov['side_ms']:.2f} ms, of it "
            f"{ov['overlap_ms']:.2f} ms ({100 * ov['overlap_ms'] / max(ov['side_ms'], 1e-9):.1f}%)"
            f" under the main stream's work; span {ov['span_ms']:.2f} ms, busy "
            f"{100 * ov['busy']:.1f}%; side-stream kernels {ov['side_kernels']}; sampler "
            f"kernels on the main stream {ov['main_sampler_kernels']}; host syncs "
            f"{ov['host_syncs']}")


def _pipelined_cfg(base, workdir, sub, *, steps=None, overlap=True, lr=None, quiet=False,
                   window=None, **model):
    """`base` (a config dict) as train.py's config for a phase-32-36 run
    under workdir/sub: steps_per_call PIPE_K, `training.overlap_sampler`
    `overlap`; `lr` replaces the lr; `quiet` drops the validations,
    meshes and numbered backups; `window` a profiler window."""
    from neurecon_tpu_torch.config import ConfigDict

    targs = ConfigDict(copy.deepcopy(base))
    d = os.path.join(workdir, sub)
    targs.training.update({"log_root_dir": d, "exp_dir": os.path.join(d, "run"),
                           "overlap_sampler": overlap, "steps_per_call": PIPE_K,
                           "monitoring": "none"})
    if steps is not None:
        targs.training["num_iters"] = steps
    if lr is not None:
        targs.training["lr"] = lr
    if quiet:
        targs.training.update({"i_val": 0, "i_val_mesh": -1, "i_backup": 0})
    if window:
        targs.training["profile_steps"] = window
    targs.model.update(model)
    return targs


def _lr0_pair(base, workdir, sub, zero_counts, read_counts):
    """PIPE_LR0_STEPS steps at lr 0 through train.py, pipelined and standard:
    (bit-equal in every step's loss and every final parameter, the
    pipelined run's launches, the standard run's)."""
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    runs = []
    for overlap in (True, False):
        targs = _pipelined_cfg(base, workdir, f"{sub}_lr0_{'pipe' if overlap else 'std'}",
                               steps=PIPE_LR0_STEPS, overlap=overlap, lr=0.0, quiet=True)
        out, launches, _, _ = _train_timed(targs, zero_counts, read_counts)
        totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
        runs.append((totals, load_checkpoint(out["final_ckpt"])["model"], launches))
    (ta, pa, la), (tb, pb, lb) = runs
    equal = len(ta) == PIPE_LR0_STEPS and ta == tb and _tree_gap(pa, pb, pb)[0]
    return equal, la, lb


def _same_run(a, b):
    """(bit-equal, max|loss diff|) of two train.py results: every step's
    loss and every final parameter."""
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    ta, tb = ([v for _, v in r["stats"]["losses"]["total_per_step"]] for r in (a, b))
    pa, pb = (load_checkpoint(r["final_ckpt"])["model"] for r in (a, b))
    gap = max((abs(x - y) for x, y in zip(ta, tb)), default=float("inf"))
    return len(ta) == len(tb) and ta == tb and _tree_gap(pa, pb, pb)[0], gap


def _volsdf_pipe_base(seed):
    """Phase 33's config: phase 16's VolSDF (`VOLSDF`, 1,024 rays, 40 steps)."""
    vol = copy.deepcopy(VOLSDF)
    vol.update({"expname": "chip_smoke_volsdf_train", "seed": seed})
    vol["data"]["mesh_N"] = 128
    vol["training"].update({"num_iters": VOLSDF_STEPS, "i_val": 20, "i_log": 10,
                            "i_val_mesh": 20, "i_backup": 20})
    return vol


STRESS_SPIN = 150_000_000  # cycles a sampler is held back in the stress order: ~76 ms at 1.98 GHz
_ORDERS = {"serial": "the sampler on the current stream in place of a second one (same draws, "
                      "serial order)",
           "stress": f"every sampler held back by a {STRESS_SPIN:,}-cycle spin on its stream"}


def _order_gate(label, base, workdir, sub, ref, zero_counts, read_counts, steps=None,
                **training):
    """The stream-order gate: train.py on `base` (its `steps` pipelined
    steps, `training` over its training section) with the sampler on the
    current stream, and again with every sampler held back on its stream
    (`_train_timed`'s "serial" and "stress"), each bit-equal in
    every step's loss and every final parameter, with the same launches, to
    `ref` ((result, launches) of the run as train.py runs it; None: that run
    too, without a profiler window). Returns (ok, max|loss diff|)."""
    runs = {}
    for order in ("side", "serial", "stress"):
        if order == "side" and ref is not None:
            runs[order] = ref
            continue
        targs = _pipelined_cfg(base, workdir, f"{sub}_{order}", steps=steps)
        targs.training.update(training)
        out, launches, _, secs = _train_timed(targs, zero_counts, read_counts, order=order)
        runs[order] = (out, launches)
        if order != "side":
            same, gap = _same_run(runs["side"][0], out)
            print(f"{label}: the same trained steps with {_ORDERS[order]}, {secs:.1f} s: every "
                  f"step's loss and every final parameter bit-equal {same} (max|loss diff| "
                  f"{gap:.3e}); launches equal {launches == runs['side'][1]}")
            runs[order] += (same and launches == runs["side"][1], gap)
    return (all(runs[o][2] for o in ("serial", "stress")),
            max(runs[o][3] for o in ("serial", "stress")))


def stream_order_check(seed, workdir, steps=2 * PIPE_K):
    """Phases 32-34's stream-order gate on its own (`tools/mutants.py`'s
    `stream` group): `steps` pipelined VolSDF steps at phase 33's config and
    lr (no validations, meshes or backups, no halt on a NaN), as train.py
    runs them, against the serial order and the held-back sampler:
    {"passes": all bit-equal, "max_loss_diff"}."""
    _, zero_counts, read_counts = _launch_counters()
    ok, gap = _order_gate("stream order", _volsdf_pipe_base(seed), workdir, "order", None,
                          zero_counts, read_counts, steps=steps, i_val=0, i_val_mesh=-1,
                          i_backup=0, halt_on_nan=False)
    return {"passes": bool(ok), "max_loss_diff": float(gap)}


def _pipelined_phase(n, name, base, ref_launches, ref_ms, workdir, tag, zero_counts,
                     read_counts, by_path, side_kernel):
    """One of phases 32-34: the lr-0 pair, then the trained run with a
    profiler window over two pipelined steps: its launches against the
    standard run's (`ref_launches`, the same config and cuts), `side_kernel`
    on the side stream in the trace, finite losses whose last 10 steps' mean
    is below the first 10's; then the stream-order gate (`_order_gate`):
    the same trained run with the sampler on the current stream (the same
    draws in the same host order, every kernel on one stream) and with
    every sampler held back by a spin on its stream, each bit-equal to it in
    every step's loss and every final parameter: the side stream's ordering
    (the waits, `record_stream`) must leave no trace.
    Returns (ok, {ms, ref_ms, overlap})."""
    t0 = time.perf_counter()
    equal, la, lb = _lr0_pair(base, workdir, f"pipe_{name}", zero_counts, read_counts)
    by_path[f"pipelined_{name}_lr0"] = la
    print(f"phase {n}: {PIPE_LR0_STEPS} {name} steps at lr 0 through train.py, pipelined "
          f"(steps_per_call {PIPE_K}) against standard: every step's loss and every final "
          f"parameter bit-equal {equal}; launches {la} against {lb}")
    targs = _pipelined_cfg(base, workdir, f"pipe_{name}", window=PIPE_WINDOW)
    out, launches, step_ms, secs = _train_timed(targs, zero_counts, read_counts)
    by_path[f"pipelined_{name}_train"] = launches
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    S = len(totals)
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    ms_step = float(np.median(step_ms[5:]))
    ov = stream_overlap(os.path.join(out["exp_dir"], "profile"))
    print(f"phase {n}: train.py {S} {name} steps pipelined (steps_per_call {PIPE_K}, the "
          f"sampler of steps 2-{PIPE_K} of a group on a second CUDA stream), {secs:.1f} s: "
          f"launches {launches} (the standard run's {ref_launches}); loss mean of steps 1-10 "
          f"{first:.5f}, of the last 10 {last:.5f}")
    print(f"phase {n}: median {ms_step:.2f} ms/step over steps 6-{S} pipelined against "
          f"{ref_ms:.2f} standard ({100 * (ms_step / ref_ms - 1):+.2f}%); all steps ms "
          f"{[round(v, 1) for v in step_ms]} {tag}")
    print(f"phase {n}: profiler window over steps {PIPE_WINDOW.replace(':', '-')} (exclusive "
          f"end): {_fmt_overlap(ov)} {tag}")
    same, _ = _order_gate(f"phase {n}", base, workdir, f"pipe_{name}", (out, launches),
                          zero_counts, read_counts)
    ok = (equal and same and launches == ref_launches
          and ov is not None
          and ov["side_kernels"].get(side_kernel, 0) >= 1 and not ov["main_sampler_kernels"]
          and len(totals) == int(targs.training.num_iters) and np.isfinite(totals).all()
          and last < first)
    print(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    return ok, {"ms": ms_step, "ref_ms": ref_ms, "overlap": ov}


def _direct_d_all_check(model, kw, rays_o, rays_d, algo, u, label):
    """compute_ray_samples with `algo` through kernel 4 against the plain
    sdf query, at phase 3's gate: |d_all diff| <= 1e-3 (far - near) on >=
    99.9% of the entries, where in det mode one entry a ray in the last bin
    of the weighted depths on both sides (the u = 1.0 tie) is exempt; every
    depth finite. Returns (ok, max|diff|, kernel-4 launches)."""
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, compute_ray_samples
    from neurecon_tpu_torch.ops import fused_mlp
    from neurecon_tpu_torch.ops.sampling import linspace01

    before = fused_mlp.fused_sdf_forward.launches
    got = compute_ray_samples(model, rays_o, rays_d, u_up=u, **kw)
    launched = fused_mlp.fused_sdf_forward.launches - before
    with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain):
        ref = compute_ray_samples(model, rays_o, rays_d, u_up=u, **kw)
    torch.cuda.synchronize()
    _, _, near, far = _prepare_rays(rays_o, rays_d, kw["obj_bounding_radius"])
    n = kw["N_samples"] if algo == "direct_use" else kw["N_nograd_samples"]
    t = linspace01(n, rays_o.device)[-2]
    last_bin = near * (1 - t) + far * t
    diff = (got - ref).abs()
    off = diff > 1e-3 * (far - near)
    tie = off & (got >= last_bin) & (ref >= last_bin)
    exempt = tie & (tie.sum(1, keepdim=True) <= 1) if not kw["perturb"] else torch.zeros_like(off)
    frac = float((off & ~exempt).float().mean())
    print(f"{label}: {algo} d_all through kernel 4 ({launched} launch) against the plain "
          f"query, {'perturb' if kw['perturb'] else 'det'}: max|diff| {float(diff.max()):.3e}, "
          f"share beyond 1e-3 (far - near) {float(off.float().mean()):.5f}, {int(exempt.sum())} "
          f"u=1.0 tie entries exempt, share of the rest {frac:.5f}")
    return (frac <= 1e-3 and bool(torch.isfinite(got).all()) and launched == 1,
            float(diff.max()), launched)


def _pipeline_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir, refs):
    """Phases 32-36 (see the module docstring). `refs`: phase 8's, 16's and
    23's median ms per step, phase 8's and 16's final checkpoints and
    phase 22's DTU-layout scene. Returns 0 or 1."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks.neus import _uniforms, make_volume_render_fn
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.tools import (plot_neus_bias, render_view, supervise,
                                          test_volsdf_algo, vis_camera, vis_ray,
                                          vis_surface_and_cam)
    from neurecon_tpu_torch.tools.eval_mesh import chamfer_distance
    from neurecon_tpu_torch.training import render_full_image
    from neurecon_tpu_torch.utils import mesh as mesh_util

    t_all = time.perf_counter()
    # ---- phase 32: NeuS pipelined at phase 8's config, seed and cuts
    neus = _train_config(os.path.join(workdir, "unused"), seed)
    ok, _ = _pipelined_phase(32, "neus", neus, by_path["train"], refs["neus_ms"], workdir, tag,
                             zero_counts, read_counts, by_path, "neus_upsample_kernel")
    if not ok:
        print("FAIL phase 32: the pipelined NeuS run is not bit-equal at lr 0 or to its serial "
              "order, missed a kernel, ran its sampler on no second stream, diverged or did not "
              "lower the loss", file=sys.stderr)
        return 1

    # ---- phase 33: VolSDF pipelined at phase 16's config and cuts
    ok, _ = _pipelined_phase(33, "volsdf", _volsdf_pipe_base(seed), by_path["volsdf_train"],
                             refs["volsdf_ms"],
                             workdir, tag, zero_counts, read_counts, by_path,
                             "sdf_forward_kernel")
    if not ok:
        print("FAIL phase 33: the pipelined VolSDF run is not bit-equal at lr 0 or to its serial "
              "order, missed a kernel, ran its sampler on no second stream, diverged or did not "
              "lower the loss", file=sys.stderr)
        return 1

    # ---- phase 34: UNISURF pipelined at phase 23's config and cuts
    uni, _ = unisurf_train_config(refs["dtu_root"], os.path.join(workdir, "unused"), seed)
    ok, _ = _pipelined_phase(34, "unisurf", uni, by_path["unisurf_train"], refs["unisurf_ms"],
                             workdir, tag, zero_counts, read_counts, by_path,
                             "sdf_forward_kernel")
    if not ok:
        print("FAIL phase 34: the pipelined UNISURF run is not bit-equal at lr 0 or to its serial "
              "order, missed a kernel, ran its root find on no second stream, diverged or did "
              "not lower the loss", file=sys.stderr)
        return 1

    # ---- phase 35: the direct_use and direct_more upsamplers
    t0 = time.perf_counter()
    c = render_chunk_inputs(seed, dev)
    checked, kw_test = c["checked"], dict(c["kw_test"])
    kw_test.pop("rayschunk", None)
    o_all, d_dirs = c["o_all"], c["d_all_dirs"]
    idx = torch.linspace(0, 120 * 160 - 1, 4096, device=dev).long()
    patch = torch.arange(60 * 160 - 1024, 60 * 160 + 1024, device=dev)
    for algo in ("direct_use", "direct_more"):
        kw = dict(kw_test, upsample_algo=algo)
        for perturb in (False, True):
            u = _uniforms(4096, 1, 64, perturb, torch.Generator(dev).manual_seed(seed), dev)
            ok, _, _ = _direct_d_all_check(checked, dict(kw, perturb=perturb), o_all[idx],
                                           d_dirs[idx], algo, u, "phase 35")
            if not ok:
                print(f"FAIL phase 35: {algo}'s d_all through kernel 4 disagrees with the "
                      "plain query", file=sys.stderr)
                return 1
        render_fn = make_volume_render_fn(checked, detailed_output=False, calc_normal=True, **kw)
        zero_counts()
        out_k = render_full_image(render_fn, o_all[patch], d_dirs[patch], rayschunk=4096)
        patch_launches = read_counts()
        with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain), \
                mock.patch.object(fused_nablas, "fused_forward_with_nablas",
                                  fused_nablas.forward_with_nablas_plain):
            out_p = render_full_image(render_fn, o_all[patch], d_dirs[patch], rayschunk=4096)
        e = {k: float(np.abs(out_k[k] - out_p[k]).max())
             for k in ("rgb", "depth_volume", "mask_volume")}
        print(f"phase 35: {algo} 2048-ray patch, kernels 4 and 1 vs plain: max|diff| {e}; "
              f"launches {patch_launches}")
        if e["rgb"] > 2e-3 or patch_launches["sdf_forward"] != 1 or patch_launches[
                "neus_upsample"]:
            print(f"FAIL phase 35: the {algo} patch disagrees with the plain render",
                  file=sys.stderr)
            return 1
        base = _train_config(os.path.join(workdir, "unused"), seed)
        targs = _pipelined_cfg(base, workdir, algo, steps=DIRECT_STEPS, overlap=False,
                               quiet=True, upsample_algo=algo)
        out, launches, step_ms, secs = _train_timed(targs, zero_counts, read_counts)
        by_path[f"{algo}_train"] = launches
        totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
        first, last = float(np.mean(totals[:5])), float(np.mean(totals[-5:]))
        ms_step = float(np.median(step_ms[5:]))
        want = {"nablas_forward": DIRECT_STEPS, "neus_upsample": 0,
                "nablas_backward": DIRECT_STEPS, "sdf_forward": DIRECT_STEPS,
                "volsdf_init": 0, "volsdf_draw": 0, "volsdf_checkpoint": 0}
        vargs = ConfigDict(copy.deepcopy(FLAGSHIP))
        vargs.model["upsample_algo"] = algo
        vargs.update({"load_pt": out["final_ckpt"], "num_views": 1,
                      "camera_path": "interpolation", "rayschunk": 4096})
        zero_counts()
        frame = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        f_launches = by_path[f"{algo}_render"] = read_counts()
        print(f"phase 35: train.py {DIRECT_STEPS} flagship steps with upsample_algo {algo} "
              f"({secs:.1f} s): launches {launches} (want {want}); loss mean of steps 1-5 "
              f"{first:.5f}, of steps {DIRECT_STEPS - 4}-{DIRECT_STEPS} {last:.5f}; median "
              f"{ms_step:.2f} ms/step over steps 6-{DIRECT_STEPS} ({512e3 / ms_step:.0f} "
              f"rays/s) {tag}")
        print(f"phase 35: render_view {algo} 1 x 120x160: launches {f_launches}, s/frame "
              f"{[round(s, 4) for s in frame['seconds']]} {tag}")
        if (launches != want or not np.isfinite(totals).all() or not last < first
                or f_launches["sdf_forward"] != 5 or f_launches["nablas_forward"] != 5
                or not all(np.isfinite(frame[k]).all() for k in ("rgb", "depth", "normal"))):
            print(f"FAIL phase 35: {algo} training or its frame missed a kernel, diverged or "
                  "did not lower the loss", file=sys.stderr)
            return 1
    print(f"phase 35: {time.perf_counter() - t0:.1f} s")

    # ---- phase 36: the tools' card paths
    t0 = time.perf_counter()
    fargs = ConfigDict(copy.deepcopy(FLAGSHIP))
    zero_counts()
    vk, fk = vis_surface_and_cam.extract_mesh_from_ckpt(refs["neus_ckpt"], fargs, N=128,
                                                        device="cuda")
    torch.cuda.synchronize()
    mesh_launches = by_path["vis_surface_and_cam"] = read_counts()
    with mock.patch.object(fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain):
        vp, fp = vis_surface_and_cam.extract_mesh_from_ckpt(refs["neus_ckpt"], fargs, N=128,
                                                            device="cuda")
    cd = chamfer_distance(vk, vp)[0] if min(len(vk), len(vp)) else float("inf")
    print(f"phase 36: vis_surface_and_cam's mesh of phase 8's final checkpoint (128^3, kernel "
          f"4): {len(vk)} verts, {len(fk)} faces; the plain grid's {len(vp)} / {len(fp)}; "
          f"Chamfer {cd:.3e}; launches {mesh_launches}")
    if cd >= 1e-3 * 2.0 or mesh_launches["sdf_forward"] != math.ceil(128 ** 3 / 262144):
        print("FAIL phase 36: vis_surface_and_cam's kernel-4 mesh disagrees with the plain "
              "grid's", file=sys.stderr)
        return 1
    vcfg = ConfigDict(copy.deepcopy(VOLSDF))
    zero_counts()
    nk = test_volsdf_algo.volsdf_algo_numbers(load_pt=refs["volsdf_ckpt"], config=vcfg,
                                              device="cuda")
    torch.cuda.synchronize()
    algo_launches = by_path["test_volsdf_algo"] = read_counts()
    npl = test_volsdf_algo.volsdf_algo_numbers(load_pt=refs["volsdf_ckpt"], config=vcfg,
                                               device="cuda", plain=True)
    span = 6.0
    share = float((np.abs(nk["d_fine"] - npl["d_fine"]) > 1e-4 * span).mean())
    print(f"phase 36: test_volsdf_algo --load_pt (phase 16's final checkpoint, learned beta "
          f"{nk['beta_net']:.5f}): the probe ray's 64 fine depths through kernel 4 and (a)-(c) "
          f"against the plain sampler: share beyond 1e-4 of the span {share:.4f}, max|diff| "
          f"{float(np.abs(nk['d_fine'] - npl['d_fine']).max()):.3e}; beta map {nk['beta_map']:.6f}"
          f" / {npl['beta_map']:.6f}, rounds {nk['iter_usage']} / {npl['iter_usage']}; "
          f"launches {algo_launches}")
    if (share > 0.02 or abs(nk["beta_map"] - npl["beta_map"]) > 1e-5 + 1e-3 * abs(
            npl["beta_map"]) or nk["iter_usage"] != npl["iter_usage"]
            or algo_launches["volsdf_init"] != 1
            or algo_launches["volsdf_checkpoint"] != test_volsdf_algo.MAX_ITER):
        print("FAIL phase 36: test_volsdf_algo's sampler through the kernels disagrees with "
              "the plain sampler", file=sys.stderr)
        return 1
    # the other tools' numbers, on the card by default
    oracle = test_volsdf_algo.volsdf_algo_numbers()
    worst_peak = max(p["peak_err"] - 2.5 / (p["N"] - 1)
                     for row in plot_neus_bias.bias_curves() for p in row)
    rargs = ConfigDict(copy.deepcopy(FLAGSHIP))
    ro, rd, _ = vis_ray.probe_rays(rargs)
    centres = np.asarray(get_data(rargs).c2w_all)[:, :3, 3]
    ray_gap = (float(np.abs(ro - centres).max()),
               float(np.abs(np.linalg.norm(rd, axis=-1) - 1).max()))
    print(f"phase 36: on the card: test_volsdf_algo's closed-form oracle max error "
          f"{oracle['err'].max():.4g} within its bound {oracle['within']}, rounds "
          f"{oracle['iter_usage']}, 64 fine depths finite "
          f"{bool(np.isfinite(oracle['d_fine']).all())}; plot_neus_bias's worst NeuS peak "
          f"beyond a sample spacing {worst_peak:.4g}; vis_ray's {len(ro)} probe rays: origin "
          f"to camera centre {ray_gap[0]:.3e}, | |d| - 1 | {ray_gap[1]:.3e}")
    if (not oracle["within"] or oracle["d_fine"].shape != (64,)
            or not np.isfinite(oracle["d_fine"]).all() or worst_peak > 0
            or ray_gap[0] > 1e-5 or ray_gap[1] > 1e-5):
        print("FAIL phase 36: a tool's numbers on the card are wrong", file=sys.stderr)
        return 1
    # supervise around a short train.py run in a child process (its config as
    # JSON: the card machine has no PyYAML); the memory this process's
    # allocator keeps cached goes back to the card first, or the child's
    # kernel-3 workspace does not fit
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sup = _pipelined_cfg(_train_config(os.path.join(workdir, "unused"), seed), workdir,
                         "supervised", steps=4, overlap=True, quiet=True)
    job = os.path.join(workdir, "supervised.json")
    with open(job, "w") as f:
        json.dump(sup.to_dict(), f)
    child = ("import json, sys; from neurecon_tpu_torch import train; "
             "from neurecon_tpu_torch.config import ConfigDict; "
             "train.main_function(ConfigDict(json.load(open(sys.argv[1]))), device='cuda')")
    lines = []
    ts = time.perf_counter()
    rc = supervise.supervise([sys.executable, "-c", child, job], stall_sec=240,
                             max_restarts=1, poll_sec=0.5, log=lines.append)
    finals = [n for n in os.listdir(os.path.join(sup.training.exp_dir, "ckpts"))
              if n.startswith("final_")] if rc == 0 else []
    print(f"phase 36: supervise around train.py (4 pipelined steps in a child process): rc {rc} "
          f"in {time.perf_counter() - ts:.1f} s, {finals}; " + "; ".join(lines))
    if rc != 0 or finals != ["final_00000004.pt"]:
        print("FAIL phase 36: supervise's train.py run did not finish", file=sys.stderr)
        return 1
    try:
        vis_camera.pyplot()
        drawn = "matplotlib is installed (figures not drawn here)"
    except RuntimeError as e:
        drawn = f"no matplotlib here, a figure raises: {e}"
        if "needs matplotlib" not in str(e):
            return 1
    print(f"phase 36: {drawn}; {time.perf_counter() - t0:.1f} s")
    print(f"phases 32-36: {time.perf_counter() - t_all:.1f} s {tag}")
    return 0


# ---- phases 37-39: JPEG scans, the NeRF-like head and ScalarField, the probes

# configs/neus_nomask_blended.yaml and configs/volsdf_nerfpp_blended.yaml as
# the files hold them (held equal to the files by tests/test_torch_jpeg.py):
# NeuS without masks and VolSDF with the NeRF++ background on a BlendedMVS
# scan, which phase 37 writes as JPEG
NEUS_NOMASK_BLENDED = {
    "data": {"N_rays": 512, "batch_size": 1,
             "data_dir": "./data/BlendedMVS/BlendedMVS/5c0d13b795da9479e12e2ee9",
             "downscale": 1, "pin_memory": True, "scale_radius": 2.0, "type": "BlendedMVS",
             "val_downscale": 4, "val_rayschunk": 256},
    "device_ids": -1, "expname": "neus_nomask_blended_5c0d13",
    "model": {"N_nograd_samples": 2048, "N_outside": 32, "N_upsample_iters": 4,
              "framework": "NeuS", "obj_bounding_radius": 1.0,
              "radiance": {"D": 4, "W": 256, "embed_multires": -1, "embed_multires_view": 4,
                           "skips": []},
              "surface": {"D": 8, "W": 256, "embed_multires": 6, "radius_init": 0.5,
                          "skips": [4]},
              "upsample_algo": "official_solution", "variance_init": 0.05},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "monitoring": "tensorboard",
                 "num_iters": 300000, "scheduler": {"type": "warmupcosine", "warmup_steps": 5000},
                 "speed_factor": 10.0, "w_eikonal": 0.1, "with_mask": False},
}
VOLSDF_NERFPP_BLENDED = {
    "data": {"N_rays": 1024, "batch_size": 1,
             "data_dir": "./data/BlendedMVS/BlendedMVS/5c0d13b795da9479e12e2ee9",
             "downscale": 1, "far": 6.0, "near": 0.0, "pin_memory": True, "scale_radius": 3.0,
             "type": "BlendedMVS", "val_downscale": 4, "val_rayschunk": 256,
             "volume_size": 5.0},
    "device_ids": -1, "expname": "volsdf_nerf++_blended_5c0d13",
    "model": {"W_geometry_feature": 256, "framework": "VolSDF", "max_upsample_iter": 5,
              "obj_bounding_radius": 3.0, "outside_scene": "nerf++",
              "radiance": {"D": 4, "embed_multires": -1, "embed_multires_view": -1,
                           "skips": []},
              "surface": {"D": 8, "embed_multires": 6, "radius_init": 1.0, "skips": [4]}},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "monitoring": "tensorboard",
                 "num_iters": 200000, "scheduler": {"type": "warmupcosine", "warmup_steps": 0},
                 "speed_factor": 10.0, "w_eikonal": 0.1},
}
BLENDED_SHAPE = (8, 576, 768)  # views, H, W: BlendedMVS's frame size
BLENDED_STEPS = 30  # phase 37's cut of each file's 300,000 / 200,000 steps
JPEG_PSNR_GATE = 40.0  # dB, a decoded q95 4:2:0 frame against the array written
HEAD_STEPS = 20  # phase 38's steps of the NeRF-like NeuS
_IMAGE_LIBS = ("imageio", "PIL", "cv2")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _jpeg_route_line():
    """The log's "images:" line as the process logs it where imageio is
    absent, and the image libraries in sys.modules."""
    from neurecon_tpu_torch.utils import io as io_util

    lines = []
    io_util._imageio.cache_clear()
    with mock.patch.object(io_util.log, "info", lines.append):
        route = io_util._imageio()
    return route, " ".join(lines), [m for m in _IMAGE_LIBS if m in sys.modules]


def _jpeg_scene_check(root_jpg, root_png, layout, scene, cfg_data):
    """A JPEG scene and its PNG twin through `get_data` as a config reads
    them: (decoded rgb's PSNR against the arrays written, cameras and masks
    equal to the PNG scene's, load seconds, the JPEG dataset)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data

    def load(root):
        data = dict(cfg_data, type=layout, data_dir=root, downscale=1.0)
        data.pop("val_downscale", None)
        return get_data(ConfigDict({"data": data}))
    t0 = time.perf_counter()
    dj = load(root_jpg)
    secs = time.perf_counter() - t0
    dp = load(root_png)
    psnr = _psnr(dj.rgb_images * 255.0, scene["encoded"].reshape(len(dj), -1, 3))
    same = (np.array_equal(dj.c2w_all, dp.c2w_all)
            and np.array_equal(dj.intrinsics_all, dp.intrinsics_all))
    for name in ("object_masks", "masks_ignore"):
        a, b = getattr(dj, name, None), getattr(dp, name, None)
        same &= (a is None) == (b is None) and (a is None or np.array_equal(a, b))
    return psnr, same, secs, dj


def _blended_train(name, base, root, workdir, seed, tag, zero_counts, read_counts, by_path,
                   want_fn, extra_cuts=()):
    """One *_blended config through train.py on the JPEG scene at `root`,
    with phase 37's cuts (printed); returns (ok, ms a step)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.utils import mesh as mesh_util

    S = BLENDED_STEPS
    tdir = os.path.join(workdir, f"{name}_train")
    cuts = [("data.data_dir", root), ("training.num_iters", S), ("training.i_val", S),
            ("training.i_val_mesh", S // 2), ("data.mesh_N", 64), ("training.i_log", 10),
            ("training.i_backup", -1), ("training.monitoring", "none"),
            ("training.log_root_dir", tdir), ("training.exp_dir", os.path.join(tdir, "run")),
            ("expname", f"chip_smoke_{name}"), ("seed", seed), *extra_cuts]
    print(f"phase 37: configs/{name}.yaml with the cuts "
          + ", ".join(f"{k}={v}" for k, v in cuts))
    targs = ConfigDict(_with_cuts(base, cuts))
    out, launches, step_ms, run_s = _train_timed(targs, zero_counts, read_counts)
    by_path[f"jpeg_{name}_train"] = launches
    ms = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    mesh = os.path.join(out["exp_dir"], "meshes", f"{S // 2:08d}.ply")
    n_faces = len(mesh_util.read_ply(mesh)[1]) if os.path.exists(mesh) else -1
    want = want_fn(S)
    rays = base["data"]["N_rays"]
    print(f"phase 37: train.py {name} {S} steps at {rays} rays from the JPEG scene, {run_s:.1f} s "
          f"in all: launches {launches} (want {want}; one validation at val_downscale "
          f"{base['data']['val_downscale']}); loss mean of steps 1-10 {first:.5f}, of the last "
          f"10 {last:.5f}; 64^3 mesh at step {S // 2}: {n_faces} faces")
    print(f"phase 37: {name} median {ms:.2f} ms/step over steps 6-{S} ({rays * 1e3 / ms:.0f} "
          f"rays/s); all steps ms {[round(v, 1) for v in step_ms]} {tag}")
    ok = (all(launches[k] == v for k, v in want.items()) and launches["sdf_forward"] > 0
          and len(totals) == S and bool(np.isfinite(totals).all()) and last < first
          and n_faces >= 0)
    return ok, ms


def _jpeg_head_probe_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 37-39 (see the module docstring). Returns 0 or 1."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import ScalarField, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp
    from neurecon_tpu_torch.tools import (bench_ablate, bench_fused_upsample, bench_gradblock,
                                          bench_render_cull, bench_roadmap, bench_volsdf_ablate,
                                          probe_lax_map, render_view)
    from neurecon_tpu_torch.utils import jpeg

    # ---- phase 37: JPEG scans through the loaders, and the *_blended configs
    t37 = time.perf_counter()
    n, H, W = BLENDED_SHAPE
    roots = {}
    scenes = {}
    t0 = time.perf_counter()
    for layout, shape in (("BlendedMVS", BLENDED_SHAPE), ("custom", SMALL_SHAPE)):
        for fmt in ("jpg", "png"):
            roots[layout, fmt] = os.path.join(workdir, f"scene_{layout.lower()}_{fmt}")
            scenes[layout, fmt] = write_scene(roots[layout, fmt], layout, *shape,
                                              background="envmap", fmt=fmt)
    write_s = time.perf_counter() - t0
    route, line, libs = _jpeg_route_line()
    frames = sorted(f for f in os.listdir(os.path.join(roots["BlendedMVS", "jpg"],
                                                       "blended_images")) if "masked" not in f)
    dec_ms = []
    for f in frames:
        t0 = time.perf_counter()
        jpeg.read_jpeg(os.path.join(roots["BlendedMVS", "jpg"], "blended_images", f))
        dec_ms.append(1e3 * (time.perf_counter() - t0))
    ok = route is None and "utils/jpeg.py::read_jpeg" in line and not libs
    print(f"phase 37: wrote the BlendedMVS-layout envmap scene ({n} views at {H}x{W}) and a "
          f"custom-layout one ({SMALL_SHAPE[0]} x {SMALL_SHAPE[1]}x{SMALL_SHAPE[2]}), each as "
          f"JPEG (q95, 4:2:0) and as PNG, in {write_s:.1f} s; images route: {line!r}; image "
          f"libraries loaded: {libs or 'none'}")
    print(f"phase 37: utils/jpeg.py decodes a {H}x{W} frame in {float(np.median(dec_ms)):.1f} ms "
          f"(median of {len(dec_ms)}, host; all {[round(v, 1) for v in dec_ms]}) {tag}")
    for layout, cfg_data in (("BlendedMVS", NEUS_NOMASK_BLENDED["data"]),
                             ("custom", {"scale_radius": 3.0})):
        psnr, same, secs, ds = _jpeg_scene_check(roots[layout, "jpg"], roots[layout, "png"],
                                                 layout, scenes[layout, "jpg"], cfg_data)
        good = psnr >= JPEG_PSNR_GATE and same and np.isfinite(ds.rgb_images).all()
        print(f"phase 37: {layout} JPEG scene through get_data in {secs:.2f} s: {len(ds)} views "
              f"of {ds.H}x{ds.W}; decoded rgb PSNR {psnr:.2f} dB against the arrays written "
              f"(gate {JPEG_PSNR_GATE:g}); cameras and masks equal to the PNG scene's {same}")
        ok &= good
    libs = [m for m in _IMAGE_LIBS if m in sys.modules]
    if not ok or libs:
        print(f"FAIL phase 37: a JPEG scene did not load through the port's reader as written "
              f"(image libraries loaded: {libs})", file=sys.stderr)
        return 1
    val_chunks = math.ceil((H // 4) * (W // 4) / 256)  # one validation, val_downscale 4
    ok_n, ms_n = _blended_train(
        "neus_nomask_blended", NEUS_NOMASK_BLENDED, roots["BlendedMVS", "jpg"], workdir, seed,
        tag, zero_counts, read_counts, by_path,
        lambda S: {"nablas_forward": S + val_chunks, "neus_upsample": S + val_chunks,
                   "nablas_backward": S},
        extra_cuts=[("training.scheduler.warmup_steps", 10)])
    max_iter = VOLSDF_NERFPP_BLENDED["model"]["max_upsample_iter"]

    def want_volsdf(S):
        calls = S + val_chunks
        return {"volsdf_init": calls, "volsdf_draw": calls,
                "volsdf_checkpoint": max_iter * calls, "nablas_forward": calls,
                "nablas_backward": S, "neus_upsample": 0}
    ok_v, ms_v = _blended_train(
        "volsdf_nerfpp_blended", VOLSDF_NERFPP_BLENDED, roots["BlendedMVS", "jpg"], workdir,
        seed, tag, zero_counts, read_counts, by_path, want_volsdf)
    print(f"phase 37: {time.perf_counter() - t37:.1f} s")
    if not (ok_n and ok_v):
        print("FAIL phase 37: a *_blended run from the JPEG scene missed a kernel, diverged or "
              "did not lower the loss", file=sys.stderr)
        return 1

    # ---- phase 38: the NeRF-like head (W_geometry_feature -1) and ScalarField
    t38 = time.perf_counter()
    c = render_chunk_inputs(seed, dev)
    hcfg = _with_cuts(FLAGSHIP, [("model.W_geometry_feature", -1)])
    head, _, _, _ = get_model(ConfigDict(copy.deepcopy(hcfg)), dev, seed=seed)
    checked = copy.deepcopy(head)
    perturb_parameters(checked, torch.Generator().manual_seed(seed + 1))
    surf = checked.implicit_surface
    ok, k2_err = upsample_checks(surf, c, "phase 38 (NeRF-like head)")
    g = torch.Generator(dev).manual_seed(seed)
    x4 = torch.rand(2 ** 18 + 4099, 3, device=dev, generator=g) * 2 - 1
    got = fused_mlp.fused_sdf_forward(surf, x4)
    ref = fused_mlp.sdf_forward_plain(surf, x4)
    torch.cuda.synchronize()
    e4 = float((got - ref).abs().max() / ref.abs().max())
    refused = []
    for fn, args in ((fused_nablas.fused_forward_with_nablas, (surf, x4[:128])),
                     (fused_nablas_vjp.fused_nablas_vjp, (surf, x4[:128], [], [], x4[:128, 0],
                                                          x4[:128], x4[:128]))):
        try:
            fn(*args)
            refused.append(False)
        except NotImplementedError:
            refused.append(True)
    print(f"phase 38: NeRF-like head (final layer {surf.dims[-1]}, geometry features = the last "
          f"hidden activation): kernel 2 vs plain max|d_all diff| det {k2_err['det']:.3e}, "
          f"perturb {k2_err['perturb']:.3e}; kernel 4 vs plain on {x4.shape[0]} points max|diff| "
          f"{e4:.2e} of max|sdf| (gate 1e-5); kernels 1 and 3 refuse the head on the card "
          f"{refused}")
    if not ok or e4 > 1e-5 or not all(refused):
        print("FAIL phase 38: the head's kernels 2 and 4 disagree with their plain versions, or "
              "kernel 1 or 3 took the head", file=sys.stderr)
        return 1
    tdir = os.path.join(workdir, "head_train")
    S = HEAD_STEPS
    hargs = _train_config(tdir, seed)
    hargs["model"]["W_geometry_feature"] = -1
    hargs["expname"] = "chip_smoke_nerf_head"
    hargs["data"]["mesh_N"] = 64
    hargs["training"].update({"num_iters": S, "i_val": S, "i_val_mesh": S // 2,
                              "i_backup": -1, "exp_dir": os.path.join(tdir, "run")})
    out, launches, step_ms, run_s = _train_timed(ConfigDict(hargs), zero_counts, read_counts)
    by_path["nerf_head_train"] = launches
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    ms_h = float(np.median(step_ms[5:]))
    want = {"neus_upsample": S + 1, "nablas_forward": 0, "nablas_backward": 0}
    print(f"phase 38: train.py {S} flagship NeuS steps with the NeRF-like head, {run_s:.1f} s: "
          f"launches {launches} (want {want}: kernel 2 once a step and for the step-0 "
          f"validation's chunk, the nablas and eikonal on autograd; kernel 4 for the step-{S // 2}"
          f" 64^3 mesh); loss mean of steps 1-10 {first:.5f}, of the last 10 {last:.5f}; median "
          f"{ms_h:.2f} ms/step ({512e3 / ms_h:.0f} rays/s) {tag}")
    vargs = ConfigDict(copy.deepcopy(hcfg))
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 1, "camera_path": "interpolation",
                  "rayschunk": 4096})
    zero_counts()
    fr = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    f_launches = by_path["nerf_head_render_view"] = read_counts()
    print(f"phase 38: render_view NeRF-like head 1 x 120x160: launches {f_launches} (kernel 2 "
          f"want 5), s/frame {[round(v, 4) for v in fr['seconds']]} {tag}")
    field = ScalarField(input_ch=3, W=128, D=4, skips=(2,), init_val=-2.0)
    field.reset_parameters(torch.Generator().manual_seed(seed))
    perturb_parameters(field.pts_linears, torch.Generator().manual_seed(seed + 1))
    with torch.no_grad():
        field.output_linear.w.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed))
        xf = torch.rand(4096, 3, generator=torch.Generator().manual_seed(seed)) * 2 - 1
        f_cpu = field(xf)
        f_dev = field.to(dev)(xf.to(dev)).cpu()
    e_f = float((f_cpu - f_dev).abs().max())
    tree_ok = {k for k in bridge.net_to_tree(field)} == {"pts_linears", "output_linear"}
    print(f"phase 38: ScalarField (W 128, D 4, skip after layer 2) on the card against the CPU: "
          f"max|diff| {e_f:.2e} of max {float(f_cpu.abs().max()):.3f} (gate 1e-5); bridge tree "
          f"{tree_ok}; {time.perf_counter() - t38:.1f} s")
    if (any(launches[k] != v for k, v in want.items()) or launches["sdf_forward"] == 0
            or len(totals) != S or not np.isfinite(totals).all() or not last < first
            or f_launches["neus_upsample"] != 5 or f_launches["nablas_forward"] != 0
            or not np.isfinite(fr["rgb"]).all() or e_f > 1e-5 or not tree_ok):
        print("FAIL phase 38: the NeRF-like head's run, its frame or ScalarField is off",
              file=sys.stderr)
        return 1

    # ---- phase 39: the probes, at cut K
    t39 = time.perf_counter()
    zero_counts()
    probes = {}
    for mod, argv in ((bench_ablate, ["--K", "3"]), (bench_volsdf_ablate, ["--K", "3"]),
                      (bench_render_cull, ["--K", "1"]), (bench_fused_upsample, ["--K", "5"]),
                      (bench_gradblock, ["--K", "5"]), (bench_roadmap, ["--K", "10"]),
                      (probe_lax_map, [])):
        name = mod.__name__.rsplit(".", 1)[1]
        t0 = time.perf_counter()
        probes[name] = (mod.main(["--seed", str(seed)] + argv), time.perf_counter() - t0)
    torch.cuda.synchronize()
    by_path["probes"] = read_counts()
    gates = {name: (bool(probes[name][0]) and (not hasattr(mod, "passed")
                                               or mod.passed(probes[name][0])))
             for name, mod in (("bench_fused_upsample", bench_fused_upsample),
                               ("bench_render_cull", bench_render_cull),
                               ("probe_lax_map", probe_lax_map), ("bench_ablate", bench_ablate),
                               ("bench_volsdf_ablate", bench_volsdf_ablate),
                               ("bench_gradblock", bench_gradblock),
                               ("bench_roadmap", bench_roadmap))}
    print(f"phase 39: the seven probes in {time.perf_counter() - t39:.1f} s ("
          + ", ".join(f"{k} {v[1]:.1f} s" for k, v in probes.items())
          + f"); launches {by_path['probes']}; gates {gates} {tag}")
    if not all(gates.values()) or any(v == 0 for v in by_path["probes"].values()):
        print("FAIL phase 39: a probe's correctness rows failed or a kernel went unlaunched",
              file=sys.stderr)
        return 1
    return 0


# ---- surfaces wider than 256 (phases 40-41) ----

# configs/neus_w512.yaml as the file holds it (the card machine has no
# PyYAML; tests/test_torch_wide.py holds the two equal): NeuS at IDR's
# published width, 8 surface layers of 512 and a radiance net of 4 of 512
NEUS_W512 = {
    "data": {"N_rays": 512, "batch_size": 1, "cam_file": "cameras_sphere.npz",
             "data_dir": "./data/neus/dtu_scan37", "downscale": 1, "pin_memory": True,
             "val_downscale": 8, "val_rayschunk": 256},
    "device_ids": -1,
    "expname": "neus_w512_37",
    "model": {"N_nograd_samples": 2048, "N_upsample_iters": 4, "framework": "NeuS",
              "obj_bounding_radius": 1.0,
              "radiance": {"D": 4, "W": 512, "embed_multires": -1, "embed_multires_view": 4,
                           "skips": []},
              "surface": {"D": 8, "W": 512, "embed_multires": 6, "radius_init": 0.5,
                          "skips": [4]},
              "upsample_algo": "official_solution", "variance_init": 0.05},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "overlap_sampler": False,
                 "fused_samplers": True, "fused_nablas_vjp": True,
                 "monitoring": "tensorboard", "num_iters": 300000,
                 "scheduler": {"type": "warmupcosine", "warmup_steps": 5000},
                 "speed_factor": 10.0, "w_eikonal": 0.1, "w_mask": 1.0, "with_mask": True},
}
WIDE_STEPS = 40  # phase 41's cut of the file's 300,000 steps
# phases 40's checks and timings: the flagship chip config at the file's widths
IDR_CHIP = _with_cuts(FLAGSHIP, [("model.surface.W", 512), ("model.radiance.W", 512)])
WIDE_K1_RAYS = 1024  # phase 40's kernel-1 check: the chunk's first 1,024 rays' points
WIDTHS_K4 = (300, 384)  # kernel 4's partly and wholly empty column groups


def wide_train_config(exp_root, seed):
    """configs/neus_w512.yaml on the synthetic scene (as phase 8 trains the
    flagship), with phase 41's cuts, and the cuts as (dotted key, value)
    pairs (printed by the phase)."""
    cuts = [("data", {"type": "synthetic", "downscale": 1, "n_images": 8, "H": 120,
                      "W": 160, "N_rays": NEUS_W512["data"]["N_rays"],
                      "val_downscale": NEUS_W512["data"]["val_downscale"],
                      "val_rayschunk": NEUS_W512["data"]["val_rayschunk"],
                      "obj_bounding_radius": 1.0, "mesh_N": 128}),
            ("training.num_iters", WIDE_STEPS), ("training.i_val", WIDE_STEPS),
            ("training.i_val_mesh", WIDE_STEPS // 2), ("training.i_log", 10),
            ("training.scheduler.warmup_steps", 10), ("training.monitoring", "none"),
            ("training.log_root_dir", exp_root),
            ("training.exp_dir", os.path.join(exp_root, "neus_w512")),
            ("expname", "chip_smoke_neus_w512"), ("seed", seed)]
    return _with_cuts(NEUS_W512, cuts), cuts


def _wide_surface(W, seed, dev):
    """The flagship surface at hidden width W (256 geometry features), from
    the geometric init with seeded noise on every weight."""
    from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters

    s = ImplicitSurface(W=W, D=8, skips=(4,), W_geo_feat=256, radius_init=0.5,
                        embed_multires=6)
    s.reset_parameters(torch.Generator().manual_seed(seed))
    perturb_parameters(s, torch.Generator().manual_seed(seed + 1))
    return s.to(dev)


def _sdf_check(surface, x, label, report=print):
    """Kernel 4 against its plain version at phase 10's gate (1e-5 of
    max|sdf|, finite) on x; returns (ok, max|diff|)."""
    from neurecon_tpu_torch.ops import fused_mlp

    torch.full((x.shape[0],), float("nan"), device=x.device)  # freed at once
    got = fused_mlp.fused_sdf_forward(surface, x)
    ref = fused_mlp.sdf_forward_plain(surface, x)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    report(f"{label}: sdf_forward on {x.shape[0]} points: max|diff| {err:.3e} ({rel:.2e} of "
           "max|sdf|)")
    return rel <= 1e-5 and bool(torch.isfinite(got).all()), err


def _step_points(surface, c):
    """A training step's rays and points from a render chunk
    (`render_chunk_inputs`): every 8th of its rays (512), their coarse depths
    and det uniforms, and the 130,560 points of their 128 depths from the
    plain upsampler and the 127 mids. Returns ((rays_o, rays_d, d_coarse,
    u), points)."""
    from neurecon_tpu_torch.ops import fused_upsample

    ev = slice(None, None, 8)
    r_o, r_d = c["rays_o"][ev].contiguous(), c["rays_d"][ev].contiguous()
    d_c, u512 = c["d_coarse"][ev].contiguous(), c["u_det"][:512]
    d_step = fused_upsample.neus_upsample_plain(surface, r_o, r_d, d_c, u512, n_iters=4,
                                                n_per_iter=16)
    d_mid = 0.5 * (d_step[:, 1:] + d_step[:, :-1])
    x = torch.cat([r_o[:, None] + r_d[:, None] * d_step[..., None],
                   r_o[:, None] + r_d[:, None] * d_mid[..., None]], 1).reshape(-1, 3).contiguous()
    return (r_o, r_d, d_c, u512), x


def wide_kernel_checks(seed, dev, report=print):
    """Phase 40's kernel checks (see the module docstring), which
    tools/mutants.py's `wide` group runs on each mutant: kernels 1-4 on the
    perturbed NeuS at IDR's widths against their plain versions at the gates
    of phases 2, 3, 6 and 10, and kernel 4 at W = 300 and 384. Returns (the
    kernels that failed, {kernel: max|diff|}, the inputs phase 40 goes on
    with)."""
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, surface_pack

    c = render_chunk_inputs(seed, dev, IDR_CHIP)
    surface = c["checked"].implicit_surface
    fails = [] if surface_pack.packed_surface(surface).wide else ["the W=512 pack's tile"]

    # kernel 1 at phase 2's gates: the first 1,024 rays of the render chunk
    # (their 128 depths from the plain upsampler and the 127 mids) and 4,099
    # points with a ragged last tile
    x1 = kernel1_points(surface, c)
    ok, errs1 = nablas_check(surface, x1[:WIDE_K1_RAYS * 255], "phase 40 (W=512)", report)
    fails += [] if ok else ["kernel 1"]

    # kernel 2 at phase 3's gates: the chunk's 4,096 rays, 512 with the prior
    ok, k2_err = upsample_checks(surface, c, "phase 40 (W=512)", report)
    fails += [] if ok else ["kernel 2"]

    # kernel 3 at phase 6's gate: a step's 130,560 points (512 of the chunk's
    # rays, their depths from the plain upsampler and the mids)
    step_rays, x3 = _step_points(surface, c)
    M3 = x3.shape[0]
    g3 = torch.Generator(dev).manual_seed(seed + 2)
    cots = (torch.randn(M3, device=dev, generator=g3),
            torch.randn(M3, 3, device=dev, generator=g3),
            torch.randn(M3, surface.W_geo_feat, device=dev, generator=g3))
    ws3, bs3 = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    got3 = fused_nablas_vjp.fused_nablas_vjp(surface, x3, ws3, bs3, *cots)
    ws_bytes = fused_nablas_vjp.fused_nablas_vjp.workspace_bytes
    ref3 = fused_nablas_vjp.nablas_vjp_plain(surface, x3, ws3, bs3, *cots)
    torch.cuda.synchronize()
    ratios = _leaf_ratios(got3, ref3)
    k3_err = max(float((g - r).abs().max()) for g, r in
                 zip([got3[0], *got3[1], *got3[2]], [ref3[0], *ref3[1], *ref3[2]]))
    finite3 = all(bool(torch.isfinite(g).all()) for g in [got3[0], *got3[1], *got3[2]])
    report(f"phase 40 (W=512): nablas_backward on {M3} points (workspace {ws_bytes} bytes): "
           "max|diff| / max|ref| per leaf "
           + ", ".join(f"{k} {v:.2e}" for k, v in ratios.items()))
    if max(ratios.values()) > 5e-4 or not finite3:
        xs, cs = x3[:4096], [t_[:4096] for t_ in cots]
        k_sub = fused_nablas_vjp.fused_nablas_vjp(surface, xs, ws3, bs3, *cs)
        p_sub = fused_nablas_vjp.nablas_vjp_plain(surface, xs, ws3, bs3, *cs)
        w64 = fused_nablas_vjp.nablas_vjp_plain(
            surface, xs.double(), [w.double() for w in ws3], [b.double() for b in bs3],
            *[t_.double() for t_ in cs])
        report("phase 40 witness (4,096 points, vs float64): kernel "
               + str({k: f"{v:.2e}" for k, v in _leaf_ratios(k_sub, w64).items()})
               + ", plain fp32 "
               + str({k: f"{v:.2e}" for k, v in _leaf_ratios(p_sub, w64).items()}))
        fails.append("kernel 3")
    del got3, ref3

    # kernel 4 at phase 10's gate: 2^20 points and 4,099 (a ragged last
    # tile) at W = 512; 2^18 and 4,099 at W = 300 (padded to 304: the fifth
    # column group partly used, three empty) and 384 (two empty)
    g10 = torch.Generator(dev).manual_seed(seed)
    x4 = torch.rand(2 ** 20, 3, device=dev, generator=g10) * 2 - 1
    tail = torch.rand(4099, 3, device=dev, generator=g10) * 2 - 1
    errs4 = []
    for xs in (x4, tail):
        ok, e = _sdf_check(surface, xs, "phase 40 (W=512)", report)
        errs4.append(e)
        fails += [] if ok else ["kernel 4"]
    for W in WIDTHS_K4:
        sw = _wide_surface(W, seed, dev)
        wide = surface_pack.packed_surface(sw).wide
        for xs in (x4[:2 ** 18], tail):
            ok, _ = _sdf_check(sw, xs, f"phase 40 (W={W}, wide tile {wide})", report)
            fails += [] if ok and wide else [f"kernel 4 at W={W}"]
        del sw
    errs = {"nablas_forward": max(errs1), "neus_upsample": k2_err["det"],
            "nablas_backward": k3_err, "sdf_forward": max(errs4)}
    inputs = {"c": c, "surface": surface, "x1": x1, "x3": x3, "x4": x4, "cots": cots,
              "step_rays": step_rays, "workspace_bytes": ws_bytes}
    return fails, errs, inputs


def _refusals(surface, x, step_rays, zero_counts, read_counts):
    """Kernels 1-4 called on `surface` at points x (kernel 2 on 4 of the
    step's rays, `_step_points`) with the launch counters set to 0 just
    before: returns (how many raised NotImplementedError, the counts)."""
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, fused_upsample

    M, geo = x.shape[0], surface.W_geo_feat
    ws, bs = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    o4, d4, d_c, u = (t_[:4].contiguous() for t_ in step_rays)
    calls = [lambda: fused_mlp.fused_sdf_forward(surface, x),
             lambda: fused_nablas.fused_forward_with_nablas(surface, x),
             lambda: fused_nablas_vjp.fused_nablas_vjp(
                 surface, x, ws, bs, torch.zeros(M, device=x.device),
                 torch.zeros(M, 3, device=x.device), torch.zeros(M, geo, device=x.device)),
             lambda: fused_upsample.fused_neus_upsample(surface, o4, d4, d_c, u, n_iters=4,
                                                        n_per_iter=16)]
    zero_counts()
    refused = 0
    for call in calls:
        try:
            call()
        except NotImplementedError:
            refused += 1
    return refused, read_counts()


def _wide_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 40-41 (see the module docstring); returns (rc, kernel rows)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, fused_upsample
    from neurecon_tpu_torch.tools import extract_surface, render_view
    from neurecon_tpu_torch.training import sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util

    t40 = time.perf_counter()
    fails, errs, inp = wide_kernel_checks(seed, dev)
    c, surface = inp["c"], inp["surface"]
    u512 = inp["step_rays"][3]

    # the whole-step gradient at phase 7's gates: the kernels against the
    # plain versions of kernels 1 and 3, on the perturbed W=512 NeuS
    targs7 = ConfigDict(wide_train_config("unused", seed)[0])
    ray_loss = get_ray_loss_fn(targs7, c["checked"], c["kw_test"])
    scene = make_synthetic_scene(n_images=1, H=120, W=160)
    batch = {"c2w": torch.tensor(scene["c2w"][:1], device=dev),
             "intrinsics": torch.tensor(scene["intrinsics"][:1], device=dev),
             "rgb": torch.tensor(scene["rgb"][:1], device=dev).reshape(1, -1, 3),
             "object_mask": torch.tensor(scene["object_mask"][:1], device=dev).reshape(1, -1)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, 120, 160, 512)
    r7o, r7d, n7, f7 = _prepare_rays(rb["rays_o"], rb["rays_d"], 1.0)
    t = c["t"]
    d7 = fused_upsample.fused_neus_upsample(surface, r7o, r7d,
                                            (n7 * (1 - t) + f7 * t).contiguous(), u512,
                                            n_iters=4, n_per_iter=16)
    loss_k, loss_p, step_ratios = _step_grad_check(c["checked"], ray_loss, rb, d_all=d7)
    worst = max(step_ratios, key=step_ratios.get)
    print(f"phase 40 (W=512): step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad "
          f"leaf {worst} {step_ratios[worst]:.2e} over {len(step_ratios)} leaves")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or step_ratios[worst] > 5e-4:
        fails.append("step gradient")

    # the VolSDF sampler (kernels (a)-(c) and kernel 4): configs/volsdf.yaml
    # with surface W 512, 1,024 rays, phase 14's betas. At the model's init
    # beta_net 0.1 phase 14's gates in full; at 0.01 and 0.001, where the
    # plain fp32 sampler itself parts from a float64-query one by more than
    # those gates at this width, each kernel in lockstep at phase 14's gates
    # and the end to end against the float64 witness (`_sampler_witness`)
    vcfg = _with_cuts(VOLSDF, [("model.surface.W", 512)])
    *_, vchecked, _, _, _, (v_o, v_d, v_far) = volsdf_check_inputs(seed, dev, vcfg)
    vs = vchecked.implicit_surface
    ok, _, _ = _sampler_check(vs, v_o, v_d, v_far, (0.1,), 512, 512, 6, seed,
                              "phase 40 (VolSDF, W=512)")
    ok_w, _ = _sampler_witness(vs, v_o, v_d, v_far, (0.01, 0.001), 512, 512, 6, seed,
                               "phase 40 (VolSDF, W=512, float64 witness)")
    fails += [] if ok else ["VolSDF sampler"]
    fails += [] if ok_w else ["VolSDF sampler against the float64 witness"]
    del vchecked, vs


    # times at the shapes of PERF.md's table
    times, extra = _surface_times(surface, inp, seed)
    for name, (ms, pms, bb, per) in times.items():
        print(f"phase 40 (W=512): {name} {per}: {ms:.3f} ms (plain {pms:.3f} ms, fp32 bound "
              f"{bb[0][0]:.3f} ms, 3xTF32 bound {bb[1][0]:.3f} ms, {ms / bb[1][0]:.2f}x the "
              f"3xTF32 bound) {json.dumps(extra[name])} {tag}")
    del inp
    print(f"phase 40: {time.perf_counter() - t40:.1f} s {tag}")
    if fails:
        print(f"FAIL phase 40: {', '.join(fails)} disagree(s) with the plain versions at the "
              "W=512 gates, or a wider surface was not refused", file=sys.stderr)
        return 1, None

    # ---- phase 41: configs/neus_w512.yaml through train.py, a frame, a mesh
    t41 = time.perf_counter()
    cfg41, cuts = wide_train_config(os.path.join(workdir, "wide"), seed)
    print(f"phase 41: configs/neus_w512.yaml with the cuts {json.dumps(cuts)}")
    out, launches, step_ms, secs = _train_timed(ConfigDict(cfg41), zero_counts, read_counts)
    by_path["wide_train"] = launches
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    ms_step = float(np.median(step_ms[5:]))
    mesh20 = os.path.join(out["exp_dir"], "meshes", f"{WIDE_STEPS // 2:08d}.ply")
    n_f20 = len(mesh_util.read_ply(mesh20)[1]) if os.path.exists(mesh20) else 0
    first, last = float(np.mean(totals[:10])), float(np.mean(totals[-10:]))
    print(f"phase 41: train.py {WIDE_STEPS} W=512 steps at 512 rays ({secs:.1f} s): launches "
          f"{launches}; loss mean of steps 1-10 {first:.5f}, of steps 31-40 {last:.5f}; "
          f"median {ms_step:.2f} ms/step over steps 6-{WIDE_STEPS} "
          f"({512e3 / ms_step:.0f} rays/s); all steps ms {[round(v, 1) for v in step_ms]}; "
          f"mesh at step {WIDE_STEPS // 2} (128^3): {out['stats']['perf'].get('mesh_sec')} s, "
          f"{n_f20} faces {tag}")
    step_total, split, busy = _step_split(
        ConfigDict(cfg41), dev,
        {"neus_upsample": (fused_upsample, "fused_neus_upsample"),
         "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
         "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
         "radiance_forward": (RadianceNet, "forward")})
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 41: one W=512 step (512 rays) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, glue, loss) "
          f"{step_total - sum(split.values()):.2f} ms; device over three steps {busy} {tag}")
    vargs = ConfigDict(IDR_CHIP)
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 1,
                  "camera_path": "interpolation", "rayschunk": 4096})
    zero_counts()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    by_path["wide_render_view"] = read_counts()
    ply = os.path.join(workdir, "wide_surface_256.ply")
    eargs = extract_surface.make_parser().parse_args(
        ["--load_pt", out["final_ckpt"], "--out", ply, "--N", "256", "--W", "512",
         "--init_r", "0.5"])
    zero_counts()
    t_mesh = time.perf_counter()
    ext = extract_surface.main_function(eargs)
    torch.cuda.synchronize()
    s_mesh = time.perf_counter() - t_mesh
    by_path["wide_extract_surface"] = read_counts()
    v256, f256 = mesh_util.read_ply(ply)
    closed = len(f256) > 0 and _closed(torch.as_tensor(f256, device=dev))
    finite_view = all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))
    print(f"phase 41: render_view 1 x 120x160 from the final checkpoint: launches "
          f"{by_path['wide_render_view']}, s/frame {[round(v, 4) for v in frames['seconds']]}, "
          f"finite {finite_view}; extract_surface N=256: {s_mesh:.3f} s (grid "
          f"{ext['grid_s']:.3f} s, triangulation {ext['triangulate_s']:.3f} s), launches "
          f"{by_path['wide_extract_surface']}, {len(v256)} verts, {len(f256)} faces, closed "
          f"{closed}; phase 41 {time.perf_counter() - t41:.1f} s {tag}")
    if (min(launches[k] for k in ("nablas_forward", "neus_upsample", "nablas_backward"))
            < WIDE_STEPS or launches["sdf_forward"] == 0 or n_f20 == 0
            or len(totals) != WIDE_STEPS or not np.isfinite(totals).all()
            or not last < first or not finite_view
            or by_path["wide_render_view"]["nablas_forward"] == 0
            or by_path["wide_render_view"]["neus_upsample"] == 0
            or by_path["wide_extract_surface"]["sdf_forward"] == 0 or not closed):
        print("FAIL phase 41: the W=512 NeuS did not train through the kernels, did not "
              "lower its loss, or gave no finite frame or closed mesh", file=sys.stderr)
        return 1, None

    rows = []
    for name, (ms, pms, bb, per) in times.items():
        launches_by_path = {p: c_[name] for p, c_ in by_path.items() if p.startswith("wide_")}
        rows.append({"name": f"{name}[wide]", "branch": "wide", "route": "cuda",
                     "source": f"neurecon_tpu_torch/csrc/{name}.cu", "replaces": _SOURCES[name],
                     "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": pms, **_bound_fields(*bb, "3xtf32"), "library_ms": None,
                     "per": per, "width": 512, **extra[name],
                     "launches_by_path": launches_by_path})
    return 0, rows


# ---- surfaces wider than 512 (phases 42-43) ----

# configs/neus_w1024.yaml as the file holds it (tests/test_torch_cluster.py
# holds the two equal): configs/neus_w512.yaml with the surface at 1024
NEUS_W1024 = _with_cuts(NEUS_W512, [("model.surface.W", 1024), ("expname", "neus_w1024_37")])
CLUSTER_STEPS = 20  # phase 43's cut of the file's 300,000 steps
# phase 42's checks and timings: the flagship chip config at the file's widths
W1024_CHIP = _with_cuts(FLAGSHIP, [("model.surface.W", 1024), ("model.radiance.W", 512)])
CLUSTER_K1_PIECE = 65280  # phase 42's plain kernel-1 reference: 256 rays' points at a time
CLUSTER_MICROCHUNK = 1024  # phase 43's render_view --microchunk (rays a block of a chunk)


def cluster_train_config(exp_root, seed):
    """configs/neus_w1024.yaml on the synthetic scene (as phase 41 trains
    neus_w512.yaml), with phase 43's cuts, and the cuts as (dotted key,
    value) pairs (printed by the phase)."""
    cuts = [("data", {"type": "synthetic", "downscale": 1, "n_images": 8, "H": 120,
                      "W": 160, "N_rays": NEUS_W1024["data"]["N_rays"],
                      "val_downscale": NEUS_W1024["data"]["val_downscale"],
                      "val_rayschunk": NEUS_W1024["data"]["val_rayschunk"],
                      "obj_bounding_radius": 1.0, "mesh_N": 128}),
            ("training.num_iters", CLUSTER_STEPS), ("training.i_val", CLUSTER_STEPS),
            ("training.i_val_mesh", CLUSTER_STEPS // 2), ("training.i_log", 5),
            ("training.scheduler.warmup_steps", 10), ("training.monitoring", "none"),
            ("training.log_root_dir", exp_root),
            ("training.exp_dir", os.path.join(exp_root, "neus_w1024")),
            ("expname", "chip_smoke_neus_w1024"), ("seed", seed)]
    return _with_cuts(NEUS_W1024, cuts), cuts


def _vjp_check(surface, x, label, seed, report=print):
    """Kernel 3 against its plain version at phase 6's gate (5e-4 of each
    leaf's max|ref|, finite) on x with seeded cotangents; returns (ok,
    max|diff| over the leaves, {leaf: ratio}, the workspace bytes)."""
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp

    M = x.shape[0]
    g = torch.Generator(x.device).manual_seed(seed + 2)
    cots = (torch.randn(M, device=x.device, generator=g),
            torch.randn(M, 3, device=x.device, generator=g),
            torch.randn(M, surface.W_geo_feat, device=x.device, generator=g))
    ws, bs = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]
    got = fused_nablas_vjp.fused_nablas_vjp(surface, x, ws, bs, *cots)
    ws_bytes = fused_nablas_vjp.fused_nablas_vjp.workspace_bytes
    ref = fused_nablas_vjp.nablas_vjp_plain(surface, x, ws, bs, *cots)
    torch.cuda.synchronize()
    leaves_g, leaves_r = [got[0], *got[1], *got[2]], [ref[0], *ref[1], *ref[2]]
    ratios = _leaf_ratios(got, ref)
    err = max(float((a - b).abs().max()) for a, b in zip(leaves_g, leaves_r))
    finite = all(bool(torch.isfinite(t_).all()) for t_ in leaves_g)
    report(f"{label}: nablas_backward on {M} points (workspace {ws_bytes} bytes): max|diff| "
           f"{err:.3e}, worst leaf {max(ratios.values()):.2e} of its max|ref|")
    return max(ratios.values()) <= 5e-4 and finite, err, ratios, ws_bytes


def cluster_kernel_checks(seed, dev, report=print):
    """Phase 42's kernel checks (see the module docstring), which
    tools/mutants.py's `cluster` group runs on each mutant: kernels 1-4 of
    the perturbed NeuS at W=1024 against their plain versions at the gates
    of phases 2, 3, 6 and 10 (the cluster tile), the same at W=640 (the first
    width past 512: two blocks of 320 rows), and kernels 1 and 3 on a surface
    of 256 hidden columns and 520 geometry features (final-layer rows past
    512: block 1's product). Returns (the kernels that failed, {kernel:
    max|diff|}, the inputs phase 42 goes on with)."""
    from neurecon_tpu_torch.ops import surface_pack

    c = render_chunk_inputs(seed, dev, W1024_CHIP)
    surface = c["checked"].implicit_surface
    kind = surface_pack.packed_surface(surface).kind
    fails = [] if kind == surface_pack.CLUSTER else ["the W=1024 pack's tile"]

    # kernel 1 at phase 2's gates on the whole render chunk (1,044,480
    # points; the plain version in pieces) and 4,099 points (a ragged tile)
    x1 = kernel1_points(surface, c)
    ok, errs1 = nablas_check(surface, x1, "phase 42 (W=1024)", report, piece=CLUSTER_K1_PIECE)
    fails += [] if ok else ["kernel 1"]

    # kernel 2 at phase 3's gates: the chunk's 4,096 rays, 512 with the prior;
    # and all 4,096 with the prior: the perturbed W=1024 surface crosses no
    # zero on the chunk's rays (its sdf stays above ~0.4 there), so without
    # the prior their depths are the pdf floor's, the same for any sdf
    ok, k2_err = upsample_checks(surface, c, "phase 42 (W=1024)", report)
    fails += [] if ok else ["kernel 2"]
    prior = copy.deepcopy(surface)
    prior.sphere_residual = True
    ok, _ = _upsample_check(prior, c["rays_o"], c["rays_d"], c["near"], c["far"], c["d_coarse"],
                            {"det": c["u_det"], "perturb": c["u_pert"]},
                            "phase 42 (W=1024, 4,096 rays, sphere prior)", report)
    fails += [] if ok else ["kernel 2 with the prior"]
    del prior

    # kernel 3 at phase 6's gate: a step's 130,560 points (512 of the chunk's
    # rays, their depths from the plain upsampler and the mids)
    step_rays, x3 = _step_points(surface, c)
    r_o, r_d, d_c, u512 = step_rays
    ev = slice(None, None, 8)
    ok, k3_err, _, ws_bytes = _vjp_check(surface, x3, "phase 42 (W=1024)", seed, report)
    fails += [] if ok else ["kernel 3"]

    # kernel 4 at phase 10's gate: 2^20 points and 4,099 (a ragged last tile)
    g10 = torch.Generator(dev).manual_seed(seed)
    x4 = torch.rand(2 ** 20, 3, device=dev, generator=g10) * 2 - 1
    tail = torch.rand(4099, 3, device=dev, generator=g10) * 2 - 1
    errs4 = []
    for xs in (x4, tail):
        ok, e = _sdf_check(surface, xs, "phase 42 (W=1024)", report)
        errs4.append(e)
        fails += [] if ok else ["kernel 4"]

    # W=640: kernels 4 (2^18 and 4,099 points), 1 (65,280 chunk points and
    # 4,099), 3 (16,320 step points) and 2 (512 rays of the chunk, det and
    # perturb); W_geo 520 on 256 hidden columns: kernels 1 and 3
    s640 = _wide_surface(640, seed, dev)
    for xs in (x4[:2 ** 18], tail):
        ok, _ = _sdf_check(s640, xs, "phase 42 (W=640)", report)
        fails += [] if ok else ["kernel 4 at W=640"]
    ok, _ = nablas_check(s640, x1[:CLUSTER_K1_PIECE], "phase 42 (W=640)", report)
    fails += [] if ok else ["kernel 1 at W=640"]
    ok, *_ = _vjp_check(s640, x3[::8].contiguous(), "phase 42 (W=640)", seed, report)
    fails += [] if ok else ["kernel 3 at W=640"]
    ok, _ = _upsample_check(s640, r_o, r_d, c["near"][ev], c["far"][ev], d_c,
                            {"det": u512, "perturb": c["u_pert"][:512]},
                            "phase 42 (W=640, 512 rays)", report)
    fails += [] if ok else ["kernel 2 at W=640"]
    del s640
    from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters

    s520 = ImplicitSurface(W=256, D=8, skips=(4,), W_geo_feat=520, radius_init=0.5,
                           embed_multires=6)
    s520.reset_parameters(torch.Generator().manual_seed(seed))
    perturb_parameters(s520, torch.Generator().manual_seed(seed + 1))
    s520 = s520.to(dev)
    fails += [] if surface_pack.packed_surface(s520).kind == surface_pack.CLUSTER else [
        "the W_geo 520 pack's tile"]
    ok, _ = nablas_check(s520, x1[:CLUSTER_K1_PIECE], "phase 42 (W=256, W_geo 520)", report)
    fails += [] if ok else ["kernel 1 at W_geo 520"]
    ok, *_ = _vjp_check(s520, x3[::8].contiguous(), "phase 42 (W=256, W_geo 520)", seed,
                        report)
    fails += [] if ok else ["kernel 3 at W_geo 520"]
    del s520
    errs = {"nablas_forward": max(errs1), "neus_upsample": k2_err["det"],
            "nablas_backward": k3_err, "sdf_forward": max(errs4)}
    inputs = {"c": c, "surface": surface, "x1": x1, "x3": x3, "x4": x4,
              "step_rays": step_rays, "workspace_bytes": ws_bytes}
    return fails, errs, inputs


def _surface_times(surface, inp, seed):
    """Each surface kernel's median ms (10 CUDA-event runs) beside its plain
    version's (3 runs) and its fp32 and 3xTF32 bounds, at the shapes of
    PERF.md's table: kernel 4 at 2^20 points, kernel 1 at a step's 130,560
    and a render chunk's 1,044,480, kernel 3 at 130,560 (its CUDA kernels
    split by torch.profiler), kernel 2 at a step's 512 rays and a chunk's
    4,096 (`inp` as `cluster_kernel_checks` returns it). Returns ({kernel:
    (ms, plain ms, bounds, per)}, {kernel: the extra fields})."""
    from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, fused_upsample

    c, x1, x3, x4 = inp["c"], inp["x1"], inp["x3"], inp["x4"]
    r_o, r_d, d_c, u512 = inp["step_rays"]
    M3 = x3.shape[0]
    n_par = sum(p.numel() for p in surface.parameters())
    g = torch.Generator(x3.device).manual_seed(seed + 2)
    cots = (torch.randn(M3, device=x3.device, generator=g),
            torch.randn(M3, 3, device=x3.device, generator=g),
            torch.randn(M3, surface.W_geo_feat, device=x3.device, generator=g))
    ws3, bs3 = [[w.detach() for w in ts] for ts in fused_nablas.surface_weights(surface)]

    def sdf_bytes(M):
        return 4.0 * (M * (3 + 1) + n_par)

    def nab_bytes(M):
        return 4.0 * (M * (3 + 1 + 3 + surface.W_geo_feat) + n_par)

    def ups_bytes(N):
        return 4.0 * (N * (6 + 64 + 64 + 128) + n_par)
    macs_sdf = _surface_macs(surface, sdf_only=True)
    macs_nab = _surface_macs(surface)
    macs_bwd = _surface_macs(surface, backward=True)
    times = {}
    with torch.no_grad():
        times["sdf_forward"] = (
            _time_ms(lambda: fused_mlp.fused_sdf_forward(surface, x4)),
            _time_ms(lambda: fused_mlp.sdf_forward_plain(surface, x4), reps=3),
            _bounds(2.0 * macs_sdf * x4.shape[0], sdf_bytes(x4.shape[0])), "2^20 points")
        times["nablas_forward"] = (
            _time_ms(lambda: fused_nablas.fused_forward_with_nablas(surface, x3)),
            _time_ms(lambda: fused_nablas.forward_with_nablas_plain(surface, x3), reps=3),
            _bounds(2.0 * macs_nab * M3, nab_bytes(M3)), f"{M3} points")
        times["neus_upsample"] = (
            _time_ms(lambda: fused_upsample.fused_neus_upsample(
                surface, r_o, r_d, d_c, u512, n_iters=4, n_per_iter=16)),
            _time_ms(lambda: fused_upsample.neus_upsample_plain(
                surface, r_o, r_d, d_c, u512, n_iters=4, n_per_iter=16), reps=3),
            _bounds(2.0 * macs_sdf * 512 * 128, ups_bytes(512)), "512 rays")
    times["nablas_backward"] = (
        _time_ms(lambda: fused_nablas_vjp.fused_nablas_vjp(surface, x3, ws3, bs3, *cots)),
        _time_ms(lambda: fused_nablas_vjp.nablas_vjp_plain(surface, x3, ws3, bs3, *cots),
                 reps=3),
        _bounds(2.0 * macs_bwd * M3, 4.0 * (M3 * (3 + 1 + 3 + surface.W_geo_feat + 3)
                                            + 2 * n_par)), f"{M3} points")
    extra = {
        "nablas_forward": {"ms_1044480": _time_ms(
            lambda: fused_nablas.fused_forward_with_nablas(surface, x1)),
            "bound_ms_1044480": _bounds(2.0 * macs_nab * x1.shape[0],
                                        nab_bytes(x1.shape[0]))[1][0]},
        "neus_upsample": {"ms_4096_rays": _time_ms(lambda: fused_upsample.fused_neus_upsample(
            surface, c["rays_o"], c["rays_d"], c["d_coarse"], c["u_det"], n_iters=4,
            n_per_iter=16)),
            "bound_ms_4096_rays": _bounds(2.0 * macs_sdf * 4096 * 128, ups_bytes(4096))[1][0]},
        "nablas_backward": {"workspace_bytes": inp["workspace_bytes"],
                            "cuda_kernels_ms": _profile_kernels(
                                lambda: fused_nablas_vjp.fused_nablas_vjp(
                                    surface, x3, ws3, bs3, *cots))},
        "sdf_forward": {}}
    return times, extra


_SOURCES = {"nablas_forward": "neurecon_tpu/ops/fused_nablas.py:74",
            "neus_upsample": "neurecon_tpu/ops/fused_upsample.py:272",
            "nablas_backward": "neurecon_tpu/ops/fused_nablas_vjp.py:120",
            "sdf_forward": "neurecon_tpu/ops/fused_mlp.py:125"}


def _cluster_phases(seed, dev, tag, zero_counts, read_counts, by_path, workdir):
    """Phases 42-43 (see the module docstring); returns (rc, kernel rows)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.base import RadianceNet
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, fused_upsample
    from neurecon_tpu_torch.tools import extract_surface, render_view
    from neurecon_tpu_torch.training import sample_ray_batch
    from neurecon_tpu_torch.utils import mesh as mesh_util

    t42 = time.perf_counter()
    fails, errs, inp = cluster_kernel_checks(seed, dev)
    c, surface = inp["c"], inp["surface"]
    u512 = inp["step_rays"][3]

    # the whole-step gradient at phase 7's gates: the kernels against the
    # plain versions of kernels 1 and 3, on the perturbed W=1024 NeuS
    targs7 = ConfigDict(cluster_train_config("unused", seed)[0])
    ray_loss = get_ray_loss_fn(targs7, c["checked"], c["kw_test"])
    scene = make_synthetic_scene(n_images=1, H=120, W=160)
    batch = {"c2w": torch.tensor(scene["c2w"][:1], device=dev),
             "intrinsics": torch.tensor(scene["intrinsics"][:1], device=dev),
             "rgb": torch.tensor(scene["rgb"][:1], device=dev).reshape(1, -1, 3),
             "object_mask": torch.tensor(scene["object_mask"][:1], device=dev).reshape(1, -1)}
    rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, 120, 160, 512)
    r7o, r7d, n7, f7 = _prepare_rays(rb["rays_o"], rb["rays_d"], 1.0)
    t = c["t"]
    d7 = fused_upsample.fused_neus_upsample(surface, r7o, r7d,
                                            (n7 * (1 - t) + f7 * t).contiguous(), u512,
                                            n_iters=4, n_per_iter=16)
    loss_k, loss_p, step_ratios = _step_grad_check(c["checked"], ray_loss, rb, d_all=d7)
    worst = max(step_ratios, key=step_ratios.get)
    print(f"phase 42 (W=1024): step loss kernels {loss_k:.8f} plain {loss_p:.8f}; worst grad "
          f"leaf {worst} {step_ratios[worst]:.2e} over {len(step_ratios)} leaves")
    if abs(loss_k - loss_p) > 1e-5 * abs(loss_p) or step_ratios[worst] > 5e-4:
        fails.append("step gradient")

    # a surface wider than the kernels take raises, and launches nothing
    refused, counts1032 = _refusals(_wide_surface(1032, seed, dev), inp["x4"][:1000],
                                    inp["step_rays"], zero_counts, read_counts)
    print(f"phase 42: a W=1032 surface: {refused} of 4 kernels refused it, launches "
          f"{counts1032}")
    if refused != 4 or any(counts1032.values()):
        fails.append("W=1032 refusal")

    times, extra = _surface_times(surface, inp, seed)
    for name, (ms, pms, bb, per) in times.items():
        print(f"phase 42 (W=1024): {name} {per}: {ms:.3f} ms (plain {pms:.3f} ms, fp32 bound "
              f"{bb[0][0]:.3f} ms, 3xTF32 bound {bb[1][0]:.3f} ms, {ms / bb[1][0]:.2f}x the "
              f"3xTF32 bound) {json.dumps(extra[name])} {tag}")
    del inp, c
    print(f"phase 42: {time.perf_counter() - t42:.1f} s {tag}")
    if fails:
        print(f"FAIL phase 42: {', '.join(fails)} disagree(s) with the plain versions at the "
              "W=1024 and W=640 gates, or a wider surface was not refused", file=sys.stderr)
        return 1, None

    # ---- phase 43: configs/neus_w1024.yaml through train.py, a frame by
    # render_view --microchunk, a mesh
    t43 = time.perf_counter()
    cfg43, cuts = cluster_train_config(os.path.join(workdir, "cluster"), seed)
    print(f"phase 43: configs/neus_w1024.yaml with the cuts {json.dumps(cuts)}")
    out, launches, step_ms, secs = _train_timed(ConfigDict(cfg43), zero_counts, read_counts)
    by_path["cluster_train"] = launches
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    ms_step = float(np.median(step_ms[5:]))
    mesh10 = os.path.join(out["exp_dir"], "meshes", f"{CLUSTER_STEPS // 2:08d}.ply")
    n_f10 = len(mesh_util.read_ply(mesh10)[1]) if os.path.exists(mesh10) else 0
    first, last = float(np.mean(totals[:5])), float(np.mean(totals[-5:]))
    print(f"phase 43: train.py {CLUSTER_STEPS} W=1024 steps at 512 rays ({secs:.1f} s): "
          f"launches {launches}; loss mean of steps 1-5 {first:.5f}, of steps "
          f"{CLUSTER_STEPS - 4}-{CLUSTER_STEPS} {last:.5f}; median {ms_step:.2f} ms/step over "
          f"steps 6-{CLUSTER_STEPS} ({512e3 / ms_step:.0f} rays/s); all steps ms "
          f"{[round(v, 1) for v in step_ms]}; mesh at step {CLUSTER_STEPS // 2} (128^3): "
          f"{out['stats']['perf'].get('mesh_sec')} s, {n_f10} faces {tag}")
    step_total, split, busy = _step_split(
        ConfigDict(cfg43), dev,
        {"neus_upsample": (fused_upsample, "fused_neus_upsample"),
         "nablas_forward": (fused_nablas, "fused_forward_with_nablas"),
         "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp"),
         "radiance_forward": (RadianceNet, "forward")})
    if isinstance(busy, float):
        busy = f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%"
    print(f"phase 43: one W=1024 step (512 rays) {step_total:.2f} ms: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
          + f", the rest (radiance backward, glue, loss) "
          f"{step_total - sum(split.values()):.2f} ms; device over three steps {busy} {tag}")
    vargs = ConfigDict(W1024_CHIP)
    vargs.update({"load_pt": out["final_ckpt"], "num_views": 1,
                  "camera_path": "interpolation", "rayschunk": 4096,
                  "microchunk": CLUSTER_MICROCHUNK})
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    frames = render_view.render_frames(vargs, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    by_path["cluster_render_view"] = read_counts()
    ply = os.path.join(workdir, "cluster_surface_256.ply")
    eargs = extract_surface.make_parser().parse_args(
        ["--load_pt", out["final_ckpt"], "--out", ply, "--N", "256", "--W", "1024",
         "--init_r", "0.5"])
    zero_counts()
    t_mesh = time.perf_counter()
    ext = extract_surface.main_function(eargs)
    torch.cuda.synchronize()
    s_mesh = time.perf_counter() - t_mesh
    by_path["cluster_extract_surface"] = read_counts()
    v256, f256 = mesh_util.read_ply(ply)
    closed = len(f256) > 0 and _closed(torch.as_tensor(f256, device=dev))
    finite_view = all(np.isfinite(frames[k]).all() for k in ("rgb", "depth", "normal"))
    print(f"phase 43: render_view --microchunk {CLUSTER_MICROCHUNK} 1 x 120x160 from the "
          f"final checkpoint: launches {by_path['cluster_render_view']}, s/frame "
          f"{[round(v, 4) for v in frames['seconds']]}, peak device memory {peak} bytes, "
          f"finite {finite_view}; extract_surface N=256: {s_mesh:.3f} s (grid "
          f"{ext['grid_s']:.3f} s, triangulation {ext['triangulate_s']:.3f} s), launches "
          f"{by_path['cluster_extract_surface']}, {len(v256)} verts, {len(f256)} faces, closed "
          f"{closed}; phase 43 {time.perf_counter() - t43:.1f} s {tag}")
    if (min(launches[k] for k in ("nablas_forward", "neus_upsample", "nablas_backward"))
            < CLUSTER_STEPS or launches["sdf_forward"] == 0 or n_f10 == 0
            or len(totals) != CLUSTER_STEPS or not np.isfinite(totals).all()
            or not last < first or not finite_view
            or by_path["cluster_render_view"]["nablas_forward"] == 0
            or by_path["cluster_render_view"]["neus_upsample"] == 0
            or by_path["cluster_extract_surface"]["sdf_forward"] == 0 or not closed):
        print("FAIL phase 43: the W=1024 NeuS did not train through the kernels, did not "
              "lower its loss, or gave no finite frame or closed mesh", file=sys.stderr)
        return 1, None

    rows = []
    for name, (ms, pms, bb, per) in times.items():
        launches_by_path = {p: c_[name] for p, c_ in by_path.items()
                            if p.startswith("cluster_")}
        rows.append({"name": f"{name}[cluster]", "branch": "cluster", "route": "cuda",
                     "source": f"neurecon_tpu_torch/csrc/{name}.cu",
                     "replaces": _SOURCES[name], "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                     **_bound_fields(*bb, "3xtf32"), "library_ms": None, "per": per,
                     "width": 1024, **extra[name], "launches_by_path": launches_by_path})
    return 0, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights (init, and the checked copy's noise)")
    ap.add_argument("--rank-job", default=None,
                    help="run one rank of phases 30-31 (started by the script itself)")
    cli = ap.parse_args(argv)
    seed = cli.seed
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if cli.rank_job:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return _rank_job(cli.rank_job)
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
    counters, zero_counts, read_counts = _launch_counters()

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
        k1_narrow0 = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"]
        frames = render_view.render_frames(vargs, device="cuda")
        torch.cuda.synchronize()
        launches = by_path["render_view"] = read_counts()
    print(f"phase 4: render_view 2 x 120x160: launches {launches}, "
          f"s/frame {[round(s, 4) for s in frames['seconds']]} {tag}")
    if not _kernel1_narrow("phase 4", k1_narrow0, launches):
        print("FAIL phase 4: a kernel-1 launch of the render left the narrow tile",
              file=sys.stderr)
        return 1
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
    k1_narrow0 = fused_nablas.fused_forward_with_nablas.launches_by_tile["narrow"]
    out, launches, step_ms, _ = _train_timed(targs, zero_counts, read_counts)
    by_path["train"] = launches
    if not _kernel1_narrow("phase 8", k1_narrow0, launches):
        print("FAIL phase 8: a kernel-1 launch of the training left the narrow tile",
              file=sys.stderr)
        return 1
    ms_step = float(np.median(step_ms[5:]))
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    phase8 = {"totals": list(totals), "ms_step": ms_step, "final_ckpt": out["final_ckpt"]}
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
    # the main path's other shapes: a VolSDF step's seven sampler launches of
    # 2^19 points, and UNISURF's 1,024-point secant launch (queued behind a
    # spin, so that the launches wait on the card and not on the host)
    x19, x1k = x10[:2 ** 19].contiguous(), x10[:1024].contiguous()
    ms4_step = _queued_ms(lambda: fused_mlp.fused_sdf_forward(surface, x19), 7, reps=3)
    ms4_1k = _queued_ms(lambda: fused_mlp.fused_sdf_forward(surface, x1k), 1, reps=50)
    bb4_step = _bounds(7 * flops4 / 2, 4.0 * (7 * 2 ** 19 * (3 + 1) + n_params))
    print(f"phase 10: sdf_forward a VolSDF step (7 x 2^19 points) {ms4_step:.3f} ms (3xTF32 "
          f"bound {bb4_step[1][0]:.3f} ms), 1,024 points {ms4_1k:.4f} ms; launches by tile "
          f"{fused_mlp.fused_sdf_forward.launches_by_tile} {tag}")
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
              "occupancy query (host)": _wall_ms(
                  lambda: query(packed.c_pad, packed.rows, packed.kind)),
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

    record = {"neus_ms": phase8["ms_step"], "neus_ckpt": phase8["final_ckpt"]}
    rc, vol_rows, _ = _volsdf_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                     work.name, record)
    if rc:
        return rc
    rc, siren_rows = _siren_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                   work.name)
    if rc:
        return rc
    rc, unisurf_fields = _unisurf_phases(seed, dev, tag, zero_counts, read_counts, by_path,
                                         work.name, record)
    if rc:
        return rc
    rc = _nerfpp_phases(seed, dev, tag, zero_counts, read_counts, by_path, work.name)
    if rc:
        return rc
    rc = _ddp_phases(seed, dev, tag, by_path, work.name, phase8)
    if rc:
        return rc
    rc = _pipeline_phases(seed, dev, tag, zero_counts, read_counts, by_path, work.name, record)
    if rc:
        return rc
    rc = _jpeg_head_probe_phases(seed, dev, tag, zero_counts, read_counts, by_path, work.name)
    if rc:
        return rc
    rc, wide_rows = _wide_phases(seed, dev, tag, zero_counts, read_counts, by_path, work.name)
    if rc:
        return rc
    rc, cluster_rows = _cluster_phases(seed, dev, tag, zero_counts, read_counts, by_path,
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
         "bound_ms_grid512": b4_grid, "ms_split_4096": split4,
         "ms_volsdf_step": ms4_step, "bound_ms_volsdf_step": bb4_step[1][0],
         "ms_1024": ms4_1k,
         "launches_by_tile": dict(fused_mlp.fused_sdf_forward.launches_by_tile)},
    ] + vol_rows
    for r in results:
        r["branch"] = "softplus" if r["name"] in counters and "volsdf" not in r["name"] else "-"
        # a Softplus row counts no launch of its kernel's sine or wide
        # instantiation
        r["launches_by_path"] = {
            p: c[r["name"]] for p, c in by_path.items()
            if not p.startswith(("wide_", "cluster_")) and (
                r["branch"] != "softplus" or not p.startswith("volsdf_siren"))}
        r.update(unisurf_fields.get(r["name"], {}))
    results += siren_rows + wide_rows + cluster_rows
    print(f"chip_smoke: phases 1-43 in {time.perf_counter() - t_start:.1f} s wall {tag}")
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

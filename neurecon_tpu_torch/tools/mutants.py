"""Mutation checks on one CUDA card: does a kernel check see a deliberately
broken kernel?

    python -m neurecon_tpu_torch.tools.mutants [--seed N] [--workdir DIR]

Eight groups, each with its unmutated copy. For the unmutated source and for
each mutant, the port's package (and `chip_smoke.py`) is copied into a
temporary directory (under `--workdir`, the system's temporary directory by
default; removed after), one edit (or a few, which together make one fault) is made to the copy,
and a fresh process
builds that copy's kernels and runs the group's check; a group's copies
build at once and take the card one at a time, the groups one after the
other. One JSON line per copy; the exit code is 0 when each unmutated copy
passes and every mutant fails.

* `sdf`: the sdf-only kernel's narrow tile (`csrc/sdf_forward.cu`'s wgmma
  pipeline), held to its plain version by the check of `chip_smoke.py`
  phase 10: the flagship surface (D=8, W=256; geometric init from the seed,
  then seeded noise on every weight, seed + 1), 2^20 points uniform in
  [-1, 1]^3 from the seed plus 4,099 more (a ragged last tile), limit 1e-5
  of max|sdf|. The last two mutants break the split-fp32 product's
  precision: one drops the correction products (a single TF32 product per
  k-step), one chains every group's wgmmas into one accumulator over the
  whole K (the tensor cores' truncating accumulation, never promoted into
  the fp32 sum); the check must see both.
* `sine`: the SIREN branch of the surface-MLP kernels, held by
  `chip_smoke.py` phase 18 (`sine_kernel_checks`: kernels 4, 1, 3 and 2 on a
  pretrained SIREN surface with seeded noise, at the SIREN path's shapes,
  with the gates of phases 10, 2, 6 and 3). Its mutants drop the activation
  flag in one wrapper (kernel 4 would run Softplus on sine weights), flip the
  sign of phi'' = -900 sin(30 a) in kernel 3, and drop omega0 = 30 from the
  slope 30 cos(30 a) that kernel 1's forward keeps (`activation_out` of
  `csrc/surface_mma.cuh`, which kernel 3 shares).
* `nablas`: the forward + nablas kernel (`csrc/nablas_forward.cu`), held by
  `chip_smoke.py` phase 2 (`nablas_check`: the perturbed flagship surface,
  one render chunk's 1,044,480 points and 4,099 more, outputs filled with
  NaN beforehand). Its mutants drop the skip's 1/sqrt(2) from the reverse
  sweep, leave the final layer's last geometry column (the 257th output, off
  the product) unwritten, and skip the ragged last tile.
* `upsample`: the NeuS upsampler (`csrc/neus_upsample.cu`), held by
  `chip_smoke.py` phase 3 (`upsample_checks`: 4,096 rays of a render chunk,
  and 512 of them with the sphere prior, det and perturb). Its mutants flip
  the merge's tie rule on the old samples' side (at equal depth they go
  after the new ones, while the new ones still count them: two samples meet
  at one slot; flipping both sides would give the same depths, as tied
  samples carry bit-equal sdf), drop the per-round doubling of s = 64, and
  drop the sphere prior.
* `sampler`: the VolSDF fine sampler's kernels (a)-(c)
  (`csrc/volsdf_fine_sample.cu`), held by `chip_smoke.py` phase 14
  (`_sampler_check`: the sampler end to end and each kernel in lockstep on
  phase 14's 1,024 flagship rays at beta_net 0.1, 0.01 and 0.001, det and
  perturb, and `_sampler_edges`: a merge with exact old / new ties, det
  draws at exact cdf ties and in flat cdf segments). Its mutants flip the
  merge's tie order (new before old: only the tie check can see it, since
  a depth drawn twice has the same sdf), move the wrong end of the beta
  bracket on a good bisection step, run one bisection step fewer, take the
  fallback draw at the net's beta instead of beta+, drop the draws' rule
  that a cdf step below 1e-5 counts as 1, and drop the background sphere's
  min from the new samples' sdf; four edit kernel (a): its convergence
  check at beta+ instead of the net's beta, its checkpoint-0 draw at
  (1 / beta+, beta+), its last interval left out of the partition (n0 - 2
  intervals), and the last depth of the round-0 buffer left unwritten (the
  lockstep starts from a NaN workspace, holds (a)'s fine depths as a share
  beyond 1e-4 of the span and its bounds as a share of rays, and its
  round-0 depths to d_init exactly).
* `stream`: the pipelined step's cross-stream ordering
  (`training.make_pipelined_train_step`), held by the stream-order gate of
  `chip_smoke.py` phases 32-34 (`stream_order_check`: 20 pipelined VolSDF
  steps at phase 33's config and lr as train.py runs them, bit-equal in
  every loss and final parameter to the same steps with the sampler on the
  current stream, and to the same steps with every sampler held back by a
  spin kernel on its stream, so that the backward, Adam and the next forward
  run first). Its mutant drops the current stream's wait on the sampler
  before Adam.
* `wide`: the wide tile of the surface-MLP kernels (surfaces wider than
  256), held by `chip_smoke.py` phase 40's kernel checks
  (`wide_kernel_checks`: kernels 1-4 on the perturbed NeuS at IDR's widths,
  W = 512, at the gates of phases 2, 3, 6 and 10, and kernel 4 at W = 300
  and 384). Its first six mutants break `surface_mma.cuh`'s routines that
  kernels 1-3 and kernel 4's wide and cluster tiles run (the narrow kernel
  4 of the `sdf` group runs wgmma and mutants of its own): the split-fp32
  product's correction products dropped, and its MMAs chained into the
  running sum; the sdf row's bias dropped (`final_row`), sin and cos
  swapped in the encoding (`embed_tile`), the skip input's 1/sqrt(2)
  dropped (`skip_input`), and the wide and cluster kernel 4's ragged last
  tile skipped. Its other mutants skip the second half of the column
  groups, leave
  the product's stage row stride at the narrow tile's 264, write a layer in
  place before every warp has passed the product (its closing barrier
  dropped, and the first four column groups held back ~20 us before their
  last chunk: the interleaving the dropped barrier allows, made certain),
  and drop the final layer's rows past 256 from kernel 1's product.
* `cluster`: the cluster tile of the surface-MLP kernels (surfaces wider
  than 512: a pair of blocks a tile, each holding half of every layer's
  rows), held by `chip_smoke.py` phase 42's kernel checks
  (`cluster_kernel_checks`: kernels 1-4 at W = 1024 and 640 at the gates of
  phases 2, 3, 6 and 10, kernels 1 and 3 at 520 geometry features). Its
  mutants drop the pair's barrier before a block writes its half in place
  (and hold block 0 back ~20 us before its last chunk, whose rows are the
  peer's: the interleaving the dropped barrier allows, made certain), read
  the peer's half of a product's input from the block's own buffer, and
  drop the final layer's rows past 512 (block 1's product in kernel 1).
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]
CHIP_SMOKE = PACKAGE.parent / "chip_smoke.py"
LIMIT = 1e-5

# name -> (file under the package, text, replacement); each text occurs once
MUTANTS = {
    "sdf row bias dropped": (
        "csrc/sdf_forward.cu", "if (lane < 16 && p0 + q < M) sdf[p0 + q] = s + __ldg(LD.b);",
        "if (lane < 16 && p0 + q < M) sdf[p0 + q] = s;"),
    "sin and cos swapped": (
        "csrc/sdf_forward.cu", "v = (r < 3) ? sinf(ph) : cosf(ph);",
        "v = (r < 3) ? cosf(ph) : sinf(ph);"),
    "skip 1/sqrt(2) dropped": [
        ("csrc/sdf_forward.cu", "if constexpr (SKIP) v *= 0.707106781187f;",
         "if constexpr (SKIP) v *= 1.f;"),
        ("csrc/sdf_forward.cu", "emb[c * LDV + q] / 1.41421356237f : 0.f;",
         "emb[c * LDV + q] : 0.f;")],
    "ragged last tile skipped": (
        "csrc/sdf_forward.cu", "const int n_tiles = (M + P - 1) / P;",
        "const int n_tiles = M / P;"),
    "plain TF32 (no correction products)": [
        ("csrc/sdf_forward.cu",
         "for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, as[s], big[s], s > 0);",
         "for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, ab[s], big[s], s > 0);"),
        ("csrc/sdf_forward.cu",
         "\n#pragma unroll\n"
         "      for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, ab[s], big[s] + ((NC * SW) >> 4), 1);\n"
         "#pragma unroll\n"
         "      for (int s = 0; s < G; ++s) wg::wgmma_m64n128k8(fresh, ab[s], big[s], 1);",
         "")],
    "promotion interval removed (one accumulator over the whole K)": [
        ("csrc/sdf_forward.cu", "wg::wgmma_m64n128k8(fresh, as[s], big[s], s > 0);",
         "wg::wgmma_m64n128k8(fresh, as[s], big[s], q > 0 || s > 0);"),
        ("csrc/sdf_forward.cu", "for (int i = 0; i < 64; ++i) sum[i] += fresh[i];",
         "for (int i = 0; i < 64; ++i) sum[i] = fresh[i];")],
}

SINE_MUTANTS = {
    "activation flag dropped in the kernel-4 wrapper": (
        "ops/fused_mlp.py", "packed.c_pad, packed.rows, packed.act,",
        "packed.c_pad, packed.rows, 0,"),
    "phi'' sign flipped in kernel 3": (
        "csrc/nablas_backward.cu", "ab[idx] = -SIREN_W0 * SIREN_W0 * buf",
        "ab[idx] = SIREN_W0 * SIREN_W0 * buf"),
    "omega0 dropped from kernel 1's slope": (
        "csrc/surface_mma.cuh", "s = SIREN_W0 * cs;", "s = cs;"),
}

NABLAS_MUTANTS = {
    "skip 1/sqrt(2) dropped from the reverse sweep": (
        "csrc/surface_mma.cuh", "const float v = buf[r * LDV + p] * inv_sqrt2;",
        "const float v = buf[r * LDV + p];"),
    "final layer's last geometry column not written": (
        "csrc/nablas_forward.cu", "idx < (LD.out_dim - n0) * P;", "idx < (LD.out_dim - n0 - 1) * P;"),
    "ragged last tile skipped": (
        "csrc/nablas_forward.cu", "const int tiles = (M + P - 1) / P;",
        "const int tiles = M / P;"),
}

UPSAMPLE_MUTANTS = {
    "merge tie order flipped (old samples' side)": (
        "csrc/neus_upsample.cu", "cnt += nd[k] < v;", "cnt += nd[k] <= v;"),
    "s = 64 in every round": (
        "csrc/neus_upsample.cu", "64.f * (float)(1 << it)", "64.f"),
    "sphere prior dropped": (
        "csrc/neus_upsample.cu",
        "v += sqrtf(x0 * x0 + x1 * x1 + x2 * x2 + 1e-12f) - sphere_r;", ""),
}

SAMPLER_MUTANTS = {
    "merge tie order flipped (new before old)": (
        "csrc/volsdf_fine_sample.cu", "return old_d <= new_d;", "return old_d < new_d;"),
    "bisection moves the wrong end on a good step": (
        "csrc/volsdf_fine_sample.cu", "if (!bad) right = sb; else left = sb;",
        "if (!bad) left = sb; else right = sb;"),
    "one bisection step fewer": (
        "csrc/volsdf_fine_sample.cu", "steps = conv ? 0 : max_bisection;",
        "steps = conv ? 0 : max_bisection - 1;"),
    "fallback draw at the net's beta": (
        "csrc/volsdf_fine_sample.cu",
        "newly ? alpha_net : 1.f / beta,\n" + " " * 23 + "newly ? beta_net : beta,",
        "alpha_net,\n" + " " * 23 + "beta_net,"),
    "cdf step below 1e-5 not taken as 1": (
        "csrc/volsdf_fine_sample.cu", "if (den < 1e-5f) den = 1.f;", ""),
    "background sphere's min dropped": (
        "csrc/volsdf_fine_sample.cu", "if (bg_r >= 0.f) v = fminf(v, bg_r - sqrtf(sq));", ""),
    "(a): convergence checked at beta+": (
        "csrc/volsdf_fine_sample.cu", "m = fmaxf(m, bn);", "m = fmaxf(m, bp);"),
    "(a): checkpoint-0 draw at (1 / beta+, beta+)": (
        "csrc/volsdf_fine_sample.cu", "crow[ch.k0 + i + 1] = 1.f - decay;",
        "crow[ch.k0 + i + 1] = 1.f - expf(-Rp);"),
    "(a): last interval left out of the partition": (
        "csrc/volsdf_fine_sample.cu", "chunk_of<T>(n0 - 1, ch.k0, ch.cnt);",
        "chunk_of<T>(n0 - 2, ch.k0, ch.cnt);"),
    "(a): last depth of the round-0 buffer not written": (
        "csrc/volsdf_fine_sample.cu", "d_buf[r * S + j] = t;",
        "if (j < n0 - 1) d_buf[r * S + j] = t;"),
}

# name -> one edit as above, or a list of edits that make one fault
WIDE_MUTANTS = {
    "mma.sync product: plain TF32 (no correction products)": (
        "csrc/surface_mma.cuh",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_small[i], b_big);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_small);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_big);",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_big[i], b_big);"),
    "mma.sync product: accumulator chained across k-steps": (
        "csrc/surface_mma.cuh",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_small[i], b_big);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_small);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_big);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i)\n"
        "#pragma unroll\n"
        "          for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][e];",
        "for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], a_small[i], b_big);\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], a_big[i], b_small);\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j], a_big[i], b_big);"),
    "mma.sync tiles: sdf row bias dropped": (
        "csrc/surface_mma.cuh", "return ((s0 + s1) + (s2 + s3)) + __ldg(L.b + row);",
        "return ((s0 + s1) + (s2 + s3));"),
    "mma.sync tiles: sin and cos swapped": (
        "csrc/surface_mma.cuh", "v = (r < 3) ? sinf(ph) : cosf(ph);",
        "v = (r < 3) ? cosf(ph) : sinf(ph);"),
    "mma.sync tiles: skip 1/sqrt(2) dropped": (
        "csrc/surface_mma.cuh", "*cat = *cat / 1.41421356237f;", "*cat = *cat;"),
    "mma.sync tiles: ragged last tile skipped": (
        "csrc/sdf_forward.cu", "const int tiles = (M + P - 1) / P;", "const int tiles = M / P;"),
    "second half of the column groups skipped": (
        "csrc/surface_mma.cuh", "    if (nw >= N) continue;",
        "    if (nw >= N || nw >= 256) continue;"),
    "stage row stride left at 264": (
        "csrc/surface_mma.cuh",
        "constexpr int MT = T::MT, LDV = T::LDV, SLD = T::SLD, CH = KC * SLD;",
        "constexpr int MT = T::MT, LDV = T::LDV, SLD = 264, CH = KC * SLD;"),
    "layer written in place before every warp passed the product": [
        ("csrc/surface_mma.cuh",
         "    if (nw >= N) continue;\n",
         "    if (nw >= N) continue;\n"
         "    if (ch == nch - 1 && nw < 256)\n"
         "      for (int i = 0; i < 20; ++i) __nanosleep(1000);\n"),
        ("csrc/surface_mma.cuh",
         "      }\n    }\n  }\n  __syncthreads();\n}\n\n// f(n, p, value)",
         "      }\n    }\n  }\n}\n\n// f(n, p, value)")],
    "final layer's rows past 256 dropped": (
        "csrc/nablas_forward.cu", "if (o < LD.out_dim && p0 + p < M) {",
        "if (o < LD.out_dim && o < 256 && p0 + p < M) {"),
}

# name -> one edit as above, or a list of edits that make one fault
CLUSTER_MUTANTS = {
    "pair's barrier before the write-back dropped": [
        ("csrc/surface_mma.cuh", "  __device__ void meet() const { cluster_sync(); }",
         "  __device__ void meet() const {}"),
        ("csrc/surface_mma.cuh",
         "    if (nw >= N) continue;\n",
         "    if (T::CL == 2 && ch == nch - 1 && !(blockIdx.x & 1))\n"
         "      for (int i = 0; i < 20; ++i) __nanosleep(1000);\n"
         "    if (nw >= N) continue;\n")],
    "peer's half read from the block's own buffer": (
        "csrc/surface_mma.cuh", ": V.peer + (size_t)(k - V.plo) * LDV;",
        ": V.own + (size_t)(k - V.plo) * LDV;"),
    "final layer's rows past 512 dropped": (
        "csrc/surface_mma.cuh",
        "__device__ int final_cols(int n) const "
        "{ return min(max(n - rank * T::NMAX, 0), T::NMAX); }",
        "__device__ int final_cols(int n) const { return rank ? 0 : min(n, T::NMAX); }"),
}

# the checks take the card one at a time (the nablas check's plain version
# alone holds tens of GB at 1,044,480 points)
# the parallel step's global masked mean (`parallel/sharding.py`), held on
# the CPU by tests/test_torch_parallel.py: two gloo ranks against the JAX
# package's sharded step on a 2-device mesh, whose masked L1 divides by the
# mask count of the whole batch; this mutant lets each rank divide by its own
# count and averages the ranks' means
PARALLEL_MUTANTS = {
    "per_rank_masked_mean": ("parallel/sharding.py",
                             "return num / (self.all_sum(den.detach()) + 1e-10)",
                             "return self.replicated(num / (den + 1e-10))"),
}

# the pipelined training step (`training.make_pipelined_train_step`).
# `sample_after_update` runs the next step's sampler after Adam, on the
# updated parameters: held on the CPU by tests/test_torch_pipeline.py against
# the JAX package's pipelined block, whose sampler reads the parameters
# before the update of the step ahead. `no_wait_before_adam` drops the
# current stream's wait on the side stream's sampler before Adam: held on the
# card by this tool's `stream` group (`chip_smoke.stream_order_check`, the
# stream-order gate of phases 32-34 on phase 33's VolSDF: as train.py runs,
# and with the main stream at a higher priority, the sampler finished before
# Adam and the missing wait left no trace; its held-back run shows it)
PIPELINE_MUTANTS = {
    "sample_after_update": (
        "training.py",
        """        held, wait = sample_ahead(next_batch, generator) if next_batch is not None else (None, None)
        metrics = finish(total, losses, extras, wait)
""",
        """        metrics = finish(total, losses, extras)
        held, wait = sample_ahead(next_batch, generator) if next_batch is not None else (None, None)
        if wait is not None:
            wait()
"""),
    "no_wait_before_adam": ("training.py",
                            "return (batch, rb, draws, samples), lambda: main.wait_event(done)",
                            "return (batch, rb, draws, samples), lambda: None"),
}
STREAM_MUTANTS = {"no_wait_before_adam": PIPELINE_MUTANTS["no_wait_before_adam"]}

_LOCKED = r'''
import fcntl
_lock = open(LOCK, "w")
fcntl.flock(_lock, fcntl.LOCK_EX)
'''

_PHASE_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
import chip_smoke
from neurecon_tpu_torch.ops import _build, fused_nablas
for mod in (chip_smoke, fused_nablas):
    if not mod.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mod.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
c = chip_smoke.render_chunk_inputs(SEED, dev)
surface = c["checked"].implicit_surface
quiet = lambda s: None
if GROUP == "nablas":
    ok, err = chip_smoke.nablas_check(surface, chip_smoke.kernel1_points(surface, c), "", quiet)
else:
    ok, err = chip_smoke.upsample_checks(surface, c, "", quiet)
print(json.dumps({"passes": bool(ok), "errors": err}))
'''

_SINE_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
import chip_smoke
from neurecon_tpu_torch.ops import _build, fused_mlp
for mod in (chip_smoke, fused_mlp):
    if not mod.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mod.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
torch.backends.cuda.matmul.allow_tf32 = False
ok, err, _, _ = chip_smoke.sine_kernel_checks(SEED, torch.device("cuda"), report=lambda s: None)
print(json.dumps({"passes": ok, "errors": err}))
'''

_STREAM_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
import chip_smoke
from neurecon_tpu_torch import training
from neurecon_tpu_torch.ops import _build
for mod in (chip_smoke, training):
    if not mod.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mod.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
import tempfile
with tempfile.TemporaryDirectory(dir=ROOT) as work:
    print(json.dumps(chip_smoke.stream_order_check(SEED, work)))
'''

_SAMPLER_CODE = r'''
import json, re, sys
import torch
sys.path.insert(0, ROOT)
import chip_smoke
from neurecon_tpu_torch.ops import _build, fused_fine_sample
for mod in (chip_smoke, fused_fine_sample):
    if not mod.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mod.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
*_, checked, _, _, _, (rays_o, rays_d, far) = chip_smoke.volsdf_check_inputs(SEED, dev)
lines = []
with chip_smoke.mock.patch("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a)))):
    ok, err, _ = chip_smoke._sampler_check(checked.implicit_surface, rays_o, rays_d, far,
                                           (0.1, 0.01, 0.001), 512, 512, 6, SEED, "")
# the lockstep readings past phase 14's gates, and whether the depths were equal
over, equal = {}, True
for line in lines:
    m = re.search(r"lockstep [^{]*(\{.*\}); round-0 and merged depths equal (\w+)", line)
    if m:
        equal &= m.group(2) == "True"
        for kernel, e in json.loads(m.group(1)).items():
            for key, v in e.items():
                limit = {"sdf": 1e-5, "unsorted_rays": 0.0}.get(key, 0.01)
                if (key.endswith("share") or key in ("sdf", "unsorted_rays")) and not v <= limit:
                    over[f"{kernel}.{key}"] = max(over.get(f"{kernel}.{key}", 0.0), v)
print(json.dumps({"passes": bool(ok), "errors": err, "lockstep_over_gates": over,
                  "depths_equal": equal}))
'''

_WIDE_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
import chip_smoke
from neurecon_tpu_torch.ops import _build, fused_mlp
for mod in (chip_smoke, fused_mlp):
    if not mod.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mod.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
torch.backends.cuda.matmul.allow_tf32 = False
fails, errs, _ = chip_smoke.wide_kernel_checks(SEED, torch.device("cuda"), report=lambda s: None)
print(json.dumps({"passes": not fails, "errors": errs, "failed": fails}))
'''

_CLUSTER_CODE = _WIDE_CODE.replace("wide_kernel_checks", "cluster_kernel_checks")

_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
from neurecon_tpu_torch.ops import _build, fused_mlp
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
if not fused_mlp.__file__.startswith(ROOT):
    raise SystemExit(f"imported {fused_mlp.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
''' + _LOCKED + r'''
dev = torch.device("cuda")
s = ImplicitSurface(W=256, D=8, skips=(4,), W_geo_feat=256, radius_init=0.5,
                    embed_multires=6)
s.reset_parameters(torch.Generator().manual_seed(SEED))
perturb_parameters(s, torch.Generator().manual_seed(SEED + 1))
s = s.to(dev)
g = torch.Generator(dev).manual_seed(SEED)
worst = 0.0
for M in (2 ** 20, 4099):
    x = torch.rand(M, 3, device=dev, generator=g) * 2 - 1
    # NaN, freed at once, in the block the output is likely to be given: an
    # unwritten entry cannot pass for a right one
    torch.full((M,), float("nan"), device=dev)
    got = fused_mlp.fused_sdf_forward(s, x)
    ref = fused_mlp.sdf_forward_plain(s, x)
    rel = float((got - ref).abs().max() / ref.abs().max())
    worst = max(worst, rel if rel == rel else float("inf"))
print(json.dumps({"max_rel_err": worst}))
'''


def edits_of(mutant):
    """A mutant's edits as a list of (file, text, replacement): none for the
    unmutated copy (None), one for a tuple."""
    if mutant is None:
        return []
    return mutant if isinstance(mutant, list) else [mutant]


def _run_group(tmp, group, cases, code, seed, judge):
    """Copy, mutate and check every case of one group at once; print a JSON
    line per case; return 0 when the unmutated copy passes and every mutant
    fails. `judge(stdout's last line)` -> (passes, the line's fields)."""
    procs = {}
    for name, edit in cases.items():
        root = Path(tmp).resolve() / f"copy{len(list(Path(tmp).iterdir()))}"
        shutil.copytree(PACKAGE, root / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(CHIP_SMOKE, root / CHIP_SMOKE.name)
        for fname, text, repl in edits_of(edit):
            src = root / PACKAGE.name / fname
            source = src.read_text()
            if source.count(text) != 1:
                raise SystemExit(f"mutant {name!r}: {text!r} is not in {fname} once")
            src.write_text(source.replace(text, repl))
        head = (f"ROOT = {str(root)!r}\nSEED = {seed}\nGROUP = {group!r}\n"
                f"LOCK = {str(Path(tmp) / 'card.lock')!r}\n")
        procs[name] = subprocess.Popen([sys.executable, "-c", head + code],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    rc = 0
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=1800)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode == 0:
            passes, fields = judge(out.strip().splitlines()[-1])
            print(json.dumps({"group": group, "case": name, **fields,
                              "check": "passes" if passes else "fails"}), flush=True)
            if passes != (name == "unmutated"):
                rc = 1
        else:
            print(json.dumps({"group": group, "case": name, "error": err[-2000:]}),
                  flush=True)
            rc = 1
    return rc


def _judge_sdf(line):
    rel = json.loads(line)["max_rel_err"]
    return rel <= LIMIT, {"max_rel_err": rel}


def _judge_phase(line):
    res = json.loads(line)
    return bool(res["passes"]), {k: v for k, v in res.items() if k != "passes"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args(argv)
    rc = 0
    with tempfile.TemporaryDirectory(prefix="ntt_mutants_", dir=args.workdir) as tmp:
        for group, mutants, code, judge in (
                ("sdf", MUTANTS, _CODE, _judge_sdf),
                ("sine", SINE_MUTANTS, _SINE_CODE, _judge_phase),
                ("nablas", NABLAS_MUTANTS, _PHASE_CODE, _judge_phase),
                ("upsample", UPSAMPLE_MUTANTS, _PHASE_CODE, _judge_phase),
                ("sampler", SAMPLER_MUTANTS, _SAMPLER_CODE, _judge_phase),
                ("stream", STREAM_MUTANTS, _STREAM_CODE, _judge_phase),
                ("wide", WIDE_MUTANTS, _WIDE_CODE, _judge_phase),
                ("cluster", CLUSTER_MUTANTS, _CLUSTER_CODE, _judge_phase)):
            rc |= _run_group(tmp, group, {"unmutated": None, **mutants}, code, args.seed,
                             judge)
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Mutation checks on one CUDA card: does a kernel check see a deliberately
broken kernel?

    python -m neurecon_tpu_torch.tools.mutants [--seed N] [--workdir DIR]

Two groups, each with its unmutated copy. For the unmutated source and for
each mutant, the port's package (and `chip_smoke.py`) is copied into a
temporary directory (under `--workdir`, the system's temporary directory by
default; removed after), one edit is made to the copy, and a fresh process
builds that copy's kernels and runs the group's check; a group's copies run
at once, the groups one after the other. One JSON line per copy; the exit
code is 0 when each unmutated copy passes and every mutant fails.

* `sdf`: the sdf-only kernel (`csrc/sdf_forward.cu` on
  `csrc/surface_mma.cuh`), held to its plain version by the check of
  `chip_smoke.py` phase 10: the flagship surface (D=8, W=256; geometric init
  from the seed, then seeded noise on every weight, seed + 1), 2^20 points
  uniform in [-1, 1]^3 from the seed plus 4,099 more (a ragged last tile),
  limit 1e-5 of max|sdf|. The last two mutants break the split-fp32
  product's precision: one drops the correction products (a single TF32
  product per k-step), one adds every MMA straight into the running sum (the
  tensor cores' truncating accumulation, unflushed); the check must see both.
* `sine`: the SIREN branch of the surface-MLP kernels, held by
  `chip_smoke.py` phase 18 (`sine_kernel_checks`: kernels 4, 1, 3 and 2 on a
  pretrained SIREN surface with seeded noise, at the SIREN path's shapes,
  with the gates of phases 10, 2, 6 and 3). Its mutants drop the activation
  flag in one wrapper (kernel 4 would run Softplus on sine weights), flip the
  sign of phi'' = -900 sin(30 a) in kernel 3, and drop omega0 = 30 from
  kernel 1's slope 30 cos(30 a).
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
        "csrc/sdf_forward.cu", "tile_sdf[p] = ((s0 + s1) + (s2 + s3)) + __ldg(LD.b);",
        "tile_sdf[p] = ((s0 + s1) + (s2 + s3));"),
    "sin and cos swapped": (
        "csrc/surface_mma.cuh", "v = (r < 3) ? sinf(ph) : cosf(ph);",
        "v = (r < 3) ? cosf(ph) : sinf(ph);"),
    "skip 1/sqrt(2) dropped": (
        "csrc/surface_mma.cuh", "*cat = *cat / 1.41421356237f;", "*cat = *cat;"),
    "ragged last tile skipped": (
        "csrc/sdf_forward.cu", "const int tiles = (M + P - 1) / P;", "const int tiles = M / P;"),
    "plain TF32 (no correction products)": (
        "csrc/surface_mma.cuh",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_small[i], b_big);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_small);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_big);",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_big[i], b_big);"),
    "accumulator chained across k-steps": (
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
}

SINE_MUTANTS = {
    "activation flag dropped in the kernel-4 wrapper": (
        "ops/fused_mlp.py", "packed.c_pad, packed.rows, packed.act,",
        "packed.c_pad, packed.rows, 0,"),
    "phi'' sign flipped in kernel 3": (
        "csrc/nablas_backward.cu", "ab[idx] = -SIREN_W0 * SIREN_W0 * buf",
        "ab[idx] = SIREN_W0 * SIREN_W0 * buf"),
    "omega0 dropped from kernel 1's slope": (
        "csrc/surface_mlp.cuh", "s[p] = SIREN_W0 * cs;", "s[p] = cs;"),
}

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
torch.backends.cuda.matmul.allow_tf32 = False
ok, err, _, _ = chip_smoke.sine_kernel_checks(SEED, torch.device("cuda"), report=lambda s: None)
print(json.dumps({"passes": ok, "errors": err}))
'''

_CODE = r'''
import json, sys
import torch
sys.path.insert(0, ROOT)
from neurecon_tpu_torch.ops import _build, fused_mlp
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
if not fused_mlp.__file__.startswith(ROOT):
    raise SystemExit(f"imported {fused_mlp.__file__}, not the copy under {ROOT}")
_build.build_all(force=True)
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


def _run_group(tmp, cases, code, seed, judge):
    """Copy, mutate and check every case of one group at once; print a JSON
    line per case; return 0 when the unmutated copy passes and every mutant
    fails. `judge(stdout's last line)` -> (passes, the line's fields)."""
    procs = {}
    for name, edit in cases.items():
        root = Path(tmp) / f"copy{len(list(Path(tmp).iterdir()))}"
        shutil.copytree(PACKAGE, root / PACKAGE.name,
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(CHIP_SMOKE, root / CHIP_SMOKE.name)
        if edit is not None:
            fname, text, repl = edit
            src = root / PACKAGE.name / fname
            source = src.read_text()
            if source.count(text) != 1:
                raise SystemExit(f"mutant {name!r}: {text!r} is not in {fname} once")
            src.write_text(source.replace(text, repl))
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", f"ROOT = {str(root)!r}\nSEED = {seed}\n" + code],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    rc = 0
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        if proc.returncode == 0:
            passes, fields = judge(out.strip().splitlines()[-1])
            print(json.dumps({"case": name, **fields,
                              "check": "passes" if passes else "fails"}), flush=True)
            if passes != (name == "unmutated"):
                rc = 1
        else:
            print(json.dumps({"case": name, "error": err[-2000:]}), flush=True)
            rc = 1
    return rc


def _judge_sdf(line):
    rel = json.loads(line)["max_rel_err"]
    return rel <= LIMIT, {"max_rel_err": rel}


def _judge_sine(line):
    res = json.loads(line)
    return bool(res["passes"]), {"phase18_errors": res["errors"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args(argv)
    rc = 0
    with tempfile.TemporaryDirectory(prefix="ntt_mutants_", dir=args.workdir) as tmp:
        for mutants, code, judge in ((MUTANTS, _CODE, _judge_sdf),
                                     (SINE_MUTANTS, _SINE_CODE, _judge_sine)):
            rc |= _run_group(tmp, {"unmutated": None, **mutants}, code, args.seed, judge)
    return rc


if __name__ == "__main__":
    sys.exit(main())

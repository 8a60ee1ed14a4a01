"""Mutation check of the sdf-only kernel (`csrc/sdf_forward.cu` on
`csrc/surface_mma.cuh`) on one CUDA card: does the kernel check see a
deliberately broken kernel? The last two mutants break the split-fp32
product's precision: one drops the correction products (a single TF32
product per k-step), one adds every MMA straight into the running sum (the
tensor cores' truncating accumulation, unflushed); the check must see both.

    python -m neurecon_tpu_torch.tools.mutants [--seed N] [--workdir DIR]

For the unmutated source and for each mutant below, the port's package is
copied into a temporary directory (under `--workdir`, the system's temporary
directory by default; removed after), one edit is made to the copy's CUDA
source, and a fresh process builds that copy's kernel and holds it against
its plain version by the check of `chip_smoke.py` phase 10: the flagship
surface (D=8, W=256; geometric init from the seed, then seeded noise on every
weight, seed + 1), 2^20 points uniform in [-1, 1]^3 from the seed plus 4,099
more (a ragged last tile), limit 1e-5 of max|sdf|. All copies run at once.
One JSON line per copy gives its largest max|diff| / max|sdf|; the exit code
is 0 when the unmutated copy passes and every mutant fails.
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
LIMIT = 1e-5

# name -> (file under csrc/, text, replacement); each text occurs once
MUTANTS = {
    "sdf row bias dropped": (
        "sdf_forward.cu", "tile_sdf[p] = ((s0 + s1) + (s2 + s3)) + __ldg(LD.b);",
        "tile_sdf[p] = ((s0 + s1) + (s2 + s3));"),
    "sin and cos swapped": (
        "surface_mma.cuh", "v = (r < 3) ? sinf(ph) : cosf(ph);",
        "v = (r < 3) ? cosf(ph) : sinf(ph);"),
    "skip 1/sqrt(2) dropped": (
        "surface_mma.cuh", "*cat = *cat / 1.41421356237f;", "*cat = *cat;"),
    "ragged last tile skipped": (
        "sdf_forward.cu", "const int tiles = (M + P - 1) / P;", "const int tiles = M / P;"),
    "plain TF32 (no correction products)": (
        "surface_mma.cuh",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_small[i], b_big);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_small);\n"
        "#pragma unroll\n"
        "        for (int i = 0; i < MT; ++i) mma_tf32(d[i], a_big[i], b_big);",
        "for (int i = 0; i < MT; ++i) mma_tf32_first(d[i], a_big[i], b_big);"),
    "accumulator chained across k-steps": (
        "surface_mma.cuh",
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workdir", type=str, default=None)
    args = ap.parse_args(argv)
    cases = {"unmutated": None, **MUTANTS}
    with tempfile.TemporaryDirectory(prefix="ntt_mutants_", dir=args.workdir) as tmp:
        procs = {}
        for i, (name, edit) in enumerate(cases.items()):
            root = Path(tmp) / f"copy{i}"
            shutil.copytree(PACKAGE, root / PACKAGE.name,
                            ignore=shutil.ignore_patterns("__pycache__"))
            if edit is not None:
                fname, text, repl = edit
                src = root / PACKAGE.name / "csrc" / fname
                code = src.read_text()
                if code.count(text) != 1:
                    raise SystemExit(f"mutant {name!r}: {text!r} is not in {fname} once")
                src.write_text(code.replace(text, repl))
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", f"ROOT = {str(root)!r}\nSEED = {args.seed}\n" + _CODE],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        rc = 0
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            if proc.returncode == 0:
                rel = json.loads(out.strip().splitlines()[-1])["max_rel_err"]
                caught = not rel <= LIMIT
                print(json.dumps({"case": name, "max_rel_err": rel,
                                  "check": "fails" if caught else "passes"}))
                if caught == (name == "unmutated"):
                    rc = 1
            else:
                print(json.dumps({"case": name, "error": err[-2000:]}))
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

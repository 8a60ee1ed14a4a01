"""The readings that a cell's limits are set from, on the card at the
cell's own sizes:

    python3 -m benchmark.calibrate --workload neus.train --seeds 12 \
        --control-seeds 3 --fault-seeds 3 --out cal_neus_train.json

For each seed the program runs the cell's set-up (a render cell also a
short window of `--seconds`), the reference follows, and the numbers the
check compares are read: the program's (the lower readings), the
control's (the reference computed in TF32, in the program's place) and,
on the first `--fault-seeds` seeds, each fault of `faults.py` that the cell
can have, planted under the timed path. One JSON line a reading, and a
summary: per number, the largest program reading and the smallest control
and fault readings. The benchmark's own runs do none of this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, mixes
from benchmark.registry import Bench


def readings(cell, seed: int, device, seconds: float, fault=None):
    """(mix, reference, the numbers compared) of one seed's program."""
    mix = mixes.make(cell.cfg, cell.traffic, seed, device, fault)
    mix.setup()
    if cell.traffic["kind"] != "train":
        mix.window(seconds)
    mix.release()
    ref = follow_reference(mix, mix.prog if cell.traffic["kind"] == "train" else {})
    return mix, ref, mix.check(ref)


def follow_reference(mix, prog: dict, **kw) -> dict:
    """The reference against which `prog` is read: in training, the one
    that follows prog's record of each step."""
    if isinstance(prog.get("follow"), list):
        return mix.reference(follow=prog["follow"], **kw)
    return mix.reference(**kw)


def train_leaves(prog: dict, ref: dict) -> dict:
    """The leaves left out of the comparison, which leaf sets grad_gap and
    which change_gap, the near-ties the reference settled as `prog` did and
    the parameter values it took from `prog` (round-off components)."""
    keep = mixes.moved_leaves(ref["grads"])
    out = {"left_out": sorted(set(ref["grads"]) - set(keep)), "ties": ref["ties"],
           "adopted": ref["adopted"]}
    for q in ("grads", "change"):
        gaps = mixes.leaf_gaps(prog[q], ref[q], keep)
        out[f"{q}_worst"] = max(gaps, key=gaps.get)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="the faults to read (default: every fault the cell can have)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--witness", type=int, nargs="*", default=None,
                    help="seeds to read against a float64 reference as well, alone")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cell = Bench().cell(args.workload)
    kind = cell.traffic["kind"]
    rows = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.witness is not None:
        for seed in args.witness:
            mix, ref, got = readings(cell, seed, dev, args.seconds)
            prog = mix.prog if kind == "train" else mix.outputs()
            emit(seed=seed, variant="program", **got)
            emit(seed=seed, variant="program_vs_f64", **mixes.READINGS[kind](
                prog, follow_reference(mix, prog, dtype=torch.float64)))
            ref32 = mix.reference()
            emit(seed=seed, variant="fp32_ref_vs_f64", **mixes.READINGS[kind](
                ref32, follow_reference(mix, ref32, dtype=torch.float64)))
        return 0
    for i in range(args.seeds):
        seed = args.first_seed + i
        t = time.perf_counter()
        mix, ref, got = readings(cell, seed, dev, args.seconds)
        diag = train_leaves(mix.prog, ref) if kind == "train" else {}
        emit(seed=seed, variant="program", seconds=time.perf_counter() - t, **got, **diag)
        if i < args.control_seeds:
            ctl_out = mix.reference(tf32=True)
            ref_c = follow_reference(mix, ctl_out)
            diag = train_leaves(ctl_out, ref_c) if kind == "train" else {}
            emit(seed=seed, variant="control", **mixes.READINGS[kind](ctl_out, ref_c), **diag)
        if i < args.fault_seeds:
            for fault in (faults.TRAIN if kind == "train" else faults.RENDER):
                if args.faults is not None and fault not in args.faults:
                    continue
                _, _, got = readings(cell, seed, dev, args.seconds, fault=fault)
                emit(seed=seed, variant=fault, **got)
        del mix, ref
    names = [k for k, v in rows[0].items() if k.endswith(("_gap", "_p90", "_p99"))]
    summary = {}
    for n in names:
        by = {}
        for r in rows:
            if n in r:
                by.setdefault(r["variant"], []).append(r[n])
        summary[n] = {"lower": max(by["program"]),
                      **{v: min(x) for v, x in by.items() if v != "program"}}
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "device": torch.cuda.get_device_name(dev)}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell of neurecon_tpu_torch on the card:

    python3 -m benchmark.run --workload neus.train --seed 7 --seconds 30 --trace 0

loads the cell's configuration, traffic and metrics by the names in
BENCHMARK.json, makes its scene and weights on the card from the seed,
warms up, measures for --seconds, checks what the timed path produced
against the plain reference, and prints one JSON line last: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics, read from a profiled stretch of the
window), `device`, with --trace 1 `breakdown` and `silent` (the cell's
per-layer metrics whose readers found nothing in the trace, such as a
roofline whose kernel no longer runs under the names its reader knows: left
out of `metrics`, named here and on stderr), and last `checks`, each number
compared beside its limit (also the last lines of stderr).

Exits non-zero without a result when there is no card, when the cell asks
for more cards than there are, or when `jax`, `jaxlib`, `flax` or the JAX
package were loaded by the time the window closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # noqa: E402  (set-up is timed from here)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "neurecon_tpu")


class Context:
    """What a per-layer metric's reader reads: the cell's configuration and
    traffic, the trace of the profiled stretch and the work arithmetic."""

    def __init__(self, cfg: dict, traffic: dict, trace):
        self.cfg, self.traffic, self.trace = cfg, traffic, trace

    def roofline(self, kernel: str, patterns) -> float | None:
        """The kernel's least time over its device time, in percent."""
        from benchmark import work
        t = self.trace.device_seconds(patterns)
        if t <= 0:
            return None
        flops, nbytes = work.kernel_work(self.cfg, self.traffic, kernel)
        return 100.0 * self.trace.units * work.least_seconds(flops, nbytes) / t

    def mfu(self) -> float | None:
        """The units' MLP work over the stretch's length at the TF32 peak."""
        from benchmark import work
        if self.trace.busy_s <= 0:
            return None
        return (100.0 * self.trace.units * work.unit_flops(self.cfg, self.traffic)
                / self.trace.window_s / work.TF32_PEAK)

    def idle_pct(self) -> float | None:
        if self.trace.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def ms_per_unit(self, patterns) -> float | None:
        t = self.trace.device_seconds(patterns)
        return 1e3 * t / self.trace.units if t > 0 else None


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            fault=None) -> dict:
    """Set up, measure and check one run of `cell` on `device`; the result
    line as a dict."""
    import torch

    from benchmark import mixes

    mix = mixes.make(cell.cfg, cell.traffic, seed, device, fault)
    mix.setup()
    setup_s = time.perf_counter() - t_start
    res = mix.window(seconds, int(cell.traffic["trace_units"]) if trace else 0)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if trace:
        ctx = Context(cell.cfg, cell.traffic, res["trace"])
        metrics, silent = {}, []
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is None:
                silent.append(m["name"])
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        got = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": got[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    mix.release()
    readings = mix.check()
    checks = {k: {"value": readings.get(k, float("inf")), "limit": lim}
              for k, lim in cell.limits.items()}
    correct = (res["failed"] == 0 and bool(checks)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if cuda:
        out["device"]["power_limit_w"] = power_limit_w()
    if trace:
        out["device"]["busy_s"] = res["trace"].busy_s
        out["device"]["window_s"] = res["trace"].window_s
        out["breakdown"] = res["trace"].breakdown()
        out["silent"] = silent
    out["checks"] = checks
    return out


def loaded_forbidden() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache in the checkout, at fixed paths
    cache = ROOT / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    from benchmark.registry import Bench
    cell = Bench(ROOT).cell(args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name in out.get("silent", []):
        print(f"per-layer metric {name} read nothing in this cell's trace: left out",
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's seven on-card probes (`neurecon_tpu_torch/tools/bench_*.py`,
`probe_lax_map.py`) on the CPU at tiny sizes and --K 2 (probe_lax_map times
nothing): each prints its
rows as JSON lines (and returns them), the correctness rows hold (the
upsampler agreement, the culled frame's PSNR, the microchunk walk), no
probe imports JAX, and the configs they hold as dicts equal the files."""
import json
import os
import subprocess
import sys

import pytest
import yaml

from neurecon_tpu_torch.tools import (bench_ablate, bench_fused_upsample, bench_gradblock,
                                      bench_render_cull, bench_roadmap, bench_volsdf_ablate,
                                      probe_common, probe_lax_map)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("bench_ablate", "bench_volsdf_ablate", "bench_render_cull", "bench_fused_upsample",
         "bench_gradblock", "bench_roadmap", "probe_lax_map")

CASES = {
    "bench_ablate": (bench_ablate, ["--rays", "8", "--width", "64"], 10),
    "bench_volsdf_ablate": (bench_volsdf_ablate,
                            ["--rays", "8", "--width", "64", "--samples", "16"], 8),
    "bench_render_cull": (bench_render_cull, ["--H", "12", "--W", "16", "--width", "64"], 4),
    "bench_fused_upsample": (bench_fused_upsample, ["--rays", "8", "--width", "64"], 8),
    "bench_gradblock": (bench_gradblock, ["--M", "128", "--width", "64"], 2),
    "bench_roadmap": (bench_roadmap, ["--N", "128"], 7),
    "probe_lax_map": (probe_lax_map, ["--chunk", "64", "--micro", "16", "--width", "64"], 2),
}


@pytest.mark.parametrize("name", TOOLS)
def test_probe_prints_json_rows(name, capsys):
    """Each probe's main on the CPU: one JSON line per row it returns, every
    timing finite and positive, the device and card named; the correctness
    rows of bench_fused_upsample, bench_render_cull and probe_lax_map pass
    (on the CPU a kernel's wrapper is its plain version, so the agreement is
    exact there; the card checks it in chip_smoke.py phase 39)."""
    module, argv, n_rows = CASES[name]
    timed = [] if name == "probe_lax_map" else ["--K", "2"]
    rows = module.main(["--device", "cpu", "--seed", "0"] + timed + argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert [json.loads(ln) for ln in lines] == rows
    assert len(rows) == n_rows and all(r["probe"] == name and r["device"] == "cpu"
                                       and r["card"] == "cpu" for r in rows)
    for r in rows:
        for key in ("ms", "s_per_frame", "per_rep_ms", "both_ms"):
            if key in r:
                assert 0 < r[key] < float("inf"), (r["row"], key)
    if hasattr(module, "passed"):
        assert module.passed(rows)
    if name == "bench_render_cull":
        assert rows[1]["culled_share"] > 0 and rows[1]["psnr_vs_baseline"] >= 30.0
    if name == "probe_lax_map":
        assert all(r["bit_equal"] and r["micro_div_frac"] == 0.0 for r in rows)
    if name == "bench_gradblock":
        assert rows[0]["program_gflop"] == rows[1]["program_gflop"] > 0


def test_probe_gates_fail_on_a_disagreement():
    """The gates read what they say: a row off the bounds fails them."""
    assert not bench_fused_upsample.passed([{"row": "agreement det", "ok": False}])
    assert not bench_render_cull.passed([{"row": "x", "finite": True,
                                          "psnr_vs_baseline": 29.0}])
    assert not probe_lax_map.passed([{"bit_equal": False}])


def test_probes_import_no_jax():
    """Importing every probe (and running --help) pulls in no JAX module."""
    code = ("import sys\n"
            + "".join(f"import neurecon_tpu_torch.tools.{t}\n" for t in TOOLS)
            + "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
              "'neurecon_tpu.'))]\n"
              "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("fname,attr", [("neus.yaml", "NEUS_YAML"),
                                        ("long_volsdf_sphere.yaml", "LONG_VOLSDF_SPHERE")])
def test_probe_configs_are_the_files(fname, attr):
    """The probes' configs equal the files but for the JAX package's TPU
    gates, which select no path in the port."""
    with open(os.path.join(REPO, "configs", fname)) as f:
        want = yaml.safe_load(f)
    for key in probe_common.TPU_GATES:
        want["training"].pop(key, None)
    assert getattr(probe_common, attr) == want

"""BENCHMARK.json against the forms it must take, and a new configuration,
traffic mix and per-layer metric dropped into a copy of the benchmark and
found by name, with no file edited."""
from __future__ import annotations

import json
import re
import shutil

import pytest
import torch

from benchmark.registry import HERE, Bench
from benchmark.run import execute

ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_forms():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    assert all(isinstance(w, str) and 0 < len(w) <= 200 for w in s["command"])
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in s["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert "\n" not in m["layer"] and 0 < len(m["layer"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(s)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_every_cell_reports_enough(cell):
    c = Bench().cell(cell)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    assert all(m["moves"] in e2e for m in c.per_layer)
    assert c.limits, "the cell's limits file is missing"
    assert c.traffic["kind"] in ("train", "render")


def test_new_config_traffic_and_metric_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    # the new files: a configuration, a traffic mix, a per-layer metric
    cfg = json.loads((root / "benchmark/configs/neus.json").read_text())
    cfg["scene"].update(n_images=3, H=16, W=24)
    cfg["model"]["surface"].update(D=2, W=16, skips=[], embed_multires=1)
    cfg["model"]["radiance"].update(D=1, W=16)
    cfg["model"].update(W_geometry_feature=16, N_samples=4, N_importance=4, N_upsample_iters=1)
    (root / "benchmark/configs/neus_tiny.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/render_tiny.json").write_text(json.dumps(
        {"kind": "render", "downscale": 2, "rayschunk": 50, "frames": 2, "check_rays": 16,
         "trace_units": 1}))
    (root / "benchmark/metrics/frames_traced.py").write_text(
        'LAYER = "training.py (render_full_image)"\nUNIT = "frames"\nSOURCE = "device_trace"\n'
        'MOVES = "render_rays_per_s"\n\n\ndef read(ctx):\n    return ctx.trace.units\n')
    (root / "benchmark/limits/neus_tiny.render_tiny.json").write_text(json.dumps(
        {"rgb_gap": 1e-3, "depth_gap": 1e-3, "normal_gap": 1e-3}))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "neus_tiny", "source": "https://example.org/neus",
                         "file": "benchmark/configs/neus_tiny.json", "reduced": [],
                         "why": "a test's"})
    s["workloads"].append({"name": "neus_tiny.render_tiny", "config": "neus_tiny",
                           "traffic": "render_tiny", "chips": 1, "why": "a test's"})
    s["end_to_end"][-1]["workloads"].append("neus_tiny.render_tiny")
    s["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                           "source": "device_trace", "layer": "training.py (render_full_image)",
                           "moves": "render_rays_per_s",
                           "workloads": ["neus_tiny.render_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    cell = Bench(root).cell("neus_tiny.render_tiny")
    assert cell.cfg["model"]["surface"]["W"] == 16 and cell.traffic["frames"] == 2
    assert [m["name"] for m in cell.per_layer] == ["frames_traced"]
    out = execute(cell, 5, 0.2, True, torch.device("cpu"), 0.0)
    assert out["metrics"]["frames_traced"] == {"value": 1, "unit": "frames"}
    assert out["correct"] is True
    for p, data in before.items():  # BENCHMARK.json only gained entries
        assert p.read_bytes() == data, f"{p} was edited"


def test_silent_metric_is_named(small_cell):
    """A per-layer metric whose reader finds nothing (here every kernel
    roofline: the plain path on the CPU launches no kernel of the port) is
    left out of `metrics` and named under `silent`."""
    cell = small_cell("neus.render")
    out = execute(cell, 3, 0.2, True, torch.device("cpu"), 0.0)
    assert out["silent"] == [m["name"] for m in cell.per_layer
                             if m["name"] not in out["metrics"]]
    assert {"fused_nablas_roofline.render", "fused_upsample_roofline.render"} <= set(
        out["silent"])
    assert list(out)[-1] == "checks"

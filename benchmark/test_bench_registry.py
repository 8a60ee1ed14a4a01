"""BENCHMARK.json against the forms it must take, and a new configuration,
traffic mix and per-layer metric, and a new framework, dropped into a copy
of the benchmark and found by name, with no file edited."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

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


# A framework the program does not know: one module of the reference
# interface (`benchmark.registry.framework`), logging each call it serves.
TOY = '''"""A toy framework: the radiance net's mean over sorted depths, scaled."""
import torch

CALLS = []


def extra_weights(cfg, gen, device):
    CALLS.append("extra_weights")
    return {"toy_gain": 1.0 + torch.rand(1, generator=gen, device=device)}


def draws(cfg, n, gen, device):
    CALLS.append("draws")
    return {"u_toy": torch.rand(n, int(cfg["model"]["N_toy"]), generator=gen, device=device)}


def _render(nets, params, rays_o, rays_d, u, train):
    d = torch.sort(u, dim=-1).values * 2.0
    n, k = d.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
    sdf, nablas, h = nets.surface_with_nablas(pts.reshape(-1, 3), train)
    views = rays_d[:, None, :].expand(n, k, 3).reshape(-1, 3)
    rad = nets.radiance(pts.reshape(-1, 3), views, nablas, h).reshape(n, k, 3)
    return rad.mean(1) * params["toy_gain"], d, nablas.reshape(n, k, 3)


def train_loss(nets, params, cfg, rays_o, rays_d, dr, target, mask, step, follow=None):
    CALLS.append(f"train_loss {step}")
    rgb, d, nablas = _render(nets, params, rays_o, rays_d, dr["u_toy"], True)
    eik = torch.mean((torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2)
    return torch.mean(torch.abs(rgb - target)) + 0.1 * eik, rgb, {"samples": d}, 0


def render_eval(nets, params, cfg, rays_o, rays_d):
    CALLS.append("render_eval")
    u = torch.linspace(0.0, 1.0, int(cfg["model"]["N_toy"])).expand(rays_o.shape[0], -1)
    rgb, d, nablas = _render(nets, params, rays_o, rays_d, u, False)
    return {"rgb": rgb, "depth": d.mean(-1), "normals": nablas.mean(1)}


def recorded(sampled, extras):
    CALLS.append("recorded")
    return {"samples": sampled["depths"]}


def shifted(cfg, sampled):
    CALLS.append("shifted")
    return dict(sampled, depths=sampled["depths"] + 0.25)


def points(cfg, n, train):
    CALLS.append("points")
    k = int(cfg["model"]["N_toy"])
    return {"upsample": 0, "sampler": 7 * n, "nablas": n * k, "radiance": n * k}


def sdf_launches(cfg):
    CALLS.append("sdf_launches")
    return 3


def shrink(m):
    CALLS.append("shrink")
    m.update(N_toy=5)
'''

_TOY_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark import faults, mixes, work
from benchmark.conftest import shrink
from benchmark.reference import nets, step, toy
from benchmark.registry import Bench
from benchmark.scene import make_scene
from benchmark.weights import make_weights
assert mixes.__file__.startswith({root!r})
dev = torch.device("cpu")
cell = shrink(Bench().cell("toy.train"))
cfg, tr = cell.cfg, cell.traffic
sp = nets.spec(cfg)
w = make_weights(cfg, 3, dev)
scene = make_scene(cfg["scene"], dev)
gen = torch.Generator().manual_seed(4)
steps = []
for k in range(3):
    steps.append((k, gen.get_state()))
    step.draws(cfg, 16, 24, 32, gen, dev)
ref = step.train_steps(cfg, w, scene, steps)
again = step.train_steps(cfg, w, scene, steps, follow=ref["follow"])
out = step.render_rays(cfg, w, scene["c2w"][:1, :3, 3].expand(8, 3), torch.randn(8, 3))
fns, _ = faults.apply_train("shifted_samples", {{"depth_sample": lambda rb, dr: {{
    "depths": torch.zeros(2, 3)}}, "loss_with_samples": lambda *a: (
    torch.zeros(()), ({{}}, {{"rgb": torch.zeros(1, 2, 3)}}))}}, None, cfg)
mix = mixes.TrainMix(cfg, tr, 1, dev)
mix.model, mix.names = torch.nn.Linear(1, 1), {{"weight": "w", "bias": "b"}}
fns = mix._recorder(fns)
mix.recording = True
fns["loss_with_samples"](None, fns["depth_sample"](None, None), None, None, 0)
print(json.dumps({{
    "calls": toy.CALLS, "N_toy": cfg["model"]["N_toy"], "surface_dims": sp["surface"]["dims"],
    "weights": sorted(k for k in w if "." not in k), "gain": float(w["toy_gain"]),
    "losses": ref["losses"], "again": again["losses"],
    "samples": list(ref["samples"][0].shape), "render": list(out["rgb"].shape),
    "points": work.points(cfg, tr), "flops": work.unit_flops(cfg, tr),
    "fused_mlp": work.kernel_work(cfg, tr, "fused_mlp"),
    "surface_bytes": work.weight_bytes(sp, "surface"),
    "recorded": mix.record["follow"][0]["samples"].tolist(),
    "state": sorted(mix.record["follow"][0]["params"])}}))
"""


def test_new_framework_found_without_edits(tmp_path):
    """A framework the harness has never seen is one new module under
    `benchmark/reference/` and its configuration: the nets' spec, the
    weights, the reference's training steps and render, the work counts,
    the recorder, the planted sampler fault and the CPU sizes all go
    through that module, and no other file changes. The program is not
    run: it does not know the framework."""
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    (root / "benchmark/reference/toy.py").write_text(TOY)
    cfg = json.loads((root / "benchmark/configs/neus.json").read_text())
    cfg["model"] = {k: v for k, v in cfg["model"].items()
                    if k not in ("N_samples", "N_importance", "N_upsample_iters",
                                 "variance_init")}
    cfg["model"].update(framework="Toy", N_toy=9)
    del cfg["training"]["speed_factor"]
    (root / "benchmark/configs/toy.json").write_text(json.dumps(cfg))
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "toy", "source": "https://example.org/toy",
                         "file": "benchmark/configs/toy.json", "reduced": [], "why": "a test's"})
    s["workloads"].append({"name": "toy.train", "config": "toy", "traffic": "train",
                           "chips": 1, "why": "a test's"})
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    run = subprocess.run([sys.executable, "-c", _TOY_RUN.format(root=str(root))], cwd=root,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["N_toy"] == 5 and got["calls"][0] == "shrink"
    assert {"extra_weights", "draws", "render_eval", "points", "sdf_launches", "shifted",
            "recorded"} <= set(got["calls"])
    assert [c for c in got["calls"] if c.startswith("train_loss")] == [
        "train_loss 0", "train_loss 1", "train_loss 2"] * 2
    assert got["surface_dims"][0] == [15, 32] and got["weights"] == ["toy_gain"]
    assert 1.0 <= got["gain"] < 2.0
    assert got["losses"] == got["again"] and all(x == x for x in got["losses"])
    assert got["samples"] == [16, 5] and got["render"] == [8, 3]
    assert got["points"] == {"rays": 16, "upsample": 0, "sampler": 112, "nablas": 80,
                             "backward": 80, "radiance": 80}
    assert got["fused_mlp"][1] == 112 * 16 + 3 * got["surface_bytes"]
    assert got["flops"] > 0
    assert got["recorded"] == [[0.25] * 3] * 2 and got["state"] == ["b", "w"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    assert {p for p in (root / "benchmark").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts} == set(before) | {
        root / "benchmark/reference/toy.py", root / "benchmark/configs/toy.json"}


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

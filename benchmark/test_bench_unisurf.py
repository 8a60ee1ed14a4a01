"""The cells `unisurf.train` and `volsdf.render`: the UNISURF framework module
found by name, its configuration against neurecon's configs/unisurf.yaml,
its work counts, the check on the CPU at `conftest.shrink` sizes (a sound
run passes, the control and every fault fail), the readers of the root
find's spans on hand-made traces, and on a card the control at cell size
(marked `cuda`)."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import calibrate, faults, mixes, spans, work
from benchmark.reference import unisurf
from benchmark.reference.nets import spec
from benchmark.registry import HERE, Bench, framework
from benchmark.run import Context, execute
from benchmark.trace import Trace

CPU = torch.device("cpu")
CELLS = ("unisurf.train", "volsdf.render")
NEW = ("train_idle_ms.root_find", "root_find_launches_per_step")


def fails(cell, readings: dict) -> bool:
    return any(readings[k] > limit for k, limit in cell.limits.items())


def test_framework_module_found_by_name():
    cell = Bench().cell("unisurf.train")
    assert framework(cell.cfg) is unisurf
    assert cell.traffic["kind"] == "train" and Bench().cell("volsdf.render").traffic == {
        "kind": "render", "downscale": 8, "rayschunk": 4096, "frames": 16, "check_rays": 4096,
        "trace_units": 2}


def test_configuration_is_neurecons_key_for_key():
    """Every key of configs/unisurf.yaml at its value; the others are the
    code's defaults that `assumed.defaults` names, the scene, and the
    benchmark's own keys."""
    from neurecon_tpu_torch.config import load_yaml

    want = load_yaml(str(HERE.parent / "configs" / "unisurf.yaml"))
    got = json.loads((HERE / "configs" / "unisurf.json").read_text())

    def check(w, g, path=""):
        for k, v in w.items():
            if isinstance(v, dict):
                check(v, g[k], f"{path}{k}.")
            else:
                assert g[k] == v, f"{path}{k}"

    check(dict(want), got)
    assert set(got) - set(want) == {"source", "reduced", "assumed", "scene"}
    assert got["reduced"] == [] and got["source"].endswith("configs/unisurf.yaml")
    extra = {k for k in got["model"] if k not in want["model"]}
    assert extra == {"N_query", "N_freespace", "N_steps", "perturb", "white_bkgd", "use_siren"}
    assert all(k in got["assumed"]["defaults"] for k in extra)


def test_points_and_work_hand_counts():
    cell = Bench().cell("unisurf.train")
    pt = work.points(cell.cfg, cell.traffic)
    assert pt == {"rays": 1024, "upsample": 0, "sampler": 1024 * (256 + 8),
                  "nablas": 1024 * 98, "backward": 1024 * 98, "radiance": 1024 * 96}
    sp = spec(cell.cfg)
    assert work.surface_macs(sp, "sdf") == 459_008
    assert work.radiance_macs(sp) == 265 * 256 + 3 * 256 * 256 + 256 * 3
    assert work.unit_flops(cell.cfg, cell.traffic) == 2 * (
        1024 * 264 * 459_008 + 1024 * 98 * (983_296 + 1_966_592)
        + 1024 * 96 * 3 * work.radiance_macs(sp))
    flops, nbytes = work.kernel_work(cell.cfg, cell.traffic, "fused_mlp")
    assert flops == 2 * 1024 * 264 * 459_008
    assert nbytes == 1024 * 264 * 16 + 9 * work.weight_bytes(sp, "surface")
    render = Bench().cell("volsdf.render")
    assert work.points(render.cfg, render.traffic)["sampler"] == 150 * 200 * 3584


def test_interval_is_the_programs():
    from neurecon_tpu_torch.models.frameworks.unisurf import _interval_f32

    t = Bench().cell("unisurf.train").cfg["training"]
    for it in (0, 1, 2, 1000, 199_000, 199_800, 250_000, 450_000):
        assert unisurf.interval(t, it) == _interval_f32(it, 1.0, 0.05, 1.5e-5)
    assert unisurf.interval(t, 0) == 1.0 and unisurf.interval(t, 250_000) == pytest.approx(0.05)


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name, seed):
    out = execute(small_cell(name), seed, 0.3, False, CPU, 0.0)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == set(small_cell(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(small_cell, name):
    cell = small_cell(name)
    for seed in (1, 2, 3):
        mix, _, got = calibrate.readings(cell, seed, CPU, 0.3)
        ctl = mix.reference(tf32=True)
        control = mixes.READINGS[cell.traffic["kind"]](ctl, calibrate.follow_reference(mix, ctl))
        assert not fails(cell, got)
        assert fails(cell, control), control


FAULTS = [(c, f) for c in CELLS for f in (faults.TRAIN if c.endswith(".train") else faults.RENDER)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(small_cell, name, fault):
    for seed in (4, 5):
        out = execute(small_cell(name), seed, 0.3, False, CPU, 0.0, fault=fault)
        assert out["correct"] is False, (fault, out["checks"])


def test_shifted_root_is_seen_by_the_sampler_alone(small_cell):
    """The shifted-root fault moves every root by r / N_steps: the check's
    `samples_p99` sees it, the numbers that follow the program's root do
    not move off their sound readings."""
    cell = small_cell("unisurf.train")
    out = execute(cell, 4, 0.3, False, CPU, 0.0, fault="shifted_samples")
    checks = {k: c["value"] for k, c in out["checks"].items()}
    assert checks["samples_p99"] > cell.limits["samples_p99"]
    assert all(v <= cell.limits[k] for k, v in checks.items() if k != "samples_p99")


def ev(cat, name, ts, end, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}


def readers():
    entries = {m["name"]: m for m in Bench().spec["per_layer"]}
    return {name: Bench().reader(entries[name]) for name in NEW}


def root_find_trace():
    """Two steps; in each, the sampler's span holds the march and the
    secant, and kernel 4's wrapper span (ops) inside the secant."""
    host = []
    for base in (0, 200):
        host += [ev("user_annotation", "ntt.step", base, base + 150),
                 ev("user_annotation", "ntt.unisurf.sample", base + 10, base + 60),
                 ev("user_annotation", "ntt.cast.march", base + 10, base + 25),
                 ev("user_annotation", "ntt.cast.secant", base + 25, base + 58),
                 ev("user_annotation", "ntt.op.sdf_forward", base + 30, base + 36),
                 ev("user_annotation", "ntt.unisurf.loss", base + 60, base + 100)]
        host += [ev("cuda_runtime", "cudaLaunchKernel", base + t, base + t + 1)
                 for t in (12, 27, 31, 40, 50, 70, 120)]
        host.append(ev("cuda_driver", "cuLaunchKernelEx", base + 33, base + 34))
    dev = []
    for base in (0, 200):
        # gaps (mid -> innermost known span, cast span around it):
        # 20-24 (22: unisurf.sample, march) counted; 32-35 (33.5: op.sdf_forward)
        # not; 44-48 (46: unisurf.sample, secant) counted; 61-65 (63: loss) not;
        # 5-9 (7: step) not
        dev += [ev("kernel", "k", base + a, base + b, tid=7)
                for a, b in ((0, 5), (9, 20), (24, 32), (35, 44), (48, 61), (65, 90))]
    return Trace(host + dev, window_s=400e-6, units=2)


def test_root_find_idle_counts_the_gaps_under_cast_spans():
    r = readers()
    t = root_find_trace()
    got = r["train_idle_ms.root_find"].read(Context({}, {}, t))
    assert got == pytest.approx((4 + 4) / 1e3, rel=1e-12)
    parts = spans.idle_ms(t)
    assert got <= parts["frameworks"] and parts["frameworks"] == pytest.approx(
        (4 + 4 + 4) / 1e3, rel=1e-12)


def test_root_find_launches_per_step():
    r = readers()
    # inside the cast spans: 12, 27, 31, 40, 50 and the cuLaunchKernelEx at 33
    assert r["root_find_launches_per_step"].read(Context({}, {}, root_find_trace())) == 6.0


def test_readers_read_nothing_without_the_cast_spans():
    t = root_find_trace()
    t.host = [h for h in t.host if not h[0].startswith("ntt.cast.")]
    assert {n: r.read(Context({}, {}, t)) for n, r in readers().items()} == dict.fromkeys(NEW)


def test_new_entries_and_cells():
    spec_ = Bench().spec
    entries = {m["name"]: m for m in spec_["per_layer"]}
    assert [m["name"] for m in spec_["per_layer"][-2:]] == list(NEW)
    for name in NEW:
        m = entries[name]
        assert (m["layer"], m["moves"], m["workloads"], m["source"], m["better"]) == (
            "models/ray_casting.py (the root find)", "train_rays_per_s", ["unisurf.train"],
            "device_trace", "lower")
    train, render = Bench().cell("unisurf.train"), Bench().cell("volsdf.render")
    assert {m["name"] for m in train.end_to_end} == {"setup_s", "train_rays_per_s",
                                                     "train_step_ms_p95"}
    assert {m["name"] for m in render.end_to_end} == {"setup_s", "render_rays_per_s"}
    assert {m["name"] for m in train.per_layer} == {
        "train_idle_pct", "train_mfu", "fused_nablas_roofline.train",
        "fused_nablas_vjp_roofline.train", "fused_mlp_roofline.train", "train_idle_ms.step",
        "train_idle_ms.frameworks", "train_idle_ms.ops", "train_idle_ms.unspanned",
        "train_host_syncs_per_step", "train_launches_per_step", *NEW}
    assert {m["name"] for m in render.per_layer} == {
        "render_idle_pct", "render_mfu", "fused_nablas_roofline.render",
        "render_idle_ms.render", "render_idle_ms.frameworks", "render_idle_ms.ops",
        "render_idle_ms.unspanned"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(card, name):
    cell = Bench().cell(name)
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        mix, _, got = calibrate.readings(cell, seed, card, 3.0)
        ctl = mix.reference(tf32=True)
        control = mixes.READINGS[cell.traffic["kind"]](ctl, calibrate.follow_reference(mix, ctl))
        assert not fails(cell, got), got
        assert fails(cell, control), control

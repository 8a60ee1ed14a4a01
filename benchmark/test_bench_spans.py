"""The readers of the program's spans (benchmark/spans.py and the
`*_idle_ms.*`, `train_host_syncs_per_step` and `train_launches_per_step`
metrics) on synthetic traces, and their entries in BENCHMARK.json."""
from __future__ import annotations

import json

import pytest

from benchmark import spans
from benchmark.registry import HERE, Bench
from benchmark.run import Context
from benchmark.trace import Trace

TRAIN = ["neus.train", "volsdf.train"]
NEW = {  # metric: (layer, unit, moves, cells), as the metrics' entries give them
    "train_idle_ms.step": ("training.py (the step)", "ms", "train_rays_per_s", TRAIN),
    "train_idle_ms.frameworks": ("frameworks", "ms", "train_rays_per_s", TRAIN),
    "train_idle_ms.ops": ("ops (host side of the kernel wrappers)", "ms", "train_rays_per_s",
                          TRAIN),
    "train_idle_ms.unspanned": ("entry", "ms", "train_rays_per_s", TRAIN),
    "render_idle_ms.render": ("training.py (render_full_image)", "ms", "render_rays_per_s",
                              ["neus.render"]),
    "render_idle_ms.frameworks": ("frameworks", "ms", "render_rays_per_s", ["neus.render"]),
    "render_idle_ms.ops": ("ops (host side of the kernel wrappers)", "ms", "render_rays_per_s",
                           ["neus.render"]),
    "render_idle_ms.unspanned": ("entry", "ms", "render_rays_per_s", ["neus.render"]),
    "train_host_syncs_per_step": ("training.py (the step)", "count", "train_rays_per_s", TRAIN),
    "train_launches_per_step": ("training.py (the step)", "count", "train_rays_per_s", TRAIN),
}


def ev(cat, name, ts, end, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts, "tid": tid}


def kernels(*intervals):
    return [ev("kernel", "k", a, b, tid=7) for a, b in intervals]


def gaps(trace):
    return sum(b - a for (_, a), (b, _) in zip(trace.busy, trace.busy[1:]))


def readers():
    entries = {m["name"]: m for m in Bench().spec["per_layer"]}
    return {name: Bench().reader(entries[name]) for name in NEW}


def step_trace():
    """Two steps on thread 1; kernel 3's wrapper span on the autograd thread
    2, inside the first step's backward."""
    host = [ev("user_annotation", "ntt.step", 0, 100),
            ev("user_annotation", "ntt.step", 120, 200),
            ev("user_annotation", "ntt.step.draw", 0, 10),
            ev("user_annotation", "ntt.neus.loss", 10, 50),
            ev("user_annotation", "ntt.neus.render", 12, 40),
            ev("user_annotation", "ntt.op.nablas_forward", 14, 18),
            ev("user_annotation", "ntt.step.backward", 50, 100),
            ev("user_annotation", "ntt.op.nablas_vjp", 60, 70, tid=2),
            ev("cpu_op", "aten::mm", 20, 40),  # a torch op: not a span of the program
            ev("user_annotation", "ntt.step.update", 130, 200)]
    dev = kernels((0, 2), (5, 13), (16, 25), (45, 62), (68, 110), (150, 200))
    # gaps (mid -> innermost span): 2-5 (3.5, step.draw), 13-16 (14.5,
    # op.nablas_forward), 25-45 (35, neus.render), 62-68 (65, op.nablas_vjp on
    # thread 2), 110-150 (130: step.update, shorter than the step around it)
    return Trace(host + dev, window_s=200e-6, units=2)


def test_innermost_span_across_two_host_threads():
    t = step_trace()
    got = spans.idle_ms(t)
    assert got == pytest.approx({"training": (3 + 40) / 1e3 / 2, "frameworks": 20 / 1e3 / 2,
                                 "ops": (3 + 6) / 1e3 / 2, "unspanned": 0.0}, rel=1e-12)


def test_the_parts_add_up_to_the_summed_gaps():
    t = step_trace()
    t.host.append(("ntt.render.chunk", 300, 400))  # a span with no gap inside
    for trace in (t, Trace(kernels((0, 1), (3, 7), (30, 31), (90, 99)) + [
            ev("user_annotation", "ntt.render", 2, 50),
            ev("user_annotation", "ntt.unisurf.sample", 20, 40),
            ev("user_annotation", "ntt.op.sdf_forward", 25, 32)], 100e-6, 3)):
        parts = spans.idle_ms(trace)
        assert sum(parts.values()) * trace.units == pytest.approx(gaps(trace) / 1e3, rel=1e-12)


def test_gap_with_no_span_is_unspanned():
    t = Trace(kernels((0, 10), (20, 30), (60, 70)) + [
        ev("user_annotation", "ntt.step", 35, 44),  # ends before the gap's middle, 45
        ev("cpu_op", "aten::mul", 40, 50)], 100e-6, 1)
    assert spans.idle_ms(t) == {"training": 0.0, "frameworks": 0.0, "ops": 0.0,
                                "unspanned": (10 + 30) / 1e3}
    t.host.append(("ntt.other", 30, 60))  # a span of no known layer is passed over
    assert spans.idle_ms(t)["unspanned"] == (10 + 30) / 1e3


def test_counts_only_inside_step_spans():
    host = [ev("user_annotation", "ntt.step", 0, 100),
            ev("user_annotation", "ntt.step", 200, 300)]
    host += [ev("cuda_runtime", "cudaStreamSynchronize", 60, 64, tid=2),  # autograd thread
             ev("cuda_runtime", "cudaStreamSynchronize", 150, 151),  # between the steps
             ev("cuda_runtime", "cudaMemcpy", 210, 211),
             ev("cuda_runtime", "cudaMemcpyAsync", 220, 221),  # does not block
             ev("cuda_runtime", "cudaEventSynchronize", 295, 301),  # leaves the step
             ev("cuda_runtime", "cudaDeviceSynchronize", 350, 351)]
    host += [ev("cuda_runtime", "cudaLaunchKernel", t, t + 1) for t in (1, 5, 90, 110, 250)]
    host += [ev("cuda_runtime", "cudaLaunchKernelExC", 30, 31),
             ev("cuda_driver", "cuLaunchKernel", 40, 41),
             ev("cuda_driver", "cuLaunchKernelEx", 199, 201)]
    t = Trace(host + kernels((0, 1)), 400e-6, 2)
    assert spans.calls_per_step(t, spans.SYNCS) == 2 / 2
    assert spans.calls_per_step(t, spans.LAUNCHES) == 6 / 2


def test_readers_read_the_spans():
    r = readers()
    ctx = Context({}, {}, step_trace())
    assert r["train_idle_ms.step"].read(ctx) == r["render_idle_ms.render"].read(ctx)
    assert r["train_idle_ms.step"].read(ctx) == pytest.approx(0.0215, rel=1e-12)
    assert r["train_idle_ms.frameworks"].read(ctx) == pytest.approx(0.01, rel=1e-12)
    assert r["train_idle_ms.ops"].read(ctx) == pytest.approx(0.0045, rel=1e-12)
    assert r["train_idle_ms.unspanned"].read(ctx) == 0.0
    assert r["train_host_syncs_per_step"].read(ctx) == 0.0
    assert r["train_launches_per_step"].read(ctx) == 0.0


def test_readers_read_nothing_from_a_program_without_spans():
    """The parent of the spans: every new reader is silent, none raises."""
    t = Trace(kernels((0, 10), (20, 30)) + [ev("cpu_op", "aten::mm", 5, 25),
                                            ev("cuda_runtime", "cudaLaunchKernel", 1, 2)],
              30e-6, 1)
    ctx = Context({}, {}, t)
    assert {name: r.read(ctx) for name, r in readers().items()} == dict.fromkeys(NEW)


def test_entries_and_readers_agree():
    """Each new metric's entry (appended, with its cells) against its reader's
    LAYER / UNIT / SOURCE / MOVES, which the registry checks on load."""
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert [m["name"] for m in spec["per_layer"][-len(NEW):]] == list(NEW)
    for name, (layer, unit, moves, cells) in NEW.items():
        m = entries[name]
        assert (m["layer"], m["unit"], m["moves"], m["workloads"]) == (layer, unit, moves, cells)
        assert (m["source"], m["better"]) == ("device_trace", "lower")
        mod = Bench().reader(m)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (layer, unit, "device_trace",
                                                                moves)
        for cell in cells:
            assert name in Bench().cell(cell).readers

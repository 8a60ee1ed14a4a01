"""The work arithmetic against hand counts from the configurations' widths,
and the roofline shares and mfu bounded by 100% for any device time at or
above the least time."""
from __future__ import annotations

import pytest

from benchmark import work
from benchmark.reference.nets import spec
from benchmark.registry import Bench
from benchmark.run import Context
from benchmark.trace import Trace

CELLS = ("neus.train", "volsdf.train", "neus.render")


@pytest.mark.parametrize("config", ["neus.train", "volsdf.train"])
def test_surface_macs_hand_counts(config):
    sp = spec(Bench().cell(config).cfg)
    # 39 -> 256, 256 -> 256 x2, 256 -> 217 (before the skip), 256 -> 256 x4
    hidden = 39 * 256 + 2 * 256 * 256 + 256 * 217 + 4 * 256 * 256
    assert hidden == 458_752
    assert work.surface_macs(sp, "sdf") == 459_008 == hidden + 256
    assert work.surface_macs(sp, "nablas") == 983_296 == 2 * hidden + 256 * 257
    assert work.surface_macs(sp, "backward") == 1_966_592 == 4 * hidden + 2 * 256 * 257
    # a backward that recomputes the forward and the nablas sweep does 2,884,096
    assert work.surface_macs(sp, "backward") + 2 * hidden == 2_884_096


def test_radiance_macs_hand_counts():
    neus, volsdf = (spec(Bench().cell(c).cfg) for c in ("neus.train", "volsdf.train"))
    # [x 3, view 3 + 24 octaves, normals 3, features 256] -> 256 x4 -> 3
    assert work.radiance_macs(neus) == 289 * 256 + 3 * 256 * 256 + 256 * 3
    assert work.radiance_macs(volsdf) == 265 * 256 + 3 * 256 * 256 + 256 * 3


def test_points_per_step_and_frame():
    b = Bench()
    pt = {c: work.points(b.cell(c).cfg, b.cell(c).traffic) for c in CELLS}
    assert pt["neus.train"] == {"rays": 512, "upsample": 512 * 128, "sampler": 0,
                                "nablas": 130_560, "backward": 130_560, "radiance": 512 * 127}
    assert pt["volsdf.train"] == {"rays": 1024, "upsample": 0, "sampler": 1024 * 3584,
                                  "nablas": 197_632, "backward": 197_632,
                                  "radiance": 1024 * 192}
    assert pt["neus.render"] == {"rays": 120_000, "upsample": 120_000 * 128, "sampler": 0,
                                 "nablas": 120_000 * 255, "backward": 0,
                                 "radiance": 120_000 * 127}


def _trace(kernel_s: dict, window_s: float, units: int) -> Trace:
    events, t = [], 0.0
    for name, s in kernel_s.items():
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": s * 1e6})
        t += s * 1e6
    return Trace(events, window_s, units)


KERNELS = [(c, m["name"]) for c in CELLS for m in Bench().cell(c).per_layer
           if "roofline" in m["name"]]
# names as the profiler gives them (demangled, with templates and arguments)
NAMES = {"fused_nablas": ["void ntt::nablas_forward_kernel<ntt::tc::Tile<128, 4> >"
                          "(ntt::tc::Mlp, float const*, int, float*, float*, float*)"],
         "fused_upsample": ["void ntt::neus_upsample_kernel<ntt::tc::Tile<64, 4> >"
                            "(ntt::tc::Mlp, float const*)"],
         "fused_nablas_vjp": ["void ntt::backward_tile_kernel<ntt::tc::Tile<128, 4> >"
                              "(ntt::tc::Mlp, float const*)",
                              "void ntt::outer_sum_kernel<128>(long long const*, int)",
                              "ntt::colsum_kernel(float const*, int, int, float*)",
                              "ntt::split_sum_kernel(float const*, long long, int, float*)"],
         "fused_mlp": ["void ntt::sdf_forward_kernel<ntt::tc::Tile<128, 4> >"
                       "(ntt::tc::Mlp, float const*, int, float*)"]}
OTHER = "void at::native::vectorized_elementwise_kernel<4>(int, float*)"


@pytest.mark.parametrize("slack", [1.0, 1.01, 3.0, 40.0])
@pytest.mark.parametrize("cell,metric", KERNELS)
def test_roofline_at_most_100(cell, metric, slack):
    c = Bench().cell(cell)
    kernel = metric.split("_roofline")[0]
    flops, nbytes = work.kernel_work(c.cfg, c.traffic, kernel)
    units = 7
    least = units * work.least_seconds(flops, nbytes)
    names = {n: least * slack / len(NAMES[kernel]) for n in NAMES[kernel]}
    names[OTHER] = least  # another kernel's time is not the kernel's
    share = c.readers[metric].read(Context(c.cfg, c.traffic,
                                           _trace(names, 10 * least * slack, units)))
    assert share is not None and share <= 100.0 + 1e-9
    assert share == pytest.approx(100.0 / slack)


def test_reader_without_its_kernels_reads_nothing():
    c = Bench().cell("neus.train")
    ctx = Context(c.cfg, c.traffic, _trace({OTHER: 0.01}, 0.02, 1))
    assert c.readers["fused_nablas_vjp_roofline.train"].read(ctx) is None


@pytest.mark.parametrize("slack", [1.0, 2.0, 25.0])
@pytest.mark.parametrize("cell", CELLS)
def test_mfu_at_most_100(cell, slack):
    c = Bench().cell(cell)
    units = 3
    least = units * work.unit_flops(c.cfg, c.traffic) / work.TF32_PEAK
    ctx = Context(c.cfg, c.traffic, _trace({"k": least}, least * slack, units))
    mfu = next(m for m in c.per_layer if "mfu" in m["name"])
    assert c.readers[mfu["name"]].read(ctx) == pytest.approx(100.0 / slack)


def test_unit_flops_hand_counts():
    b = Bench()
    neus, volsdf, render = (b.cell(c) for c in CELLS)
    sp = spec(neus.cfg)
    step = 2 * (65_536 * 459_008 + 130_560 * (983_296 + 1_966_592)
                + 65_024 * 3 * work.radiance_macs(sp))
    assert work.unit_flops(neus.cfg, neus.traffic) == step
    frame = 2 * (120_000 * 128 * 459_008 + 120_000 * 255 * 983_296
                 + 120_000 * 127 * work.radiance_macs(sp))
    assert work.unit_flops(render.cfg, render.traffic) == frame
    vs = spec(volsdf.cfg)
    assert work.unit_flops(volsdf.cfg, volsdf.traffic) == 2 * (
        1024 * 3584 * 459_008 + 197_632 * (983_296 + 1_966_592)
        + 1024 * 192 * 3 * work.radiance_macs(vs))


def test_idle_and_ms_per_unit():
    c = Bench().cell("volsdf.train")
    tr = _trace({"void ntt::vfs::init_kernel<256, 8>(float*)": 0.002,
                 "void ntt::sdf_forward_kernel<>(float*)": 0.008,
                 "void at::native::elementwise_kernel<>(float*)": 0.010}, 0.025, 2)
    ctx = Context(c.cfg, c.traffic, tr)
    assert c.readers["fine_sample_ms_per_step"].read(ctx) == pytest.approx(5.0)
    assert c.readers["train_idle_pct"].read(ctx) == pytest.approx(20.0)

"""The port's spans (`neurecon_tpu_torch/utils/trace.py`) on the CPU.

With no profiler running `span` is one shared null context and the switch is
torch's own flag. Under `torch.profiler.profile` one training step of each
framework (the small cases of `tests/test_torch_parallel.py`) and one
`render_full_image` call record the documented `ntt.*` names, nested as
README's profiler paragraph lists them.
"""
import copy
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neurecon_tpu_torch.utils import trace
from tests.test_torch_parallel import _case_batch, _case_cfg

PACKAGE = Path(__file__).resolve().parents[1] / "neurecon_tpu_torch"
FRAMEWORK = {"neus_mask": "neus", "volsdf_mask": "volsdf", "unisurf": "unisurf"}
# every span name the port opens, without its "ntt." prefix
SPANS = {"step", "step.draw", "step.backward", "step.update", "render", "render.chunk",
         "render.copy", "op.nablas_forward", "op.upsample", "op.nablas_vjp", "op.sdf_forward",
         "op.fine_sample", "op.pack", "cast.march", "cast.secant"} | {
             f"{fw}.{part}" for fw in FRAMEWORK.values() for part in ("sample", "render", "loss")}


def _spans(prof):
    """[(name, nearest enclosing ntt.* name or None, start)] of the ntt.*
    events of a profile, in time order."""
    out = []
    for e in prof.events():
        if not e.name.startswith("ntt."):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("ntt."):
            parent = parent.cpu_parent
        out.append((e.name[4:], parent.name[4:] if parent is not None else None,
                    e.time_range.start))
    return sorted(out, key=lambda s: s[2])


def _case(case):
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks import get_model

    cfg = _case_cfg(case)
    args = ConfigDict(copy.deepcopy(cfg))
    model, kw_train, kw_test, factory = get_model(args, "cpu", seed=0)
    batch, H, W = _case_batch(case, cfg)
    kw_train["H"], kw_train["W"] = H, W
    return args, model, kw_train, kw_test, factory, batch


def test_span_without_profiler_is_the_shared_null_context():
    assert trace.profiling() is torch.autograd.profiler._is_profiler_enabled is False
    assert trace.span("step", 3) is trace.span("op.pack") is trace._OFF
    with trace.span("step.draw"):
        pass


def test_span_under_profiler_is_a_record_function_with_the_step_index():
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.profiling() is True
        step, draw = trace.span("step", 7), trace.span("step.draw")
        assert isinstance(step, torch.profiler.record_function)
        assert (step.name, step.args) == ("ntt.step", "7")
        assert (draw.name, draw.args) == ("ntt.step.draw", None)
    assert trace.profiling() is False


@pytest.mark.parametrize("case", list(FRAMEWORK))
def test_training_step_spans_nest(case):
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_pipeline_fns
    from neurecon_tpu_torch.training import make_pipelined_train_step

    args, model, kw_train, _, _, batch = _case(case)
    optimizer, scheduler = make_optimizer(args, model)
    step = make_pipelined_train_step(get_pipeline_fns(args, model, kw_train), model,
                                     optimizer, scheduler)
    gen = torch.Generator().manual_seed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch, gen, 7)
    fw = FRAMEWORK[case]
    spans = _spans(prof)
    assert {n for n, _, _ in spans} <= SPANS
    parents = {}
    for name, parent, _ in spans:
        parents.setdefault(name, set()).add(parent)
    top = [(n, p) for n, p, _ in spans if p == "step"]
    assert [n for n, _ in top] == ["step.draw", f"{fw}.sample", f"{fw}.loss", "step.backward",
                                   "step.update"]
    assert parents["step"] == {None}
    assert parents[f"{fw}.render"] == {f"{fw}.loss"}
    assert parents["op.nablas_forward"] == {f"{fw}.render"}
    assert parents["op.nablas_vjp"] == {"step.backward"}
    if fw == "neus":
        assert parents["op.upsample"] == {"neus.sample"}
    if fw == "volsdf":
        assert parents["op.fine_sample"] == {"volsdf.sample"}
    if fw == "unisurf":
        assert parents["op.sdf_forward"] == {"cast.march", "cast.secant"}
        assert parents["cast.march"] == parents["cast.secant"] == {"unisurf.sample"}


@pytest.mark.parametrize("case", ["neus_mask", "volsdf_mask"])
def test_render_full_image_spans_each_chunk(case):
    from neurecon_tpu_torch.training import render_full_image

    _, _, _, kw_test, factory, _ = _case(case)
    render_fn = factory(detailed_output=False, calc_normal=True,
                        **{k: v for k, v in kw_test.items() if k not in ("H", "W", "rayschunk")})
    gen = torch.Generator().manual_seed(0)
    rays_o = torch.randn(40, 3) * 0.1 + torch.tensor([0.0, 0.0, -2.5])
    rays_d = torch.nn.functional.normalize(-rays_o + torch.randn(40, 3) * 0.1, dim=-1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = render_full_image(render_fn, rays_o, rays_d, rayschunk=16, generator=gen)
    assert out["rgb"].shape == (40, 3)
    fw = FRAMEWORK[case]
    spans = [(n, p) for n, p, _ in _spans(prof)]
    assert [s for s in spans if s[1] in (None, "render")] == (
        [("render", None)] + [("render.chunk", "render"), ("render.copy", "render")] * 3)
    assert spans.count((f"{fw}.sample", "render.chunk")) == 3
    assert spans.count((f"{fw}.render", "render.chunk")) == 3
    assert spans.count(("op.nablas_forward", f"{fw}.render")) == 3


def test_every_span_is_a_documented_name_through_the_helper():
    """The package opens spans only through `utils/trace.py::span`, under the
    names README's profiler paragraph lists; no bare record_function."""
    named = set()
    for path in PACKAGE.rglob("*.py"):
        src = path.read_text()
        if path.name != "trace.py":
            assert "record_function" not in src, path
        named |= set(re.findall(r'\bspan\("([a-z_.]+)"', src))
    assert named == SPANS
    readme = (PACKAGE.parent / "README.md").read_text()
    assert all(f"`ntt.{n}`" in readme for n in SPANS)

"""The port's UNISURF path against the benchmark's plain reference
(`benchmark/reference/unisurf.py`) on the CPU, with no JAX: the root find
(the march alone and with its secant steps: depths, `mask`,
`mask_sign_change`), the render at the program's root (rgb, depth, and the
novel-view render's normals), the loss and its smoothness term at the first
step's Δ and at one past the δ_min clamp, one step's gradients, and the
spans that the root find opens under a profiler.

Both sides run the same perturbed weights (`perturb_parameters`: the
geometric init zeroes the octave columns, so a comparison on it could not
see the encoding) on a small surface (W=64) and 24 rays from a ring of
cameras: rays that hit the surface, rays that miss it, and rays that start
inside it. Tolerances: both sides compute in float32 through two codings of
the same MLP (the port's plain kernel versions, the reference's weight-norm
layers and autograd), so logits agree to a few ulps; a root's depth is a
secant quotient of such logits, 1e-5 absolute on depths of 1-7; what the
render builds on the same root (rgb, depth, normals, losses) 1e-5 relative
or absolute; the gradients run through the double backward of the
smoothness term and the radiance net's normals, 1e-4 of each leaf's norm.
"""
from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import unisurf as ref
from benchmark.reference.nets import Nets, spec
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model, get_pipeline_fns
from neurecon_tpu_torch.models.frameworks import unisurf as port
from neurecon_tpu_torch.models.ray_casting import root_finding_surface_points

ROOT = Path(__file__).resolve().parents[1]
N_RAYS = 24
DEPTH_ATOL = 1e-5
RENDER_TOL = 1e-5
GRAD_RTOL = 1e-4


def _cfg() -> dict:
    """The benchmark's UNISURF configuration (neurecon's configs/unisurf.yaml)
    with a small surface and radiance net, a 32-step march and 8 + 8
    samples a ray."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / "unisurf.json").read_text())
    m = cfg["model"]
    m.update(W_geometry_feature=64, N_steps=32, N_query=8, N_freespace=8)
    m["surface"].update(D=4, W=64, skips=[2], embed_multires=4)
    m["radiance"].update(D=2, W=64)
    cfg["data"]["N_rays"] = N_RAYS
    return cfg


def _canonical(name: str) -> str:
    """The reference's name of a port parameter: implicit_surface.layers.<l>.v
    -> surface.<l>.v, radiance_net.layers.<l>.g -> radiance.<l>.g."""
    net, _, rest = name.partition(".layers.")
    return {"implicit_surface": "surface", "radiance_net": "radiance"}[net] + "." + rest


@pytest.fixture(scope="module")
def case():
    """(cfg, the port's model and training kwargs, the reference's nets and
    parameters, rays_o, rays_d, target rgb, the step's draws)."""
    torch.manual_seed(0)
    cfg = _cfg()
    model, kw_train, _, _ = get_model(ConfigDict(copy.deepcopy(cfg)), "cpu")
    perturb_parameters(model, torch.Generator().manual_seed(5))
    params = {_canonical(n): p.detach().clone().requires_grad_(True)
              for n, p in model.named_parameters()}
    nets = Nets(spec(cfg), params)
    gen = torch.Generator().manual_seed(7)
    theta = torch.rand(N_RAYS, generator=gen) * 6.283
    origin = torch.stack([3.0 * torch.cos(theta), 0.3 * torch.randn(N_RAYS, generator=gen),
                          3.0 * torch.sin(theta)], -1)
    origin[-3:] *= 0.05  # three rays start inside the surface
    look = 0.6 * torch.randn(N_RAYS, 3, generator=gen)  # some hit, some miss
    rays_d = (look - origin) * (0.8 + 0.4 * torch.rand(N_RAYS, 1, generator=gen))
    target = torch.rand(N_RAYS, 3, generator=gen)
    draws = ref.draws(cfg, N_RAYS, gen, torch.device("cpu"))
    return cfg, model, kw_train, nets, params, origin, rays_d, target, draws


def _sample_kwargs(kw_train: dict) -> dict:
    return {k: v for k, v in kw_train.items() if k not in ("H", "W", "rayschunk")}


def _ref_root(case):
    cfg, _, _, nets, _, o, d, _, _ = case
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    near, far = (x[:, 0] for x in ref.near_far(o, d, float(cfg["model"]["obj_bounding_radius"])))
    return ref.root_find(nets, o, d, near, far, int(cfg["model"]["N_steps"]),
                         ref.logit_tau(cfg["model"]["tau"]))


def _compare_roots(got, want):
    (d_p, pt_p, mask_p, sc_p), (d_r, pt_r, mask_r, sc_r) = got, want
    assert torch.equal(mask_p, mask_r) and torch.equal(sc_p, sc_r)
    assert torch.allclose(d_p, d_r, rtol=0, atol=DEPTH_ATOL)
    assert torch.allclose(pt_p, pt_r, rtol=0, atol=DEPTH_ATOL)


def test_the_rays_hit_miss_and_start_inside(case):
    depth, _, mask, sign_change = _ref_root(case)
    assert 4 <= int(mask.sum()) <= N_RAYS - 7  # hits
    assert int((~sign_change).sum()) >= 2  # misses keep far
    assert torch.equal(depth[-3:], torch.zeros(3))  # the first march depth is inside


def test_march_alone_matches(case, monkeypatch):
    """With no secant step, the root is the secant point of the march's
    bracket: the march's crossing, its first of equal minima and its masks."""
    cfg, model, kw_train, _, _, o, d, _, _ = case
    monkeypatch.setattr(ref, "N_SECANT", 0)
    rays_o, rays_d, near, far = port._prepare_rays(o, d, cfg["model"]["obj_bounding_radius"])
    got = root_finding_surface_points(model.forward_surface_fast, rays_o, rays_d, near=near,
                                      far=far, N_steps=cfg["model"]["N_steps"], logit_tau=0.0,
                                      N_secant_steps=0, fill_inf=False)
    _compare_roots(got, _ref_root(case))


def test_root_find_matches(case):
    cfg, model, kw_train, _, _, o, d, _, _ = case
    got = port.compute_ray_samples(model, o, d, **_sample_kwargs(kw_train))
    want = _ref_root(case)
    _compare_roots(got, want)
    # the secant moved the hits' depths off the march's bracket
    assert float((got[0] - want[0]).abs().max()) < 1e-3 * float(want[0][want[2]].min())


def test_render_at_the_programs_root(case):
    cfg, model, kw_train, nets, _, o, d, _, draws = case
    root = port.compute_ray_samples(model, o, d, **_sample_kwargs(kw_train))
    delta = ref.interval(cfg["training"], 0)
    render = port.make_volume_render_fn(model, detailed_output=True, calc_normal=True,
                                        **_sample_kwargs(kw_train))
    with torch.no_grad():
        rgb, depth, extras = render(o, d, interval=delta, surface_override=root,
                                    uniforms=(draws["u_interval"], draws["u_free"], None))
        want = ref.render(nets, cfg, o, d, delta, {k: draws[k] for k in ("u_interval", "u_free")},
                          False, follow=root)
    for got, w in ((rgb, want["rgb"]), (depth, want["depth"]),
                   (extras["normals_volume"], want["normals"])):
        assert torch.allclose(got, w, rtol=RENDER_TOL, atol=RENDER_TOL)


def test_novel_view_render_matches(case):
    """`render_eval`: evenly spaced samples at the default Δ of 1.0, the
    render's own root find, against the port's render function with its
    test kwargs."""
    cfg, model, _, nets, params, o, d, _, _ = case
    kw_test = get_model(ConfigDict(copy.deepcopy(cfg)), "cpu")[2]
    render = port.make_volume_render_fn(model, detailed_output=False, calc_normal=True,
                                        **_sample_kwargs(kw_test))
    with torch.no_grad():
        rgb, depth, extras = render(o, d)
        want = ref.render_eval(nets, params, cfg, o, d)
    assert torch.allclose(rgb, want["rgb"], rtol=RENDER_TOL, atol=RENDER_TOL)
    assert torch.allclose(depth, want["depth"], rtol=RENDER_TOL, atol=RENDER_TOL)
    assert torch.allclose(extras["normals_volume"], want["normals"], rtol=RENDER_TOL,
                          atol=RENDER_TOL)


def _losses(case, it: int):
    """(the port's losses, the reference's total and smoothness term, both
    sides' parameters) at step `it` on the program's root."""
    cfg, model, kw_train, nets, params, o, d, target, draws = case
    root = port.compute_ray_samples(model, o, d, **_sample_kwargs(kw_train))
    fns = get_pipeline_fns(ConfigDict(copy.deepcopy(cfg)), model, dict(kw_train, H=1, W=1))
    rb = {"rays_o": o, "rays_d": d, "target_rgb": target}
    _, (losses, extras) = fns["loss_with_samples"](rb, root, dict(draws), None, it)
    out = ref.render(nets, cfg, o, d, ref.interval(cfg["training"], it), draws, True,
                     follow=root)
    reg = out["reg_normals"]
    smooth = float(cfg["training"]["w_reg"]) * torch.mean((reg[:, 1] - reg[:, 0]) ** 2)
    return losses, extras, ref.loss(out, target, cfg["training"]), smooth


@pytest.mark.parametrize("it", [0, 250_000])
def test_loss_and_smoothness_term(case, it):
    cfg = case[0]
    delta = ref.interval(cfg["training"], it)
    assert delta == port._interval_f32(it, 1.0, 0.05, 1.5e-5)
    assert delta == (1.0 if it == 0 else pytest.approx(0.05))  # past the δ_min clamp
    losses, extras, total, smooth = _losses(case, it)
    total, smooth = total.detach(), smooth.detach()
    assert float(extras["scalars"]["interval"]) == delta
    assert float(losses["loss_reg"].detach()) == pytest.approx(float(smooth), rel=RENDER_TOL)
    assert float(losses["total"].detach()) == pytest.approx(float(total), rel=RENDER_TOL)
    # the neighbours' normals differ by up to a few 1e-2: a term ~1e-6 of the
    # total, present on both sides and equal to the tolerance
    assert float(smooth) > 0.0


def test_one_steps_gradients(case):
    _, model, _, _, params, *_ = case
    model.zero_grad()
    losses, _, total, _ = _losses(case, 3)
    losses["total"].backward()
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(total, [params[k] for k in names])))
    for n, p in model.named_parameters():
        g, want = p.grad, grads[_canonical(n)]
        assert float(torch.linalg.norm(g - want)) <= GRAD_RTOL * float(
            torch.linalg.norm(want)) + 1e-9, n


def test_profiler_records_the_root_find_spans_inside_the_sampler(case):
    cfg, model, kw_train, _, _, o, d, _, _ = case
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        port.compute_ray_samples(model, o, d, **_sample_kwargs(kw_train))
    parents = {}
    for e in prof.events():
        if e.name.startswith("ntt.cast."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("ntt."):
                p = p.cpu_parent
            parents.setdefault(e.name, []).append(p.name if p is not None else None)
    assert parents == {"ntt.cast.march": ["ntt.unisurf.sample"],
                       "ntt.cast.secant": ["ntt.unisurf.sample"]}

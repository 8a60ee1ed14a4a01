"""The NeRF-like surface head (`W_geometry_feature: -1`: a final layer of one
row, the last hidden activation as the geometry features) and `ScalarField`
against the JAX package, on the CPU: the surface's forward, nablas and
geometry features with and without weight norm, the bridge both ways, each
framework's ray loss and gradient tree (NeuS, VolSDF and UNISURF at W=64 on
JAX's samples), 5 Adam steps of each, and `ScalarField` with skips."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.models.base import ImplicitSurface as JaxImplicitSurface
from neurecon_tpu.models.base import ScalarField as JaxScalarField
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.frameworks import get_model as jax_get_model
from neurecon_tpu.models.frameworks.neus import compute_ray_samples as jax_neus_samples
from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_neus_loss
from neurecon_tpu.models.frameworks.unisurf import compute_ray_samples as jax_unisurf_samples
from neurecon_tpu.models.frameworks.unisurf import make_ray_loss_fn as jax_unisurf_loss
from neurecon_tpu.models.frameworks.volsdf import compute_ray_samples as jax_volsdf_samples
from neurecon_tpu.models.frameworks.volsdf import make_ray_loss_fn as jax_volsdf_loss
from neurecon_tpu.training import TrainState
from neurecon_tpu.training import make_train_step as jax_make_train_step

import chip_smoke
from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import (ImplicitSurface, ScalarField, make_optimizer,
                                            perturb_parameters)
from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
from neurecon_tpu_torch.training import make_train_step

SURFACE = {"D": 3, "W": 64, "skips": [1], "radius_init": 0.5, "embed_multires": 4}
RADIANCE = {"D": 2, "W": 64, "skips": [], "embed_multires": -1, "embed_multires_view": 2}


def _t(x):
    return torch.tensor(np.asarray(x))


def _surface_pair(weight_norm, seed=0):
    """The JAX head's init loaded into the port's head, then seeded noise on
    every weight (so that the octave columns and all rows take part), and
    the noisy weights back into a JAX pytree."""
    kw = dict(W=64, D=4, skips=(2,), W_geo_feat=-1, radius_init=0.5, embed_multires=4,
              weight_norm=weight_norm)
    js = JaxImplicitSurface(**kw)
    params = jax.tree_util.tree_map(np.asarray, js.init(jax.random.PRNGKey(seed)))
    ts = ImplicitSurface(**kw)
    bridge.load_surface_tree(ts, params)
    perturb_parameters(ts, torch.Generator().manual_seed(seed + 1))
    return js, jax.tree_util.tree_map(jnp.asarray, bridge.net_to_tree(ts)), ts


@pytest.mark.parametrize("weight_norm", [True, False])
def test_surface_forward_nablas_and_bridge(weight_norm):
    """sdf and h (the last hidden activation, [M, W]) within 1e-5, nablas
    within rtol 2e-3 / atol 2e-4 (tests/test_torch_base.py's bounds), on 300
    points, through forward, forward_with_nablas (autograd, graph and no
    graph) and forward_query; the bridge keeps a final layer of one row and
    round-trips the tree."""
    js, params, ts = _surface_pair(weight_norm)
    last = params["layers"][-1]
    assert ts.dims[-1] == (64, 1) and ts.nablas_by_autograd
    assert np.asarray(last["v" if weight_norm else "w"]).shape == (1, 64)
    x = np.random.RandomState(1).randn(300, 3).astype(np.float32) * 0.6
    sdf_j, h_j = js.forward(params, jnp.asarray(x), return_h=True)
    sdf_j2, nab_j, h_j2 = js.forward_with_nablas(params, jnp.asarray(x))
    sdf_t, h_t = ts.forward(_t(x), return_h=True)
    assert h_t.shape == (300, 64)
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    for grad_on in (True, False):
        with torch.set_grad_enabled(grad_on):
            s, n, h = ts.forward_with_nablas(_t(x))
        assert s.requires_grad == n.requires_grad == grad_on
        np.testing.assert_allclose(s.detach().numpy(), np.asarray(sdf_j2), atol=1e-5, rtol=0)
        np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_j2), atol=1e-5, rtol=0)
        np.testing.assert_allclose(n.detach().numpy(), np.asarray(nab_j), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ts.forward_query(_t(x)).numpy(), np.asarray(sdf_j), atol=1e-5,
                               rtol=0)
    back = ImplicitSurface(**{k: getattr(ts, k) for k in ("W", "D", "skips", "W_geo_feat",
                                                           "weight_norm")},
                           radius_init=0.5, embed_multires=4)
    bridge.load_surface_tree(back, jax.tree_util.tree_map(np.asarray, params))
    for a, b in zip(jax.tree_util.tree_leaves(bridge.net_to_tree(back)),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _cfg(framework, lr=1e-4):
    """A W=64 model of `framework` with the NeRF-like head on a 24x32
    synthetic scene (NeuS with its mask, VolSDF with the builtin background,
    UNISURF as configs/unisurf.yaml with a 32-step march)."""
    if framework == "UNISURF":
        cfg = copy.deepcopy(chip_smoke.UNISURF)
        cfg["data"].update({"N_rays": 12, "val_rayschunk": 128})
        cfg["model"].update({"N_steps": 32, "N_query": 8, "N_freespace": 8})
        cfg["model"]["surface"].update({"D": 3, "W": 64, "skips": [1], "embed_multires": 4})
        cfg["model"]["radiance"].update({"D": 2, "W": 64})
    else:
        model = {"NeuS": {"N_samples": 16, "N_importance": 16, "N_upsample_iters": 2,
                          "obj_bounding_radius": 1.0},
                 "VolSDF": {"N_samples": 8, "N_importance": 8, "fine_sample_mul": 2,
                            "max_upsample_iter": 2, "obj_bounding_radius": 3.0,
                            "outside_scene": "builtin"}}[framework]
        surface = dict(SURFACE, radius_init=1.0 if framework == "VolSDF" else 0.5)
        cfg = {"expname": "torch_nerf_head",
               "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24, "W": 32,
                        "N_rays": 12, "val_rayschunk": 256, "near": 0.0, "far": 6.0},
               "model": dict(model, framework=framework, perturb=False, surface=surface,
                             radiance=dict(RADIANCE)),
               "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                            "speed_factor": 10.0, "num_iters": 20,
                            "scheduler": {"type": "exponential_step", "min_factor": 0.1}}}
    cfg["model"]["W_geometry_feature"] = -1
    cfg["training"]["lr"] = lr
    return cfg


def _setup(framework, lr=1e-4):
    """Both packages' models with the same weights (the port's init with
    seeded noise, the learnable scale sharpened), 12 rays from
    (0.1, -0.1, -2.5) towards the origin with targets, and each framework's
    seams: JAX's samples for them and the draws both sides take."""
    cfg = _cfg(framework, lr)
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    jm, _, jkw, _, _ = jax_get_model(jargs)
    targs = ConfigDict(copy.deepcopy(cfg))
    tm, tkw, _, _ = get_model(targs, "cpu")
    assert tm.implicit_surface.dims[-1] == (64, 1)
    assert tm.radiance_net.dims[0][0] == jm.radiance_net.dims[0][0]
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    with torch.no_grad():
        if framework == "NeuS":
            tm.ln_s.fill_(0.3)
        elif framework == "VolSDF":
            tm.ln_beta.fill_(float(np.log(0.05) / 10))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    rng = np.random.RandomState(3)
    n = 12
    th = rng.uniform(-0.25, 0.25, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -2.5], np.float32), d.shape))
    rb = {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
          "target_rgb": jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32))}
    key = jax.random.PRNGKey(4)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    if framework == "NeuS":
        rb["target_mask"] = jnp.asarray(rng.uniform(0, 1, n) > 0.3)
        d_all = jax.jit(lambda p: jax_neus_samples(jm, p, rb["rays_o"], rb["rays_d"], key,
                                                   **kw))(params)
        j_loss = jax_neus_loss(jm, jargs, jkw)
        j_kw = {"d_all": d_all}
        t_kw = {"d_all": _t(d_all)}
    elif framework == "VolSDF":
        k_render, k_eik = jax.random.split(key)
        fine = jax.jit(lambda p: jax_volsdf_samples(jm, p, rb["rays_o"], rb["rays_d"],
                                                    k_render, **kw))(params)
        eik = jax.random.uniform(k_eik, (n, 1, 3), jnp.float32, -3.0, 3.0)
        j_loss = jax_volsdf_loss(jm, jargs, jkw)
        j_kw = {"fine_override": fine}
        t_kw = {"fine_override": tuple(_t(f) for f in fine), "eik_pts": _t(eik)}
    else:
        surf = jax_unisurf_samples(jm, params, rb["rays_o"], rb["rays_d"], None, **kw)
        j_loss = jax_unisurf_loss(jm, jargs, jkw)
        k_render, _ = jax.random.split(key)
        k_int, k_free = jax.random.split(k_render)
        u = (_t(jax.random.uniform(k_int, (n, cfg["model"]["N_query"]))),
             _t(jax.random.uniform(k_free, (n, cfg["model"]["N_freespace"]))),
             _t(jax.random.uniform(jax.random.fold_in(k_render, 7), (n, 3))))
        j_kw = {"surface_override": surf}
        t_kw = {"surface_override": tuple(_t(s) for s in surf), "uniforms": u}
    return jargs, params, targs, tm, tkw, rb, key, j_loss, j_kw, t_kw


FRAMEWORKS = ["NeuS", "VolSDF", "UNISURF"]


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_ray_loss_and_grads_match_jax(framework):
    """On JAX's samples (NeuS d_all, VolSDF fine samples and eikonal points,
    UNISURF's root find and draws): loss terms to rel 1e-5, every gradient
    leaf within 5e-4 of its max|ref| (the JAX package's full-step bound),
    the head's one-row final layer and the eikonal term's double backward
    included."""
    jargs, params, targs, tm, tkw, rb, key, j_loss, j_kw, t_kw = _setup(framework)
    it = 1000 if framework == "UNISURF" else 0
    (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, it, **j_kw), has_aux=True))(params)
    total, (got, _) = get_ray_loss_fn(targs, tm, tkw)(
        {k: _t(v) for k, v in rb.items()}, it=it, **t_kw)
    total.backward()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    g_t = bridge.grads_to_tree(tm)
    assert np.abs(g_t["implicit_surface"]["layers"][-1]["g"]).max() > 0
    assert jax.tree_util.tree_structure(g_t) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, g_j))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


# the parameters after 5 Adam steps, against how far the JAX run moved each
# leaf (max|p_5 - p_0|): at most 1% of all the model's elements beyond 1e-3
# of their leaf's move (earlier slices' bound, pooled over the leaves: a
# bias leaf of the head has 1 or 64 elements), none beyond 0.1. Adam's step
# g / (|g| + 1e-8) turns the rounding of a gradient element near 1e-8 into
# a visible share of a step (measured: NeuS and UNISURF none beyond 1e-3 of
# ~19k elements; VolSDF two, ln_beta at 5.6e-3 and a bias of the head's last
# hidden layer, whose units Softplus(100) has all but switched off, with
# step-0 gradients of ~4e-9)
MOVED, SHARE, WORST = 1e-3, 0.01, 0.1


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_adam_trajectory_matches_jax(framework):
    """5 Adam steps on one fixed batch and fixed samples under the
    exponential_step schedule (UNISURF: configs/unisurf.yaml's multistep):
    the total loss at every step to rel 1e-4, and the parameters within the
    bounds above."""
    jargs, params, targs, tm, tkw, rb, key, j_loss, j_kw, t_kw = _setup(framework, lr=1e-3)
    it = 1000 if framework == "UNISURF" else None
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(
        lambda p, b, k, i: j_loss(p, b, k, it if it is not None else i, **j_kw), opt,
        jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    optimizer, scheduler = make_optimizer(targs, tm)
    rb_t = {k: _t(v) for k, v in rb.items()}
    t_step = make_train_step(lambda b, g, i: t_loss(b, it=it if it is not None else i, **t_kw),
                             tm, optimizer, scheduler)
    for i in range(5):
        state, m_j = j_step(state, rb, key)
        m_t = t_step(rb_t, None, i)
        want = float(m_j["losses"]["total"])
        assert abs(m_t["losses"]["total"].item() - want) <= 1e-4 * abs(want), i
    ratios = []
    for (path, p0), p5, pt in zip(jax.tree_util.tree_leaves_with_path(params),
                                  jax.tree_util.tree_leaves(state.params),
                                  jax.tree_util.tree_leaves(bridge.model_to_tree(tm))):
        moved = np.abs(np.asarray(p5) - np.asarray(p0)).max()
        r = np.abs(pt - np.asarray(p5)).reshape(-1) / moved
        assert r.max() <= WORST, (jax.tree_util.keystr(path), r.max())
        ratios.append(r)
    ratios = np.concatenate(ratios)
    assert (ratios > MOVED).mean() <= SHARE, ((ratios > MOVED).sum(), ratios.size)


@pytest.mark.parametrize("skips", [(), (1,), (0, 2)])
def test_scalar_field_matches_jax(skips):
    """ScalarField (input 3, W=32, D=4): the port's init is the constant
    init_val everywhere, its hidden weights within the kaiming-uniform bound
    and its tree shaped as the JAX init's; the JAX init loaded through the
    bridge, then seeded noise on every weight (the output layer's too), gives
    the JAX forward within 1e-5 on 200 points of [..., 3]."""
    jf = JaxScalarField(input_ch=3, W=32, D=4, skips=skips, init_val=-2.0)
    p_j = jax.tree_util.tree_map(np.asarray, jf.init(jax.random.PRNGKey(0)))
    tf = ScalarField(input_ch=3, W=32, D=4, skips=skips, init_val=-2.0)
    tf.reset_parameters(torch.Generator().manual_seed(0))
    x = np.random.RandomState(2).randn(10, 20, 3).astype(np.float32)
    np.testing.assert_array_equal(tf(_t(x)).detach().numpy(), -2.0)
    tree = bridge.net_to_tree(tf)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(p_j)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(p_j)):
        assert a.shape == b.shape
    for layer in tf.pts_linears:
        assert np.abs(layer.w.detach().numpy()).max() <= np.sqrt(6.0 / layer.in_dim)
    bridge.load_net_tree(tf, p_j, "scalar_field")
    perturb_parameters(tf.pts_linears, torch.Generator().manual_seed(3))
    with torch.no_grad():
        tf.output_linear.w.add_(0.1 * torch.randn(1, 32, generator=torch.Generator()
                                                  .manual_seed(4)))
    p_t = jax.tree_util.tree_map(jnp.asarray, bridge.net_to_tree(tf))
    want = np.asarray(jf.forward(p_t, jnp.asarray(x)))
    got = tf(_t(x)).detach().numpy()
    assert got.shape == (10, 20) and np.abs(want + 2.0).max() > 1e-2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

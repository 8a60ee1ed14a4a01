"""The port's NeRF++ background against the JAX package, on the CPU: the
`NeRF` net, the ray-sphere geometry (`get_sphere_intersection`,
`get_dvals_from_radius`, rays that miss included), NeuS without a mask and
VolSDF with `outside_scene: nerf++` (render outputs, the background's
`sigma_out` / `radiance_out`, the loss and every gradient leaf, on JAX's own
jitter uniforms through the `u_out` seam), VolSDF on rays whose far is short
or zero, the ray through the exact origin, a params-only resume of a JAX
nerf++ checkpoint through `train.py`, a `render_view` frame whose rays miss
the sphere, `train.py` on `configs/synthetic_quality_nomask.yaml` at small
widths with a resume, and the port's model for every config of the repo."""
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models.base import NeRF as JaxNeRF
from neurecon_tpu.models.frameworks import get_model as jax_get_model
from neurecon_tpu.models.frameworks.neus import compute_ray_samples as jax_neus_samples
from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_neus_loss
from neurecon_tpu.models.frameworks.neus import volume_render_rays as jax_neus_render
from neurecon_tpu.models.frameworks.volsdf import compute_ray_samples as jax_volsdf_samples
from neurecon_tpu.models.frameworks.volsdf import make_ray_loss_fn as jax_volsdf_loss
from neurecon_tpu.models.frameworks.volsdf import volume_render_rays as jax_volsdf_render
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.ops.ray import get_dvals_from_radius as jax_dvals
from neurecon_tpu.ops.ray import get_sphere_intersection as jax_intersect
from neurecon_tpu.tools.camera_paths import generate_camera_path as jax_camera_path
from neurecon_tpu.training import render_full_image as jax_render_full_image
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli
from neurecon_tpu_torch.models.base import NeRF, perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
from neurecon_tpu_torch.models.frameworks import neus, volsdf
from neurecon_tpu_torch.ops import get_dvals_from_radius, get_sphere_intersection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_OUT = 8


def _t(x):
    return torch.tensor(np.asarray(x))


def _small_nets():
    return ({"D": 3, "W": 64, "skips": [1], "radius_init": 0.5, "embed_multires": 4},
            {"D": 2, "W": 64, "skips": [], "embed_multires": -1, "embed_multires_view": 2})


def _neus_cfg():
    """NeuS without a mask at W=64, N_outside 8, on a 24x32 envmap scene."""
    surface, radiance = _small_nets()
    return {
        "expname": "torch_nomask",
        "data": {"type": "synthetic", "background": "envmap", "downscale": 1, "n_images": 4,
                 "H": 24, "W": 32, "N_rays": 12, "val_rayschunk": 256},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0, "N_outside": N_OUT,
                  "W_geometry_feature": 64, "N_samples": 16, "N_importance": 16,
                  "N_upsample_iters": 2, "perturb": True,
                  "surface": surface, "radiance": radiance},
        "training": {"with_mask": False, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": 5e-4, "num_iters": 20,
                     "scheduler": {"type": "warmupcosine", "warmup_steps": 5}},
    }


def _volsdf_cfg(radius=3.0):
    """VolSDF with the NeRF++ background at W=64, N_outside 8, on a 24x32
    envmap scene whose cameras sit inside the sphere (scale_radius 3.0)."""
    surface, radiance = _small_nets()
    surface["radius_init"] = 1.0
    return {
        "expname": "torch_volsdf_nerfpp",
        "data": {"type": "synthetic", "background": "envmap", "downscale": 1, "n_images": 4,
                 "H": 24, "W": 32, "scale_radius": 3.0, "near": 0.0, "far": 6.0,
                 "N_rays": 12, "val_rayschunk": 256},
        "model": {"framework": "VolSDF", "obj_bounding_radius": radius,
                  "outside_scene": "nerf++", "N_outside": N_OUT, "W_geometry_feature": 64,
                  "N_samples": 8, "N_importance": 8, "fine_sample_mul": 2,
                  "max_upsample_iter": 2, "perturb": True,
                  "surface": surface, "radiance": radiance},
        "training": {"w_eikonal": 0.1, "speed_factor": 10.0, "lr": 5e-4, "num_iters": 20,
                     "scheduler": {"type": "exponential_step", "min_factor": 0.1}},
    }


def _models(cfg, sharpen, noise_seed=1):
    """Both packages' models with the same weights: the port's init with
    seeded noise on every weight (the background net's included), and the
    learnable scale set by `sharpen` (a model attribute and its value)."""
    jargs = JaxConfigDict(cfg)
    jm, _, jkw, _, _ = jax_get_model(jargs)
    targs = ConfigDict(cfg)
    tm, tkw, _, _ = get_model(targs, "cpu")
    perturb_parameters(tm, torch.Generator().manual_seed(noise_seed))
    with torch.no_grad():
        getattr(tm, sharpen[0]).fill_(sharpen[1])
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jargs, jm, jkw, params, targs, tm, tkw


def _rays(n, origin, spread=0.3, seed=3):
    """n rays from `origin` around +z, unnormalized, and random targets."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    d *= rng.uniform(0.8, 1.2, (n, 1)).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.asarray(origin, np.float32), d.shape))
    return {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
            "target_rgb": jnp.asarray(rng.uniform(0, 1, (n, 3)).astype(np.float32))}


def _jax_u_out(key, n):
    """The outside jitter JAX draws from a render key: uniform(split(key)[1])."""
    return jax.random.uniform(jax.random.split(key)[1], (n, N_OUT))


def _close(got, want, keys, atol=1e-5, rtol=1e-5):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("width,skips", [(32, (4,)), (256, (4,)), (64, (2, 5))])
def test_nerf_matches_jax(width, skips):
    """The background net (input 4, 10 octaves, 4 view octaves, D=8, skip
    after layer 4) at W=32 and the full W=256, and at W=64 with two skips:
    sigma and rgb to rtol 1e-5 on 300 points (x / r, 1 / r) with the port's
    init plus noise loaded into the JAX net."""
    kw = dict(W=width, input_ch=4, multires=10, multires_view=4, skips=skips)
    tn = NeRF(**kw)
    tn.reset_parameters(torch.Generator().manual_seed(0))
    perturb_parameters(tn, torch.Generator().manual_seed(1))
    assert tn.pts_linears[skips[0] + 1].in_dim == width + 84  # [input_pts, h] after the skip
    jn = JaxNeRF(use_view_dirs=True, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, bridge._net_to_tree(tn, bridge._value))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(
        jax.eval_shape(jn.init, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    p = rng.randn(300, 3).astype(np.float32) * 3
    r = np.linalg.norm(p, axis=-1, keepdims=True)
    x = np.concatenate([p / r, 1 / r], -1).astype(np.float32)
    v = rng.randn(300, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    want = jn.forward(params, jnp.asarray(x), jnp.asarray(v))
    with torch.no_grad():
        got = tn(_t(x), _t(v))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_sphere_geometry_matches_jax():
    """near / far / mask of rays from inside, on and outside the sphere of
    radius 3 (a third miss it: zero-filled), and the depths at radii 3-30,
    far and near roots: to 1e-6 of their scale."""
    rng = np.random.RandomState(0)
    o = (rng.randn(60, 3) * 2.5).astype(np.float32)
    o[:6] = o[:6] / np.linalg.norm(o[:6], axis=-1, keepdims=True) * 3.0
    d = rng.randn(60, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jax_intersect(jnp.asarray(o), jnp.asarray(d), r=3.0)
    got = get_sphere_intersection(_t(o), _t(d), r=3.0)
    assert 0 < int((~np.asarray(want[2])).sum()) < 60
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    rs = np.broadcast_to(3.0 / np.linspace(1, 0.1, 10, dtype=np.float32), (60, 10))
    for far_end in (True, False):
        np.testing.assert_allclose(
            get_dvals_from_radius(_t(o), _t(d), _t(rs), far_end=far_end).numpy(),
            np.asarray(jax_dvals(jnp.asarray(o), jnp.asarray(d), jnp.asarray(rs),
                                 far_end=far_end)), atol=3e-5)


@pytest.mark.parametrize("perturb", [False, True])
def test_neus_render_with_background_matches_jax(perturb):
    """NeuS without a mask on 12 rays from outside the unit sphere, some of
    them missing it, on JAX's d_all and JAX's outside jitter (u_out): rgb,
    depth, acc, sigma_out, radiance_out within 1e-5 (rtol 1e-5)."""
    cfg = _neus_cfg()
    jargs, jm, jkw, params, targs, tm, tkw = _models(cfg, ("ln_s", 0.3))
    rb = _rays(12, (0.1, -0.1, -2.5), spread=0.45)
    key = jax.random.PRNGKey(4)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    kw["perturb"] = perturb
    d_all = jax.jit(lambda p: jax_neus_samples(jm, p, rb["rays_o"], rb["rays_d"], key,
                                               **kw))(params)
    want = jax.jit(lambda p: jax_neus_render(jm, p, rb["rays_o"], rb["rays_d"], key,
                                             d_all_override=d_all, **kw))(params)
    with torch.no_grad():
        got = neus.volume_render_rays(tm, _t(rb["rays_o"]), _t(rb["rays_d"]),
                                      d_all_override=_t(d_all),
                                      u_out=_t(_jax_u_out(key, 12)), **kw)
    assert float(np.asarray(want["mask_volume"]).max()) > 0.5
    assert got["sigma_out"].shape == (12, 31 + N_OUT)
    _close(got, want, ("rgb", "depth_volume", "mask_volume", "sigma_out", "radiance_out",
                       "d_final", "alpha"))


@pytest.mark.parametrize("perturb", [False, True])
def test_volsdf_render_with_background_matches_jax(perturb):
    """VolSDF with NeRF++ on 12 rays from inside the radius-3 sphere, on
    JAX's fine samples (per-ray fars from the sphere) and JAX's jitter of
    the outside radii: rgb, depth, acc, sigma_out, radiance_out within 1e-5
    (rtol 1e-5), and the joined depths."""
    cfg = _volsdf_cfg()
    jargs, jm, jkw, params, targs, tm, tkw = _models(cfg, ("ln_beta", float(np.log(0.05) / 10)))
    rb = _rays(12, (0.1, -0.1, -2.5))
    key = jax.random.PRNGKey(4)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    kw["perturb"] = perturb
    fine = jax.jit(lambda p: jax_volsdf_samples(jm, p, rb["rays_o"], rb["rays_d"], key,
                                                **kw))(params)
    want = jax.jit(lambda p: jax_volsdf_render(jm, p, rb["rays_o"], rb["rays_d"], key,
                                               fine_override=fine, **kw))(params)
    with torch.no_grad():
        got = volsdf.volume_render_rays(tm, _t(rb["rays_o"]), _t(rb["rays_d"]),
                                        fine_override=tuple(_t(f) for f in fine),
                                        u_out=_t(_jax_u_out(key, 12)), **kw)
    assert got["sigma_out"].shape == (12, N_OUT)
    _close(got, want, ("rgb", "depth_volume", "mask_volume", "sigma_out", "radiance_out",
                       "d_vals"))


@pytest.mark.parametrize("framework", ["NeuS", "VolSDF"])
def test_ray_loss_and_grads_match_jax(framework):
    """Loss terms to rel 1e-5; every gradient leaf, the nerf_outside leaves
    included, to max|diff| <= 5e-4 max|ref| (tests/test_torch_train.py's
    bounds), on JAX's samples, eikonal points and outside jitter.

    The NeuS case takes noise seed 3. The background's density leaves get
    gradients of only 1e-7-1e-5 here (through alpha = 1 - exp(-softplus(sigma)
    dist) of a few outside samples), so one ReLU decision that the two fp32
    programs take on opposite sides moves a leaf by that point's whole share:
    at seed 1 a layer-5 pre-activation of 1.1e-6 (typical 0.15) does so by
    5e-3 of the leaf's max, at seed 2 a layer-1 one by 5e-2. Both are
    rounding at a kink, not a fault of either side (every other unit of
    those layers agrees within 1e-9)."""
    key = jax.random.PRNGKey(4)
    if framework == "NeuS":
        jargs, jm, jkw, params, targs, tm, tkw = _models(_neus_cfg(), ("ln_s", 0.3),
                                                         noise_seed=3)
        rb = _rays(12, (0.1, -0.1, -2.5), spread=0.45)
        kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
        d_all = jax.jit(lambda p: jax_neus_samples(jm, p, rb["rays_o"], rb["rays_d"], key,
                                                   **kw))(params)
        j_loss = jax_neus_loss(jm, jargs, jkw)
        (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
            lambda p: j_loss(p, rb, key, 0, d_all=d_all), has_aux=True))(params)
        extra = {"d_all": _t(d_all), "u_out": _t(_jax_u_out(key, 12))}
    else:
        jargs, jm, jkw, params, targs, tm, tkw = _models(
            _volsdf_cfg(), ("ln_beta", float(np.log(0.05) / 10)))
        rb = _rays(12, (0.1, -0.1, -2.5))
        kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
        k_render, k_eik = jax.random.split(key)
        fine = jax.jit(lambda p: jax_volsdf_samples(jm, p, rb["rays_o"], rb["rays_d"],
                                                    k_render, **kw))(params)
        eik = jax.random.uniform(k_eik, (12, 1, 3), jnp.float32, -3.0, 3.0)
        j_loss = jax_volsdf_loss(jm, jargs, jkw)
        (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
            lambda p: j_loss(p, rb, key, 0, fine_override=fine), has_aux=True))(params)
        extra = {"fine_override": tuple(_t(f) for f in fine), "eik_pts": _t(eik),
                 "u_out": _t(_jax_u_out(k_render, 12))}
    total, (got, _) = get_ray_loss_fn(targs, tm, tkw)({k: _t(v) for k, v in rb.items()},
                                                      **extra)
    total.backward()
    assert "loss_mask" not in got and set(got) == set(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    g_t = bridge.grads_to_tree(tm)
    assert np.abs(g_t["nerf_outside"]["pts_linears"][0]["w"]).max() > 0
    assert jax.tree_util.tree_structure(g_t) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, g_j))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


def test_volsdf_short_and_zero_far_rays_match_jax():
    """The three kinds of ray the sampler had not seen: one leaving the
    sphere (origin at radius 2.7 pointing out, far 0.3), one missing it
    (far 0) and one starting on it pointing out (far 0), det, through the
    whole render (the plain sampler on both sides): finite, beta_map the
    net's beta, iter_usage 0, and rgb / depth / acc / sigma_out within 1e-5."""
    cfg = _volsdf_cfg()
    jargs, jm, jkw, params, targs, tm, tkw = _models(cfg, ("ln_beta", float(np.log(0.1) / 10)))
    rb = _rays(12, (0.1, -0.1, -2.5))  # rays 3-11: full-length ones beside the probe's
    o, d = np.array(rb["rays_o"]), np.array(rb["rays_d"])
    o[:3] = [[0.0, 0.0, 2.7], [0.0, 4.0, 0.0], [3.0, 0.0, 0.0]]
    d[:3] = [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    kw["perturb"] = False
    want = jax.jit(lambda p: jax_volsdf_render(jm, p, jnp.asarray(o), jnp.asarray(d),
                                               jax.random.PRNGKey(1), **kw))(params)
    _, _, _, fars = volsdf._ray_bounds(_t(o), _t(d), 0.0, 6.0, 3.0, True)
    np.testing.assert_allclose(fars[:3, 0].numpy(), [0.3, 0.0, 0.0], atol=1e-6)
    assert (fars[3:] > 5.0).all()
    with torch.no_grad():
        got = volsdf.volume_render_rays(tm, _t(o), _t(d), **kw)
    for k in ("rgb", "depth_volume", "mask_volume", "beta_map", "sigma_out"):
        assert torch.isfinite(got[k]).all(), k
    np.testing.assert_allclose(got["beta_map"][:3].numpy(), 0.1, rtol=1e-6)
    assert got["iter_usage"][:3].tolist() == [0, 0, 0]
    _close(got, want, ("rgb", "depth_volume", "mask_volume", "beta_map", "iter_usage",
                       "sigma_out", "radiance_out"))


def test_neus_origin_ray_gradients_are_finite():
    """JAX's tests/test_neus.py origin-ray case in the port: a ray from
    (0, 0, -3) through the exact origin puts a midpoint at r = 0, whose
    0 / 0 the safe norm keeps out of the background net's gradients. Every
    gradient finite, and the loss equal to JAX's (rel 1e-5)."""
    cfg = _neus_cfg()
    cfg["model"]["perturb"] = False
    jargs, jm, jkw, params, targs, tm, tkw = _models(cfg, ("ln_s", 0.3))
    rb = _rays(12, (0.1, -0.1, -2.5), spread=0.45)  # rays 2-11 as the render test's
    o, d = np.array(rb["rays_o"]), np.array(rb["rays_d"])
    o[:2] = [[0.0, 0.0, -3.0], [0.1, 0.0, -3.0]]
    d[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    want = jax.jit(lambda p: jax_neus_render(jm, p, jnp.asarray(o), jnp.asarray(d),
                                             jax.random.PRNGKey(1), **kw))(params)
    d_mid = np.asarray(want["d_final"])[0, :31]
    assert np.min(np.abs(d_mid - 3.0)) == 0.0  # a midpoint at the origin
    got = neus.volume_render_rays(tm, _t(o), _t(d), **kw)
    loss = torch.mean(torch.abs(got["rgb"]))
    loss.backward()
    assert abs(loss.item() - float(jnp.mean(jnp.abs(want["rgb"])))) <= 1e-5 * loss.item()
    for name, p in tm.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert tm.nerf_outside.pts_linears[0].w.grad.abs().max() > 0


def _write_cfg(tmp, cfg, name):
    path = os.path.join(str(tmp), name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def test_params_only_resume_of_jax_nerfpp_checkpoint(tmp_path):
    """A JAX VolSDF nerf++ checkpoint (params + optax state, as the JAX
    trainer writes it) resumes through the port's train.py: the background
    net loads (the step starts from JAX's weights: its first loss equals the
    JAX loss of the same weights to within the draws' spread), the lr resumes
    at the step and the final checkpoint carries nerf_outside."""
    cfg = _volsdf_cfg()
    cfg["training"].update({"log_root_dir": str(tmp_path), "i_val": -1, "i_log": 1,
                            "i_save": 900, "i_backup": -1, "i_val_mesh": -1,
                            "monitoring": "none"})
    args, _ = parse_cli(argv=["--config", _write_cfg(tmp_path, cfg, "v.yaml"), "--device",
                              "cpu", "--training:num_iters", "6"],
                        extra_args_fn=train._extra_args)
    jargs = JaxConfigDict(args.to_dict())
    jm, _, _, _, _ = jax_get_model(jargs)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    ckdir = os.path.join(args.training.exp_dir, "ckpts")
    JaxCheckpointIO(ckdir).save("latest.pt", global_step=5, model=params,
                                opt_state=optax.adam(1e-3).init(params))
    loaded = {}
    real = bridge.load_tree

    def spy(model, tree, strict=True):
        real(model, tree, strict)
        loaded.update(bridge.model_to_tree(model))
    train.bridge.load_tree = spy
    try:
        out = train.main_function(args)
    finally:
        train.bridge.load_tree = real
    for a, b in zip(jax.tree_util.tree_leaves(params["nerf_outside"]),
                    jax.tree_util.tree_leaves(loaded["nerf_outside"])):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert out["it"] == 6 and not out["resumed_opt"]
    with open(out["final_ckpt"], "rb") as f:
        ck = pickle.load(f)
    assert set(ck["model"]) == {"ln_beta", "implicit_surface", "radiance_net", "nerf_outside"}
    groups = ck["torch_opt_state"]["param_groups"]
    n_params = sum(len(g["params"]) for g in groups)
    assert n_params == len(jax.tree_util.tree_leaves(params))  # the background net's too


def test_render_view_frame_with_missing_rays_matches_jax(tmp_path):
    """render_view (volume mode) on a JAX VolSDF nerf++ checkpoint whose
    sphere (radius 2) the cameras (at distance 6) see from outside, so that
    the frame's corner rays miss it (far 0): the frame's rgb within 1e-4 of
    the JAX render of the same camera, finite everywhere."""
    cfg = _volsdf_cfg(radius=2.0)
    cfg["data"]["scale_radius"] = 6.6  # cameras at 6.6 / 1.1
    jargs = JaxConfigDict(cfg)
    jm, _, _, jkw, jfactory = jax_get_model(jargs)
    tm, _, _, _ = get_model(ConfigDict(cfg), "cpu")
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    tree = bridge.model_to_tree(tm)
    ckpt = JaxCheckpointIO(str(tmp_path)).save("latest.pt", global_step=3, model=tree)
    from neurecon_tpu_torch.tools import render_view
    args = ConfigDict(cfg)
    args.update({"load_pt": ckpt, "num_views": 1, "camera_path": "interpolation",
                 "rayschunk": 400, "device": "cpu"})
    frames = render_view.render_frames(args, device="cpu")
    ds = jax_get_data(jargs)
    c2w = jax_camera_path("interpolation", np.asarray(ds.c2w_all), 1)[0]
    o, d, _ = jax_get_rays(None, jnp.asarray(c2w, jnp.float32),
                           jnp.asarray(ds.intrinsics_all[0]), ds.H, ds.W)
    _, _, hit = jax_intersect(o, d / jnp.linalg.norm(d, axis=-1, keepdims=True), r=2.0)
    assert 0 < int((~np.asarray(hit)).sum()) < hit.size  # some rays miss the sphere
    render_fn = jfactory(detailed_output=False, calc_normal=True,
                         **{k: v for k, v in jkw.items() if k != "rayschunk"})
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ret = jax_render_full_image(render_fn, params, o, d, jax.random.PRNGKey(0), rayschunk=400)
    assert np.isfinite(frames["rgb"]).all() and np.isfinite(frames["depth"]).all()
    np.testing.assert_allclose(frames["rgb"][0], ret["rgb"].reshape(24, 32, 3), atol=1e-4)


def test_train_nomask_resumes(tmp_path):
    """train.py on configs/synthetic_quality_nomask.yaml at small widths on the
    CPU: 3 steps with a validation image (no mask), then a resume to 5 with
    the optimizer state; the background net's stats are logged; eval_staged
    reads both checkpoints (finite PSNR and Chamfer against a GT sphere)."""
    argv = ["--config", os.path.join(REPO, "configs", "synthetic_quality_nomask.yaml"),
            "--device", "cpu", "--data:H", "24", "--data:W", "32", "--data:n_images", "4",
            "--data:N_rays", "16", "--data:val_downscale", "4",
            "--model:N_samples", "8", "--model:N_importance", "8",
            "--model:N_upsample_iters", "2", "--model:N_outside", "4",
            "--training:log_root_dir", str(tmp_path), "--training:i_val", "3",
            "--training:i_log", "1", "--training:monitoring", "none"]

    def args(n):
        a, _ = parse_cli(argv=argv + ["--training:num_iters", str(n)],
                         extra_args_fn=train._extra_args)
        a.model.surface.update(D=3, W=64, skips=[1])
        a.model.radiance.update(D=2, W=64)
        a.model["W_geometry_feature"] = 64
        return a
    out = train.main_function(args(3))
    assert out["it"] == 3 and not out["resumed_opt"]
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert len(totals) == 3 and np.isfinite(totals).all()
    assert "loss_mask" not in out["stats"]["losses"]
    assert "extras_sigma_out" in out["stats"]
    assert os.listdir(os.path.join(out["exp_dir"], "imgs", "val", "predicted_rgb"))
    out2 = train.main_function(args(5))
    assert out2["it"] == 5 and out2["resumed_opt"]
    with open(out2["final_ckpt"], "rb") as f:
        ck = pickle.load(f)
    assert "nerf_outside" in ck["model"]
    assert {float(s["step"]) for s in ck["torch_opt_state"]["state"].values()} == {5.0}

    from neurecon_tpu_torch.tools.eval_staged import evaluate_ckpts
    from neurecon_tpu_torch.tools.make_gt_mesh import make_gt_mesh
    gt = str(tmp_path / "gt.ply")
    make_gt_mesh("sphere", 0.5, 24, 1.5, gt, device="cpu")
    rows = evaluate_ckpts(args(5), [out["final_ckpt"], out2["final_ckpt"]], gt_mesh=gt,
                          n_eval=1, rayschunk=512, mesh_N=24, n_samples=2000, device="cpu")
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["chamfer"]) for r in rows)


CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def test_every_config_builds():
    """The port's get_model builds a model for every configs/*.yaml on the
    CPU, at the file's widths; the NeRF++ configs carry the background net
    and the others none."""
    assert len(CONFIGS) >= 26
    for path in CONFIGS:
        args, _ = parse_cli(argv=["--config", path], extra_args_fn=train._extra_args)
        model, kw_train, kw_test, _ = get_model(args, "cpu")
        nerfpp = (args.model.framework == "NeuS" and not args.training.with_mask) or (
            args.model.get("outside_scene", "builtin") == "nerf++")
        assert (getattr(model, "nerf_outside", None) is not None) == nerfpp, path
        assert kw_test["perturb"] is False, path


@pytest.mark.parametrize("name,attr", [("synthetic_quality_nomask.yaml", "NEUS_NOMASK"),
                                       ("volsdf_nerfpp.yaml", "VOLSDF_NERFPP")])
def test_chip_smoke_nerfpp_configs_are_the_files(name, attr):
    """chip_smoke.py's phases 27-29 train the configs as the files hold them
    (the card machine has no PyYAML)."""
    import chip_smoke
    with open(os.path.join(REPO, "configs", name)) as f:
        assert getattr(chip_smoke, attr) == yaml.safe_load(f)

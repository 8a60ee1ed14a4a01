"""The port's UNISURF against the JAX package's, on the CPU: the render with
perturb off and on (the JAX keys' draws through `uniforms=`) and the
regularisation points, the ray loss and its gradient tree on JAX's root-find
output, a 10-step Adam trajectory under the multistep schedule, the interval
schedule and `checkpoint_render_kwargs`; then train.py on a DTU-layout scene
on disk (train, resume, validation images, a mesh), its checkpoint through
render_view, extract_surface and eval_staged; the refusals that remain; and
chip_smoke.py's UNISURF config against configs/unisurf.yaml."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.frameworks import checkpoint_render_kwargs as jax_ckpt_kwargs
from neurecon_tpu.models.frameworks.unisurf import compute_ray_samples as jax_samples
from neurecon_tpu.models.frameworks.unisurf import get_model as jax_get_model
from neurecon_tpu.models.frameworks.unisurf import interval_at as jax_interval_at
from neurecon_tpu.models.frameworks.unisurf import make_ray_loss_fn as jax_ray_loss_fn
from neurecon_tpu.models.frameworks.unisurf import volume_render_rays as jax_render
from neurecon_tpu.training import TrainState
from neurecon_tpu.training import make_train_step as jax_make_train_step

import chip_smoke
from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import make_optimizer, perturb_parameters
from neurecon_tpu_torch.models.frameworks import (checkpoint_render_kwargs, get_model,
                                                  get_ray_loss_fn)
from neurecon_tpu_torch.models.frameworks.unisurf import interval_at, volume_render_rays
from neurecon_tpu_torch.training import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(lr=1e-4):
    """configs/unisurf.yaml's sections with a small net (W=64), a 32-step
    march, 8 + 8 samples a ray, and a multistep schedule inside 10 steps."""
    cfg = copy.deepcopy(chip_smoke.UNISURF)
    cfg["data"].update({"N_rays": 16, "val_rayschunk": 128})
    cfg["model"].update({"W_geometry_feature": 64, "N_steps": 32, "N_query": 8,
                         "N_freespace": 8})
    cfg["model"]["surface"].update({"D": 3, "W": 64, "skips": [1], "embed_multires": 4})
    cfg["model"]["radiance"].update({"D": 2, "W": 64})
    cfg["training"].update({"lr": lr, "scheduler": {"type": "multistep", "milestones": [3, 6],
                                                    "gamma": 0.5}})
    return cfg


def _setup(cfg, n_rays=16):
    """Both models with the same perturbed weights, rays from (0.1, -0.1, -2.5)
    towards the unit sphere, a JAX key, and JAX's root find for the rays."""
    jm, _, jkw, _, _ = jax_get_model(JaxConfigDict(copy.deepcopy(cfg)))
    targs = ConfigDict(copy.deepcopy(cfg))
    tm, tkw, _, _ = get_model(targs, "cpu")
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    rng = np.random.RandomState(3)
    th = rng.uniform(-0.2, 0.2, (n_rays, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    d *= rng.uniform(0.8, 1.2, (n_rays, 1)).astype(np.float32)  # unnormalized
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -2.5], np.float32), d.shape))
    rb = {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
          "target_rgb": jnp.asarray(rng.uniform(0, 1, (n_rays, 3)).astype(np.float32))}
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    surf = jax_samples(jm, params, rb["rays_o"], rb["rays_d"], None, **kw)
    return jm, jkw, params, targs, tm, tkw, rb, jax.random.PRNGKey(4), surf


def _t(x):
    return torch.tensor(np.asarray(x))


def _render_uniforms(key, n, cfg):
    """The draws JAX's renderer makes from `key`: the interval and
    free-space strata and the regularisation jitter."""
    k_int, k_free = jax.random.split(key)
    k_reg = jax.random.fold_in(key, 7)
    return (_t(jax.random.uniform(k_int, (n, cfg["model"]["N_query"]))),
            _t(jax.random.uniform(k_free, (n, cfg["model"]["N_freespace"]))),
            _t(jax.random.uniform(k_reg, (n, 3))))


@pytest.mark.parametrize("perturb", [False, True])
def test_volume_render_rays_matches_jax(perturb):
    """The whole render (root find included) with w_reg's surface and
    neighbour points: rgb, depth and accumulation maps, surface depth,
    the regularisation nablas and the normals within 1e-5, the surface mask
    equal."""
    cfg = _cfg()
    jm, jkw, params, targs, tm, tkw, rb, key, _ = _setup(cfg)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    kw["perturb"] = perturb
    want = jax.jit(lambda p: jax_render(jm, p, rb["rays_o"], rb["rays_d"], key, 0.3,
                                        reg_perturb=0.01, calc_normal=True, **kw))(params)
    with torch.no_grad():
        got = volume_render_rays(tm, _t(rb["rays_o"]), _t(rb["rays_d"]), 0.3, reg_perturb=0.01,
                                 calc_normal=True,
                                 uniforms=_render_uniforms(key, 16, cfg), **kw)
    mask = np.asarray(want["mask_surface"])
    assert mask.sum() >= 8 and np.array_equal(got["mask_surface"].numpy(), mask)
    for k in ("rgb", "depth_volume", "mask_volume", "depth_surface", "nablas_surface_reg",
              "normals_volume", "surface_points", "implicit_surface"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_ray_loss_and_grads_match_jax():
    """On JAX's root find and JAX's draws: loss terms to rel 1e-5, every
    gradient leaf within 5e-4 of its max|ref| (the JAX package's full-step
    bound); the float32 interval scalar within two ulps of JAX's."""
    cfg = _cfg()
    jm, jkw, params, targs, tm, tkw, rb, key, surf = _setup(cfg)
    j_loss = jax_ray_loss_fn(jm, JaxConfigDict(copy.deepcopy(cfg)), jkw)
    (_, (want, j_ex)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 1000, surface_override=surf), has_aux=True))(params)
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    k_render, _ = jax.random.split(key)
    total, (got, extras) = t_loss({k: _t(v) for k, v in rb.items()}, it=1000,
                                  surface_override=tuple(_t(s) for s in surf),
                                  uniforms=_render_uniforms(k_render, 16, cfg))
    total.backward()
    assert set(got) == set(want) and float(want["loss_reg"]) > 0
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    # float32 on both sides; numpy's and XLA's expf may differ by an ulp
    assert abs(extras["scalars"]["interval"].item() - float(j_ex["scalars"]["interval"])) <= 1.2e-7
    g_t = bridge.grads_to_tree(tm)
    assert set(g_t) == set(g_j) == {"implicit_surface", "radiance_net"}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


def test_adam_trajectory_matches_jax():
    """10 Adam steps on one fixed batch, root find and draws, under the
    multistep schedule (milestones 3 and 6): the total loss at every step to
    rel 1e-4, each leaf after 10 steps within 2e-3 of how far the JAX leaf
    moved. (NeuS and VolSDF hold 1e-3: here a few gradient entries of layer
    0 sit at ~4e-9, below Adam's eps of 1e-8, where fp32 sums in another
    order differ by ~2% and Adam's normalised step carries that into the
    weight; 1.02e-3 measured.)"""
    cfg = _cfg(lr=1e-3)
    jm, jkw, params, targs, tm, tkw, rb, key, surf = _setup(cfg)
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(
        lambda p, b, k, it: j_loss(p, b, k, it, surface_override=surf), opt, jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    optimizer, scheduler = make_optimizer(targs, tm)
    surf_t = tuple(_t(s) for s in surf)
    k_render, _ = jax.random.split(key)
    u = _render_uniforms(k_render, 16, cfg)
    rb_t = {k: _t(v) for k, v in rb.items()}
    t_step = make_train_step(
        lambda b, g, it: t_loss(b, it=it, surface_override=surf_t, uniforms=u),
        tm, optimizer, scheduler)
    for i in range(10):
        state, m_j = j_step(state, rb, key)
        m_t = t_step(rb_t, None, i)
        want = float(m_j["losses"]["total"])
        assert abs(m_t["losses"]["total"].item() - want) <= 1e-4 * abs(want), i
        assert set(m_t["grad_norms"]) == {"implicit_surface", "radiance_net"}
    assert scheduler.get_last_lr()[0] == pytest.approx(1e-3 * 0.25)
    for (path, p0), p10, pt in zip(jax.tree_util.tree_leaves_with_path(params),
                                   jax.tree_util.tree_leaves(state.params),
                                   jax.tree_util.tree_leaves(bridge.model_to_tree(tm))):
        moved = np.abs(np.asarray(p10) - np.asarray(p0)).max()
        assert np.abs(pt - np.asarray(p10)).max() <= 2e-3 * moved, jax.tree_util.keystr(path)


@pytest.mark.parametrize("step", [0, 1000, 450000, None, -1])
def test_interval_schedule_matches_jax(step):
    """interval_at and checkpoint_render_kwargs as the JAX package's (a
    step of None or below 0 reads as the end of training); the loss's
    float32 interval within 1e-6 of interval_at; NeuS and VolSDF take none."""
    cfg = copy.deepcopy(chip_smoke.UNISURF)
    jargs, targs = JaxConfigDict(copy.deepcopy(cfg)), ConfigDict(copy.deepcopy(cfg))
    assert checkpoint_render_kwargs(targs, step) == jax_ckpt_kwargs(jargs, step)
    it = 450000 if step is None or step < 0 else step
    assert interval_at(targs, it) == jax_interval_at(jargs, it)
    assert checkpoint_render_kwargs(targs, step) == {"interval": interval_at(targs, it)}
    from neurecon_tpu_torch.models.frameworks.unisurf import _interval_f32
    t = targs.training
    f32 = _interval_f32(it, float(t.delta_max), float(t.delta_min), float(t.delta_beta))
    assert np.float32(f32) == f32 and abs(f32 - interval_at(targs, it)) <= 1e-6
    for framework in ("NeuS", "VolSDF"):
        other = ConfigDict(copy.deepcopy(cfg))
        other.model["framework"] = framework
        assert checkpoint_render_kwargs(other, step) == {}


def _train_args(tmp, scene_dir, n_iters):
    cfg = _cfg()
    cfg["data"].update({"data_dir": scene_dir, "val_downscale": 2, "mesh_N": 24})
    cfg["training"].update({"num_iters": n_iters, "log_root_dir": str(tmp),
                            "exp_dir": os.path.join(str(tmp), "run"), "i_val": 2, "i_log": 2,
                            "i_val_mesh": 2, "i_backup": 2, "monitoring": "none"})
    return ConfigDict(cfg)


@pytest.fixture(scope="module")
def dtu_scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("unisurf_dtu") / "scan")
    chip_smoke.write_scene(root, "DTU", 4, 30, 40)
    return root


def test_train_resume_render_mesh_eval_on_dtu_scene(dtu_scene, tmp_path):
    """train.py trains UNISURF from a DTU-layout scene on the CPU (validation
    images with the surface depth and mask, the logged interval, a mesh),
    resumes with its optimizer state, and its checkpoint renders through
    render_view (volume at the checkpoint's interval, and root finding),
    meshes through extract_surface and evaluates through eval_rgb and
    eval_staged."""
    from neurecon_tpu_torch.tools import eval_rgb, extract_surface, render_view
    from neurecon_tpu_torch.tools.eval_staged import evaluate_ckpts
    from neurecon_tpu_torch.utils import mesh

    out = train.main_function(_train_args(tmp_path, dtu_scene, 4), device="cpu")
    assert out["it"] == 4 and not out["resumed_opt"]
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert len(totals) == 4 and np.isfinite(totals).all()
    args = _train_args(tmp_path, dtu_scene, 4)
    assert [it for it, _ in out["stats"]["scalars"]["interval"]] == [2, 4]
    for it, v in out["stats"]["scalars"]["interval"]:
        assert abs(v - interval_at(args, it - 1)) <= 1e-6
    imgs = os.path.join(out["exp_dir"], "imgs", "val")
    for name in ("predicted_rgb", "pred_depth_surface", "predicted_mask", "predicted_normals"):
        assert os.listdir(os.path.join(imgs, name)), name
    assert os.path.exists(os.path.join(out["exp_dir"], "meshes", "00000002.ply"))
    out2 = train.main_function(_train_args(tmp_path, dtu_scene, 6), device="cpu")
    assert out2["it"] == 6 and out2["resumed_opt"]

    vargs = _train_args(tmp_path, dtu_scene, 6)
    vargs.update({"load_pt": out2["final_ckpt"], "num_views": 1, "rayschunk": 300,
                  "downscale": 2})
    frames = render_view.render_frames(vargs, device="cpu")
    assert frames["rgb"].shape == (1, 15, 20, 3) and np.isfinite(frames["rgb"]).all()
    vargs["use_surface_render"] = "root_finding"
    cast = render_view.render_frames(vargs, device="cpu")
    assert cast["rgb"].shape == (1, 15, 20, 3) and np.isfinite(cast["rgb"]).all()
    eargs = _train_args(tmp_path, dtu_scene, 6)
    eargs.update({"load_pt": out2["final_ckpt"], "downscale": 2, "n_eval": 1,
                  "rayschunk": 300})
    assert np.isfinite(eval_rgb.main_function(eargs, device="cpu")["psnr_mean"])
    ply = str(tmp_path / "u.ply")
    sc = vargs.model.surface
    ext = extract_surface.main_function(extract_surface.make_parser().parse_args(
        ["--load_pt", out2["final_ckpt"], "--out", ply, "--N", "24", "--volume_size", "3.0",
         "--D", str(sc.D), "--W", str(sc.W), "--skip", str(sc.skips[0]),
         "--embed_multires", str(sc.embed_multires), "--W_geo_feat", "64", "--device", "cpu"]))
    assert ext["n_faces"] > 100 and len(mesh.read_ply(ply)[1]) == ext["n_faces"]
    rows = evaluate_ckpts(_train_args(tmp_path, dtu_scene, 6), [out2["final_ckpt"]], n_eval=1,
                          rayschunk=600, device="cpu")
    assert rows[0]["step"] == 6 and np.isfinite(rows[0]["psnr"])


def test_remaining_refusals(dtu_scene, tmp_path):
    """UNISURF trains (above); the overlap sampler is still refused for it,
    and the profiler window (now ported) writes its trace, a window left
    open at the end of the run closed there."""
    args = _train_args(tmp_path, dtu_scene, 2)
    args.training["overlap_sampler"] = True
    with pytest.raises(NotImplementedError, match="overlap_sampler"):
        train.main_function(args, device="cpu")
    args = _train_args(tmp_path, dtu_scene, 2)
    args.training["profile_steps"] = "0:5"
    out = train.main_function(args, device="cpu")
    assert os.listdir(os.path.join(out["exp_dir"], "profile")) == [
        "trace_00000000_00000002.json"]


def test_chip_smoke_unisurf_config_is_configs_unisurf_yaml(tmp_path):
    """chip_smoke.py's UNISURF is configs/unisurf.yaml (the card machine has
    no PyYAML to read it), and the config phase 23 trains differs from it
    only at the cuts it prints."""
    with open(os.path.join(REPO, "configs", "unisurf.yaml")) as f:
        want = yaml.safe_load(f)
    assert chip_smoke.UNISURF == want
    cfg, cuts = chip_smoke.unisurf_train_config(str(tmp_path / "scan"), str(tmp_path), 3)

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out
    a, b = flat(want), flat(cfg)
    changed = {k for k in set(a) | set(b) if a.get(k, object()) != b.get(k, object())}
    assert changed == {k for k, _ in cuts}
    assert b["training.num_iters"] == chip_smoke.UNISURF_STEPS and b["data.mesh_N"] == 128

"""The port's VolSDF render, loss and training against the JAX package, on
the CPU: `volume_render_rays` on the same fine samples and eikonal points,
the ray loss and its full gradient tree (`ln_beta` included), a 20-step Adam
trajectory under `exponential_step`, `train.py` on a small VolSDF config with
a resume, a `render_view` frame and a `--use_surface_render` patch on a JAX
checkpoint, and `extract_surface --config` / `eval_staged` on VolSDF
checkpoints."""
import os
import pickle
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models import ray_casting as jrc
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.frameworks.volsdf import compute_ray_samples as jax_samples
from neurecon_tpu.models.frameworks.volsdf import get_model as jax_get_model
from neurecon_tpu.models.frameworks.volsdf import make_ray_loss_fn as jax_ray_loss_fn
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.tools.camera_paths import generate_camera_path as jax_camera_path
from neurecon_tpu.tools.extract_surface import main_function as jax_extract_surface
from neurecon_tpu.training import TrainState
from neurecon_tpu.training import make_train_step as jax_make_train_step
from neurecon_tpu.training import render_full_image as jax_render_full_image
from neurecon_tpu.utils import mesh as jax_mesh
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

import chip_smoke
from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli
from neurecon_tpu_torch.models import ray_casting as rc
from neurecon_tpu_torch.models.base import make_optimizer, perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
from neurecon_tpu_torch.tools import render_view
from neurecon_tpu_torch.tools.eval_staged import evaluate_ckpts
from neurecon_tpu_torch.tools.extract_surface import main_function as extract_surface
from neurecon_tpu_torch.training import make_train_step
from neurecon_tpu_torch.utils import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(lr=5e-4):
    """A small VolSDF (W=64) on a 24x32 synthetic scene scaled as
    configs/synthetic_quality_volsdf.yaml scales it (radius 2.6, near 0, far
    6), 8 + 8x2 fine-sampler depths, 2 rounds, perturb off."""
    return {
        "expname": "torch_volsdf",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24, "W": 32,
                 "scale_radius": 2.6, "near": 0.0, "far": 6.0, "N_rays": 16,
                 "val_rayschunk": 256},
        "model": {"framework": "VolSDF", "obj_bounding_radius": 3.0,
                  "outside_scene": "builtin", "W_geometry_feature": 64,
                  "N_samples": 8, "N_importance": 8, "fine_sample_mul": 2,
                  "max_upsample_iter": 2, "perturb": False,
                  "surface": {"D": 4, "W": 64, "skips": [2], "radius_init": 1.0,
                              "embed_multires": 4},
                  "radiance": {"D": 2, "W": 64, "skips": [], "embed_multires": -1,
                               "embed_multires_view": -1}},
        "training": {"w_eikonal": 0.1, "speed_factor": 10.0, "lr": lr, "num_iters": 20,
                     "scheduler": {"type": "exponential_step", "min_factor": 0.1}},
    }


def _setup(cfg, n_rays=12):
    """Both models with the same perturbed weights (beta sharpened to 0.05),
    rays from inside the background sphere, JAX's fine samples for them and
    the eikonal points JAX's ray loss draws from the same key."""
    jargs = JaxConfigDict(cfg)
    jm, _, jkw, _, _ = jax_get_model(jargs)
    targs = ConfigDict(cfg)
    tm, tkw, _, _ = get_model(targs, "cpu")
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tm.ln_beta.fill_(float(np.log(0.05) / 10.0))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    rng = np.random.RandomState(3)
    th = rng.uniform(-0.3, 0.3, (n_rays, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    d *= rng.uniform(0.8, 1.2, (n_rays, 1)).astype(np.float32)  # unnormalized
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -2.5], np.float32), d.shape))
    rb = {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
          "target_rgb": jnp.asarray(rng.uniform(0, 1, (n_rays, 3)).astype(np.float32))}
    key = jax.random.PRNGKey(4)
    k_render, k_eik = jax.random.split(key)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    fine = jax_samples(jm, params, rb["rays_o"], rb["rays_d"], k_render, **kw)
    eik = jax.random.uniform(k_eik, (n_rays, 1, 3), jnp.float32, -3.0, 3.0)
    return jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine, eik


def _t(x):
    return torch.tensor(np.asarray(x))


def test_volume_render_rays_matches_jax():
    """On JAX's fine samples and eikonal points: rgb, acc and the eikonal
    nablas within 1e-5, depth within 1e-4 (fp32 sums in another order
    through both MLPs), beta map and rounds passed through unchanged."""
    cfg = _cfg()
    jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine, eik = _setup(cfg)
    from neurecon_tpu.models.frameworks.volsdf import volume_render_rays as jax_render
    from neurecon_tpu_torch.models.frameworks.volsdf import volume_render_rays
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    want = jax.jit(lambda p: jax_render(jm, p, rb["rays_o"], rb["rays_d"], key,
                                        eik_pts=eik, fine_override=fine, calc_normal=True,
                                        **kw))(params)
    with torch.no_grad():
        got = volume_render_rays(tm, _t(rb["rays_o"]), _t(rb["rays_d"]), eik_pts=_t(eik),
                                 fine_override=tuple(_t(f) for f in fine), calc_normal=True,
                                 **kw)
    assert float(want["mask_volume"].max()) > 0.5  # the rays see the surface
    for k, atol in (("rgb", 1e-5), ("mask_volume", 1e-5), ("depth_volume", 1e-4),
                    ("eik_nablas", 1e-5), ("normals_volume", 1e-4), ("d_vals", 0),
                    ("beta_map", 0), ("iter_usage", 0)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("variant", ["plain", "mask_ignore_and_anchor"])
def test_ray_loss_and_grads_match_jax(variant):
    """Loss terms to rel 1e-5; every gradient leaf, ln_beta included, to
    max|diff| <= 5e-4 max|ref| (the JAX package's own full-step bound between
    its kernel and plain paths): fp32 sums in another order through both MLPs
    and the grad-of-grad."""
    cfg = _cfg()
    if variant != "plain":
        cfg["training"].update({"w_sdf_anchor": 0.5, "sdf_anchor_until": 100})
    jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine, eik = _setup(cfg)
    if variant != "plain":
        rb["mask_ignore"] = jnp.asarray(np.arange(12) % 3 != 0)
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 7, fine_override=fine), has_aux=True))(params)
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    total, (got, extras) = t_loss({k: _t(v) for k, v in rb.items()}, it=7,
                                  fine_override=tuple(_t(f) for f in fine), eik_pts=_t(eik))
    total.backward()
    assert set(got) == set(want) and ("loss_sdf_anchor" in got) == (variant != "plain")
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    assert set(extras["scalars"]) >= {"alpha", "beta"}
    g_t = bridge.grads_to_tree(tm)
    assert "ln_beta" in g_t and np.abs(g_t["ln_beta"]).max() > 0
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


def test_adam_trajectory_matches_jax():
    """20 Adam steps on one fixed batch, fixed fine samples and eikonal
    points, per-module lr (ln_beta its own group), exponential_step: the
    total loss at every step to rel 1e-4, each leaf after 20 steps to
    max|diff| <= 1e-3 max|p_20 - p_0| of the JAX leaf."""
    cfg = _cfg(lr={"default": 1e-3, "ln_beta": 4e-3})
    jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine, eik = _setup(cfg)
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(
        lambda p, b, k, it: j_loss(p, b, k, it, fine_override=fine), opt, jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    optimizer, scheduler = make_optimizer(targs, tm)
    assert [g["name"] for g in optimizer.param_groups] == ["ln_beta", "default"]
    fine_t, eik_t = tuple(_t(f) for f in fine), _t(eik)
    rb_t = {k: _t(v) for k, v in rb.items()}
    t_step = make_train_step(lambda b, g, it: t_loss(b, fine_override=fine_t, eik_pts=eik_t),
                             tm, optimizer, scheduler)
    for i in range(20):
        state, m_j = j_step(state, rb, key)
        m_t = t_step(rb_t, None, i)
        want = float(m_j["losses"]["total"])
        assert abs(m_t["losses"]["total"].item() - want) <= 1e-4 * abs(want), i
        assert set(m_t["grad_norms"]) == {"ln_beta", "implicit_surface", "radiance_net"}
    p_t = bridge.model_to_tree(tm)
    for (path, p0), p20, pt in zip(jax.tree_util.tree_leaves_with_path(params),
                                   jax.tree_util.tree_leaves(state.params),
                                   jax.tree_util.tree_leaves(p_t)):
        moved = np.abs(np.asarray(p20) - np.asarray(p0)).max()
        assert np.abs(pt - np.asarray(p20)).max() <= 1e-3 * moved, jax.tree_util.keystr(path)


def _train_args(tmp, n_iters):
    cfg = _cfg()
    cfg["training"].update({"log_root_dir": str(tmp), "i_val": 3, "i_log": 2,
                            "i_save": 900, "i_backup": 3, "i_val_mesh": -1,
                            "monitoring": "none"})
    cfg["data"]["val_downscale"] = 4
    path = os.path.join(str(tmp), "volsdf_small.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    args, _ = parse_cli(argv=["--config", path, "--device", "cpu",
                              "--training:num_iters", str(n_iters)],
                        extra_args_fn=train._extra_args)
    return args


def test_train_resumes_and_evaluates(tmp_path):
    """train.py (main_function) trains the small VolSDF on the CPU with
    validation images (the beta heat-map and upsampling rounds among them),
    resumes with its optimizer state, and eval_staged reads its checkpoints
    (finite PSNR and Chamfer against a GT sphere mesh)."""
    out = train.main_function(_train_args(tmp_path, 4))
    assert out["it"] == 4 and not out["resumed_opt"]
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert len(totals) == 4 and np.isfinite(totals).all()
    assert {"beta", "alpha"} <= set(out["stats"]["scalars"])
    imgs = os.path.join(out["exp_dir"], "imgs", "val")
    for name in ("predicted_rgb", "beta_heat_map", "upsample_iters"):
        assert os.listdir(os.path.join(imgs, name)), name
    out2 = train.main_function(_train_args(tmp_path, 6))
    assert out2["it"] == 6 and out2["resumed_opt"]
    with open(out2["final_ckpt"], "rb") as f:
        ck = pickle.load(f)
    assert set(ck["model"]) == {"ln_beta", "implicit_surface", "radiance_net"}
    assert {float(s["step"]) for s in ck["torch_opt_state"]["state"].values()} == {6.0}

    from neurecon_tpu_torch.tools.make_gt_mesh import make_gt_mesh
    gt = str(tmp_path / "gt.ply")
    make_gt_mesh("sphere", 1.0, 24, 1.5, gt, device="cpu")
    rows = evaluate_ckpts(_train_args(tmp_path, 6), [os.path.join(
        out["exp_dir"], "ckpts", "00000003.pt"), out2["final_ckpt"]], gt_mesh=gt,
        n_eval=1, rayschunk=512, mesh_N=24, n_samples=2000, device="cpu")
    assert [r["step"] for r in rows] == [3, 6]
    assert all(np.isfinite(r["psnr"]) and np.isfinite(r["chamfer"]) for r in rows)


def test_unported_volsdf_options_are_refused(tmp_path):
    """NeRF++ (ported) builds and takes a step whose every background leaf
    gets a finite gradient, SIREN builds, overlap_sampler (ported) trains
    through train.py in groups of 2 steps."""
    cfg = _cfg()
    cfg["model"].update(outside_scene="nerf++", N_outside=4)
    targs = ConfigDict(cfg)
    model, kw, _, _ = get_model(targs, "cpu")
    assert model.nerf_outside is not None and not model.use_sphere_bg
    ds = jax_get_data(JaxConfigDict(cfg))
    batch = {"c2w": _t(ds.c2w_all[:1]), "intrinsics": _t(ds.intrinsics_all[:1]),
             "rgb": _t(ds.rgb_images[:1]).reshape(1, -1, 3)}
    kw["H"], kw["W"] = ds.H, ds.W
    from neurecon_tpu_torch.models.frameworks import make_trainer
    opt, sched = make_optimizer(targs, model)
    step = make_train_step(make_trainer(targs, model, kw), model, opt, sched)
    metrics = step(batch, torch.Generator().manual_seed(0), 0)
    assert np.isfinite(metrics["losses"]["total"].item())
    assert set(metrics["grad_norms"]) == {"ln_beta", "implicit_surface", "radiance_net",
                                          "nerf_outside"}
    g = bridge.grads_to_tree(model)["nerf_outside"]
    assert all(np.isfinite(x).all() for x in jax.tree_util.tree_leaves(g))
    assert np.abs(g["rgb_linear"]["w"]).max() > 0
    cfg = _cfg()
    cfg["model"]["surface"].update(use_siren=True, skips=[])  # SIREN is ported (no skips)
    model, _, _, _ = get_model(ConfigDict(cfg), "cpu")
    assert model.implicit_surface.use_siren
    args = _train_args(tmp_path, 4)
    args.training.update(overlap_sampler=True, steps_per_call=2)
    out = train.main_function(args)
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert out["it"] == 4 and len(totals) == 4 and np.isfinite(totals).all()


@pytest.fixture(scope="module")
def jax_volsdf_ckpt(tmp_path_factory):
    """A JAX VolSDF checkpoint as the JAX trainer writes it (params and optax
    state), perturbed weights, beta 0.05."""
    import optax
    _, _, _, params, _, _, _, _, _, _, _ = _setup(_cfg())
    d = tmp_path_factory.mktemp("volsdf_ckpt")
    params = jax.tree_util.tree_map(np.asarray, params)
    return JaxCheckpointIO(str(d)).save("latest.pt", global_step=9, model=params,
                                        opt_state=optax.adam(1e-3).init(params))


def test_render_view_frame_matches_jax(jax_volsdf_ckpt):
    """render_view (volume mode) on a JAX VolSDF checkpoint against the JAX
    render of the same camera: rgb within 1e-4 on every pixel (the plain
    samplers agree to ~1e-6 of the span), normals within the 2e-3 of the
    NeuS render tests (a normal is a normalized, weighted sum of nablas,
    whose own tolerance is rtol 2e-3 / atol 2e-4)."""
    args = ConfigDict(_cfg())
    args.update({"load_pt": jax_volsdf_ckpt, "num_views": 1, "camera_path": "interpolation",
                 "rayschunk": 400, "device": "cpu"})
    frames = render_view.render_frames(args, device="cpu")
    jargs = JaxConfigDict(_cfg())
    jm, _, _, jkw, jfactory = jax_get_model(jargs)
    with open(jax_volsdf_ckpt, "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f)["model"])
    ds = jax_get_data(jargs)
    c2w = jax_camera_path("interpolation", np.asarray(ds.c2w_all), 1)[0]
    o, d, _ = jax_get_rays(None, jnp.asarray(c2w, jnp.float32),
                           jnp.asarray(ds.intrinsics_all[0]), ds.H, ds.W)
    render_fn = jfactory(detailed_output=False, calc_normal=True,
                         **{k: v for k, v in jkw.items() if k != "rayschunk"})
    ret = jax_render_full_image(render_fn, params, o, d, jax.random.PRNGKey(0), rayschunk=400)
    np.testing.assert_allclose(frames["rgb"][0], ret["rgb"].reshape(24, 32, 3), atol=1e-4)
    np.testing.assert_allclose(frames["normal"][0],
                               ret["normals_volume"].reshape(24, 32, 3) / 2 + 0.5, atol=2e-3)
    assert (ret["rgb"] > 0.05).any() and np.isfinite(frames["depth"]).all()


def test_surface_render_patch_matches_jax():
    """`--use_surface_render sphere_tracing` on VolSDF: the casters query
    `forward_surface_fast`, the background min included; a patch of rays from
    inside the background sphere, masks equal, depth and rgb within 1e-5."""
    _, jm, _, params, _, tm, _, rb, _, _, _ = _setup(_cfg(), n_rays=48)
    cfg = {"near": 0.0, "far": 6.0}
    j_render = jrc.make_surface_render_fn(jm, "sphere_tracing", cfg)
    t_render = rc.make_surface_render_fn(tm, "sphere_tracing", cfg)
    rgb_w, depth_w, ex_w = j_render(params, rb["rays_o"], rb["rays_d"])
    rgb_g, depth_g, ex_g = t_render(_t(rb["rays_o"]), _t(rb["rays_d"]))
    mask = np.asarray(ex_w["mask_surface"])
    assert mask.any() and np.array_equal(ex_g["mask_surface"].numpy(), mask)
    np.testing.assert_allclose(depth_g.numpy()[mask], np.asarray(depth_w)[mask], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(rgb_g.numpy(), np.asarray(rgb_w), rtol=0, atol=1e-5)


def test_extract_surface_config_on_volsdf_checkpoint(jax_volsdf_ckpt, tmp_path):
    """extract_surface --config (a VolSDF yaml) on a JAX VolSDF checkpoint:
    the mesh of implicit_surface alone, as the JAX CLI makes it (same faces,
    vertices within 1e-5)."""
    path = str(tmp_path / "volsdf.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(_cfg(), f)
    flags = dict(load_pt=jax_volsdf_ckpt, config=path, N=24, volume_size=2.0, level=0.0,
                 chunk=4096, D=8, W=256, W_geo_feat=256, skip=4, init_r=1.0,
                 embed_multires=6)
    jax_extract_surface(SimpleNamespace(out=str(tmp_path / "jax.ply"), **flags))
    out = extract_surface(SimpleNamespace(out=str(tmp_path / "port.ply"), device="cpu",
                                          **flags))
    jv, jf = jax_mesh.read_ply(str(tmp_path / "jax.ply"))
    tv, tf = mesh.read_ply(str(tmp_path / "port.ply"))
    assert len(tf) > 100 and out["n_faces"] == len(tf)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


def test_chip_smoke_volsdf_config_is_configs_volsdf_yaml():
    """chip_smoke.py's VolSDF model and training sections are those of
    configs/volsdf.yaml (the card machine has no PyYAML to read the file)."""
    with open(os.path.join(REPO, "configs", "volsdf.yaml")) as f:
        want = yaml.safe_load(f)
    for section in ("model", "training"):
        assert chip_smoke.VOLSDF[section] == want[section], section

"""The port's training slice against the JAX package, on the CPU: the NeuS ray
loss and its full gradient tree on identical rays and samples, the lr
schedules, a 20-step Adam trajectory, random ray batches, and the trainer
(`train.py`) end to end: train, resume, render, resume from a JAX checkpoint."""
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
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.base import make_schedule as jax_make_schedule
from neurecon_tpu.models.frameworks.neus import compute_ray_samples
from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_ray_loss_fn
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.ops import get_rays_at as jax_get_rays_at
from neurecon_tpu.training import TrainState
from neurecon_tpu.training import make_train_step as jax_make_train_step
from neurecon_tpu.training import render_full_image as jax_render_full_image
from neurecon_tpu.training import sample_ray_batch as jax_sample_ray_batch
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli, save_config
from neurecon_tpu_torch.models.base import (make_optimizer, make_schedule,
                                            perturb_parameters)
from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
from neurecon_tpu_torch.models.frameworks.neus import get_model
from neurecon_tpu_torch.ops import get_rays, get_rays_at
from neurecon_tpu_torch.training import make_train_step, sample_ray_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")


def _cfg(width="small", scheduler=None, lr=5e-4):
    """NeuS at W=64 (the JAX package's own small test widths) or at the
    flagship widths, 8 rays, 16 + 16 samples, on a 24x32 synthetic scene."""
    if width == "small":
        surface = {"D": 3, "W": 64, "skips": [1], "radius_init": 0.5, "embed_multires": 4}
        radiance = {"D": 2, "W": 64, "skips": [], "embed_multires": -1,
                    "embed_multires_view": 2}
        geo = 64
    else:
        surface = {"D": 8, "W": 256, "skips": [4], "radius_init": 0.5, "embed_multires": 6}
        radiance = {"D": 4, "W": 256, "skips": [], "embed_multires": -1,
                    "embed_multires_view": 4}
        geo = 256
    return {
        "expname": "torch_train",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24, "W": 32,
                 "N_rays": 8, "val_rayschunk": 256, "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": geo, "N_samples": 16, "N_importance": 16,
                  "N_upsample_iters": 2, "perturb": False,
                  "surface": surface, "radiance": radiance},
        "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": lr, "num_iters": 20,
                     "scheduler": scheduler or {"type": "warmupcosine", "warmup_steps": 5}},
    }


def _setup(cfg, perturb):
    """The JAX model and params, the port's model with the same weights, one
    JAX ray batch and JAX's samples d_all for it."""
    jargs = JaxConfigDict(cfg)
    jm, _, jkw, _, _ = jax_get_model(jargs)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["ln_s"] = jnp.asarray([0.3], jnp.float32)  # a sharper s than the init's
    targs = ConfigDict(cfg)
    tm, tkw, _, _ = get_model(targs, "cpu")
    bridge.load_tree(tm, jax.tree_util.tree_map(np.asarray, params))
    if perturb:
        perturb_parameters(tm, torch.Generator().manual_seed(1))
        params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    ds = jax_get_data(jargs)
    batch = {"c2w": jnp.asarray(ds.c2w_all[:1]), "intrinsics": jnp.asarray(ds.intrinsics_all[:1]),
             "rgb": jnp.asarray(ds.rgb_images[:1]).reshape(1, -1, 3),
             "object_mask": jnp.asarray(ds.object_masks[:1]).reshape(1, -1)}
    rb = jax_sample_ray_batch(jax.random.PRNGKey(3), batch, ds.H, ds.W, 8)
    key = jax.random.PRNGKey(4)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    d_all = compute_ray_samples(jm, params, rb["rays_o"], rb["rays_d"], key, **kw)
    rb_t = {k: torch.tensor(np.asarray(v)) for k, v in rb.items()}
    return jargs, jm, jkw, params, targs, tm, tkw, rb, rb_t, key, d_all


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("width,perturb", [("small", False), ("small", True),
                                           ("flagship", True)])
def test_ray_loss_and_grads_match_jax(width, perturb):
    """Loss terms to rel 1e-5; every gradient leaf to max|diff| <= 5e-4
    max|ref| (the JAX package's own full-step bound between its kernel and
    plain paths, tests/test_fused_nablas_vjp.py): fp32 sums in another order
    through both MLPs and the grad-of-grad."""
    jargs, jm, jkw, params, targs, tm, tkw, rb, rb_t, key, d_all = _setup(_cfg(width), perturb)
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 0, d_all=d_all), has_aux=True))(params)

    t_loss = get_ray_loss_fn(targs, tm, tkw)
    total, (got, _) = t_loss(rb_t, d_all=torch.tensor(np.asarray(d_all)))
    total.backward()
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    g_t = bridge.grads_to_tree(tm)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        assert _rel(b, a) < 5e-4, (jax.tree_util.keystr(path), _rel(b, a))


@pytest.mark.parametrize("scheduler", [
    {"type": "multistep", "milestones": [5, 12], "gamma": 0.5},
    {"type": "warmupcosine", "warmup_steps": 5},
    {"type": "exponential_step", "min_factor": 0.1}])
def test_schedules_match_jax(scheduler):
    """factor(step) and the optimizer's lr at every step of 20, atol 1e-7
    (float32 arithmetic on both sides)."""
    cfg = _cfg(scheduler=scheduler, lr={"default": 1e-3, "ln_s": 4e-3})
    f_j = jax_make_schedule(JaxConfigDict(cfg))
    f_t = make_schedule(ConfigDict(cfg))
    tm, _, _, _ = get_model(ConfigDict(cfg), "cpu")
    opt, sched = make_optimizer(ConfigDict(cfg), tm)
    assert [g["name"] for g in opt.param_groups] == ["ln_s", "default"]
    for s in range(21):
        want = float(f_j(s))
        assert abs(f_t(s) - want) <= 1e-7, (s, f_t(s), want)
        lrs = {g["name"]: g["lr"] for g in opt.param_groups}
        assert abs(lrs["default"] - 1e-3 * want) <= 1e-7 * 1e-3
        assert abs(lrs["ln_s"] - 4e-3 * want) <= 1e-7 * 4e-3
        opt.step()
        sched.step()


def test_adam_trajectory_matches_jax():
    """20 Adam steps on one fixed batch and fixed samples, W=64, per-module
    lr, exponential_step: the total loss at every step to rel 1e-4, and each
    parameter leaf after 20 steps to max|diff| <= 1e-3 max|p_20 - p_0| of
    the JAX leaf (Adam's normalised update magnifies differences where a
    gradient is near 0)."""
    cfg = _cfg(scheduler={"type": "exponential_step", "min_factor": 0.1},
               lr={"default": 1e-3, "ln_s": 4e-3})
    jargs, jm, jkw, params, targs, tm, tkw, rb, rb_t, key, d_all = _setup(cfg, True)
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(
        lambda p, b, k, it: j_loss(p, b, k, it, d_all=d_all), opt, jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))

    t_loss = get_ray_loss_fn(targs, tm, tkw)
    d_t = torch.tensor(np.asarray(d_all))
    optimizer, scheduler = make_optimizer(targs, tm)
    t_step = make_train_step(lambda b, g, it: t_loss(b, d_all=d_t), tm, optimizer, scheduler)
    for i in range(20):
        state, m_j = j_step(state, rb, key)
        m_t = t_step(rb_t, None, i)
        want = float(m_j["losses"]["total"])
        assert abs(m_t["losses"]["total"].item() - want) <= 1e-4 * abs(want), i
    p_t = bridge.model_to_tree(tm)
    for (path, p0), p20, pt in zip(jax.tree_util.tree_leaves_with_path(params),
                                   jax.tree_util.tree_leaves(state.params),
                                   jax.tree_util.tree_leaves(p_t)):
        moved = np.abs(np.asarray(p20) - np.asarray(p0)).max()
        assert np.abs(pt - np.asarray(p20)).max() <= 1e-3 * moved, jax.tree_util.keystr(path)


def test_random_ray_batches():
    """N_rays pixels drawn from a torch.Generator: the rays equal the JAX
    package's rays at the same pixels, and the targets are gathered there."""
    ds = jax_get_data(JaxConfigDict(_cfg()))
    c2w, intr = np.asarray(ds.c2w_all[:1]), np.asarray(ds.intrinsics_all[:1])
    gen = torch.Generator().manual_seed(0)
    o, d, inds = get_rays(torch.tensor(c2w), torch.tensor(intr), ds.H, ds.W, N_rays=500,
                          generator=gen)
    assert o.shape == (1, 500, 3) and inds.shape == (1, 500)
    assert int(inds.max()) < ds.H * ds.W and len(np.unique(inds.numpy())) > 300  # with replacement
    o_j, d_j = jax_get_rays_at(jnp.asarray(inds.numpy()), jnp.asarray(c2w),
                               jnp.asarray(intr), ds.H, ds.W)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=0, atol=1e-6)
    o2, d2 = get_rays_at(inds, torch.tensor(c2w), torch.tensor(intr), ds.H, ds.W)
    assert torch.equal(d2, d)
    rgb = torch.tensor(np.asarray(ds.rgb_images[:1])).reshape(1, -1, 3)
    mask = torch.tensor(np.asarray(ds.object_masks[:1])).reshape(1, -1)
    rb = sample_ray_batch(torch.Generator().manual_seed(0),
                          {"c2w": torch.tensor(c2w), "intrinsics": torch.tensor(intr),
                           "rgb": rgb, "object_mask": mask}, ds.H, ds.W, 500)
    assert torch.equal(rb["target_rgb"][0], rgb[0, inds[0]])
    assert torch.equal(rb["target_mask"][0], mask[0, inds[0]])
    assert torch.equal(rb["rays_d"], d)


def _smoke_args(tmp, n_iters, *extra):
    args, _ = parse_cli(argv=["--config", SMOKE, "--device", "cpu",
                              "--training:num_iters", str(n_iters),
                              "--training:log_root_dir", str(tmp),
                              "--data:N_rays", "32", "--data:val_downscale", "4",
                              "--training:i_val", "4", "--training:i_log", "2",
                              "--training:monitoring", "none", *extra], extra_args_fn=train._extra_args)
    return args


def test_train_resume_and_render(tmp_path):
    """configs/synthetic_smoke.yaml trains through the port's train.py on the
    CPU, resumes with its optimizer state, and its final checkpoint renders
    in the JAX package as in the port (rgb atol 2e-3: the JAX package's
    render-equivalence bound, det-plateau sample moves included)."""
    out = train.main_function(_smoke_args(tmp_path, 4))
    assert out["it"] == 4 and not out["resumed_opt"]
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert len(totals) == 4 and np.isfinite(totals).all()
    exp = out["exp_dir"]
    assert os.path.exists(os.path.join(exp, "stats.p_0"))
    assert os.listdir(os.path.join(exp, "imgs", "val", "predicted_rgb"))

    out2 = train.main_function(_smoke_args(tmp_path, 6))
    assert out2["it"] == 6 and out2["resumed_opt"]
    with open(out2["final_ckpt"], "rb") as f:
        ck = pickle.load(f)
    steps = {float(s["step"]) for s in ck["torch_opt_state"]["state"].values()}
    assert steps == {6.0}

    # the final checkpoint rendered by both packages
    args = _smoke_args(tmp_path, 6)
    jargs = JaxConfigDict(args.to_dict())
    jm, _, _, jkw, jfactory = jax_get_model(jargs)
    params = jax.tree_util.tree_map(jnp.asarray, ck["model"])
    tm, _, tkw, tfactory = get_model(args, "cpu")
    bridge.load_tree(tm, ck["model"])
    _, val = jax_get_data(jargs, return_val=True, val_downscale=4)
    _, vin, _ = val[1]
    o, d, _ = jax_get_rays(None, jnp.asarray(vin["c2w"]), jnp.asarray(vin["intrinsics"]),
                           val.H, val.W)
    o, d = o[480:720], d[480:720]  # the middle rows, across the object
    kw = {k: v for k, v in jkw.items() if k not in ("rayschunk", "H", "W")}
    want = jax_render_full_image(jfactory(detailed_output=False, **kw), params, o, d,
                                 jax.random.PRNGKey(0), rayschunk=240)
    from neurecon_tpu_torch.training import render_full_image
    got = render_full_image(tfactory(detailed_output=False, **kw),
                            torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                            rayschunk=240)
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]), atol=2e-3)


def test_resume_from_jax_checkpoint(tmp_path):
    """A JAX trainer's checkpoint (params + optax state): the port takes the
    params and the step, resumes the lr schedule there and restarts Adam's
    moments with its bias correction at that step, as the JAX package's
    fast_forward_schedule does."""
    args = _smoke_args(tmp_path, 7)
    jargs = JaxConfigDict(args.to_dict())
    jm, _, _, _, _ = jax_get_model(jargs)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    ckdir = os.path.join(args.training.exp_dir, "ckpts")
    JaxCheckpointIO(ckdir).save("latest.pt", global_step=5, model=params,
                                opt_state=optax.adam(1e-3).init(params))
    out = train.main_function(args)
    assert out["it"] == 7 and not out["resumed_opt"]
    with open(out["final_ckpt"], "rb") as f:
        ck = pickle.load(f)
    steps = {float(s["step"]) for s in ck["torch_opt_state"]["state"].values()}
    assert steps == {7.0}
    factor = jax_make_schedule(jargs)
    assert abs(ck["torch_opt_state"]["param_groups"][0]["lr"]
               - 5e-4 * float(factor(7))) <= 1e-10


def test_unported_options_are_refused(tmp_path):
    # meshes in the loop (tests/test_torch_mesh.py), the profiler window and
    # the overlap sampler are ported: the window writes a Chrome trace of its
    # steps under exp_dir/profile, and a window with stop <= start raises;
    # with lr 0, 4 pipelined steps in groups of 3 (the last group of one
    # runs fresh) are bit-equal to 4 standard steps, so train.py draws in
    # the standard order
    args = _smoke_args(tmp_path, 4)
    args.training["profile_steps"] = "2:3"
    out = train.main_function(args)
    traces = os.listdir(os.path.join(out["exp_dir"], "profile"))
    assert traces == ["trace_00000002_00000003.json"]
    with open(os.path.join(out["exp_dir"], "profile", traces[0])) as f:
        assert '"traceEvents"' in f.read()
    args = _smoke_args(tmp_path, 4)
    args.training["profile_steps"] = "3:3"
    with pytest.raises(ValueError, match="start < stop"):
        train.main_function(args)
    totals = []
    for i, overlap in enumerate(("false", "true")):
        out = train.main_function(_smoke_args(
            tmp_path / str(i), 4, "--training:overlap_sampler", overlap,
            "--training:steps_per_call", "3", "--training:lr", "0.0",
            "--training:i_log", "1", "--training:i_val", "0"))
        totals.append([v for _, v in out["stats"]["losses"]["total_per_step"]])
    assert len(totals[1]) == 4 and np.isfinite(totals[1]).all()
    assert totals[0] == totals[1]


def test_save_config_round_trips_through_yaml(tmp_path):
    args = _smoke_args(tmp_path, 4)
    args.training["lr"] = {"default": 1e-4, "ln_s": 2.5e-3}
    args.training["tiny"] = 1e-12
    args.training["quote"] = "it's: [not a list]"
    path = os.path.join(str(tmp_path), "config.yaml")
    save_config(args, path)
    with open(path) as f:
        back = yaml.safe_load(f)
    want = args.to_dict()
    want["training"]["ckpt_file"] = None
    want["training"].pop("exp_dir")
    assert back == want


def test_checkpoint_load_file_picks_highest_step_and_filters(tmp_path):
    """Auto-resume takes the highest global_step (a numbered backup can be
    ahead of `latest` after a crash); ignore_keys / only_use_keys filter
    the model's top-level keys."""
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO
    io = CheckpointIO(str(tmp_path))
    tree = {"ln_s": np.ones(1, np.float32), "implicit_surface": {"layers": []},
            "radiance_net": {"layers": []}}
    io.save("00000010.pt", 10, model=tree)
    io.save("latest.pt", 5, model=tree)
    assert io.load_file()["global_step"] == 10
    assert set(io.load_file("latest.pt", ignore_keys=["radiance_net"])["model"]) == {
        "ln_s", "implicit_surface"}
    assert set(io.load_file(only_use_keys="ln_s")["model"]) == {"ln_s"}
    assert CheckpointIO(str(tmp_path / "empty")).load_file() == {}

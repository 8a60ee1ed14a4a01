"""The port's VolSDF + SIREN training against the JAX package, on the CPU:
the SIREN sphere pretrain on JAX's points, the SIREN VolSDF ray loss and its
gradient tree, a 20-step Adam trajectory, `train.py --device cpu` on a small
SIREN config with the pretrain, and `chip_smoke.VOLSDF_SIREN` held equal to
`configs/volsdf_siren.yaml`.

`compare_trainers` (not a test: minutes a step on the CPU at
`chip_smoke.py`'s full VolSDF configs; it imports JAX, so it lives here and
not in the port's tools) compares the two trainers over a longer run, from
the root of the repository:

    JAX_PLATFORMS=cpu python -u -c "import chip_smoke; from tests.test_torch_siren_train \
        import compare_trainers; compare_trainers(chip_smoke.VOLSDF, 20)"

with `chip_smoke.VOLSDF_SIREN` for the SIREN run. Both sides start from
the same weights (the JAX init, and for SIREN the JAX pretrain, copied
through `bridge.py`) and take the same ray batches (the same pixels of the
same images); each runs its own train step (its own sampler draws and
eikonal points, from its own generator). Printed as JSON
lines: every step's loss terms on both sides, and at steps 0, 10, 20, ...
`ln_beta` and the min / max sdf of the surface on a 64^3 grid over the
scene's volume (`data.volume_size`).
"""
import copy
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

import chip_smoke
from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.base import pretrain_siren_sdf as jax_pretrain
from neurecon_tpu.models.frameworks.volsdf import get_model as jax_get_model
from neurecon_tpu.models.frameworks.volsdf import make_ray_loss_fn as jax_ray_loss_fn
from neurecon_tpu.ops.ray import get_rays_at as jax_get_rays_at
from neurecon_tpu.training import TrainState
from neurecon_tpu.tools.extract_surface import main_function as jax_extract_surface
from neurecon_tpu.training import make_train_step as jax_make_train_step
from neurecon_tpu.utils import mesh as jax_mesh
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli
from neurecon_tpu_torch.models import base
from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
from neurecon_tpu_torch.models.frameworks import volsdf
from neurecon_tpu_torch.tools.extract_surface import main_function as extract_surface
from neurecon_tpu_torch.training import make_train_step
from neurecon_tpu_torch.utils import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# The two trainers side by side (not a test; see the module docstring)
# ---------------------------------------------------------------------------

def _grid_points(n: int, volume_size: float) -> np.ndarray:
    t = np.linspace(-volume_size / 2, volume_size / 2, n, dtype=np.float32)
    return np.stack(np.meshgrid(t, t, t, indexing="ij"), -1).reshape(-1, 3)


def compare_trainers(cfg: dict, steps: int, seed: int = 0, every: int = 10, out=print):
    """Train the JAX package and the port (plain path, CPU) side by side for
    `steps` steps from the same weights on the same ray batches; print a JSON
    line per step and per checkpoint (see the module docstring)."""
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    jm, _, jkw, _, _ = jax_get_model(jargs)
    root = jax.random.PRNGKey(seed)
    init_key, _ = jax.random.split(root)
    params = jax.jit(jm.init)(init_key)
    surf = jm.implicit_surface
    if surf.use_siren and surf.geometric_init:  # the JAX trainer's pretrain
        new_surf, pre = jax_pretrain(surf, params["implicit_surface"],
                                     jax.random.fold_in(root, 7),
                                     lr=float(cfg["training"].get("lr_pretrain", 1e-4)),
                                     target_radius=surf.radius_init,
                                     obj_bounding_size=surf.obj_bounding_size)
        params = dict(params, implicit_surface=new_surf)
        out(json.dumps({"pretrain_final_l1": float(pre[-1])}))
    targs = ConfigDict(copy.deepcopy(cfg))
    tm, tkw, _, _ = get_model(targs, "cpu")
    bridge.load_tree(tm, jax.tree_util.tree_map(np.asarray, params))

    ds = jax_get_data(jargs)
    H, W, N = ds.H, ds.W, int(cfg["data"]["N_rays"])
    rgb = np.asarray(ds.rgb_images, np.float32).reshape(len(ds), -1, 3)
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(j_loss, opt, jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
    optimizer, scheduler = base.make_optimizer(targs, tm)
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    t_step = make_train_step(lambda b, g, it: t_loss(b, g, it), tm, optimizer, scheduler)
    gen = torch.Generator().manual_seed(seed)
    grid = _grid_points(64, float(cfg["data"].get("volume_size", 3.0)))
    rng = np.random.RandomState(seed)

    def grid_range(sdf_fn):
        vals = np.concatenate([np.asarray(sdf_fn(grid[i:i + 65536]))
                               for i in range(0, len(grid), 65536)])
        return [float(vals.min()), float(vals.max())]

    for it in range(steps + 1):
        if it % every == 0 or it == steps:
            with torch.no_grad():
                port = grid_range(lambda x: tm.implicit_surface(torch.tensor(x)).numpy())
            jaxr = grid_range(lambda x: surf.forward(state.params["implicit_surface"],
                                                     jnp.asarray(x)))
            out(json.dumps({"step": it, "ln_beta": {
                "jax": float(np.asarray(state.params["ln_beta"]).reshape(-1)[0]),
                "port": float(tm.ln_beta.detach()[0])},
                "grid_sdf_min_max": {"jax": jaxr, "port": port}}))
        if it == steps:
            break
        img = rng.randint(len(ds))
        inds = rng.randint(0, H * W, N)
        o, d = jax_get_rays_at(jnp.asarray(inds[None]), jnp.asarray(ds.c2w_all[img:img + 1]),
                               jnp.asarray(ds.intrinsics_all[img:img + 1]), H, W)
        rb = {"rays_o": np.asarray(o), "rays_d": np.asarray(d),
              "target_rgb": rgb[img:img + 1, inds]}
        state, m_j = j_step(state, {k: jnp.asarray(v) for k, v in rb.items()},
                            jax.random.fold_in(root, 1000 + it))
        m_t = t_step({k: torch.tensor(v) for k, v in rb.items()}, gen, it)
        out(json.dumps({"step": it, "losses": {
            "jax": {k: float(v) for k, v in m_j["losses"].items()},
            "port": {k: float(v) for k, v in m_t["losses"].items()}}}))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

def _cfg(lr=1e-4):
    """A small VolSDF with SIREN nets (W=64, D=3 and 2, no skips, no
    encoding; view encoding 2) on a 24x32 synthetic scene scaled as
    configs/synthetic_quality_siren.yaml scales it, 8 + 8x2 fine-sampler
    depths, 2 rounds, perturb off, the multistep schedule of
    configs/volsdf_siren.yaml."""
    return {
        "expname": "torch_volsdf_siren",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24, "W": 32,
                 "scale_radius": 2.6, "near": 0.0, "far": 6.0, "N_rays": 16,
                 "val_rayschunk": 256},
        "model": {"framework": "VolSDF", "obj_bounding_radius": 3.0,
                  "outside_scene": "builtin", "W_geometry_feature": 64,
                  "N_samples": 8, "N_importance": 8, "fine_sample_mul": 2,
                  "max_upsample_iter": 2, "perturb": False,
                  "surface": {"D": 3, "W": 64, "skips": [], "radius_init": 1.0,
                              "embed_multires": -1, "use_siren": True},
                  "radiance": {"D": 2, "W": 64, "skips": [], "embed_multires": -1,
                               "embed_multires_view": 2, "use_siren": True}},
        "training": {"w_eikonal": 0.1, "lr": lr, "lr_pretrain": 1.5e-4, "num_iters": 20,
                     "scheduler": {"type": "multistep", "milestones": [10, 15],
                                   "gamma": 0.5}},
    }


def _t(x):
    return torch.tensor(np.asarray(x))


def _setup(cfg, n_rays=12):
    """Both models with the same weights (the port's SIREN init with seeded
    noise on every weight, beta sharpened to 0.05), rays from inside the
    background sphere, and fine samples for them, which both sides are
    given: the port's plain sampler's (it equals JAX `compute_ray_samples`,
    tests/test_torch_volsdf.py, and skips the JAX sampler's compile)."""
    jargs = JaxConfigDict(cfg)
    jm, _, jkw, _, _ = jax_get_model(jargs)
    targs = ConfigDict(cfg)
    tm, tkw, _, _ = get_model(targs, "cpu")
    base.perturb_parameters(tm, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tm.ln_beta.fill_(float(np.log(0.05)))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    rng = np.random.RandomState(3)
    th = rng.uniform(-0.3, 0.3, (n_rays, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -2.5], np.float32), d.shape))
    rb = {"rays_o": jnp.asarray(o), "rays_d": jnp.asarray(d),
          "target_rgb": jnp.asarray(rng.uniform(0, 1, (n_rays, 3)).astype(np.float32))}
    key = jax.random.PRNGKey(4)
    with torch.no_grad():
        fine = tuple(jnp.asarray(t.numpy()) for t in volsdf.compute_ray_samples(
            tm, _t(rb["rays_o"]), _t(rb["rays_d"]), **tkw))
    return jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine


def test_ray_loss_and_grads_match_jax():
    """The SIREN VolSDF ray loss on the same fine samples: loss terms to rel
    1e-5; every gradient leaf (ln_beta included) within 5e-4 of its
    max|ref|, the JAX package's own full-step bound."""
    jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine = _setup(_cfg())
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 3, fine_override=fine), has_aux=True))(params)
    k_render, k_eik = jax.random.split(key)
    eik = jax.random.uniform(k_eik, (12, 1, 3), jnp.float32, -3.0, 3.0)
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    total, (got, _) = t_loss({k: _t(v) for k, v in rb.items()}, it=3,
                             fine_override=tuple(_t(f) for f in fine), eik_pts=_t(eik))
    total.backward()
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    g_t = bridge.grads_to_tree(tm)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


def test_adam_trajectory_matches_jax():
    """20 Adam steps on one fixed batch with fixed fine samples, under the
    multistep schedule: the total loss at every step to rel 1e-4, each leaf
    after 20 steps within 1e-3 of the JAX leaf's movement."""
    cfg = _cfg(lr={"default": 1e-4, "ln_beta": 4e-3})
    jargs, jm, jkw, params, targs, tm, tkw, rb, key, fine = _setup(cfg)
    k_render, k_eik = jax.random.split(key)
    eik_t = _t(jax.random.uniform(k_eik, (12, 1, 3), jnp.float32, -3.0, 3.0))
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    opt = jax_make_optimizer(jargs, params)
    j_step = jax.jit(jax_make_train_step(
        lambda p, b, k, it: j_loss(p, b, k, it, fine_override=fine), opt, jit=False))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0))
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    optimizer, scheduler = base.make_optimizer(targs, tm)
    fine_t = tuple(_t(f) for f in fine)
    rb_t = {k: _t(v) for k, v in rb.items()}
    t_step = make_train_step(lambda b, g, it: t_loss(b, fine_override=fine_t, eik_pts=eik_t),
                             tm, optimizer, scheduler)
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


def test_train_pretrains_the_siren_sphere(tmp_path, monkeypatch):
    """train.py --device cpu on the small SIREN config: the sphere pretrain
    runs before the first step (cut to 20 iterations here; lr from
    training.lr_pretrain, the target the surface's radius_init, the box its
    obj_bounding_size) and is saved as latest.pt at step 0, two steps train
    with finite losses, and a resume from the checkpoints does not pretrain
    again."""
    calls = []

    def short_pretrain(surface, **kw):
        calls.append(kw)
        init = [p.detach().clone() for p in surface.parameters()]
        out = base.pretrain_siren_sdf(surface, num_iters=20, batch_points=500, **kw)
        calls.append([p.detach().clone() for p in surface.parameters()])
        assert any(not torch.equal(a, b) for a, b in zip(init, calls[-1]))
        return out
    monkeypatch.setattr(train, "pretrain_siren_sdf", short_pretrain)
    cfg = _cfg()
    cfg["training"].update({"log_root_dir": str(tmp_path), "i_val": 2, "i_log": 1,
                            "i_save": 900, "i_backup": -1, "i_val_mesh": -1,
                            "monitoring": "none"})
    cfg["data"]["val_downscale"] = 4
    path = os.path.join(str(tmp_path), "siren_small.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    def args(n):
        a, _ = parse_cli(argv=["--config", path, "--device", "cpu",
                               "--training:num_iters", str(n)],
                         extra_args_fn=train._extra_args)
        return a
    out = train.main_function(args(2))
    assert len(calls) == 2 and calls[0]["lr"] == 1.5e-4
    assert calls[0]["target_radius"] == 1.0 and calls[0]["obj_bounding_size"] == 3.0
    ckpts = os.path.join(out["exp_dir"], "ckpts")
    with open(os.path.join(ckpts, "latest.pt"), "rb") as f:
        pre = pickle.load(f)
    assert pre["global_step"] == 0 and "torch_opt_state" in pre
    tm, _, _, _ = get_model(ConfigDict(cfg), "cpu")
    bridge.load_tree(tm, pre["model"])
    saved = [p.detach() for p in tm.implicit_surface.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(saved, calls[1]))  # the pretrained surface
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    assert out["it"] == 2 and len(totals) == 2 and np.isfinite(totals).all()
    out2 = train.main_function(args(3))
    assert out2["it"] == 3 and out2["resumed_opt"] and len(calls) == 2

def test_chip_smoke_volsdf_siren_config_is_configs_volsdf_siren_yaml():
    """chip_smoke.py's SIREN model and training sections are those of
    configs/volsdf_siren.yaml (the card machine has no PyYAML to read it)."""
    with open(os.path.join(REPO, "configs", "volsdf_siren.yaml")) as f:
        want = yaml.safe_load(f)
    for section in ("model", "training"):
        assert chip_smoke.VOLSDF_SIREN[section] == want[section], section


def test_extract_surface_use_siren_matches_jax_config(tmp_path):
    """`extract_surface --use_siren` (the port's flag for a SIREN surface
    without a config file, which the card machine cannot read) on a JAX SIREN
    VolSDF checkpoint against the JAX CLI with `--config` (the SIREN yaml):
    the same faces, vertices within 1e-4 (1e-3 of a cell). The sdf row's bias
    is moved to the grid's median sdf, so that the init has a zero set to
    mesh; the SIREN init's field is rough (some 60k faces at N=24), and a
    vertex on an edge whose two values nearly agree moves by the sdf's fp32
    difference over theirs (1.1e-5 measured on 3 of 96,501 coordinates)."""
    from types import SimpleNamespace
    cfg = _cfg()
    jm, _, _, _, _ = jax_get_model(JaxConfigDict(cfg))
    params = jax.tree_util.tree_map(np.array, jax.jit(jm.init)(jax.random.PRNGKey(2)))
    grid = _grid_points(24, 3.0)
    med = float(np.median(np.asarray(jm.implicit_surface.forward(
        params["implicit_surface"], jnp.asarray(grid)))))
    params["implicit_surface"]["layers"][-1]["b"][0] -= med
    ckpt = JaxCheckpointIO(str(tmp_path)).save("siren.pt", global_step=0, model=params)
    path = str(tmp_path / "siren.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    flags = dict(load_pt=ckpt, N=24, volume_size=3.0, level=0.0, chunk=4096, D=3, W=64,
                 W_geo_feat=64, skip=-1, init_r=1.0, embed_multires=-1)
    jax_extract_surface(SimpleNamespace(out=str(tmp_path / "jax.ply"), config=path, **flags))
    out = extract_surface(SimpleNamespace(out=str(tmp_path / "port.ply"), config=None,
                                          use_siren=True, device="cpu", **flags))
    jv, jf = jax_mesh.read_ply(str(tmp_path / "jax.ply"))
    tv, tf = mesh.read_ply(str(tmp_path / "port.ply"))
    assert len(tf) > 100 and out["n_faces"] == len(tf)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-4)


"""The port's ray casters and surface renderer against the JAX package, on
the CPU: root finding (coarse march, argmin, secant), sphere tracing, the
surface render function, `render_view --use_surface_render`,
`--render_mesh` (the z-buffer rasterizer) and `--alter_radiance`."""
import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models import ray_casting as jrc
from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.tools.camera_paths import generate_camera_path as jax_camera_path
from neurecon_tpu.tools.mesh_raster import rasterize_mesh as jax_rasterize_mesh
from neurecon_tpu.training import render_full_image as jax_render_full_image
from neurecon_tpu.utils import mesh as jax_mesh
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models import ray_casting as rc
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model
from neurecon_tpu_torch.tools import render_view
from neurecon_tpu_torch.tools.mesh_raster import rasterize_mesh
from neurecon_tpu_torch.training import render_full_image

RADIUS = 0.5


def _cfg():
    """A small NeuS (W=64, D=4, skip at 2) on a 24x32 synthetic sphere scene."""
    return {
        "expname": "torch_raycast",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24,
                 "W": 32, "val_rayschunk": 256, "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": 64, "N_samples": 32, "N_importance": 32,
                  "N_upsample_iters": 2,
                  "surface": {"D": 4, "W": 64, "skips": [2], "radius_init": 0.5,
                              "embed_multires": 4},
                  "radiance": {"D": 2, "W": 64, "skips": [], "embed_multires": -1,
                               "embed_multires_view": 2}},
        "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": 5e-4, "num_iters": 100},
    }


@functools.lru_cache(maxsize=None)
def _models(perturb):
    """The JAX NeuS and its params, and the port's NeuS with the same
    weights (perturbed: seeded noise on every weight, octave columns
    included)."""
    jm, _, _, _, _ = jax_get_model(JaxConfigDict(_cfg()))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tm, _, _, _ = get_model(ConfigDict(_cfg()), "cpu")
    bridge.load_tree(tm, params)
    if perturb:
        perturb_parameters(tm, torch.Generator().manual_seed(1))
        params = bridge.model_to_tree(tm)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


def _rays(n, seed=0, spread=0.3):
    """Rays from near (0, 0, -3) within `spread` rad of the axis: at 0.3
    about a third hit the r=0.5 sphere, the rest miss; plus one ray starting
    inside."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(-spread, spread, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -3.0], np.float32),
                                             d.shape))
    o[-1] = [0.05, 0.0, 0.1]  # inside: the caster reports depth 0
    return o, d


def _sphere_j(p):
    return jnp.linalg.norm(p, axis=-1) - RADIUS


def _sphere_t(p):
    return torch.linalg.norm(p, dim=-1) - RADIUS


def _queries(kind):
    """(JAX query, port query) of one sdf: the analytic sphere or the net."""
    if kind == "sphere":
        return _sphere_j, _sphere_t
    jm, params, tm = _models(perturb=True)
    return functools.partial(jm.forward_surface_fast, params), tm.forward_surface_fast


def _assert_depths(got, want, hit):
    """Depth within 1e-5 where the cast converged on the surface (`hit`); a
    ray that misses or grazes marches on through |sdf| of order one, and its
    20 steps sum the fp32 rounding of each: rtol 5e-5 there."""
    np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[~hit], want[~hit], rtol=5e-5, atol=1e-5)


def test_linspace01_is_jnp_linspace():
    for n in (1, 2, 7, 64, 128, 256, 1000):
        assert np.array_equal(rc.linspace01(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n)))


@pytest.mark.parametrize("kind", ["sphere", "net"])
@pytest.mark.parametrize("N_steps,logit_tau,fill_inf", [(256, 0.0, True), (128, 0.05, False)])
def test_root_finding_matches_jax(kind, N_steps, logit_tau, fill_inf):
    """Masks equal; depth and hit points within 1e-5 (fp32 sdf sums in
    another order move the secant by ~1e-7)."""
    jq, tq = _queries(kind)
    o, d = _rays(96)
    kw = dict(near=0.0, far=6.0, N_steps=N_steps, logit_tau=logit_tau, fill_inf=fill_inf)
    want = jrc.root_finding_surface_points(jq, jnp.asarray(o), jnp.asarray(d), **kw)
    got = rc.root_finding_surface_points(tq, torch.tensor(o), torch.tensor(d), **kw)
    d_w, pt_w, m_w, sc_w = (np.asarray(a) for a in want)
    d_g, pt_g, m_g, sc_g = (a.numpy() for a in got)
    assert np.array_equal(m_g, m_w) and np.array_equal(sc_g, sc_w)
    assert 10 < m_w.sum() < 90 and d_w[-1] == 0.0
    np.testing.assert_allclose(d_g, d_w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt_g, pt_w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["sphere", "net"])
def test_run_secant_matches_jax(kind):
    """The secant alone from one bracket per ray: within 1e-5 where the
    bracket holds the crossing (f_low < 0 < f_high); elsewhere it
    extrapolates, and those lanes, which callers mask away, need only be
    finite."""
    jq, tq = _queries(kind)
    o, d = _rays(64, seed=1, spread=0.1)  # at depth 3 every ray is inside
    rng = np.random.RandomState(2)
    d_high = rng.uniform(1.8, 2.3, 64).astype(np.float32)
    d_low = rng.uniform(2.9, 3.1, 64).astype(np.float32)
    f_high = np.asarray(jq(jnp.asarray(o + d_high[:, None] * d)))
    f_low = np.asarray(jq(jnp.asarray(o + d_low[:, None] * d)))
    want = jrc.run_secant(*(jnp.asarray(a) for a in (f_low, f_high, d_low, d_high, o, d)),
                          jq, 8, 0.0)
    got = rc.run_secant(*(torch.tensor(a) for a in (f_low, f_high, d_low, d_high, o, d)),
                        tq, 8, 0.0)
    assert np.isfinite(got.numpy()).all()
    ok = (f_low < 0) & (f_high > 0)
    assert ok.sum() >= 24
    np.testing.assert_allclose(got.numpy()[ok], np.asarray(want)[ok], rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["sphere", "net"])
def test_sphere_tracing_matches_jax(kind):
    """20 fixed steps, the step applied before the mask narrows: masks
    equal, depth and points as `_assert_depths` says."""
    jq, tq = _queries(kind)
    o, d = _rays(96, seed=3)
    want = jrc.sphere_tracing_surface_points(jq, jnp.asarray(o), jnp.asarray(d),
                                             near=0.0, far=6.0, N_iters=20)
    got = rc.sphere_tracing_surface_points(tq, torch.tensor(o), torch.tensor(d),
                                           near=0.0, far=6.0, N_iters=20)
    mask = np.asarray(want[2])
    assert np.array_equal(got[2].numpy(), mask) and 0 < mask.sum() < 96
    hit = mask & (np.abs(np.asarray(jq(want[1]))) < 1e-4)
    assert hit.sum() > 5
    _assert_depths(got[0].numpy(), np.asarray(want[0]), hit)
    # the points are o + d * depth: within 1e-5 on the converged rays
    np.testing.assert_allclose(got[1].numpy()[hit], np.asarray(want[1])[hit], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("algo", ["sphere_tracing", "root_finding"])
def test_surface_render_fn_matches_jax(algo):
    """make_surface_render_fn on unnormalized rays through the perturbed
    net: masks equal, depth as `_assert_depths` says, rgb within 1e-5, normals and
    nablas within the forward+nablas tolerance of the render tests (rtol
    2e-3, atol 2e-4). The renderer is deterministic: it ignores the
    generator."""
    jm, params, tm = _models(perturb=True)
    o, d = _rays(96, seed=4)
    d = d * np.random.RandomState(5).uniform(0.8, 1.2, (96, 1)).astype(np.float32)
    cfg = {"near": 0.0, "far": 6.0}
    if algo == "root_finding":
        cfg["N_steps"] = 128
    j_render = jrc.make_surface_render_fn(jm, algo, cfg)
    t_render = rc.make_surface_render_fn(tm, algo, cfg)
    rgb_w, depth_w, ex_w = j_render(params, jnp.asarray(o), jnp.asarray(d))
    rgb_g, depth_g, ex_g = t_render(torch.tensor(o), torch.tensor(d),
                                    torch.Generator().manual_seed(7))
    mask = np.asarray(ex_w["mask_surface"])
    assert np.array_equal(ex_g["mask_surface"].numpy(), mask) and 0 < mask.sum() < 96
    pts = np.asarray(jnp.asarray(o) + depth_w[:, None] * jnp.asarray(d) / np.linalg.norm(
        d, axis=-1, keepdims=True))
    hit = mask & (np.abs(np.asarray(jm.forward_surface_fast(params, jnp.asarray(pts)))) < 1e-4)
    _assert_depths(depth_g.numpy(), np.asarray(depth_w), hit)
    np.testing.assert_allclose(rgb_g.numpy(), np.asarray(rgb_w), rtol=0, atol=1e-5)
    for k in ("normals_surface", "implicit_nablas"):
        np.testing.assert_allclose(ex_g[k].numpy(), np.asarray(ex_w[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    again = t_render(torch.tensor(o), torch.tensor(d))
    assert torch.equal(again[0], rgb_g) and torch.equal(again[1], depth_g)


def test_rasterize_mesh_matches_jax():
    ax = np.linspace(-1.0, 1.0, 20)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    v, f = jax_mesh.marching_tetrahedra(np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6)
    v = v * (2.0 / 19) - 1.0
    ds = jax_get_data(JaxConfigDict(_cfg()))
    c2w, K = np.asarray(ds.c2w_all[1]), np.asarray(ds.intrinsics_all[0])
    # then a few faces scaled up past the largest bucket: the subdivision
    for vv, ff in ((v, f), (v * 2.0, f[:40])):
        want = jax_rasterize_mesh(vv, ff, c2w, K, 24, 32)
        got = rasterize_mesh(vv, ff, c2w, K, 24, 32)
        assert want[2].any()
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Two JAX checkpoints of the small NeuS (seeds 0 and 1), and a mesh of
    the first one's surface."""
    jm, _, _, _, _ = jax_get_model(JaxConfigDict(_cfg()))
    d = tmp_path_factory.mktemp("raycast")
    paths = []
    for seed in (0, 1):
        params = jax.jit(jm.init)(jax.random.PRNGKey(seed))
        params["ln_s"] = jnp.asarray([0.45], jnp.float32)
        paths.append(JaxCheckpointIO(str(d)).save(f"{seed}.pt", global_step=7 + seed,
                                                  model=params))
    with open(paths[0], "rb") as fh:
        surf = jax.tree_util.tree_map(jnp.asarray, pickle.load(fh)["model"]["implicit_surface"])
    ply = str(d / "surface.ply")
    jax_mesh.extract_mesh(lambda x: jm.implicit_surface.forward(surf, x), volume_size=2.0,
                          N=24, filepath=ply)
    return paths, ply


def _jax_surface_frames(path, algo, n_views=2):
    """The JAX render_view surface loop, unrolled: the same checkpoint,
    camera path and cast range."""
    jargs = JaxConfigDict(_cfg())
    jm, _, _, _, _ = jax_get_model(jargs)
    with open(path, "rb") as fh:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(fh)["model"])
    ds = jax_get_data(jargs)
    c2ws = jax_camera_path("interpolation", np.asarray(ds.c2w_all), n_views)
    far = 1.2 * (float(np.linalg.norm(np.asarray(c2ws)[:, :3, 3], axis=-1).max()) + 1.0)
    cfg = {"near": 0.0, "far": far}
    if algo == "root_finding":
        cfg["N_steps"] = 128
    render_fn = jrc.make_surface_render_fn(jm, algo, cfg)
    out = []
    for i, c2w in enumerate(c2ws):
        o, d, _ = jax_get_rays(None, jnp.asarray(c2w, jnp.float32),
                               jnp.asarray(ds.intrinsics_all[0]), ds.H, ds.W)
        out.append(jax_render_full_image(render_fn, params, o, d, jax.random.PRNGKey(i),
                                         rayschunk=300))
    return out, c2ws, np.asarray(ds.intrinsics_all[0])


def _view_args(path, **extra):
    args = ConfigDict(_cfg())
    args.update({"load_pt": path, "num_views": 2, "camera_path": "interpolation",
                 "rayschunk": 300, "device": "cpu", **extra})
    return args


@pytest.mark.parametrize("algo", ["sphere_tracing", "root_finding"])
def test_render_view_surface_render_matches_jax(jax_ckpts, algo):
    """render_view --use_surface_render against the JAX loop on a JAX
    checkpoint: rgb within 1e-5 and normals within 2e-3 on every pixel, the
    per-frame normalized depth within 1e-5; with --render_mesh, the
    rasterized mesh equal to the JAX rasterizer's frame."""
    paths, ply = jax_ckpts
    frames = render_view.render_frames(
        _view_args(paths[0], use_surface_render=algo, render_mesh=ply), device="cpu")
    want, c2ws, K = _jax_surface_frames(paths[0], algo)
    for i, ret in enumerate(want):
        np.testing.assert_allclose(frames["rgb"][i], ret["rgb"].reshape(24, 32, 3),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(frames["normal"][i],
                                   ret["normals_surface"].reshape(24, 32, 3) / 2 + 0.5,
                                   rtol=0, atol=2e-3)
        depth = np.nan_to_num(ret["depth_volume"].reshape(24, 32, 1), posinf=0.0)
        np.testing.assert_allclose(frames["depth"][i], depth / (depth.max() + 1e-10),
                                   rtol=0, atol=1e-5)
        assert ret["mask_surface"].any()
        mesh_w = jax_rasterize_mesh(*jax_mesh.read_ply(ply), np.asarray(c2ws[i]), K, 24, 32)[0]
        assert np.array_equal(frames["mesh"][i], mesh_w) and (mesh_w < 1).any()


def test_render_view_alter_radiance(jax_ckpts, tmp_path):
    """--alter_radiance renders checkpoint A's surface with checkpoint B's
    radiance net: the same frames as one checkpoint holding that mix."""
    paths, _ = jax_ckpts
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO, load_checkpoint
    a, b = load_checkpoint(paths[0])["model"], load_checkpoint(paths[1])["model"]
    mixed = CheckpointIO(str(tmp_path)).save("mixed.pt", 7,
                                             model=dict(a, radiance_net=b["radiance_net"]))
    kw = dict(use_surface_render="sphere_tracing", num_views=1)
    got = render_view.render_frames(_view_args(paths[0], alter_radiance=paths[1], **kw),
                                    device="cpu")
    want = render_view.render_frames(_view_args(mixed, **kw), device="cpu")
    plain = render_view.render_frames(_view_args(paths[0], **kw), device="cpu")
    assert np.array_equal(got["rgb"], want["rgb"])
    assert not np.array_equal(got["rgb"], plain["rgb"])
    assert np.array_equal(got["normal"], plain["normal"])


def test_render_full_image_passes_the_surface_renderer_through():
    """render_full_image hands its generator to a surface renderer, which
    ignores it; the chunks reassemble the one-call render (to fp32
    rounding: the MLP's sums block by batch size)."""
    _, _, tm = _models(perturb=False)
    o, d = _rays(50, seed=6)
    fn = rc.make_surface_render_fn(tm, "sphere_tracing", {"near": 0.0, "far": 6.0})
    whole = fn(torch.tensor(o), torch.tensor(d))
    ret = render_full_image(fn, torch.tensor(o), torch.tensor(d), rayschunk=16,
                            generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(ret["mask_surface"], whole[2]["mask_surface"].numpy())
    np.testing.assert_allclose(ret["rgb"], whole[0].numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ret["depth_volume"], whole[1].numpy(), rtol=5e-5, atol=1e-5)

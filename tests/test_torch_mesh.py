"""The port's mesh path against the JAX package, on the CPU: the sdf-only
query (kernel 4's plain version), the grid query, marching tetrahedra, the
PLY writer, `extract_surface`, the GT meshes, the Chamfer and PSNR metrics,
`eval_staged`, and meshes inside the training loop (`train.py`)."""
import os
import re
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio.synthetic import composite_sdf as jax_composite_sdf
from neurecon_tpu.dataio.synthetic import torus_radii as jax_torus_radii
from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
from neurecon_tpu.models.frameworks import get_model as jax_get_model
from neurecon_tpu.ops.fused_mlp import fused_sdf_forward as jax_fused_sdf_forward
from neurecon_tpu.tools import eval_mesh as jax_eval_mesh
from neurecon_tpu.tools import eval_rgb as jax_eval_rgb
from neurecon_tpu.tools.eval_staged import evaluate_ckpts as jax_evaluate_ckpts
from neurecon_tpu.tools.extract_surface import main_function as jax_extract_surface
from neurecon_tpu.utils import mesh as jax_mesh
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
from neurecon_tpu_torch.ops.fused_mlp import fused_sdf_forward, sdf_forward_plain
from neurecon_tpu_torch.tools import eval_mesh, eval_rgb
from neurecon_tpu_torch.tools.eval_staged import evaluate_ckpts
from neurecon_tpu_torch.tools.extract_surface import main_function as extract_surface
from neurecon_tpu_torch.tools.make_gt_mesh import main as make_gt_mesh_cli
from neurecon_tpu_torch.tools.make_gt_mesh import make_gt_mesh
from neurecon_tpu_torch.utils import mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "configs", "synthetic_smoke.yaml")
SMALL = dict(W=64, D=4, skips=[2], W_geo_feat=64, radius_init=0.5, embed_multires=4)
FLAGSHIP = dict(W=256, D=8, skips=[4], W_geo_feat=256, radius_init=0.5, embed_multires=6)


def _surfaces(cfg, perturb, seed=0):
    """The JAX surface and params, and the port's surface with the same
    weights (perturbed: seeded noise on every weight, octave columns
    included)."""
    js = JaxSurface(**cfg)
    params = jax.tree_util.tree_map(np.asarray, js.init(jax.random.PRNGKey(seed)))
    ts = ImplicitSurface(**cfg)
    bridge.load_surface_tree(ts, params)
    if perturb:
        perturb_parameters(ts, torch.Generator().manual_seed(seed + 1))
        params = {"layers": [{n: getattr(l, n).detach().numpy().copy() for n in ("v", "g", "b")}
                             for l in ts.layers]}
    return js, jax.tree_util.tree_map(jnp.asarray, params), ts


def _points(n, seed=0, scale=1.0):
    return np.random.RandomState(seed).uniform(-scale, scale, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("perturb", [False, True])
def test_sdf_forward_plain_matches_jax_kernel(perturb):
    """Kernel 4's plain version against the JAX package's Pallas kernel in
    interpret mode (W=64, D=4, skip at 2, tile 256; 700 points leave a
    ragged tile): rtol 1e-5 of max|sdf| (fp32 sums in another order)."""
    js, params, ts = _surfaces(SMALL, perturb)
    x = _points(700)
    want = np.asarray(jax_fused_sdf_forward(js, params, jnp.asarray(x), tile=256,
                                            interpret=True))
    got = sdf_forward_plain(ts, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(fused_sdf_forward(ts, torch.tensor(x)).numpy(), got)


@pytest.mark.parametrize("sphere_residual", [False, True])
def test_forward_query_matches_jax_at_flagship_width(sphere_residual):
    """forward_query (kernel 4 and the prior outside it) against the JAX
    forward at the flagship widths on 2,048 points of any prefix, rtol 1e-5."""
    cfg = dict(FLAGSHIP, sphere_residual=sphere_residual)
    js, params, ts = _surfaces(cfg, perturb=True)
    x = _points(2048, seed=1).reshape(32, 64, 3)
    want = np.asarray(js.forward(params, jnp.asarray(x)))
    got = ts.forward_query(torch.tensor(x))
    assert got.shape == (32, 64) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(ts.forward_fast(torch.tensor(x)), got)


def test_fused_sdf_forward_checks_its_input():
    _, _, ts = _surfaces(SMALL, perturb=False)
    with pytest.raises(TypeError):
        fused_sdf_forward(ts, torch.zeros(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        fused_sdf_forward(ts, torch.zeros(3, 4).t())
    assert fused_sdf_forward(ts, torch.zeros(0, 3)).shape == (0,)


@pytest.mark.parametrize("N", [16, 24])
def test_query_grid_matches_jax(N):
    js, params, ts = _surfaces(SMALL, perturb=True)
    want = jax_mesh.query_grid(lambda x: js.forward(params, x), N, 2.0)
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return ts.forward_query(x)
    got = mesh.query_grid(fn, N, 2.0, chunk=1000)
    assert got.shape == (N, N, N) and got.dtype == torch.float32
    assert sum(calls) == N ** 3 and max(calls) <= 1000
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _grids():
    N = 20
    ax = np.linspace(-1.0, 1.0, N)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6
    rng = np.random.RandomState(3)
    return {"sphere": (sphere, 0.0), "random": (rng.randn(12, 14, 16), 0.0),
            "level": (sphere, 0.25), "empty": (np.ones((8, 8, 8)), 0.0),
            "float32": (sphere.astype(np.float32), 0.0)}


@pytest.mark.parametrize("name", ["sphere", "random", "level", "empty", "float32"])
def test_marching_tetrahedra_matches_jax(name):
    values, level = _grids()[name]
    want_v, want_f = jax_mesh.marching_tetrahedra(values, level)
    got_v, got_f = mesh.marching_tetrahedra(torch.tensor(values), level)
    assert got_v.dtype == torch.float32 and got_f.dtype == torch.int32
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-6)
    if name != "empty":
        assert len(want_f) > 50


def test_write_ply_is_byte_identical_and_round_trips(tmp_path):
    values, _ = _grids()["sphere"]
    v, f = jax_mesh.marching_tetrahedra(values)
    jax_mesh.write_ply(str(tmp_path / "jax.ply"), v, f)
    mesh.write_ply(str(tmp_path / "port.ply"), torch.tensor(v), torch.tensor(f))
    assert (tmp_path / "jax.ply").read_bytes() == (tmp_path / "port.ply").read_bytes()
    rv, rf = mesh.read_ply(str(tmp_path / "port.ply"))
    assert np.array_equal(rv, v) and np.array_equal(rf, f)
    mesh.write_ply(str(tmp_path / "empty.ply"), np.zeros((0, 3)), np.zeros((0, 3)))
    ev, ef = jax_mesh.read_ply(str(tmp_path / "empty.ply"))
    assert ev.shape == (0, 3) and ef.shape == (0, 3)


def test_extract_surface_matches_jax_cli(tmp_path):
    """The port's CLI (--device cpu) and the JAX CLI on one JAX checkpoint at
    N=24: the two grids agree in sign everywhere, so the meshes have the same
    faces, and vertices within 1e-5."""
    cfg = dict(SMALL, skips=[2])
    js, params, ts = _surfaces(cfg, perturb=True)
    ckpt = JaxCheckpointIO(str(tmp_path)).save(
        "ck.pt", global_step=3, model={"implicit_surface": params})
    flags = dict(load_pt=ckpt, config=None, N=24, volume_size=2.0, level=0.0,
                 chunk=4096, D=4, W=64, W_geo_feat=64, skip=2, init_r=0.5,
                 embed_multires=4)
    jgrid = jax_mesh.query_grid(lambda x: js.forward(params, x), 24, 2.0)
    tgrid = mesh.query_grid(ts.forward_query, 24, 2.0).numpy()
    assert (np.sign(jgrid) == np.sign(tgrid)).all() and (jgrid != 0).all()
    jax_extract_surface(SimpleNamespace(out=str(tmp_path / "jax.ply"), **flags))
    out = extract_surface(SimpleNamespace(out=str(tmp_path / "port.ply"), device="cpu",
                                          **flags))
    jv, jf = jax_mesh.read_ply(str(tmp_path / "jax.ply"))
    tv, tf = mesh.read_ply(str(tmp_path / "port.ply"))
    assert len(tf) > 100 and out["n_faces"] == len(tf)
    assert {"grid_s", "triangulate_s", "write_s"} <= set(out)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", ["sphere", "torus", "composite"])
def test_make_gt_mesh_matches_jax(shape, tmp_path):
    def jfn(p):
        if shape == "sphere":
            return jnp.linalg.norm(p, axis=-1) - 0.5
        if shape == "composite":
            return jax_composite_sdf(p, 0.5, xp=jnp)
        R, r = jax_torus_radii(0.5)
        q = jnp.sqrt(p[..., 0] ** 2 + p[..., 2] ** 2) - R
        return jnp.sqrt(q ** 2 + p[..., 1] ** 2) - r
    jax_mesh.extract_mesh(jfn, volume_size=1.5, N=24, filepath=str(tmp_path / "j.ply"))
    make_gt_mesh(shape, 0.5, 24, 1.5, str(tmp_path / "t.ply"), device="cpu")
    jv, jf = jax_mesh.read_ply(str(tmp_path / "j.ply"))
    tv, tf = mesh.read_ply(str(tmp_path / "t.ply"))
    assert len(tf) > 100
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)


@pytest.mark.parametrize("entry", ["make_gt_mesh CLI", "make_gt_mesh", "extract_mesh",
                                   "extract_surface"])
def test_mesh_entry_points_need_a_card_unless_cpu_is_asked(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = str(tmp_path / "m.ply")
    calls = {
        "make_gt_mesh CLI": lambda: make_gt_mesh_cli(["--N", "8", "--out", out]),
        "make_gt_mesh": lambda: make_gt_mesh("sphere", 0.5, 8, 1.5, out),
        "extract_mesh": lambda: mesh.extract_mesh(lambda p: p.norm(dim=-1) - 0.5, N=8,
                                                  filepath=out),
        "extract_surface": lambda: extract_surface(SimpleNamespace(
            load_pt=str(tmp_path / "absent.pt"), out=out)),
    }
    with pytest.raises(RuntimeError, match="--device cpu"):
        calls[entry]()
    assert not os.path.exists(out)


def test_chamfer_and_sampling_match_jax():
    values, _ = _grids()["sphere"]
    v, f = jax_mesh.marching_tetrahedra(values)
    pa = eval_mesh.sample_surface(v, f, 3000)
    assert np.array_equal(pa, jax_eval_mesh.sample_surface(v, f, 3000))
    pb = eval_mesh.sample_surface(v * 1.05, f, 3000, seed=1)
    assert eval_mesh.chamfer_distance(pa, pb) == jax_eval_mesh.chamfer_distance(pa, pb)


def test_psnr_and_decomposition_match_jax():
    rng = np.random.RandomState(5)
    H, W = 12, 16
    gt = rng.rand(H * W, 3)
    pred = np.clip(gt + 0.05 * rng.randn(H * W, 3), -0.1, 1.1)
    mask = np.zeros((H, W), bool)
    mask[3:10, 4:13] = True
    m = mask.reshape(-1)
    assert eval_rgb.psnr(pred, gt) == jax_eval_rgb.psnr(pred, gt)
    assert eval_rgb.psnr(pred, gt, m) == jax_eval_rgb.psnr(pred, gt, m)
    assert np.array_equal(eval_rgb.erode_mask(mask), jax_eval_rgb.erode_mask(mask))
    assert (eval_rgb.masked_psnr_decomposition(pred, gt, m, H, W)
            == jax_eval_rgb.masked_psnr_decomposition(pred, gt, m, H, W))


def _jax_mesh_its(it, i_val_mesh, num_iters):
    """The JAX trainer's mesh-step expression, read from its source."""
    src = open(os.path.join(REPO, "neurecon_tpu", "train.py")).read()
    expr = re.search(r"mesh_its = (sorted\(.*?\)\)\))\n", src, re.S).group(1)
    return eval(expr, {}, {"it": it, "i_val_mesh": i_val_mesh, "num_iters": num_iters,
                           "special_i_val_mesh": [3000, 5000, 7000]})


@pytest.mark.parametrize("it,i_val_mesh,num_iters", [
    (0, 10000, 300000), (25000, 10000, 300000), (0, -1, 1000), (0, 2, 9),
    (4000, 3000, 20000), (7000, 0, 8000), (3, 5, 3)])
def test_mesh_schedule_matches_jax_loop(it, i_val_mesh, num_iters):
    assert train.mesh_steps(it, i_val_mesh, num_iters) == _jax_mesh_its(it, i_val_mesh,
                                                                        num_iters)


def test_flagship_schedule_is_not_refused(tmp_path):
    # nothing of configs/neus.yaml is refused since the overlap sampler was
    # ported: its model and both of its training steps build
    from neurecon_tpu_torch.models.frameworks import get_model, get_pipeline_fns, make_trainer

    args, _ = parse_cli(argv=["--config", os.path.join(REPO, "configs", "neus.yaml")])
    args.data["type"] = "synthetic"
    model, kw, _, _ = get_model(args, "cpu")
    kw["H"], kw["W"] = 120, 160
    assert callable(make_trainer(args, model, kw))
    assert set(get_pipeline_fns(args, model, kw)) == {"draw_step", "depth_sample",
                                                     "loss_with_samples"}
    # 300,000 steps, i_val_mesh 10,000
    steps = train.mesh_steps(0, int(args.training.i_val_mesh), int(args.training.num_iters))
    assert steps[:4] == [3000, 5000, 7000, 10000] and steps[-1] == 300000


def test_train_writes_meshes_at_scheduled_steps(tmp_path):
    """configs/synthetic_smoke.yaml through train.py on the CPU with
    i_val_mesh 2 and mesh_N 24: meshes at steps 2 and 4 (not at 6, the
    last step), each a closed surface of the sphere the init starts from."""
    args, _ = parse_cli(argv=["--config", SMOKE, "--device", "cpu",
                              "--training:num_iters", "6",
                              "--training:log_root_dir", str(tmp_path),
                              "--data:N_rays", "32", "--data:val_downscale", "4",
                              "--training:i_val", "100", "--training:i_log", "2",
                              "--training:i_val_mesh", "2",
                              "--training:monitoring", "none"],
                        extra_args_fn=train._extra_args)
    args.data["mesh_N"] = 24
    out = train.main_function(args)
    mdir = os.path.join(out["exp_dir"], "meshes")
    assert sorted(os.listdir(mdir)) == ["00000002.ply", "00000004.ply"]
    v, f = mesh.read_ply(os.path.join(mdir, "00000004.ply"))
    assert len(f) > 100
    assert abs(np.linalg.norm(v, axis=-1).mean() - 0.5) < 0.05
    assert out["stats"]["perf"]["mesh_sec"]


def _staged_cfg():
    return {
        "expname": "staged", "data": {"type": "synthetic", "downscale": 1, "n_images": 2,
                                      "H": 24, "W": 32, "val_rayschunk": 512},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0, "variance_init": 0.05,
                  "W_geometry_feature": 32, "N_samples": 16, "N_importance": 16,
                  "N_upsample_iters": 2,
                  "surface": {"D": 2, "W": 32, "skips": [], "radius_init": 0.5,
                              "embed_multires": 2},
                  "radiance": {"D": 1, "W": 32, "skips": [], "embed_multires": -1,
                               "embed_multires_view": -1}},
        "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": 5e-4},
    }


def test_eval_staged_matches_jax(tmp_path):
    """Two JAX checkpoints through both packages' eval_staged against a GT
    sphere mesh made by the port's make_gt_mesh: the same rows, PSNR within
    0.05 dB (the det-plateau sample moves of the upsampler) and Chamfer
    within 1e-3 (two meshes from grids that agree but for rounding)."""
    jm, *_ = jax_get_model(JaxConfigDict(_staged_cfg()))
    ckpts = []
    for seed in (0, 1):
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
        params["ln_s"] = np.asarray([0.3], np.float32)
        ckpts.append(JaxCheckpointIO(str(tmp_path)).save(f"{seed}.pt", 100 * (seed + 1),
                                                         model=params))
    gt = str(tmp_path / "gt.ply")
    make_gt_mesh("sphere", 0.5, 32, 1.5, gt, device="cpu")
    kw = dict(gt_mesh=gt, n_eval=1, rayschunk=512, mesh_N=24, n_samples=2000)
    want = jax_evaluate_ckpts(JaxConfigDict(_staged_cfg()), ckpts, microchunk=0, **kw)
    got = evaluate_ckpts(ConfigDict(_staged_cfg()), ckpts, device="cpu",
                         out_path=str(tmp_path / "rows.jsonl"), **kw)
    assert len(got) == 2 and len(open(tmp_path / "rows.jsonl").readlines()) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"] and g["ckpt"] == w["ckpt"]
        for k in ("psnr", "psnr_min", "psnr_max", "psnr_masked", "psnr_interior"):
            assert abs(g[k] - w[k]) < 0.05, (k, g[k], w[k])
        assert abs(g["chamfer"] - w["chamfer"]) < 1e-3

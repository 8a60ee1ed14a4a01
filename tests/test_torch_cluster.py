"""Surfaces wider than 512 (the kernels' cluster tile, `csrc/surface_mma.cuh`:
a pair of wide blocks on one tile, each holding half of every layer's rows),
on the CPU: the plain versions that kernels 1, 3 and 4 are held to on the
card, against the JAX package at W=1024 on seeded inputs; configs/neus_w1024.yaml
in both packages and in chip_smoke.py; `render_view --microchunk`.

Tolerances, each max|diff| / max|ref| per output or gradient leaf: 2e-4, the
JAX package's own bound between its kernel and its plain path (fp32 sums in
another order on each side), as tests/test_torch_wide.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
from neurecon_tpu.ops.fused_mlp import fused_sdf_forward as jax_fused_sdf_forward
from neurecon_tpu.ops.fused_nablas import fused_forward_with_nablas as jax_fused_nablas

from neurecon_tpu_torch import bridge, train
from neurecon_tpu_torch.config import ConfigDict, parse_cli
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import get_model
from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, surface_pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W1024_YAML = os.path.join(REPO, "configs", "neus_w1024.yaml")
# a shallow surface at the cluster tile's widest (D=3 keeps the CPU run short)
WIDE3 = dict(W=1024, D=3, skips=(1,), W_geo_feat=256, embed_multires=6, radius_init=0.5)
TOL = 2e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _pair(cfg=WIDE3, seed=0):
    """The JAX surface and the port's with the same weights: the JAX init
    plus seeded noise on every weight (the init zeroes the octave columns)."""
    js = JaxSurface(weight_norm=True, **cfg)
    params = jax.jit(js.init)(jax.random.PRNGKey(seed))
    ts = ImplicitSurface(weight_norm=True, **cfg)
    bridge._load_layers(ts.layers, jax.tree_util.tree_map(np.asarray, params),
                        "implicit_surface")
    perturb_parameters(ts, torch.Generator().manual_seed(seed + 1))
    params = jax.tree_util.tree_map(jnp.asarray, bridge._layers_to_tree(ts.layers))
    return js, params, ts


def _points(n, seed=1):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * 0.6


def test_surface_outputs_match_the_jax_kernels_at_w1024():
    """The plain versions of kernels 1 and 4 against the JAX Pallas kernels
    in interpret mode (96 points on tiles of 64: a ragged last tile), at
    W=1024 on the cluster tile's pack."""
    js, params, ts = _pair()
    assert surface_pack.pack(ts).kind == surface_pack.CLUSTER
    x = _points(96)
    want = jax_fused_nablas(js, params, jnp.asarray(x), tile=64, interpret=True)
    with torch.no_grad():
        got = fused_nablas.forward_with_nablas_plain(ts, torch.tensor(x))
        sdf = fused_mlp.sdf_forward_plain(ts, torch.tensor(x))
    for name, a, b in zip(("sdf", "nablas", "h"), got, want):
        assert a.shape == b.shape and _rel(a.numpy(), b) < TOL, (name, _rel(a.numpy(), b))
    want_sdf = jax_fused_sdf_forward(js, params, jnp.asarray(x), tile=64, interpret=True)
    assert _rel(sdf.numpy(), want_sdf) < TOL


def _loss_terms(sdf, nablas, h, xp):
    """sdf, the eikonal term on nablas (the grad-of-grad path) and an
    rgb-like term on h (tests/test_torch_vjp.py)."""
    if xp is jnp:
        eik = jnp.mean((jnp.linalg.norm(nablas, axis=-1) - 1.0) ** 2)
    else:
        eik = torch.mean((torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2)
    return xp.mean(xp.tanh(sdf) ** 2) + eik + xp.mean(xp.sin(3.0 * h[..., :8]))


def test_eikonal_gradient_tree_matches_jax_at_w1024():
    """The port's differentiable surface op (its plain backward on the CPU,
    what kernel 3 is held to) against jax.grad of the JAX surface at W=1024,
    D=3: outputs, every weight-norm leaf's gradient and x's."""
    js, params, ts = _pair()
    x = _points(128, seed=2)
    xt = torch.tensor(x, requires_grad=True)
    out = ts.forward_with_nablas(xt)
    loss = _loss_terms(*out, torch)
    loss.backward()
    tree = {"layers": [{n: getattr(layer, n).grad.numpy() for n in ("v", "g", "b")}
                       for layer in ts.layers]}

    def jloss(p, x_):
        return _loss_terms(*js.forward_with_nablas(p, x_), jnp)
    outs_j = jax.jit(js.forward_with_nablas)(params, jnp.asarray(x))
    val, (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, jnp.asarray(x))
    assert abs(loss.item() - float(val)) <= 1e-5 * abs(float(val))
    for a, b in zip(out, outs_j):
        assert _rel(a.detach().numpy(), b) < TOL
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gp),
                            jax.tree_util.tree_leaves(tree)):
        assert _rel(b, a) < TOL, (jax.tree_util.keystr(path), _rel(b, a))
    assert _rel(xt.grad.numpy(), gx) < TOL


def test_w1024_model_builds_from_the_yaml_on_both_sides():
    """configs/neus_w1024.yaml builds in the JAX package and in the port with
    the same parameter tree (surface layers 39 -> 1024, ..., the skip layer's
    1024 - 39 outputs, 1024 -> 257; the radiance net at 512) and a cluster
    pack; JAX's init loads into the port; the file is neus_w512.yaml with
    the surface width and expname changed, and chip_smoke.py's copy is the
    file."""
    import chip_smoke
    with open(W1024_YAML) as f:
        w1024 = yaml.safe_load(f)
    jm, *_ = jax_get_model(JaxConfigDict(w1024))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    args, _ = parse_cli(argv=["--config", W1024_YAML], extra_args_fn=train._extra_args)
    tm, *_ = get_model(args, "cpu")
    bridge.load_tree(tm, params)
    mine = bridge.model_to_tree(tm)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)
    s = tm.implicit_surface
    assert [tuple(d) for d in s.dims] == ([(39, 1024)] + [(1024, 1024)] * 2 + [(1024, 985)]
                                          + [(1024, 1024)] * 4 + [(1024, 257)])
    assert tm.radiance_net.W == 512
    lay = surface_pack.layout(s)
    assert lay["tile"] == surface_pack.CLUSTER and lay["rows"] == 1024
    with open(os.path.join(REPO, "configs", "neus_w512.yaml")) as f:
        w512 = yaml.safe_load(f)
    w512["model"]["surface"]["W"] = 1024
    w512["expname"] = w1024["expname"]
    assert w512 == w1024
    assert chip_smoke.NEUS_W1024 == w1024
    cfg, cuts = chip_smoke.cluster_train_config("/tmp/unused", 0)
    assert cfg["model"] == w1024["model"]


def _smoke_ckpt(tmp_path):
    """configs/synthetic_smoke.yaml at small widths with seeded noise on
    every weight, saved as a checkpoint; returns (config dict, its path)."""
    from neurecon_tpu_torch.utils.checkpoints import CheckpointIO
    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"].update({"H": 12, "W": 16, "n_images": 2})
    cfg["model"].update({"N_samples": 8, "N_importance": 8, "N_upsample_iters": 2})
    cfg["model"]["surface"]["W"] = cfg["model"]["radiance"]["W"] = 64
    cfg["training"]["exp_dir"] = str(tmp_path)
    tm, *_ = get_model(ConfigDict(cfg), "cpu")
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    path = CheckpointIO(str(tmp_path)).save("latest.pt", 3, model=bridge.model_to_tree(tm))
    return cfg, path


def test_render_view_microchunk_gives_the_same_frame(tmp_path):
    """render_view with --microchunk 16 (each 64-ray chunk in four blocks)
    renders the frame that it renders without it; the flag parses, and a
    chunk that is no multiple of it is refused."""
    from neurecon_tpu_torch.tools import render_view
    cfg, path = _smoke_ckpt(tmp_path)
    frames = {}
    for micro in (0, 16):
        args = ConfigDict(cfg)
        args.update({"load_pt": path, "num_views": 1, "camera_path": "interpolation",
                     "camera_inds": "0,1", "rayschunk": 64, "microchunk": micro})
        frames[micro] = render_view.render_frames(args, device="cpu")
    for k in ("rgb", "depth", "normal"):
        assert np.isfinite(frames[16][k]).all()
        np.testing.assert_allclose(frames[16][k], frames[0][k], rtol=0, atol=1e-6)
    opts, _ = parse_cli(argv=["--config", os.path.join(REPO, "configs", "synthetic_smoke.yaml"),
                              "--microchunk", "512"], extra_args_fn=render_view._extra_args)
    assert opts.microchunk == 512
    args = ConfigDict(cfg)
    args.update({"load_pt": path, "num_views": 1, "camera_path": "interpolation",
                 "camera_inds": "0,1", "rayschunk": 64, "microchunk": 24})
    with pytest.raises(ValueError):
        render_view.render_frames(args, device="cpu")


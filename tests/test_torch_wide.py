"""Surfaces wider than 256 (the kernels' wide tile, `csrc/surface_mma.cuh`),
on the CPU: the port against the JAX package at IDR's width (W=512, D=8, skip
4, 256 geometry features; configs/neus_w512.yaml) on seeded inputs, the
pack's layout and refusals at the wide widths (and the cluster tile's, past
512, up to 1024), chip_smoke.py's copy of the
config, the wide mutants of tools/mutants.py, and the module gaps of the
port's utilities (a checkpoint loaded from a URL, `Logger.add_figure`).

Tolerances, each max|diff| / max|ref| per output or gradient leaf:
- sdf, h and nablas against the JAX Pallas kernels in interpret mode and
  against the JAX surface: 2e-4, the JAX package's own bound between its
  kernel and its plain path (fp32 sums in another order on each side);
- the eikonal gradient tree: 2e-4, as tests/test_torch_vjp.py;
- the NeuS ray loss: rel 1e-5 per term; its gradients: 5e-4 per leaf, the
  JAX package's full-step bound, as tests/test_torch_train.py.
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
from neurecon_tpu_torch.config import parse_cli
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import get_model
from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, surface_pack
from neurecon_tpu_torch.utils.checkpoints import CheckpointIO
from neurecon_tpu_torch.utils.logger import Logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W512_YAML = os.path.join(REPO, "configs", "neus_w512.yaml")
IDR = dict(W=512, D=8, skips=(4,), W_geo_feat=256, embed_multires=6, radius_init=0.5)
TOL = 2e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _pair(cfg=IDR, seed=0):
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


def test_surface_outputs_match_the_jax_kernels_at_w512():
    """The plain versions that kernels 1 and 4 are held to on the card,
    against the JAX Pallas kernels in interpret mode (96 points on tiles of
    64: a ragged last tile), at W=512."""
    js, params, ts = _pair()
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


def test_eikonal_gradient_tree_matches_jax_at_w512():
    """The port's differentiable surface op (its plain backward on the CPU,
    what kernel 3 is held to) against jax.grad of the JAX surface at W=512:
    outputs, every weight-norm leaf's gradient and x's."""
    js, params, ts = _pair()
    x = _points(200, seed=2)
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


def _w512_cfg():
    """configs/neus_w512.yaml's networks on the synthetic scene: 8 rays,
    16 + 16 samples (tests/test_torch_train.py's cut)."""
    with open(W512_YAML) as f:
        model = yaml.safe_load(f)["model"]
    return {
        "expname": "torch_wide",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24, "W": 32,
                 "N_rays": 8, "val_rayschunk": 256, "obj_bounding_radius": 1.0},
        "model": dict(model, N_samples=16, N_importance=16, N_upsample_iters=2,
                      perturb=False),
        "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": 5e-4, "num_iters": 20,
                     "scheduler": {"type": "warmupcosine", "warmup_steps": 5}},
    }


def test_neus_ray_loss_and_grads_match_jax_at_w512():
    """One NeuS ray loss on 8 rays at IDR's widths (surface and radiance
    W=512) and its full gradient tree, against the JAX package on the same
    rays and samples (tests/test_torch_train.py's comparison)."""
    from test_torch_train import _setup
    from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn

    jargs, jm, jkw, params, targs, tm, tkw, rb, rb_t, key, d_all = _setup(_w512_cfg(), True)
    assert tm.implicit_surface.W == 512 and tm.radiance_net.W == 512
    j_loss = jax_ray_loss_fn(jm, jargs, jkw)
    (_, (want, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 0, d_all=d_all), has_aux=True))(params)
    total, (got, _) = get_ray_loss_fn(targs, tm, tkw)(rb_t, d_all=torch.tensor(np.asarray(d_all)))
    total.backward()
    for k in want:
        assert abs(got[k].item() - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(bridge.grads_to_tree(tm))):
        assert _rel(b, a) < 5e-4, (jax.tree_util.keystr(path), _rel(b, a))


def test_idr_model_builds_from_the_yaml_on_both_sides():
    """configs/neus_w512.yaml builds in the JAX package and in the port with
    the same parameter tree, IDR's surface layers (39 -> 512, ..., the skip
    layer's 512 - 39 outputs, 512 -> 257) and a wide pack; JAX's init loads
    into the port."""
    with open(W512_YAML) as f:
        jm, *_ = jax_get_model(JaxConfigDict(yaml.safe_load(f)))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    args, _ = parse_cli(argv=["--config", W512_YAML], extra_args_fn=train._extra_args)
    tm, *_ = get_model(args, "cpu")
    bridge.load_tree(tm, params)
    mine = bridge.model_to_tree(tm)
    assert (jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(params)):
        assert a.shape == b.shape and np.array_equal(a, b)
    s = tm.implicit_surface
    assert [tuple(d) for d in s.dims] == ([(39, 512)] + [(512, 512)] * 2 + [(512, 473)]
                                          + [(512, 512)] * 4 + [(512, 257)])
    assert surface_pack.layout(s)["wide"] and not surface_pack.layout(
        ImplicitSurface(**dict(IDR, W=256)))["wide"]


@pytest.mark.parametrize("W,geo,rows,tile", [
    (300, 256, 304, "wide"), (384, 256, 384, "wide"), (512, 256, 512, "wide"),
    (256, 300, 256, "wide"), (256, 256, 256, "narrow"), (520, 256, 520, "cluster"),
    (640, 256, 640, "cluster"), (1024, 256, 1024, "cluster"), (256, 520, 256, "cluster")],
    ids=["W300", "W384", "W512", "geo300", "W256", "W520", "W640", "W1024", "geo520"])
def test_layout_at_wide_widths(W, geo, rows, tile):
    """The pack at the flagship depth: K and N padded to 8, blocks at
    multiples of 32 floats in order, `rows` the widest padded hidden K or N,
    and the wide tile for a padded hidden width past 256 or final-layer rows
    past 264 (W_geo 300: 301 rows), the cluster tile past 512 (W=520, the
    first padded width past it; W_geo 520: 521 rows), the narrow tiles at
    W=256."""
    s = ImplicitSurface(**dict(IDR, W=W, W_geo_feat=geo))
    lay = surface_pack.layout(s)
    pad = surface_pack.pad8
    assert surface_pack.TILE_NAMES[lay["tile"]] == tile and lay["rows"] == rows
    assert lay["wide"] == (tile == "wide")
    assert lay["c_pad"] == 40
    off = 0
    for l, (rec, (i, o)) in enumerate(zip(lay["records"], s.dims)):
        K, N, out, inp, off_wT, off_w, off_b, skip = rec
        assert (K, N, out, inp, skip) == (pad(i), pad(o), o, i, int(l == 4))
        assert off_wT == off and off_wT % 32 == off_w % 32 == off_b % 32 == 0
        assert off_wT + K * N <= off_w and off_w + N * K <= off_b and off_b + N <= lay["size"]
        off = (off_b + N + 31) // 32 * 32
    assert off == lay["size"]
    assert lay["records"][3][1] == pad(W - 39) and lay["records"][4][0] == pad(W)
    assert lay["records"][-1][:3] == [pad(W), pad(geo + 1), geo + 1]
    pk = surface_pack.pack(s)
    assert pk.kind == lay["tile"] and pk.wide == lay["wide"]
    assert pk.tile == (128 if tile == "narrow" else 64)
    assert pk.blocks_per_tile == (2 if tile == "cluster" else 1)


def test_kernel1_counts_launches_by_tile_names():
    """`fused_forward_with_nablas.launches_by_tile` is keyed by the pack's tile
    names, and a CPU call (the plain version) counts no launch."""
    from neurecon_tpu_torch.ops import fused_nablas
    fn = fused_nablas.fused_forward_with_nablas
    assert tuple(fn.launches_by_tile) == surface_pack.TILE_NAMES
    before, by_tile = fn.launches, dict(fn.launches_by_tile)
    s = ImplicitSurface(W=16, D=2, skips=[], W_geo_feat=4, radius_init=0.5, embed_multires=2)
    sdf, nablas, h = fn(s, torch.zeros(5, 3))
    assert sdf.shape == (5,) and nablas.shape == (5, 3) and h.shape == (5, 4)
    assert fn.launches == before and fn.launches_by_tile == by_tile


@pytest.mark.parametrize("cfg", [dict(IDR, W=1025), dict(IDR, W_geo_feat=1032),
                                 dict(IDR, W=1040)], ids=["W1025", "geo1032", "W1040"])
def test_layout_refuses_past_1024(cfg):
    """A padded hidden width or final-layer rows past 1024 raise
    NotImplementedError, with the limit in the message (W=1025 pads to
    1032)."""
    with pytest.raises(NotImplementedError, match="<= 1024"):
        surface_pack.layout(ImplicitSurface(**cfg))


def test_chip_smoke_neus_w512_is_the_file():
    """chip_smoke.py's phase 41 trains configs/neus_w512.yaml as the file
    holds it (the card machine has no PyYAML), and the file is
    configs/neus.yaml with the two widths and expname changed."""
    import chip_smoke
    with open(W512_YAML) as f:
        w512 = yaml.safe_load(f)
    assert chip_smoke.NEUS_W512 == w512
    with open(os.path.join(REPO, "configs", "neus.yaml")) as f:
        neus = yaml.safe_load(f)
    neus["model"]["surface"]["W"] = neus["model"]["radiance"]["W"] = 512
    neus["expname"] = w512["expname"]
    assert neus == w512
    cfg, cuts = chip_smoke.wide_train_config("/tmp/unused", 0)
    assert cfg["model"] == w512["model"] and dict(cuts)["training.num_iters"] == 40


@pytest.mark.parametrize("group", ["MUTANTS", "SINE_MUTANTS", "NABLAS_MUTANTS",
                                   "UPSAMPLE_MUTANTS", "SAMPLER_MUTANTS", "WIDE_MUTANTS",
                                   "CLUSTER_MUTANTS"])
def test_kernel_mutants_each_edit_one_place(group):
    """Every mutant of tools/mutants.py's kernel groups names a text that
    occurs exactly once in its file (the tool refuses any other)."""
    from neurecon_tpu_torch.tools import mutants
    for name, mutant in getattr(mutants, group).items():
        edits = mutants.edits_of(mutant)
        assert edits, name
        for fname, text, repl in edits:
            source = (mutants.PACKAGE / fname).read_text()
            assert source.count(text) == 1, (name, fname)
            assert text != repl, name


def test_checkpoint_loads_from_a_file_url(tmp_path):
    """CheckpointIO.load_file takes a `scheme://` name as the JAX package
    does: fetched once into <ckpt_dir>/_zoo under a hash of the whole URL,
    then read from there; two URLs with one basename do not collide."""
    src = CheckpointIO(str(tmp_path / "a"))
    path_a = src.save("latest.pt", 7, model={"w": np.arange(3, dtype=np.float32)})
    path_b = CheckpointIO(str(tmp_path / "b")).save(
        "latest.pt", 9, model={"w": np.zeros(2, np.float32)})
    io = CheckpointIO(str(tmp_path / "run"))
    got = io.load_file("file://" + path_a)
    assert got["global_step"] == 7 and np.array_equal(got["model"]["w"], np.arange(3))
    zoo = tmp_path / "run" / "_zoo"
    assert len(list(zoo.iterdir())) == 1
    os.remove(path_a)  # the second load reads the cached copy
    assert io.load_file("file://" + path_a)["global_step"] == 7
    assert io.load_file("file://" + path_b)["global_step"] == 9
    assert sorted(p.name.split("_", 1)[1] for p in zoo.iterdir()) == ["latest.pt"] * 2
    assert not any(p.suffix == ".part" for p in zoo.iterdir())


def test_logger_add_figure(tmp_path):
    """Logger.add_figure writes the figure's RGB pixels under imgs/<class>
    and closes it; a logger that does not write only closes it."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    lg = Logger(str(tmp_path / "logs"))
    fig = plt.figure(figsize=(2, 1), dpi=50)
    plt.plot([0, 1], [1, 0])
    lg.add_figure(fig, "curve", 3)
    files = os.listdir(tmp_path / "logs" / "imgs" / "curve")
    assert files in (["00000003_0.png"], ["00000003_0.npy"])
    assert not plt.fignum_exists(fig.number)
    fig2 = plt.figure()
    Logger(str(tmp_path / "quiet"), writes=False).add_figure(fig2, "curve", 0)
    assert not plt.fignum_exists(fig2.number)
    assert not os.path.exists(tmp_path / "quiet")

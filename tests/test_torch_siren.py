"""The port's SIREN networks and the sine branch of its surface-MLP kernels'
plain versions against the JAX package, on the CPU: the same weights (the
JAX init, copied through `bridge`, or that init with seeded noise on every
weight) and the same numpy inputs.

The plain versions are what the CUDA kernels are held to on a card
(`tests/test_torch_cuda.py`, `chip_smoke.py` phase 18); here each is held to
the JAX Pallas kernel of the same function in interpret mode, built with
`use_siren`: kernel 4 (`fused_mlp`), kernel 1 (`fused_nablas`), kernel 3
(`fused_nablas_vjp`) and kernel 2 (`fused_upsample`)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.base import pretrain_siren_sdf as jax_pretrain
from neurecon_tpu.models.frameworks.neus import NeuS as JaxNeuS
from neurecon_tpu.models.frameworks.volsdf import VolSDF as JaxVolSDF
from neurecon_tpu.ops import near_far_from_sphere as jax_near_far
from neurecon_tpu.ops.fused_mlp import fused_sdf_forward as jax_fused_sdf
from neurecon_tpu.ops.fused_nablas import fused_forward_with_nablas as jax_fused_nablas
from neurecon_tpu.ops.fused_nablas_vjp import fused_forward_with_nablas_vjp
from neurecon_tpu.ops.fused_upsample import fused_neus_upsample as jax_fused_upsample

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import (ImplicitSurface, init_siren, perturb_parameters,
                                            pretrain_siren_sdf)
from neurecon_tpu_torch.models.frameworks.neus import NeuS
from neurecon_tpu_torch.models.frameworks.volsdf import VolSDF
from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, fused_upsample
from neurecon_tpu_torch.ops import surface_pack

SURFACE = dict(D=3, W=64, skips=[], radius_init=0.5, embed_multires=-1, use_siren=True)
RADIANCE = dict(D=2, W=64, skips=[], embed_multires=-1, embed_multires_view=2,
                use_siren=True)
GEO = 64


@functools.lru_cache(maxsize=None)
def _jax_init(seed, weight_norm):
    """The JAX NeuS with SIREN nets and its init (numpy leaves), made once
    per seed: the init's compile is most of a test's time otherwise."""
    surf = dict(SURFACE, weight_norm=weight_norm)
    rad = dict(RADIANCE, weight_norm=weight_norm)
    jm = JaxNeuS(W_geo_feat=GEO, surface_cfg=surf, radiance_cfg=rad)
    return jm, jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def _pair(seed=0, perturb=False, weight_norm=True):
    """A JAX NeuS and the port's with SIREN nets and the same weights: the
    JAX init, or (`perturb`) that init with seeded noise on every weight."""
    jm, init = _jax_init(seed, weight_norm)
    params = jax.tree_util.tree_map(jnp.asarray, init)
    tm = NeuS(W_geo_feat=GEO, surface_cfg=dict(SURFACE, weight_norm=weight_norm),
              radiance_cfg=dict(RADIANCE, weight_norm=weight_norm))
    bridge.load_tree(tm, init)
    if perturb:
        perturb_parameters(tm, torch.Generator().manual_seed(seed + 1))
        params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jm, params, tm


def _points(n, seed=1, scale=0.6):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * scale


def _rel(a, b):
    """max|a - b| / max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


# fp32 on both sides, sums in another order: ~1e-7 relative per product,
# which sin(30 a) scales by 30 at each layer; 1e-5 of max|ref| holds it
REL = 1e-5


@pytest.mark.parametrize("perturb", [False, True])
def test_surface_forward_matches_jax(perturb):
    jm, params, tm = _pair(perturb=perturb)
    x = _points(512)
    sdf_j, h_j = jm.implicit_surface.forward(params["implicit_surface"], jnp.asarray(x),
                                             return_h=True)
    with torch.no_grad():
        sdf_t, h_t = tm.implicit_surface(torch.tensor(x), return_h=True)
    assert _rel(sdf_t, sdf_j) < REL and _rel(h_t, h_j) < REL
    assert np.abs(np.asarray(sdf_j)).max() > 0.05  # not a degenerate net


@pytest.mark.parametrize("perturb", [False, True])
def test_radiance_forward_matches_jax(perturb):
    jm, params, tm = _pair(perturb=perturb)
    rng = np.random.RandomState(2)
    x, v, n = (rng.randn(300, 3).astype(np.float32) for _ in range(3))
    g = rng.randn(300, GEO).astype(np.float32)
    want = jm.radiance_net.forward(params["radiance_net"], *map(jnp.asarray, (x, v, n, g)))
    with torch.no_grad():
        got = tm.radiance_net(*map(torch.tensor, (x, v, n, g)))
    assert _rel(got, want) < REL


def test_siren_layers_refuse_skips():
    with pytest.raises(ValueError, match="skips"):
        ImplicitSurface(**dict(SURFACE, skips=[1]), W_geo_feat=GEO)


def test_init_siren_bounds():
    """The first layer's weights in U(±1/in), the others' in U(±sqrt(6/in)/30),
    biases as nn.Linear's default, spread over the whole range."""
    gen = torch.Generator().manual_seed(0)
    for in_dim, first, bound in ((3, True, 1 / 3), (256, False, np.sqrt(6 / 256) / 30)):
        w, b = init_siren(in_dim, 256, first, gen)
        assert w.abs().max() <= bound and w.abs().max() > 0.95 * bound
        assert b.abs().max() <= 1 / np.sqrt(in_dim) and b.abs().max() > 0.9 / np.sqrt(in_dim)
    s = ImplicitSurface(**SURFACE, W_geo_feat=GEO)
    s.reset_parameters(torch.Generator().manual_seed(0))
    w0 = fused_nablas.effective_weight(s.layers[0]).detach()
    assert w0.abs().max() <= 1 / 3 + 1e-6  # weight norm: w = g v / |v| = v at init


# ---- the kernels' plain versions, sine branch, against the JAX kernels


@pytest.mark.parametrize("perturb", [False, True])
def test_sdf_forward_plain_matches_jax_kernel_interpret(perturb):
    """Kernel 4 (the sdf-only forward): the port's wrapper on CPU tensors
    (its plain version) against JAX `fused_sdf_forward` in interpret mode;
    200 points on tiles of 128 (a ragged last tile)."""
    jm, params, tm = _pair(perturb=perturb)
    x = _points(200, seed=3, scale=1.0)
    want = jax_fused_sdf(jm.implicit_surface, params["implicit_surface"], jnp.asarray(x),
                         tile=128, interpret=True)
    got = fused_mlp.fused_sdf_forward(tm.implicit_surface, torch.tensor(x))
    assert _rel(got, want) < REL


@pytest.mark.parametrize("perturb", [False, True])
def test_forward_with_nablas_plain_matches_jax_kernel_interpret(perturb):
    """Kernel 1 (forward + nablas): the plain version against JAX
    `fused_forward_with_nablas` in interpret mode; sdf and h within 1e-5 of
    max|ref|, nablas at the JAX nablas kernel's own rtol 2e-3 / atol 2e-4
    (with 30 cos(30 a) slopes, |nablas| reaches tens)."""
    jm, params, tm = _pair(perturb=perturb)
    x = _points(128, seed=4)
    want = jax_fused_nablas(jm.implicit_surface, params["implicit_surface"], jnp.asarray(x),
                            tile=128, interpret=True)
    got = fused_nablas.fused_forward_with_nablas(tm.implicit_surface, torch.tensor(x))
    assert _rel(got[0], want[0]) < REL and _rel(got[2], want[2]) < REL
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-3, atol=2e-4)


def _loss_terms(sdf, nablas, h, xp):
    """sdf directly, the eikonal term on nablas (the grad-of-grad path) and
    an rgb-like term on h (tests/test_fused_nablas_vjp.py:_loss_terms)."""
    if xp is jnp:
        eik = jnp.mean((jnp.linalg.norm(nablas, axis=-1) - 1.0) ** 2)
    else:
        eik = torch.mean((torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2)
    return xp.mean(xp.tanh(sdf) ** 2) + eik + xp.mean(xp.sin(3.0 * h[..., :8]))


@pytest.mark.parametrize("perturb", [False, True])
def test_nablas_vjp_plain_matches_jax_kernel_interpret(perturb):
    """Kernel 3 (the eikonal backward, phi'' = -900 sin(30 a)): the grads of
    a loss on every output through the port's op (its plain backward on the
    CPU) against the JAX custom-VJP Pallas op in interpret mode; 37 points on
    tiles of 32. Every leaf within 2e-4 of its max|ref|, the JAX package's
    own bound (tests/test_fused_nablas_vjp.py)."""
    jm, params, tm = _pair(perturb=perturb)
    surf = tm.implicit_surface
    x = _points(37, seed=5, scale=0.5)
    js = jm.implicit_surface

    def loss(p, x_):
        return _loss_terms(*fused_forward_with_nablas_vjp(js, p, x_, tile=32, interpret=True),
                           jnp)
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        params["implicit_surface"], jnp.asarray(x))
    surf.zero_grad(set_to_none=True)
    xt = torch.tensor(x, requires_grad=True)
    got = _loss_terms(*surf.forward_with_nablas(xt), torch)
    got.backward()
    assert abs(got.item() - float(val)) <= 1e-5 * abs(float(val))
    tree = {"layers": [{n: getattr(layer, n).grad.numpy() for n in ("v", "g", "b")}
                       for layer in surf.layers]}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(gp),
                            jax.tree_util.tree_leaves(tree)):
        assert _rel(b, a) < 2e-4, (jax.tree_util.keystr(path), _rel(b, a))
    assert _rel(xt.grad, gx) < 2e-4


def test_plain_backward_matches_torch_double_backward():
    """The hand derivation's sine branch against torch's create_graph
    autograd of the same MLP (no JAX), on every cotangent at once."""
    ts = ImplicitSurface(**SURFACE, W_geo_feat=GEO)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    perturb_parameters(ts, torch.Generator().manual_seed(1))
    x = torch.tensor(_points(50, seed=6))
    rng = np.random.RandomState(7)
    cots = [torch.tensor(rng.randn(*s).astype(np.float32))
            for s in ((50,), (50, 3), (50, GEO))]
    ws, bs = [[t.detach().requires_grad_(True) for t in ts_] for ts_ in
              fused_nablas.surface_weights(ts)]
    xg = x.clone().requires_grad_(True)
    sdf, h = ts.mlp(xg, (ws, bs))
    (nab,) = torch.autograd.grad(sdf.sum(), xg, create_graph=True)
    total = (sdf * cots[0]).sum() + (nab * cots[1]).sum() + (h * cots[2]).sum()
    want = torch.autograd.grad(total, [xg, *ws, *bs])
    got_x, got_w, got_b = fused_nablas_vjp.nablas_vjp_plain(
        ts, x, [w.detach() for w in ws], [b.detach() for b in bs], *cots)
    for g, w in zip([got_x, *got_w, *got_b], want):
        assert _rel(g, w) < 1e-4


def test_upsample_plain_matches_jax_kernel_interpret():
    """Kernel 2 (the NeuS upsampler) with a D=3 SIREN surface in NeuS (no
    config pairs them; the kernel's sine branch comes with kernel 1's
    header): the port's plain version against JAX `fused_neus_upsample` in
    interpret mode on the same sorted uniforms; samples agree but for rare
    ulp-level cdf ties (the JAX kernel test's 0.5%)."""
    jm, params, tm = _pair(perturb=True)
    rng = np.random.RandomState(0)
    n = 48
    th = rng.uniform(-0.35, 0.35, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape))
    near, far = jax_near_far(jnp.asarray(o), jnp.asarray(d), r=1.0)
    t = jnp.linspace(0.0, 1.0, 64)
    dc = np.asarray(near * (1 - t) + far * t)
    u = np.sort(rng.uniform(0, 1, (n, 4, 16)), -1).reshape(n, 64).astype(np.float32)
    want = np.asarray(jax_fused_upsample(jm.implicit_surface, params["implicit_surface"],
                                         jnp.asarray(o), jnp.asarray(d), jnp.asarray(dc),
                                         jnp.asarray(u), n_iters=4, n_per_iter=16, tile=16,
                                         interpret=True))
    got = fused_upsample.fused_neus_upsample(tm.implicit_surface, torch.tensor(o),
                                             torch.tensor(d), torch.tensor(dc),
                                             torch.tensor(u), n_iters=4,
                                             n_per_iter=16).numpy()
    span = float(dc.max() - dc.min())
    assert got.shape == want.shape == (n, 128) and np.isfinite(got).all()
    assert (np.abs(got - want) > 1e-4 * span).mean() < 5e-3
    assert np.all(np.diff(got, axis=-1) >= 0)


# ---- the pack, the bridge and the pretrain


def test_pack_takes_the_siren_shapes_and_carries_the_activation():
    """configs/volsdf_siren.yaml's surface (D=5, W=256, no skips, no
    encoding) is inside the tensor-core pack's limits; the pack says sine,
    and the activation is part of the pack cache's key."""
    s = ImplicitSurface(D=5, W=256, skips=[], W_geo_feat=256, embed_multires=-1,
                        use_siren=True)
    s.reset_parameters(torch.Generator().manual_seed(0))
    lay = surface_pack.layout(s)
    assert (lay["c_pad"], lay["rows"]) == (8, 256)
    assert [r[:4] for r in lay["records"]] == [[8, 256, 256, 3]] + [[256, 256, 256, 256]] * 4 \
        + [[256, 264, 257, 256]]
    assert not any(r[7] for r in lay["records"])
    packed = surface_pack.packed_surface(s)
    assert packed.act == fused_nablas.ACT_SINE == fused_nablas.activation_code(s)
    s.use_siren = False  # the same weights under Softplus: another pack
    other = surface_pack.packed_surface(s)
    assert other is not packed and other.act == fused_nablas.ACT_SOFTPLUS
    s.skips = (2,)
    s.use_siren = True
    with pytest.raises(ValueError, match="SIREN"):
        surface_pack.layout(s)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_bridge_round_trips_siren_trees(weight_norm):
    """A JAX VolSDF with SIREN nets: its pytree (v/g/b under weight norm,
    else w/b) into the port and back, bit for bit."""
    surf = dict(SURFACE, weight_norm=weight_norm)
    rad = dict(RADIANCE, weight_norm=weight_norm)
    jm = JaxVolSDF(W_geo_feat=GEO, surface_cfg=surf, radiance_cfg=rad)
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(3)))
    tm = VolSDF(W_geo_feat=GEO, surface_cfg=surf, radiance_cfg=rad)
    bridge.load_tree(tm, tree)
    back = bridge.model_to_tree(tm)
    names = ("v", "g", "b") if weight_norm else ("w", "b")
    assert set(back["implicit_surface"]["layers"][0]) == set(names)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for (path, a), b in zip(flat_a, flat_b):
        assert a.shape == b.shape and np.array_equal(a, b), jax.tree_util.keystr(path)


def test_pretrain_matches_jax_on_its_points():
    """20 iterations of the SIREN sphere pretrain on the points JAX draws
    (`jax.random.split(key, num_iters)`, then a uniform per key, as JAX's
    scan does), fed through the port's `points` seam: the L1 loss at every
    iteration to rel 1e-4, each leaf after 20 steps within 1e-3 of its
    movement (the Adam-trajectory tolerances)."""
    jm, params, tm = _pair()
    js, surf = jm.implicit_surface, tm.implicit_surface
    key, n_it, n_pts, size = jax.random.PRNGKey(11), 20, 256, 3.0
    p20, want = jax_pretrain(js, params["implicit_surface"], key, num_iters=n_it, lr=1.5e-4,
                             batch_points=n_pts, target_radius=0.5, obj_bounding_size=size)
    pts = [np.asarray(jax.random.uniform(k, (n_pts, 3), jnp.float32, -size, size))
           for k in jax.random.split(key, n_it)]
    got = pretrain_siren_sdf(surf, num_iters=n_it, lr=1.5e-4, batch_points=n_pts,
                             target_radius=0.5, obj_bounding_size=size,
                             points=lambda i: torch.tensor(pts[i]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    for (path, p0), pj, pt in zip(
            jax.tree_util.tree_leaves_with_path(params["implicit_surface"]),
            jax.tree_util.tree_leaves(p20),
            jax.tree_util.tree_leaves(bridge._layers_to_tree(surf.layers))):
        moved = np.abs(np.asarray(pj) - np.asarray(p0)).max()
        assert np.abs(pt - np.asarray(pj)).max() <= 1e-3 * moved, jax.tree_util.keystr(path)


def test_pretrain_lowers_the_l1_from_its_generator():
    """The port's own draws (a seeded torch.Generator): the loss falls and
    the same seed gives the same run."""
    runs = []
    for _ in range(2):
        s = ImplicitSurface(**SURFACE, W_geo_feat=GEO)
        s.reset_parameters(torch.Generator().manual_seed(0))
        runs.append(pretrain_siren_sdf(s, num_iters=30, lr=1e-3, batch_points=256,
                                       target_radius=0.5,
                                       generator=torch.Generator().manual_seed(5)))
    assert torch.equal(runs[0], runs[1])
    assert runs[0][-10:].mean() < 0.75 * runs[0][:10].mean()

"""The port's network modules against the JAX package: the same weights (the
JAX `model.init`, copied through `bridge`) and the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.base import get_embedder as jax_get_embedder
from neurecon_tpu.models.frameworks.neus import NeuS as JaxNeuS

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import get_embedder, perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import NeuS
from neurecon_tpu_torch.ops import fused_nablas

SMALL = dict(surface=dict(D=4, W=64, skips=[2], radius_init=0.5, embed_multires=4),
             radiance=dict(D=2, W=64, skips=[], embed_multires=-1,
                           embed_multires_view=2), geo=64)
FLAGSHIP = dict(surface=dict(D=8, W=256, skips=[4], radius_init=0.5,
                             embed_multires=6),
                radiance=dict(D=4, W=256, skips=[], embed_multires=-1,
                              embed_multires_view=4), geo=256)

# fp32 on both sides, sums in another order (XLA's dot vs torch's GEMM):
# ~1e-6 per layer, so 1e-5 absolute on the sdf/features and the radiance;
# nablas come out of a reverse sweep through every layer, hence the same
# rtol 2e-3 / atol 2e-4 the JAX package holds its own nablas kernel to
# (tests/test_fused_nablas.py)
ATOL = 1e-5


def _pair(cfg, sphere_residual=False, seed=0, perturb=False):
    """The JAX model and the port's, with the same weights: the JAX init, or
    (`perturb`) that init with seeded noise on every weight, so that the
    octave columns and the geometry-feature rows take part."""
    surf = dict(cfg["surface"], sphere_residual=sphere_residual)
    jm = JaxNeuS(W_geo_feat=cfg["geo"], surface_cfg=surf,
                 radiance_cfg=cfg["radiance"], speed_factor=10.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))  # eager init takes ~5 s
    tm = NeuS(W_geo_feat=cfg["geo"], surface_cfg=surf,
              radiance_cfg=cfg["radiance"], speed_factor=10.0)
    bridge.load_tree(tm, jax.tree_util.tree_map(np.asarray, params))
    if perturb:
        perturb_parameters(tm, torch.Generator().manual_seed(seed + 1))
        params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jm, params, tm


def _points(n, seed=1):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * 0.6


@pytest.mark.parametrize("multires", [-1, 0, 4, 6, 10])
def test_embedder(multires):
    x = _points(200)
    fj, dj = jax_get_embedder(multires, 3)
    ft, dt = get_embedder(multires, 3)
    assert dj == dt
    np.testing.assert_allclose(ft(torch.tensor(x)).numpy(),
                               np.asarray(fj(jnp.asarray(x))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg,sphere_residual,perturb", [
    (SMALL, False, False), (SMALL, True, False), (FLAGSHIP, False, False),
    (SMALL, True, True), (FLAGSHIP, False, True)],
    ids=["W64", "W64-sphere_residual", "W256", "W64-sphere_residual-perturbed",
         "W256-perturbed"])
def test_surface_forward_and_nablas(cfg, sphere_residual, perturb):
    jm, params, tm = _pair(cfg, sphere_residual, perturb=perturb)
    x = _points(1500)
    sj, hj = jax.jit(lambda p, x: jm.implicit_surface.forward(
        p, x, return_h=True))(params["implicit_surface"], jnp.asarray(x))
    st, ht = tm.implicit_surface(torch.tensor(x), return_h=True)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(sj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ht.detach().numpy(), np.asarray(hj), rtol=0, atol=ATOL)

    sj, nj, hj = jax.jit(jm.forward_with_nablas)(params, jnp.asarray(x))
    with torch.no_grad():  # the render calls it gradient-free
        st, nt, ht = tm.implicit_surface.forward_with_nablas(torch.tensor(x))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["W64", "W256"])
def test_radiance_net(cfg):
    jm, params, tm = _pair(cfg)
    rng = np.random.RandomState(2)
    n = 1000
    x = _points(n)
    v = rng.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    nrm = rng.randn(n, 3).astype(np.float32)
    geo = rng.randn(n, cfg["geo"]).astype(np.float32)
    want = jax.jit(jm.radiance_net.forward)(params["radiance_net"],
                                            *map(jnp.asarray, (x, v, nrm, geo)))
    with torch.no_grad():
        got = tm.radiance_net(*map(torch.tensor, (x, v, nrm, geo)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_bridge_round_trip_and_forward_s():
    jm, params, tm = _pair(SMALL)
    tree = bridge.model_to_tree(tm)
    flat_j = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))
    flat_t = jax.tree_util.tree_leaves(tree)
    assert len(flat_j) == len(flat_t)
    for a, b in zip(flat_j, flat_t):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(float(tm.forward_s().detach()), float(jm.forward_s(params)),
                               rtol=1e-6)


def test_port_geometric_init_is_a_sphere():
    """The port's own init (no JAX weights) approximates |x| - radius_init,
    as the JAX init does (mean error ~0.05-0.2 depending on the seed, on
    both sides)."""
    tm = NeuS(W_geo_feat=256, surface_cfg=FLAGSHIP["surface"],
              radiance_cfg=FLAGSHIP["radiance"])
    tm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.tensor(_points(500))
    x = (x / x.norm(dim=-1, keepdim=True)
         * torch.linspace(0.2, 0.9, 500)[:, None]).contiguous()
    with torch.no_grad():
        sdf, nablas, _ = fused_nablas.fused_forward_with_nablas(
            tm.implicit_surface, x)
    want = (x.norm(dim=-1) - 0.5).numpy()
    assert np.corrcoef(sdf.numpy(), want)[0, 1] > 0.8  # 0.86 at this seed
    assert np.abs(sdf.numpy() - want).mean() < 0.15
    assert np.isfinite(nablas.numpy()).all()

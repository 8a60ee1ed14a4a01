"""The port's VolSDF math and §3.4 fine sampler against the JAX package, on
the CPU: `sdf_to_sigma`, `error_bound` (with its 0 * inf fixup),
`sample_cdf`, both `searchsorted` routes, the det upsample's ordering (which
the CUDA merge relies on), and `fine_sample_plain` against JAX `fine_sample`
and against the Pallas kernel family in interpret mode, det and perturb, on
identical uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.frameworks.volsdf import VolSDF as JaxVolSDF
from neurecon_tpu.models.frameworks.volsdf import error_bound as jax_error_bound
from neurecon_tpu.models.frameworks.volsdf import fine_sample as jax_fine_sample
from neurecon_tpu.models.frameworks.volsdf import sdf_to_sigma as jax_sdf_to_sigma
from neurecon_tpu.ops.fused_fine_sample import fused_fine_sample as jax_fused_fine_sample
from neurecon_tpu.ops.sampling import sample_cdf as jax_sample_cdf
from neurecon_tpu.ops.sampling import searchsorted as jax_searchsorted

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import volsdf
from neurecon_tpu_torch.ops import fused_fine_sample as ffs
from neurecon_tpu_torch.ops import sampling

SMALL = dict(W=64, D=4, skips=[2], embed_multires=4)
FLAGSHIP = dict(W=256, D=8, skips=[4], embed_multires=6)
RADIANCE = dict(W=32, D=1, skips=[], embed_multires=-1, embed_multires_view=-1)


def _rays(n, seed=0):
    """Rays from (0, 0, -3) through the unit sphere of the geometric init."""
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.35, 0.35, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape))
    return o, d


def _models(surface_cfg, beta):
    """The JAX VolSDF and the port's with the same weights: the port's
    geometric init with seeded noise on every weight, and beta_net = `beta`."""
    kw = dict(beta_init=0.1, speed_factor=10.0, W_geo_feat=surface_cfg["W"],
              obj_bounding_radius=3.0, surface_cfg=surface_cfg, radiance_cfg=RADIANCE)
    jm = JaxVolSDF(**kw)
    tm = volsdf.VolSDF(**kw)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tm.ln_beta.fill_(float(np.log(beta) / 10.0))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jm, params, tm


def _jax_uniforms(key, N, max_iter, n_final, perturb):
    """u_fin in the reference key order, as `_fine_sample_dispatch` draws it."""
    keys = jax.random.split(key, max_iter + 2)
    us = [jax.random.uniform(keys[i], (N, n_final)) if perturb
          else jnp.broadcast_to(jnp.linspace(0.0, 1.0, n_final), (N, n_final))
          for i in range(max_iter + 2)]
    return np.asarray(jnp.concatenate(us, -1))


def _sample_both(surface_cfg, beta, N, n0, n_up, n_final, max_iter, perturb, pallas):
    jm, params, tm = _models(surface_cfg, beta)
    o, d = _rays(N)
    far = np.full((N, 1), 6.0, np.float32)
    t = np.asarray(jnp.linspace(0.0, 1.0, n0))
    d_init = (far * t).astype(np.float32)
    alpha, beta_j = jm.forward_ab(params)
    key = jax.random.PRNGKey(9)
    kw = dict(eps=0.1, max_iter=max_iter, max_bisection=10)
    ref = jax.jit(lambda p: jax_fine_sample(
        lambda x: jm.forward_surface(p, x), jnp.asarray(d_init), jnp.asarray(o),
        jnp.asarray(d), alpha_net=alpha, beta_net=beta_j, far=jnp.asarray(far), key=key,
        final_N_importance=n_final, N_up=n_up, perturb=perturb, **kw))(params)
    u = _jax_uniforms(key, N, max_iter, n_final, perturb)
    a_t, b_t = tm.forward_ab()
    got = ffs.fused_fine_sample(
        tm.implicit_surface, torch.tensor(o), torch.tensor(d), torch.tensor(d_init),
        torch.tensor(far), a_t.detach(), b_t.detach(), torch.tensor(u), n_final=n_final,
        n_up=n_up, sphere_bg_r=3.0, **kw)
    pal = None
    if pallas:
        pal = jax_fused_fine_sample(
            jm.implicit_surface, params["implicit_surface"], jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(d_init), jnp.asarray(far), alpha, beta_j, jnp.asarray(u),
            n_final=n_final, n_up=n_up, tile=8, interpret=True, sphere_bg_r=3.0, **kw)
    return [x.numpy() for x in got], [np.asarray(x) for x in ref], pal


def _assert_samples_agree(got, want, span):
    """Every fine depth within 1e-5 of the span, the beta map to rtol 1e-5,
    iter_usage equal on every ray. The JAX package's own bounds between its
    Pallas and plain samplers are looser (>= 98% of the samples within 1e-4
    of the span, beta rtol 1e-3, iter_usage equal on >= 90%,
    tests/test_fused_fine_sample.py), for fp32 sums in another order that may
    flip a bound sitting at eps; on these rays the plain versions agree to
    6e-6 (1e-6 of the span), with equal beta maps and rounds."""
    (gd, gb, gi), (wd, wb, wi) = got, [np.asarray(x) for x in want]
    assert gd.shape == wd.shape and np.isfinite(gd).all()
    np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5 * span)
    np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int32


def test_sdf_to_sigma_and_error_bound_match_jax():
    """Random sorted depths and sdf values, and one row built so that
    exp(-R) underflows to 0 while exp(E) overflows: 0 * inf = NaN, which both
    turn into +inf. Values to rtol 1e-5 (exp and cumsums in another order)."""
    rng = np.random.RandomState(0)
    d = np.sort(rng.uniform(0, 6, (5, 40)), -1).astype(np.float32)
    sdf = rng.uniform(-1, 1, (5, 40)).astype(np.float32)
    for alpha, beta in ((10.0, 0.1), (2.0, 0.5)):
        np.testing.assert_allclose(
            volsdf.sdf_to_sigma(torch.tensor(sdf), alpha, beta).numpy(),
            np.asarray(jax_sdf_to_sigma(jnp.asarray(sdf), alpha, beta)), rtol=1e-6)
        np.testing.assert_allclose(
            volsdf.error_bound(torch.tensor(d), torch.tensor(sdf), alpha, beta).numpy(),
            np.asarray(jax_error_bound(jnp.asarray(d), jnp.asarray(sdf), alpha, beta)),
            rtol=1e-5, atol=1e-7)
    d0 = np.array([[0, 1, 2, 3, 4]], np.float32)
    s0 = np.array([[-5, -5, 0, 0, 0]], np.float32)
    got = volsdf.error_bound(torch.tensor(d0), torch.tensor(s0), 100.0, 0.01).numpy()
    want = np.asarray(jax_error_bound(jnp.asarray(d0), jnp.asarray(s0), 100.0, 0.01))
    assert np.isinf(want[0, 2]) and np.isinf(got[0, 2])
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("det", [True, False])
def test_sample_cdf_matches_jax(det):
    """The opacity inversion on a monotone, unnormalized cdf with flat runs,
    at JAX's own uniforms (unsorted under perturb): within 1e-6 of the span."""
    rng = np.random.RandomState(1)
    bins = np.sort(rng.uniform(0, 6, (6, 50)), -1).astype(np.float32)
    steps = rng.uniform(0, 0.05, (6, 49)) * (rng.uniform(size=(6, 49)) > 0.4)
    cdf = np.minimum(np.cumsum(steps, -1), 1.0).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_sample_cdf(key, jnp.asarray(bins), jnp.asarray(cdf), 24, det=det))
    u = (np.broadcast_to(np.asarray(jnp.linspace(0.0, 1.0, 24)), (6, 24)) if det
         else np.asarray(jax.random.uniform(key, (6, 24))))
    got = sampling.sample_cdf(torch.tensor(bins), torch.tensor(cdf),
                              torch.tensor(np.ascontiguousarray(u))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-6)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted_routes_agree(side, monkeypatch):
    """The comparison count and the torch.searchsorted route give the same
    counts on sorted rows with ties (and equal the JAX package's)."""
    rng = np.random.RandomState(2)
    a = np.sort(rng.randint(0, 40, (3, 4, 300)), -1).astype(np.float32)
    v = rng.randint(-2, 42, (3, 4, 70)).astype(np.float32)
    count = sampling.searchsorted(torch.tensor(a), torch.tensor(v), side)  # 21,000 compares
    monkeypatch.setattr(sampling, "COUNT_SEARCH_LIMIT", 100)
    sort = sampling.searchsorted(torch.tensor(a), torch.tensor(v), side)
    assert torch.equal(count, sort)
    want = np.asarray(jax_searchsorted(jnp.asarray(a), jnp.asarray(v), side))
    np.testing.assert_array_equal(count.numpy(), want)
    # a broadcast batch (one row for all) takes the same route
    b = sampling.searchsorted(torch.tensor(a[:1, :1]), torch.tensor(v), side)
    np.testing.assert_array_equal(b.numpy(), np.asarray(
        jax_searchsorted(jnp.asarray(a[:1, :1]), jnp.asarray(v), side)))


def test_det_upsample_is_sorted():
    """The det draw of each round (pdf proportional to bounds + 1e-5, inverse
    CDF at linspace(0, 1, n_up + 2), both ends dropped) gives non-decreasing
    depths, so merging it into the sorted buffer by ranks equals the
    reference's stable sort of the concatenation: on bounds from the plain
    sampler's own sweeps, clipped at 1e5 and all but zero."""
    rng = np.random.RandomState(4)
    d = torch.tensor(np.sort(rng.uniform(0, 6, (8, 200)), -1).astype(np.float32))
    sdf = torch.tensor(rng.uniform(-0.5, 0.5, (8, 200)).astype(np.float32))
    u = sampling.linspace01(130).expand(8, -1)
    for beta in (0.001, 0.05, 0.3, 3.0):
        bounds = torch.clamp(volsdf.error_bound(d, sdf, 1.0 / beta, beta), 0.0, 1e5)
        up = sampling.sample_pdf(d, bounds, u)[:, 1:-1]
        assert (up[:, 1:] >= up[:, :-1]).all(), beta
        merged, order = torch.sort(torch.cat([d, up], -1), dim=-1, stable=True)
        # the rank merge: old i at i + #new < d_i, new j at j + #old <= up_j
        pos_old = torch.arange(200) + sampling.searchsorted(up, d, "left")
        pos_new = torch.arange(128) + sampling.searchsorted(d, up, "right")
        ranked = torch.empty_like(merged)
        ranked.scatter_(1, pos_old, d)
        ranked.scatter_(1, pos_new, up)
        assert torch.equal(ranked, merged)
        assert torch.equal(order.sort(-1).values, torch.arange(328).expand(8, -1))


@pytest.mark.parametrize("perturb", [False, True])
def test_fine_sample_plain_matches_jax_and_pallas(perturb):
    """W=64 D=4 skip 2, 16 rays, n0 = n_up = 32, max_iter 3, 10 bisection
    steps, beta_net 0.35 (the rays end in rounds 2, 3 and unconverged): the
    plain sampler against JAX `fine_sample` and against the Pallas family in
    interpret mode, on the same uniforms."""
    got, ref, pal = _sample_both(SMALL, 0.35, 16, 32, 32, 16, 3, perturb, pallas=True)
    assert len(set(got[2].tolist())) > 1  # a mix of convergence rounds
    _assert_samples_agree(got, ref, 6.0)
    _assert_samples_agree(got, pal, 6.0)


def test_fine_sample_plain_matches_jax_at_flagship_width():
    """The flagship surface (D=8 W=256 skip 4, multires 6) on 4 rays, n0 =
    n_up = 64, max_iter 3: 1,024 sdf queries per ray."""
    got, ref, _ = _sample_both(FLAGSHIP, 0.2, 4, 64, 64, 16, 3, True, pallas=False)
    _assert_samples_agree(got, ref, 6.0)

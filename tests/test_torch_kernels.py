"""The plain versions of the port's two CUDA kernels against the JAX package.

Kernel 1 (forward + nablas) against the JAX Pallas kernel itself in
interpret mode (tests/test_torch_base.py holds it against JAX
`forward_with_nablas` at the flagship width); kernel 2 (the official_solution
upsampler) against the JAX `neus_upsample` loop in det and perturb mode and
with the sphere_residual prior. On the CPU the port's wrappers take these
plain versions; tests/test_torch_cuda.py holds the kernels to them on a card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.frameworks.neus import NeuS as JaxNeuS
from neurecon_tpu.models.frameworks.neus import neus_upsample as jax_neus_upsample
from neurecon_tpu.ops import near_far_from_sphere as jax_near_far
from neurecon_tpu.ops.fused_nablas import fused_forward_with_nablas as jax_fused_nablas

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import NeuS, _uniforms
from neurecon_tpu_torch.ops import fused_nablas, fused_upsample

SMALL = dict(D=4, W=64, skips=[2], radius_init=0.5, embed_multires=4)
FLAGSHIP = dict(D=8, W=256, skips=[4], radius_init=0.5, embed_multires=6)
RADIANCE = dict(D=1, W=32, skips=[], embed_multires=-1, embed_multires_view=-1)


def _pair(surface_cfg, geo, seed=0, perturb=False):
    """JAX and port models with the same weights; `perturb` adds seeded noise
    to every weight (see tests/test_torch_base.py)."""
    jm = JaxNeuS(W_geo_feat=geo, surface_cfg=surface_cfg, radiance_cfg=RADIANCE)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))  # eager init takes ~5 s
    tm = NeuS(W_geo_feat=geo, surface_cfg=surface_cfg, radiance_cfg=RADIANCE)
    bridge.load_tree(tm, jax.tree_util.tree_map(np.asarray, params))
    if perturb:
        perturb_parameters(tm, torch.Generator().manual_seed(seed + 1))
        params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jm, params, tm


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.35, 0.35, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32),
                                             d.shape))
    near, far = jax_near_far(jnp.asarray(o), jnp.asarray(d), r=1.0)
    t = jnp.linspace(0.0, 1.0, 64)
    d_coarse = np.asarray(near * (1 - t) + far * t)
    return o, d, d_coarse


class TestNablasPlain:
    def test_matches_jax_pallas_kernel_interpret(self):
        """The JAX kernel's own fast case (tests/test_fused_nablas.py)."""
        self._check(perturb=False)

    def test_matches_jax_pallas_kernel_interpret_perturbed_weights(self):
        """The same with noise on every weight: octave columns included."""
        self._check(perturb=True)

    @staticmethod
    def _check(perturb):
        cfg = dict(D=3, W=64, skips=[], radius_init=0.5, embed_multires=2)
        jm, params, tm = _pair(cfg, 32, perturb=perturb)
        x = np.random.RandomState(1).randn(128, 3).astype(np.float32) * 0.8
        want = jax_fused_nablas(jm.implicit_surface, params["implicit_surface"],
                                jnp.asarray(x), tile=128, interpret=True)
        got = fused_nablas.forward_with_nablas_plain(tm.implicit_surface,
                                                     torch.tensor(x))
        # the Pallas kernel's tolerances against jax.grad, same reasons
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-4, atol=1e-5)


def _jax_upsample(jm, params, o, d, d_coarse, key, perturb, n_iters=4, n_per=16):
    fn = jax.jit(functools.partial(
        jax_neus_upsample, jm, upsample_algo="official_solution",
        N_importance=n_iters * n_per, N_upsample_iters=n_iters,
        N_nograd_samples=0, fixed_s_recp=1 / 64.0, perturb=perturb))
    return np.asarray(fn(params, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(d_coarse), key))


def _jax_round_uniforms(key, n, n_iters, n_per):
    """The per-round uniforms JAX's neus_upsample draws (its key-split
    sequence, as in tests/test_fused_upsample.py), each round sorted."""
    us = []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        us.append(np.sort(np.asarray(jax.random.uniform(sub, (n, n_per))), -1))
    return np.concatenate(us, -1).astype(np.float32)


def _assert_depths_close(got, ref, d_coarse, frac_tol):
    """Samples agree except for rare moves where an fp32 cdf differs by an
    ulp at a tie with u (a bin or less); the same check, with the same
    reason, as the JAX package's upsampler kernel test."""
    diff = np.abs(got - ref)
    span = float(d_coarse.max() - d_coarse.min())
    frac_off = (diff > 1e-4 * span).mean()
    assert np.isfinite(got).all()
    assert frac_off < frac_tol, f"{frac_off:.4%} off (max {diff.max():.3e})"
    assert diff.max() <= span / 8


class TestUpsamplePlain:
    def test_det(self):
        self._det(perturb=False)

    def test_det_perturbed_weights(self):
        self._det(perturb=True)

    @staticmethod
    def _det(perturb):
        jm, params, tm = _pair(SMALL, 64, perturb=perturb)
        o, d, dc = _rays(64)
        ref = _jax_upsample(jm, params, o, d, dc, jax.random.PRNGKey(7), False)
        u = _uniforms(64, 4, 16, False, None, torch.device("cpu"))
        got = fused_upsample.fused_neus_upsample(
            tm.implicit_surface, torch.tensor(o), torch.tensor(d),
            torch.tensor(dc), u, n_iters=4, n_per_iter=16).numpy()
        assert got.shape == ref.shape == (64, 128)
        # det u (1.0 included) lands on cdf plateaus: the JAX kernel test's 3%
        _assert_depths_close(got, ref, dc, frac_tol=0.03)

    @pytest.mark.parametrize("sphere_residual", [False, True])
    def test_perturb_same_uniforms(self, sphere_residual):
        self._perturb(sphere_residual, perturb_weights=False)

    @pytest.mark.parametrize("sphere_residual", [False, True])
    def test_perturb_same_uniforms_perturbed_weights(self, sphere_residual):
        self._perturb(sphere_residual, perturb_weights=True)

    @staticmethod
    def _perturb(sphere_residual, perturb_weights):
        jm, params, tm = _pair(dict(SMALL, sphere_residual=sphere_residual), 64,
                               perturb=perturb_weights)
        o, d, dc = _rays(64, seed=1)
        key = jax.random.PRNGKey(3)
        ref = _jax_upsample(jm, params, o, d, dc, key, True)
        u = torch.tensor(_jax_round_uniforms(key, 64, 4, 16))
        got = fused_upsample.fused_neus_upsample(
            tm.implicit_surface, torch.tensor(o), torch.tensor(d),
            torch.tensor(dc), u, n_iters=4, n_per_iter=16).numpy()
        _assert_depths_close(got, ref, dc, frac_tol=5e-3)
        assert np.all(np.diff(got, axis=-1) >= 0)

    def test_wrapper_checks_shapes(self):
        _, _, tm = _pair(SMALL, 64)
        o, d, dc = _rays(8)
        u = torch.zeros(8, 63)  # wrong: 4 rounds x 16
        with pytest.raises(ValueError):
            fused_upsample.fused_neus_upsample(
                tm.implicit_surface, torch.tensor(o), torch.tensor(d),
                torch.tensor(dc), u, n_iters=4, n_per_iter=16)


@pytest.mark.parametrize("cfg,geo", [(SMALL, 64), (FLAGSHIP, 256)], ids=["W64", "W256"])
def test_packed_weights_layout(cfg, geo):
    """The buffer the kernels read (built in Python, read only on a card):
    each layer's W^T, W and b sit at their offsets with 16-byte rows."""
    from neurecon_tpu_torch.models.base import effective_weight

    tm = NeuS(W_geo_feat=geo, surface_cfg=cfg, radiance_cfg=RADIANCE)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    surf = tm.implicit_surface
    params, meta, wmax = fused_nablas.pack_surface(surf)
    assert wmax == cfg["W"]
    for l, (row, layer) in enumerate(zip(meta.tolist(), surf.layers)):
        i, o, off_wT, off_w, off_b, skip, ld_wT, ld_w = row
        w = effective_weight(layer).detach()
        assert (i, o, skip) == (w.shape[1], w.shape[0], int(l in cfg["skips"]))
        assert off_wT % 4 == off_w % 4 == 0 and ld_wT % 4 == ld_w % 4 == 0
        wT = params[off_wT:off_wT + i * ld_wT].reshape(i, ld_wT)
        wf = params[off_w:off_w + o * ld_w].reshape(o, ld_w)
        assert torch.equal(wT[:, :o], w.t()) and not wT[:, o:].any()
        assert torch.equal(wf[:, :i], w) and not wf[:, i:].any()
        assert torch.equal(params[off_b:off_b + o], layer.b.detach())

"""The NeuS `direct_use` and `direct_more` upsamplers of the port against the
JAX package's, on the CPU: the sorted section depths d_all
(`compute_ray_samples` against JAX's, which runs `neus_upsample`), the
render through them, and the training loss with every gradient leaf
(`compute_losses` through the ray loss), det and perturb, on the same
weights (`bridge.py`, seeded noise), JAX's ray batch and JAX's uniforms
(through the `u_up` seam). W=64 nets, 64 rays, 16 coarse + 16 fine depths,
512 depths for `direct_more`'s sdf sweep."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.models.frameworks.neus import compute_ray_samples as jax_samples
from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_ray_loss_fn
from neurecon_tpu.models.frameworks.neus import volume_render_rays as jax_render
from neurecon_tpu.training import sample_ray_batch as jax_sample_ray_batch

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
from neurecon_tpu_torch.models.frameworks.neus import compute_ray_samples, volume_render_rays
from tests.test_torch_parallel import _case_batch, _case_cfg

N = 64
ALGOS = ("direct_use", "direct_more")


def _t(x):
    return torch.tensor(np.asarray(x))


def _setup(algo, perturb):
    cfg = _case_cfg("neus_mask")
    cfg["model"].update(upsample_algo=algo, N_nograd_samples=512, perturb=perturb)
    targs = ConfigDict(copy.deepcopy(cfg))
    tm, tkw, _, _ = get_model(targs, "cpu", seed=0)
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    jm, _, jkw, _, _ = jax_get_model(jargs)
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    batch, H, W = _case_batch("neus_mask", cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    rb = jax_sample_ray_batch(jax.random.PRNGKey(3), jbatch, H, W, N)
    key = jax.random.PRNGKey(4)
    key_up, _ = jax.random.split(key)
    # JAX's sample_pdf draws its uniforms from the upsampler's key; det: none
    u_up = _t(jax.random.uniform(key_up, (N, 16))) if perturb else None
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    return cfg, targs, tm, tkw, jargs, jm, kw, params, rb, key, u_up


def _jax_d_all(jm, params, rb, key, kw):
    return jax.jit(lambda p: jax_samples(jm, p, rb["rays_o"], rb["rays_d"], key, **kw))(params)


def _depth_gap(got, want, span):
    """Share of depths beyond 1e-4 of the span, and the largest gap."""
    diff = np.abs(got - want)
    return float((diff > 1e-4 * span).mean()), float(diff.max())


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_d_all_matches_jax(algo, perturb):
    """d_all within 1e-4 of each ray's span on all but 1% of the depths
    (an fp32 cdf a ulp off at a tie with a det uniform moves a depth within
    its bin, as the JAX package's upsampler tests allow), none beyond one
    coarse bin; the coarse depths equal to the ulp."""
    cfg, targs, tm, tkw, jargs, jm, kw, params, rb, key, u_up = _setup(algo, perturb)
    want = np.asarray(_jax_d_all(jm, params, rb, key, kw))
    got = compute_ray_samples(tm, _t(rb["rays_o"]), _t(rb["rays_d"]), u_up=u_up, **kw).numpy()
    assert got.shape == want.shape == (N, 32)
    assert np.all(np.diff(got, axis=-1) >= 0)
    span = float(want.max() - want.min())
    share, worst = _depth_gap(got, want, span)
    assert share <= 0.01 and worst <= span / 15, (share, worst)


@pytest.mark.parametrize("perturb", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_render_and_loss_match_jax(algo, perturb):
    """The render and the training loss with the upsampler inside (perturb),
    or on JAX's d_all (det: a depth at a det uniform's cdf tie moves by up
    to a bin between any two fp32 cdfs, which `test_d_all_matches_jax`
    allows, and moves a section's eikonal term): rgb and accumulation
    within 1e-5, depth within 1e-4 (fp32 sums of ~2.5 in another order, as
    the VolSDF render test holds it); the loss terms to rel 1e-5 (earlier slices')
    and every gradient leaf within 5e-4 of its max|ref| (the JAX package's
    full-step bound)."""
    cfg, targs, tm, tkw, jargs, jm, kw, params, rb, key, u_up = _setup(algo, perturb)
    d_all = None if perturb else _jax_d_all(jm, params, rb, key, kw)
    d_t = None if perturb else _t(d_all)
    want = jax.jit(lambda p: jax_render(jm, p, rb["rays_o"], rb["rays_d"], key,
                                        d_all_override=d_all, **kw))(params)
    with torch.no_grad():
        got = volume_render_rays(tm, _t(rb["rays_o"]), _t(rb["rays_d"]), u_up=u_up,
                                 d_all_override=d_t, **kw)
    for k, atol in (("rgb", 1e-5), ("depth_volume", 1e-4), ("mask_volume", 1e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                                   rtol=0, atol=atol, err_msg=k)
    j_loss = jax_ray_loss_fn(jm, jargs, dict(kw))
    (_, (want_l, _)), g_j = jax.jit(jax.value_and_grad(
        lambda p: j_loss(p, rb, key, 0, d_all=d_all), has_aux=True))(params)
    t_loss = get_ray_loss_fn(targs, tm, tkw)
    total, (got_l, _) = t_loss({k: _t(v) for k, v in rb.items()}, u_up=u_up, d_all=d_t)
    total.backward()
    assert set(got_l) == set(want_l)
    for k in want_l:
        assert abs(got_l[k].item() - float(want_l[k])) <= 1e-5 * abs(float(want_l[k])), k
    g_t = bridge.grads_to_tree(tm)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(g_j),
                            jax.tree_util.tree_leaves(g_t)):
        err = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64)).max()
        assert err <= 5e-4 * np.abs(np.asarray(a)).max(), (jax.tree_util.keystr(path), err)


def test_unknown_upsample_algo_raises():
    cfg = _case_cfg("neus_mask")
    cfg["model"]["upsample_algo"] = "bogus"
    model, kw, _, _ = get_model(ConfigDict(cfg), "cpu")
    kw = {k: v for k, v in kw.items() if k not in ("H", "W")}
    with pytest.raises(ValueError, match="bogus"):
        compute_ray_samples(model, torch.zeros(2, 3), torch.ones(2, 3), **kw)

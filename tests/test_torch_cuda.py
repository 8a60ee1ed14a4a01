"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips when no card is present. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import NeuS, _uniforms
from neurecon_tpu_torch.ops import fused_nablas, fused_upsample
from neurecon_tpu_torch.ops.ray import near_far_from_sphere

SMALL = dict(W=64, D=4, skips=[2], radius_init=0.5, embed_multires=4)
FLAGSHIP = dict(W=256, D=8, skips=[4], radius_init=0.5, embed_multires=6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model(surface_cfg, W_geo, device, seed=0):
    """Geometric init plus seeded noise on every weight: the init alone zeroes
    the octave columns, which would hide an error in the encoding."""
    model = NeuS(W_geo_feat=W_geo, surface_cfg=surface_cfg,
                 radiance_cfg=dict(D=1, W=32, skips=[], embed_multires=-1,
                                   embed_multires_view=-1))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    perturb_parameters(model, torch.Generator().manual_seed(seed + 1))
    return model.to(device)


def _rays(n, device, seed=0):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1)
    o = np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape)
    return (torch.tensor(np.ascontiguousarray(o), device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo", [(SMALL, 64), (FLAGSHIP, 256),
                                     (dict(SMALL, embed_multires=-1), 32)])
def test_nablas_kernel_matches_plain(cuda, cfg, geo):
    surf = _model(cfg, geo, cuda).implicit_surface
    rng = np.random.RandomState(1)
    x = torch.tensor(rng.randn(1000, 3).astype(np.float32) * 0.6, device=cuda)
    before = fused_nablas.fused_forward_with_nablas.launches
    got = fused_nablas.fused_forward_with_nablas(surf, x)
    torch.cuda.synchronize()
    assert fused_nablas.fused_forward_with_nablas.launches == before + 1
    ref = fused_nablas.forward_with_nablas_plain(surf, x)
    # fp32 sums in another order than the plain version's GEMMs
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,perturb,sphere", [
    (SMALL, 64, False, False), (SMALL, 64, True, False),
    (SMALL, 64, True, True), (FLAGSHIP, 256, True, False)])
def test_upsample_kernel_matches_plain(cuda, cfg, geo, perturb, sphere):
    surf = _model(dict(cfg, sphere_residual=sphere), geo, cuda).implicit_surface
    N = 203  # not a multiple of the kernel's 8 rays per block
    rays_o, rays_d = _rays(N, cuda)
    near, far = near_far_from_sphere(rays_o, rays_d, r=1.0)
    t = torch.linspace(0, 1, 64, device=cuda)
    d_coarse = (near * (1 - t) + far * t).contiguous()
    u = _uniforms(N, 4, 16, perturb, torch.Generator(cuda).manual_seed(3), cuda)
    got = fused_upsample.fused_neus_upsample(surf, rays_o, rays_d, d_coarse, u,
                                             n_iters=4, n_per_iter=16)
    ref = fused_upsample.neus_upsample_plain(surf, rays_o, rays_d, d_coarse, u,
                                             n_iters=4, n_per_iter=16)
    torch.cuda.synchronize()
    assert got.shape == (N, 128)
    assert bool((got[:, 1:] >= got[:, :-1]).all()), "output must be sorted"
    # the sharp sigmoid (s up to 512) can move a sample when an fp32 sum
    # order changes; such moves must stay rare. The det uniforms include
    # u = 1.0, which meets cdf[-1] = 1 +- an ulp: whether it lands in the
    # last or the second-to-last bin flips with the summation order (the
    # JAX package's own kernel test allows 3% in det mode for this).
    span = float((far - near).max())
    off = (got - ref).abs() > 1e-3 * span
    frac = 1e-3 if perturb else 5e-3
    assert float(off.float().mean()) <= frac, float((got - ref).abs().max())


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    surf = _model(SMALL, 64, cuda).implicit_surface
    x = torch.zeros(10, 3, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_nablas.fused_forward_with_nablas(surf, x)
    x = torch.zeros(3, 10, device=cuda).t()
    with pytest.raises(ValueError):
        fused_nablas.fused_forward_with_nablas(surf, x)

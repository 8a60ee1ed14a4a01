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
from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp, fused_upsample
from neurecon_tpu_torch.ops.ray import near_far_from_sphere
from neurecon_tpu_torch.utils import mesh

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
@pytest.mark.parametrize("cfg,geo,M", [(dict(SMALL), 64, 1000),
                                      (dict(SMALL, skips=[1, 3]), 64, 37),
                                      (FLAGSHIP, 256, 4096),
                                      (FLAGSHIP, 256, 4099),
                                      (FLAGSHIP, 256, 0)])
def test_backward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 3 against its plain version: every weight and bias grad and
    x_bar, max|diff| <= 5e-4 max|ref| per leaf (fp32 sums over all points
    in another order; the JAX package's full-step bound). M = 4099 and 37
    leave a ragged last tile; M = 0 gives zeros."""
    surf = _model(cfg, geo, cuda).implicit_surface
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(M, 3).astype(np.float32) * 0.6, device=cuda)
    cots = [torch.tensor(rng.randn(*s).astype(np.float32), device=cuda)
            for s in ((M,), (M, 3), (M, geo))]
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(surf)]
    before = fused_nablas_vjp.fused_nablas_vjp.launches
    got = fused_nablas_vjp.fused_nablas_vjp(surf, x, ws, bs, *cots)
    torch.cuda.synchronize()
    assert fused_nablas_vjp.fused_nablas_vjp.launches == before + (M > 0)
    ref = fused_nablas_vjp.nablas_vjp_plain(surf, x, ws, bs, *cots)
    leaves = [(got[0], ref[0])] + list(zip(got[1], ref[1])) + list(zip(got[2], ref[2]))
    for i, (g, r) in enumerate(leaves):
        assert g.shape == r.shape and bool(torch.isfinite(g).all()), i
        err = float((g - r).abs().max()) if g.numel() else 0.0
        assert err <= 5e-4 * float(r.abs().max()) if M else err == 0.0, (i, err)


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda):
    surf = _model(SMALL, 64, cuda).implicit_surface
    x = torch.rand(5000, 3, device=cuda) - 0.5
    cots = [torch.ones(5000, device=cuda), torch.ones(5000, 3, device=cuda),
            torch.ones(5000, 64, device=cuda)]
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(surf)]
    a = fused_nablas_vjp.fused_nablas_vjp(surf, x, ws, bs, *cots)
    b = fused_nablas_vjp.fused_nablas_vjp(surf, x, ws, bs, *cots)
    for p, q in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs(cuda):
    surf = _model(SMALL, 64, cuda).implicit_surface
    x = torch.zeros(10, 3, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused_nablas.fused_forward_with_nablas(surf, x)
    x = torch.zeros(3, 10, device=cuda).t()
    with pytest.raises(ValueError):
        fused_nablas.fused_forward_with_nablas(surf, x)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,M", [(dict(SMALL), 64, 1000),
                                      (dict(SMALL, skips=[1, 3]), 64, 37),
                                      (dict(SMALL, embed_multires=-1), 32, 300),
                                      (FLAGSHIP, 256, 4096),
                                      (FLAGSHIP, 256, 4099),
                                      (FLAGSHIP, 256, 0)])
def test_sdf_forward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 4 against its plain version: max|diff| <= 1e-5 max|sdf| (fp32
    sums in another order). M = 4099 and 37 leave a ragged last tile; M = 0
    returns an empty tensor without a launch."""
    surf = _model(cfg, geo, cuda).implicit_surface
    x = torch.tensor(np.random.RandomState(4).uniform(-1, 1, (M, 3)).astype(np.float32),
                     device=cuda)
    before = fused_mlp.fused_sdf_forward.launches
    got = fused_mlp.fused_sdf_forward(surf, x)
    torch.cuda.synchronize()
    assert fused_mlp.fused_sdf_forward.launches == before + (M > 0)
    ref = fused_mlp.sdf_forward_plain(surf, x)
    assert got.shape == (M,) and bool(torch.isfinite(got).all())
    if M:
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_forward_query_adds_the_prior_outside_the_kernel(cuda):
    surf = _model(dict(SMALL, sphere_residual=True), 64, cuda).implicit_surface
    x = torch.rand(8, 50, 3, device=cuda) * 2 - 1
    got = surf.forward_query(x)
    ref = surf.mlp(x.reshape(-1, 3))[0] + torch.linalg.norm(x.reshape(-1, 3), dim=-1) - 0.5
    assert got.shape == (8, 50)
    torch.testing.assert_close(got.reshape(-1), ref, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_sdf_grid_through_kernel_matches_plain(cuda):
    """A 64^3 grid through kernel 4 and through the plain version: values
    within 1e-5 of max; where the signs agree everywhere, the triangulations
    on the card have the same faces and vertices within 1e-2 grid cells (a
    vertex's place on its edge moves by the value error over the edge's
    value difference, which is small where the surface grazes the edge:
    1.9e-3 cells measured on an H100)."""
    surf = _model(FLAGSHIP, 256, cuda).implicit_surface
    got = mesh.query_grid(surf.forward_query, 64, 2.0, device=cuda)
    ref = mesh.query_grid(lambda x: fused_mlp.sdf_forward_plain(surf, x), 64, 2.0,
                          device=cuda)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    if bool((torch.sign(got) == torch.sign(ref)).all()):
        vg, fg = mesh.marching_tetrahedra(got)
        vr, fr = mesh.marching_tetrahedra(ref)
        assert torch.equal(fg, fr) and len(fg) > 0
        torch.testing.assert_close(vg, vr, rtol=0, atol=1e-2)


@pytest.mark.cuda
def test_sdf_forward_raises_on_an_unsupported_shape(cuda):
    """A width the kernels do not take raises on the card; nothing falls
    back to the plain version."""
    surf = _model(dict(SMALL, W=300), 64, cuda).implicit_surface
    before = fused_mlp.fused_sdf_forward.launches
    with pytest.raises(NotImplementedError):
        fused_mlp.fused_sdf_forward(surf, torch.zeros(10, 3, device=cuda))
    with pytest.raises(TypeError):
        fused_mlp.fused_sdf_forward(surf, torch.zeros(10, 3, device=cuda, dtype=torch.float64))
    assert fused_mlp.fused_sdf_forward.launches == before

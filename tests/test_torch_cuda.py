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
from neurecon_tpu_torch.ops import (fused_fine_sample, fused_mlp, fused_nablas,
                                    fused_nablas_vjp, fused_upsample, surface_pack)
from neurecon_tpu_torch.ops.ray import near_far_from_sphere
from neurecon_tpu_torch.ops.sampling import linspace01
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
                                      (FLAGSHIP, 256, 0),
                                      (FLAGSHIP, 256, 129),
                                      (dict(SMALL, W=60), 60, 1000),
                                      (dict(SMALL, embed_multires=-1, skips=[1, 3]), 32, 300)])
def test_backward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 3 against its plain version: every weight and bias grad and
    x_bar, max|diff| <= 5e-4 max|ref| per leaf (fp32 sums over all points
    in another order; the JAX package's full-step bound). M = 4099, 1000,
    300, 129 and 37 leave a ragged last 128-point tile; M = 0 gives zeros;
    W = 60 is no multiple of the MMA's 8."""
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
@pytest.mark.parametrize("cfg,geo,M", [(SMALL, 64, 5000), (FLAGSHIP, 256, 4099)],
                         ids=["small", "flagship_ragged"])
def test_backward_kernel_is_deterministic(cuda, cfg, geo, M):
    """Two runs give bit-equal gradients (no atomics; fixed-order sums), also
    with a ragged last tile."""
    surf = _model(cfg, geo, cuda).implicit_surface
    x = torch.rand(M, 3, device=cuda) - 0.5
    cots = [torch.ones(M, device=cuda), torch.ones(M, 3, device=cuda),
            torch.ones(M, geo, device=cuda)]
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
                                      (FLAGSHIP, 256, 0),
                                      (FLAGSHIP, 256, 127),
                                      (FLAGSHIP, 256, 128),
                                      (FLAGSHIP, 256, 129),
                                      (FLAGSHIP, 256, 1),
                                      (dict(SMALL, W=60), 60, 1000),
                                      (dict(FLAGSHIP, embed_multires=-1), 256, 300)])
def test_sdf_forward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 4 against its plain version: max|diff| <= 1e-5 max|sdf| (fp32
    sums in another order). M = 4099, 1000, 300, 129, 127, 37 and 1 leave a
    ragged last 128-point tile, M = 128 and 4096 none; M = 0 returns an empty
    tensor without a launch; W = 60 is no multiple of the MMA's 8."""
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
def test_sdf_forward_keeps_its_pack_until_the_weights_change(cuda):
    """A repeated call with unchanged weights packs nothing; after an
    in-place update the next call packs again and follows the new weights."""
    surf = _model(FLAGSHIP, 256, cuda).implicit_surface
    x = torch.rand(4096, 3, device=cuda) * 2 - 1
    fused_mlp.fused_sdf_forward(surf, x)
    n = surface_pack.packed_surface.packs
    for _ in range(3):
        fused_mlp.fused_sdf_forward(surf, x)
    assert surface_pack.packed_surface.packs == n
    with torch.no_grad():
        surf.layers[-1].b.add_(0.25)
    got = fused_mlp.fused_sdf_forward(surf, x)
    torch.cuda.synchronize()
    assert surface_pack.packed_surface.packs == n + 1
    ref = fused_mlp.sdf_forward_plain(surf, x)
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


def _fine_sample_both(cuda, surface_cfg, geo, N, n0, n_up, max_iter, perturb, beta=0.35,
                      n_final=16):
    """The VolSDF fine sampler through kernels (a)-(c) and kernel 4, and its
    plain version, on rays from (0, 0, -3) inside the background sphere."""
    surf = _model(surface_cfg, geo, cuda).implicit_surface
    rays_o, rays_d = _rays(N, cuda)
    far = torch.full((N, 1), 6.0, device=cuda)
    d_init = (far * linspace01(n0, cuda)).contiguous()
    if perturb:
        u = torch.rand(N, (max_iter + 2) * n_final, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(5))
    else:
        u = fused_fine_sample.det_uniforms(n_final, max_iter + 2, N, cuda)
    kw = dict(eps=0.1, max_iter=max_iter, max_bisection=10, n_final=n_final, n_up=n_up,
              sphere_bg_r=3.0)
    ab = (torch.tensor(1.0 / beta, device=cuda), torch.tensor(beta, device=cuda))
    fns = (fused_fine_sample.launch_init, fused_fine_sample.launch_draw,
           fused_fine_sample.launch_checkpoint, fused_mlp.fused_sdf_forward)
    before = [f.launches for f in fns]
    got = fused_fine_sample.fused_fine_sample(surf, rays_o, rays_d, d_init, far, *ab, u, **kw)
    torch.cuda.synchronize()
    launched = [f.launches - b for f, b in zip(fns, before)]
    assert launched == ([1, max_iter, max_iter, 1 + max_iter] if N else [0, 0, 0, 0])
    ref = fused_fine_sample.fine_sample_plain(surf, rays_o, rays_d, d_init, far, *ab, u, **kw)
    return got, ref


def _assert_fine_samples_close(got, ref, span=6.0):
    """The JAX package's own bounds between its Pallas and plain samplers
    (tests/test_fused_fine_sample.py): <= 2% of the fine depths beyond 1e-4
    of the span, the beta map to rtol 1e-3 / atol 1e-5 (on >= 99% of the
    rays, as chip_smoke.py phase 14 holds it), iter_usage equal on >= 90% of
    the rays. The kernels' prefix sums run in another order than the plain
    cumsum, and kernel 4's MLP sums in another order than cuBLAS, so a bound
    that sits at eps can flip a round or a bisection step."""
    (gd, gb, gi), (rd, rb, ri) = got, ref
    assert gd.shape == rd.shape and gi.dtype == torch.int32
    assert bool(torch.isfinite(gd).all()) and bool(torch.isfinite(gb).all())
    assert float(((gd - rd).abs() > 1e-4 * span).float().mean()) <= 0.02
    assert float(((gb - rb).abs() > 1e-5 + 1e-3 * rb.abs()).float().mean()) <= 0.01
    assert float((gi == ri).float().mean()) >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,N,n0,n_up,max_iter,perturb,beta", [
    (dict(SMALL, skips=[1, 3]), 64, 203, 32, 32, 3, False, 0.35),
    (dict(SMALL, skips=[1, 3]), 64, 203, 32, 32, 3, True, 0.35),
    (dict(SMALL, sphere_residual=True), 64, 64, 50, 37, 2, True, 0.35),  # S = 124
    (FLAGSHIP, 256, 1024, 512, 512, 6, True, 0.1),
    (FLAGSHIP, 256, 0, 512, 512, 6, False, 0.1)])
def test_fine_sample_kernels_match_plain(cuda, cfg, geo, N, n0, n_up, max_iter, perturb,
                                         beta):
    """Kernels (a)-(c) with kernel 4 against the plain fine sampler: W=64
    with two skips on a ragged 203 rays, a sphere_residual prior with a
    buffer of 124 entries (not a multiple of 32), the flagship widths on
    1,024 rays (n0 = n_up = 512, 6 rounds: 3,584 depths a ray), and N = 0
    (empty outputs, no launch). At beta_net 0.01 or 0.001 on these rays
    3.3% of the fine depths moved beyond 1e-4 of the span (an H100): many
    rays run all 60 bisection steps, and the bounds scale kernel 4's ~1e-6
    sdf differences from cuBLAS by 1 / beta, so one flipped decision moves a
    ray's beta+ and its draws. Those betas are held by chip_smoke.py phase
    14 instead: end to end on the synthetic scene, and kernel by kernel on
    the plain stages' inputs."""
    got, ref = _fine_sample_both(cuda, cfg, geo, N, n0, n_up, max_iter, perturb, beta=beta)
    assert got[0].shape == (N, 16) and got[1].shape == (N,) and got[2].shape == (N,)
    if N:
        _assert_fine_samples_close(got, ref)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips when no card is present. This file imports no
JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from neurecon_tpu_torch.models.base import perturb_parameters, pretrain_siren_sdf
from neurecon_tpu_torch.models.frameworks.neus import NeuS, _uniforms
from neurecon_tpu_torch.ops import (fused_fine_sample, fused_mlp, fused_nablas,
                                    fused_nablas_vjp, fused_upsample, surface_pack)
from neurecon_tpu_torch.ops.ray import near_far_from_sphere
from neurecon_tpu_torch.ops.sampling import linspace01
from neurecon_tpu_torch.utils import mesh

SMALL = dict(W=64, D=4, skips=[2], radius_init=0.5, embed_multires=4)
FLAGSHIP = dict(W=256, D=8, skips=[4], radius_init=0.5, embed_multires=6)
# configs/volsdf_siren.yaml's surface, and a narrow one
SIREN = dict(W=256, D=5, skips=[], radius_init=1.0, embed_multires=-1, use_siren=True)
SIREN_SMALL = dict(W=64, D=3, skips=[], radius_init=1.0, embed_multires=-1, use_siren=True)


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


def _siren_surface(cfg, geo, device, seed=0):
    """A SIREN surface fitted to the unit sphere (300 pretrain iterations),
    then seeded noise on every weight: the stand-in for trained sine weights
    (the bare SIREN init is no sphere, and its sdf is near constant)."""
    model = NeuS(W_geo_feat=geo, surface_cfg=cfg,
                 radiance_cfg=dict(D=1, W=32, skips=[], embed_multires=-1,
                                   embed_multires_view=-1))
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model = model.to(device)
    pretrain_siren_sdf(model.implicit_surface, num_iters=300, lr=1e-4, target_radius=1.0,
                       obj_bounding_size=3.0,
                       generator=torch.Generator(device).manual_seed(seed + 7))
    perturb_parameters(model, torch.Generator().manual_seed(seed + 1))
    return model.implicit_surface


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
    N = 203  # not a multiple of the kernel's 4 rays per block
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
@pytest.mark.parametrize("M", [1, 127, 128, 129, 300])
def test_nablas_kernel_ragged_sizes(cuda, M):
    """Kernel 1 on 128-point tiles at the flagship widths: fewer points than
    a tile, one short of it, exactly one, one past it, and a caster's few
    hundred hit points; outputs filled with NaN beforehand, so an unwritten
    entry cannot pass."""
    surf = _model(FLAGSHIP, 256, cuda).implicit_surface
    x = torch.tensor(np.random.RandomState(M).randn(M, 3).astype(np.float32) * 0.6,
                     device=cuda)
    nan = [torch.full(shape, float("nan"), device=cuda) for shape in ((M,), (M, 3), (M, 256))]
    del nan
    got = fused_nablas.fused_forward_with_nablas(surf, x)
    torch.cuda.synchronize()
    ref = fused_nablas.forward_with_nablas_plain(surf, x)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 512, 1100, 4096])
def test_upsample_kernel_block_shapes(cuda, N):
    """Kernel 2 on its two block shapes: 4 rays on 64-point tiles (1 ray; a
    training step's 512, which must give at least 128 blocks, or every SM of
    a smaller card) and 8 rays on 128-point tiles (1,100: not a multiple of
    8; a render chunk's 4,096), flagship surface, det and perturb, at phase
    3's shares."""
    surf = _model(FLAGSHIP, 256, cuda).implicit_surface
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    P, R = fused_upsample.block_shape(N, sms)
    assert (P, R) == ((128, 8) if N >= 1100 else (64, 4))
    if N == 512:
        assert -(-N // R) >= min(128, sms)
    rays_o, rays_d = _rays(N, cuda)
    near, far = near_far_from_sphere(rays_o, rays_d, r=1.0)
    t = torch.linspace(0, 1, 64, device=cuda)
    d_coarse = (near * (1 - t) + far * t).contiguous()
    span = float((far - near).max())
    for perturb in (False, True):
        u = _uniforms(N, 4, 16, perturb, torch.Generator(cuda).manual_seed(3), cuda)
        got = fused_upsample.fused_neus_upsample(surf, rays_o, rays_d, d_coarse, u,
                                                 n_iters=4, n_per_iter=16)
        ref = fused_upsample.neus_upsample_plain(surf, rays_o, rays_d, d_coarse, u,
                                                 n_iters=4, n_per_iter=16)
        torch.cuda.synchronize()
        assert got.shape == (N, 128) and bool(torch.isfinite(got).all())
        assert bool((got[:, 1:] >= got[:, :-1]).all())
        off = (got - ref).abs() > 1e-3 * span
        assert float(off.float().mean()) <= (1e-3 if perturb else 5e-3)


@pytest.mark.cuda
def test_one_pack_per_training_step(cuda):
    """A training step (kernel 2, then kernel 1 under autograd, then kernel
    3 in the backward, then an Adam step) packs the surface's weights once:
    kernels 1 and 3 read the pack kernel 2 made from the same parameters.
    A render chunk after the first packs nothing."""
    model = _model(SMALL, 64, cuda)
    surf = model.implicit_surface
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    rays_o, rays_d = _rays(64, cuda)
    near, far = near_far_from_sphere(rays_o, rays_d, r=1.0)
    t = torch.linspace(0, 1, 64, device=cuda)
    d_coarse = (near * (1 - t) + far * t).contiguous()
    u = _uniforms(64, 4, 16, False, None, cuda)
    counters = (fused_upsample.fused_neus_upsample, fused_nablas.fused_forward_with_nablas,
                fused_nablas_vjp.fused_nablas_vjp)
    for _ in range(3):
        packs, launches = surface_pack.pack.packs, [f.launches for f in counters]
        d_all = fused_upsample.fused_neus_upsample(surf, rays_o, rays_d, d_coarse, u,
                                                   n_iters=4, n_per_iter=16)
        pts = rays_o[:, None] + rays_d[:, None] * d_all[..., None]
        sdf, nablas, h = surf.forward_with_nablas(pts)
        loss = (sdf.square().mean() + (nablas.norm(dim=-1) - 1).square().mean()
                + h.square().mean())
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        assert surface_pack.pack.packs == packs + 1
        assert [f.launches for f in counters] == [n + 1 for n in launches]
    with torch.no_grad():
        for chunk in range(3):
            packs = surface_pack.pack.packs
            d_all = fused_upsample.fused_neus_upsample(surf, rays_o, rays_d, d_coarse, u,
                                                       n_iters=4, n_per_iter=16)
            surf.forward_with_nablas(rays_o[:, None] + rays_d[:, None] * d_all[..., None])
            assert surface_pack.pack.packs == packs + (chunk == 0)


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
    assert launched == ([1, 1, max_iter, 1 + max_iter] if N else [0, 0, 0, 0])
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
    (FLAGSHIP, 256, 0, 512, 512, 6, False, 0.1),
    (SMALL, 64, 96, 1024, 1024, 4, True, 0.35),  # S = 5,120: 512-thread blocks
    (SMALL, 64, 48, 2048, 2048, 5, False, 0.35)])  # S = 12,288: 1,024-thread blocks
def test_fine_sample_kernels_match_plain(cuda, cfg, geo, N, n0, n_up, max_iter, perturb,
                                         beta):
    """Kernels (a)-(c) with kernel 4 against the plain fine sampler: W=64
    with two skips on a ragged 203 rays, a sphere_residual prior with a
    buffer of 124 entries (not a multiple of 32), the flagship widths on
    1,024 rays (n0 = n_up = 512, 6 rounds: 3,584 depths a ray), N = 0
    (empty outputs, no launch), and buffers of 5,120 and 12,288 depths (the
    kernels' 512- and 1,024-thread blocks). At beta_net 0.01 or 0.001 on these rays
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


def _sampler_inputs(cuda, N=256, n0=512, seed=0):
    """Phase 14's surface and the first N of its rays (chip_smoke's
    `volsdf_check_inputs`), d_init over [0, far]."""
    import chip_smoke

    *_, checked, _, _, _, (rays_o, rays_d, far) = chip_smoke.volsdf_check_inputs(seed, cuda)
    rays_o, rays_d, far = rays_o[:N].contiguous(), rays_d[:N].contiguous(), far[:N].contiguous()
    return checked.implicit_surface, rays_o, rays_d, far, (far * linspace01(n0, cuda)).contiguous()


@pytest.mark.cuda
def test_draw_and_merge_kernels_at_ties_and_flat_segments(cuda):
    """chip_smoke's `_sampler_edges`: kernel (b) against `draw_plain` on
    equal bounds whose every u_j equals a cdf entry (all sums exact: bit for
    bit) and on zero bounds beside one of 1.0, where ~3% of the draws fall
    in cdf steps below 1e-5 (the denominator rule; share beyond 1e-4 of the
    span at most 1%); kernel (c)'s merge with new depths equal to every
    other old one and another sdf there: the merged depths equal the stable
    sort's, and the sdf sits in its order (old before new)."""
    import chip_smoke

    surf, rays_o, rays_d, far, d_init = _sampler_inputs(cuda)
    ab = (torch.tensor(10.0, device=cuda), torch.tensor(0.1, device=cuda))
    with torch.no_grad():
        edges = chip_smoke._sampler_edges(surf, rays_o, rays_d, d_init, far, ab,
                                          fused_fine_sample.det_uniforms(16, 4, 256, cuda),
                                          n_final=16)
    assert edges["draw_ties"] == 0.0
    assert edges["draw_flat_share"] <= 0.01
    assert edges["merge_ties_sdf"] <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.1, 0.001])
def test_checkpoint_kernel_in_lockstep(cuda, beta):
    """Each of kernels (a)-(c) on its plain stage's inputs (chip_smoke's
    `_lockstep`): (a)'s round-0 depths equal d_init and the merged depths
    the stable sort's, bit for bit, every share at most 1% (phase 14's
    gates), the det draws of (b) and of (c)'s tail sorted, and the round-0
    and merged sdf within 1e-5."""
    import chip_smoke

    surf, rays_o, rays_d, far, d_init = _sampler_inputs(cuda)
    ab = (torch.tensor(1.0 / beta, device=cuda), torch.tensor(beta, device=cuda))
    u = torch.rand(256, 8 * 16, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    with torch.no_grad():
        err, merged_equal = chip_smoke._lockstep(surf, rays_o, rays_d, d_init, far, ab, u,
                                                 n_up=512, max_iter=6, n_final=16)
    assert merged_equal
    assert max(v for e in err.values() for k, v in e.items() if k.endswith("share")) <= 0.01
    assert max(e.get("unsorted_rays", 0.0) for e in err.values()) == 0
    assert max(e.get("sdf", 0.0) for e in err.values()) <= 1e-5


@pytest.mark.cuda
def test_fused_draw_matches_draw_plain_on_its_own_bounds(cuda):
    """Kernel (c)'s tail draws the next round from the bounds it computed;
    `draw_plain` on the plain bounds of (c)'s own merged buffer and beta
    (error_bound at (1 / beta, beta), clipped to [0, 1e5]) gives the same
    depths but for at most 1% beyond 1e-4 of the span (sums in another
    order), and they ascend."""
    surf, rays_o, rays_d, far, d_init = _sampler_inputs(cuda)
    N, n0, n_up, n_final = 256, 512, 512, 16
    ab = torch.tensor([1000.0, 0.001], device=cuda)
    u = fused_fine_sample.det_uniforms(n_final, 4, N, cuda)
    ws = fused_fine_sample.workspace(N, n0 + 2 * n_up, n_final, cuda)
    kw = dict(n_final=n_final, u_stride=u.shape[1], eps=0.1, prior_r=-1.0, bg_r=3.0)
    with torch.no_grad():
        pts = (rays_o[:, None] + rays_d[:, None] * d_init[..., None]).reshape(-1, 3)
        fused_fine_sample.launch_init(ws, rays_o, rays_d, d_init,
                                      fused_mlp.fused_sdf_forward(surf, pts), far, ab, u,
                                      beta_c=fused_fine_sample.beta_plus_denominator(n0, 0.1),
                                      **kw)
        nd, pts = fused_fine_sample.launch_draw(ws, rays_o, rays_d, 0, n0, n_up)
        nd2, _ = fused_fine_sample.launch_checkpoint(
            ws, rays_o, rays_d, 0, n0, nd, fused_mlp.fused_sdf_forward(surf, pts), ab, u, it=1,
            max_iter=2, max_bisection=10, **kw)
        P = n0 + n_up
        d, s, beta = ws["d"][1][:, :P], ws["s"][1][:, :P], ws["beta"][:, None]
        bounds = torch.clamp(fused_fine_sample.error_bound(d, s, 1.0 / beta, beta), 0.0, 1e5)
        want = fused_fine_sample.draw_plain(d, bounds, n_up)
    torch.cuda.synchronize()
    assert bool((nd2[:, 1:] >= nd2[:, :-1]).all())
    assert float(((nd2 - want).abs() > 1e-4 * far).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [0.1, 0.001])
@pytest.mark.parametrize("N", [1, 203, 1024])
@pytest.mark.parametrize("n0", [2, 50, 512, 2048])
def test_init_kernel_matches_init_plain(cuda, n0, N, beta):
    """Kernel (a) alone against `init_plain` on the same finished sdf (a
    sphere of radius 1 with seeded noise, min the background sphere): n0 = 2
    is one interval (most threads own none), 2,048 the chunk of 8. Phase
    14's lockstep gates: the finished sdf within 1e-5, at most 1% of the
    bounds beyond rtol 1e-3 / atol 1e-6, at most 1% of the rays off in beta
    (rtol 1e-3 / atol 1e-5), in converged or in iter_usage, at most 1% of
    the fine depths beyond 1e-4 of the span; the round-0 depths equal d_init
    exactly. The workspace starts as NaN, and its rows have a stride of n0 +
    5 entries."""
    n_final, S = 16, n0 + 5
    rays_o, rays_d = _rays(N, cuda, seed=n0)
    far = torch.full((N, 1), 6.0, device=cuda)
    d_init = (far * linspace01(n0, cuda)).contiguous()
    pts = rays_o[:, None] + rays_d[:, None] * d_init[..., None]
    g = torch.Generator(cuda).manual_seed(n0 + N)
    raw = (pts.norm(dim=-1) - 1.0 + 0.02 * torch.randn(N, n0, device=cuda, generator=g))
    u = torch.rand(N, 3 * n_final, device=cuda, generator=g)
    ab = torch.tensor([1.0 / beta, beta], device=cuda)
    ws = fused_fine_sample.workspace(N, S, n_final, cuda)
    for t in ws.values():
        if torch.is_tensor(t) and t.is_floating_point():
            t.fill_(float("nan"))
    before = fused_fine_sample.launch_init.launches
    with torch.no_grad():
        fused_fine_sample.launch_init(
            ws, rays_o, rays_d, d_init, raw.reshape(-1).contiguous(), far, ab, u,
            n_final=n_final, u_stride=u.shape[1], eps=0.1,
            beta_c=fused_fine_sample.beta_plus_denominator(n0, 0.1), prior_r=-1.0, bg_r=3.0)
        sdf = fused_fine_sample.background_min(raw, pts, 3.0)
        want = fused_fine_sample.init_plain(d_init, sdf, far, ab[0], ab[1], u[:, :n_final],
                                            eps=0.1)
    torch.cuda.synchronize()
    assert fused_fine_sample.launch_init.launches == before + 1

    def off(a, b, rtol, atol):
        return float((~((a - b).abs() <= atol + rtol * b.abs())).float().mean())

    assert torch.equal(ws["d"][0][:, :n0], d_init)
    assert float((ws["s"][0][:, :n0] - sdf).abs().max()) <= 1e-5
    assert off(ws["bounds"][:, :n0 - 1], want["bounds"], 1e-3, 1e-6) <= 0.01
    assert off(ws["beta"], want["beta"][:, 0], 1e-3, 1e-5) <= 0.01
    assert float((ws["converged"].bool() != want["converged"]).float().mean()) <= 0.01
    assert float((ws["iter_usage"] != want["iter_usage"]).float().mean()) <= 0.01
    assert off(ws["fine"], want["fine"], 0.0, 1e-4 * 6.0) <= 0.01


@pytest.mark.cuda
def test_sharp_beta_sampler_at_phase14_gates(cuda):
    """One call at beta_net 0.001 (six rounds of bisection for the rays that
    never converge, then the fallback draw) on phase 14's rays, through
    chip_smoke's `_sampler_check`: end to end and in lockstep, with the
    merge-tie and det-draw edge checks, at phase 14's gates."""
    import chip_smoke

    *_, checked, _, _, _, (rays_o, rays_d, far) = chip_smoke.volsdf_check_inputs(0, cuda)
    ok, _, _ = chip_smoke._sampler_check(checked.implicit_surface, rays_o, rays_d, far, (0.001,),
                                         512, 512, 6, 0, "sharp beta")
    assert ok


# ---- the sine branch (SIREN surfaces), held at the Softplus cases' limits


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,M", [(SIREN, 256, 4099), (SIREN, 256, 129),
                                      (SIREN_SMALL, 64, 1000)])
def test_sine_sdf_forward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 4's sine branch on points in the scene's box [-3, 3]^3 (30 a
    reaches tens of radians on the first layer): max|diff| <= 1e-5 max|sdf|."""
    surf = _siren_surface(cfg, geo, cuda)
    x = torch.tensor(np.random.RandomState(4).uniform(-3, 3, (M, 3)).astype(np.float32),
                     device=cuda)
    got = fused_mlp.fused_sdf_forward(surf, x)
    torch.cuda.synchronize()
    ref = fused_mlp.sdf_forward_plain(surf, x)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,M", [(SIREN, 256, 4099), (SIREN_SMALL, 64, 1000)])
def test_sine_nablas_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 1's sine branch (slopes 30 cos(30 a)): sdf and h atol 1e-4,
    nablas rtol 2e-3 / atol 2e-4, as the Softplus cases."""
    surf = _siren_surface(cfg, geo, cuda)
    x = torch.tensor(np.random.RandomState(1).uniform(-3, 3, (M, 3)).astype(np.float32),
                     device=cuda)
    got = fused_nablas.fused_forward_with_nablas(surf, x)
    torch.cuda.synchronize()
    ref = fused_nablas.forward_with_nablas_plain(surf, x)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=2e-3, atol=2e-4)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg,geo,M", [(SIREN, 256, 4099), (SIREN_SMALL, 64, 300)])
def test_sine_backward_kernel_matches_plain(cuda, cfg, geo, M):
    """Kernel 3's sine branch (phi'' = -900 sin(30 a), from the next layer's
    input kept in the workspace): every leaf within 5e-4 of its max|ref|."""
    surf = _siren_surface(cfg, geo, cuda)
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.uniform(-3, 3, (M, 3)).astype(np.float32), device=cuda)
    cots = [torch.tensor(rng.randn(*s).astype(np.float32), device=cuda)
            for s in ((M,), (M, 3), (M, geo))]
    ws, bs = [[t.detach() for t in ts] for ts in fused_nablas.surface_weights(surf)]
    got = fused_nablas_vjp.fused_nablas_vjp(surf, x, ws, bs, *cots)
    torch.cuda.synchronize()
    ref = fused_nablas_vjp.nablas_vjp_plain(surf, x, ws, bs, *cots)
    leaves = [(got[0], ref[0])] + list(zip(got[1], ref[1])) + list(zip(got[2], ref[2]))
    for i, (g, r) in enumerate(leaves):
        assert bool(torch.isfinite(g).all()), i
        assert float((g - r).abs().max()) <= 5e-4 * float(r.abs().max()), i


@pytest.mark.cuda
@pytest.mark.parametrize("perturb", [False, True])
def test_sine_upsample_kernel_matches_plain(cuda, perturb):
    """Kernel 2's sine branch with a D=5 SIREN surface (the unit sphere)
    on rays from (0, 0, -3), near / far on the sphere of radius 2: the
    Softplus cases' shares."""
    surf = _siren_surface(SIREN, 256, cuda)
    N = 203
    rays_o, rays_d = _rays(N, cuda)
    near, far = near_far_from_sphere(rays_o, rays_d, r=2.0)
    t = torch.linspace(0, 1, 64, device=cuda)
    d_coarse = (near * (1 - t) + far * t).contiguous()
    u = _uniforms(N, 4, 16, perturb, torch.Generator(cuda).manual_seed(3), cuda)
    got = fused_upsample.fused_neus_upsample(surf, rays_o, rays_d, d_coarse, u,
                                             n_iters=4, n_per_iter=16)
    ref = fused_upsample.neus_upsample_plain(surf, rays_o, rays_d, d_coarse, u,
                                             n_iters=4, n_per_iter=16)
    torch.cuda.synchronize()
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    off = (got - ref).abs() > 1e-3 * float((far - near).max())
    assert float(off.float().mean()) <= (1e-3 if perturb else 5e-3)


@pytest.mark.cuda
def test_sine_kernels_follow_the_activation(cuda):
    """The activation reaches every launch: the same weights as a SIREN
    surface and as a Softplus one give each kernel's own plain version, not
    the other's (a wrapper that dropped the flag would run Softplus on sine
    weights)."""
    surf = _siren_surface(SIREN_SMALL, 64, cuda)
    x = torch.rand(500, 3, device=cuda) * 6 - 3
    for use_siren in (True, False):
        surf.use_siren = use_siren
        ref = fused_mlp.sdf_forward_plain(surf, x)
        got4 = fused_mlp.fused_sdf_forward(surf, x)
        got1 = fused_nablas.fused_forward_with_nablas(surf, x)[0]
        torch.cuda.synchronize()
        for got in (got4, got1):
            assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


"""The split-fp32 ("3xTF32") scheme of the tensor-core kernels
(`csrc/surface_mma.cuh`), their weight pack (`ops/surface_pack.py`) and its
cache, on the CPU.

The kernels cannot run here, so their arithmetic is emulated in torch on the
pack they read: `cvt.rna.tf32.f32` by integer operations on the float's bits
(exact; the pack's own `surface_pack.tf32_rna`, also the kernels' rounding),
each operand split into big + small, and every layer product summed per
k-step of 8 as small_a big_b + big_a small_b + big_a big_b, the small terms
first, and added to a running fp32 sum. The emulated sdf-only forward
(kernel 4) is held to the JAX package's Pallas kernel (interpret mode) and
to the port's plain version within kernel 4's card limit, 1e-5 of max|sdf|;
a single TF32 product is shown to miss that limit, so the check can see
TF32 rounding. The emulated forward + nablas (kernel 1: the final layer's
first 256 outputs as a product and the rest in fp32, the reverse sweep
through the pack's W planes) and the upsampler's sdf queries (kernel 2) are
held to the JAX package's Pallas kernels and the plain versions at the card
checks' gates (`chip_smoke.py` phases 2 and 3).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
from neurecon_tpu.ops import near_far_from_sphere as jax_near_far
from neurecon_tpu.ops.fused_mlp import fused_sdf_forward as jax_fused_sdf_forward
from neurecon_tpu.ops.fused_nablas import fused_forward_with_nablas as jax_fused_nablas
from neurecon_tpu.ops.fused_upsample import fused_neus_upsample as jax_fused_upsample

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import (SIREN_W0, ImplicitSurface, effective_weight,
                                            perturb_parameters, sphere_sdf)
from neurecon_tpu_torch.models.frameworks.neus import _uniforms
from neurecon_tpu_torch.ops import fused_upsample, surface_pack
from neurecon_tpu_torch.ops.fused_mlp import sdf_forward_plain
from neurecon_tpu_torch.ops.fused_nablas import forward_with_nablas_plain

FLAGSHIP = dict(W=256, D=8, skips=[4], W_geo_feat=256, radius_init=0.5, embed_multires=6)
W60 = dict(W=60, D=4, skips=[2], W_geo_feat=60, radius_init=0.5, embed_multires=4)
SIREN = dict(W=256, D=5, skips=[], W_geo_feat=256, radius_init=1.0, embed_multires=-1,
             use_siren=True)
LIMIT = 1e-5  # kernel 4's card check (chip_smoke.py phase 10), of max|sdf|
NMAX = 256    # final-layer outputs the narrow kernel 1 product takes (csrc tc::Narrow::NMAX)
INV_SQRT2 = torch.tensor(1.0) / torch.tensor(1.41421356237)  # the kernels' 1.f / 1.41421356237f


tf32_rna, split = surface_pack.tf32_rna, surface_pack.split_tf32


def mma(a: torch.Tensor, b: torch.Tensor, terms: int = 3, b_parts=None) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels accumulate it: per k-step of 8 the
    products in fp32, added to the running fp32 sum; with terms=3 the
    split-fp32 products (small terms first), with terms=1 a single TF32
    product. `b_parts`: b's (big, small) as the pack stores them."""
    a_big, a_small = split(a)
    b_big, b_small = b_parts if b_parts is not None else split(b)
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        step = a_big[:, s] @ b_big[s]
        if terms == 3:
            step = (a_small[:, s] @ b_big[s] + a_big[:, s] @ b_small[s]) + step
        acc = acc + step
    return acc


def _block(planes, off, rows, cols):
    """A [rows][cols] block of the pack at `off` in each of its three planes."""
    return [q[off:off + rows * cols].view(rows, cols) for q in planes]


def emulate_hidden(surface, pk, x: torch.Tensor, terms: int = 3):
    """The hidden layers as the tensor-core kernels run them on the pack `pk`:
    the encoding in c_pad rows, the skip input (the encoding right after h,
    divided by sqrt(2)), every product through `mma` with the weights' TF32
    parts from the pack's big and small planes, and the activation epilogue
    (Softplus(beta = 100) as the plain version computes it, threshold 20, and
    sigmoid(100 a), or sin(30 a) and 30 cos(30 a); padded outputs written as
    0). Returns (h_D [M, K_D], the slopes [M, N_l]
    of every hidden layer)."""
    planes = pk.params.view(3, pk.plane)
    params, records = planes[0], pk.meta.tolist()
    C, M = surface.input_ch, x.shape[0]
    emb = torch.zeros(M, pk.c_pad)
    emb[:, :C] = surface.embed_fn(x)
    buf, slopes = None, []
    for l in range(surface.D):
        K, N, out_dim, in_dim, off_wT, _, off_b, skip = records[l]
        if l == 0:
            v = emb
        elif skip:
            h_dim = in_dim - C
            v = torch.zeros(M, K)
            v[:, :h_dim] = buf[:, :h_dim]
            v[:, h_dim:in_dim] = emb[:, :C]
            v = v / torch.tensor(1.41421356237, dtype=torch.float32)
        else:
            v = buf[:, :K]
        w = _block(planes, off_wT, K, N)
        a = mma(v, w[0], terms, b_parts=(w[1], w[2])) + params[off_b:off_b + N]
        if surface.use_siren:
            y = SIREN_W0 * a
            buf, slope = torch.sin(y), SIREN_W0 * torch.cos(y)
        else:
            y = 100.0 * a
            buf = torch.where(y > 20.0, y, torch.log1p(torch.exp(y))) / 100.0
            slope = torch.sigmoid(y)
        buf[:, out_dim:] = 0.0
        slope[:, out_dim:] = 0.0
        slopes.append(slope)
    return buf, slopes


def emulate_sdf_forward(surface, x: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """csrc/sdf_forward.cu on the CPU: `emulate_hidden` on its pack, then its
    fp32 sdf row."""
    pk = surface_pack.pack(surface)
    params, records = pk.params[:pk.plane], pk.meta.tolist()
    buf, _ = emulate_hidden(surface, pk, x, terms)
    K, N, _, _, _, off_w, off_b, _ = records[surface.D]
    return buf[:, :K] @ params[off_w:off_w + K] + params[off_b]


def emulate_nablas_forward(surface, x: torch.Tensor):
    """csrc/nablas_forward.cu on the CPU, on the surface's kept pack:
    `emulate_hidden`; the final layer's first 256 outputs as one product
    (sdf and h straight from it) and any output past them in fp32 on the
    CUDA cores; the nablas sweep from W_D's sdf row, g <- (g s_l) W_l
    through the W planes of the pack, the skip's and layer 0's encoding rows
    split off into g_e (divided by sqrt(2) at the skip); the encoding
    pullback. Returns (sdf [M], nablas [M, 3], h [M, W_geo])."""
    pk = surface_pack.packed_surface(surface)
    planes = pk.params.view(3, pk.plane)
    params, records = planes[0], pk.meta.tolist()
    C, M, D = surface.input_ch, x.shape[0], surface.D
    h, slopes = emulate_hidden(surface, pk, x)
    K, N, out_dim, _, off_wT, off_w, off_b, _ = records[D]
    n0 = min(N, NMAX)
    wT = _block(planes, off_wT, K, N)
    out = mma(h[:, :K], wT[0][:, :n0].contiguous(), 3,
              b_parts=(wT[1][:, :n0].contiguous(), wT[2][:, :n0].contiguous()))
    out = out[:, :min(out_dim, n0)] + params[off_b:off_b + min(out_dim, n0)]
    W = _block(planes, off_w, N, K)
    extra = h[:, :K] @ W[0][n0:out_dim].t() + params[off_b + n0:off_b + out_dim]
    y = torch.cat([out, extra], 1)

    g = W[0][0].expand(M, -1)
    ge = torch.zeros(M, pk.c_pad)
    for l in reversed(range(D)):
        K, N, _, in_dim, _, off_w, _, skip = records[l]
        W = _block(planes, off_w, N, K)
        g = mma(g[:, :N] * slopes[l], W[0], 3, b_parts=(W[1], W[2]))
        if l == 0:
            ge[:, :C] += g[:, :C]
        elif skip:
            h_dim = in_dim - C
            v = g[:, :in_dim] * INV_SQRT2
            ge[:, :C] += v[:, h_dim:]
            g = torch.nn.functional.pad(v[:, :h_dim], (0, K - h_dim))
    nablas = ge[:, :3].clone()
    for f in range((C - 3) // 6):
        fr, ph = 2.0 ** f, x * 2.0 ** f
        nablas = nablas + fr * (ge[:, 3 + 6 * f:6 + 6 * f] * torch.cos(ph)
                                - ge[:, 6 + 6 * f:9 + 6 * f] * torch.sin(ph))
    return y[:, 0], nablas, y[:, 1:]


def _surfaces(cfg, seed=0):
    """The JAX surface and params, and the port's surface with the same
    weights plus seeded noise on every weight (octave columns included)."""
    js = JaxSurface(**cfg)
    params = jax.tree_util.tree_map(np.asarray, js.init(jax.random.PRNGKey(seed)))
    ts = ImplicitSurface(**cfg)
    bridge.load_surface_tree(ts, params)
    perturb_parameters(ts, torch.Generator().manual_seed(seed + 1))
    params = {"layers": [{n: getattr(l, n).detach().numpy().copy() for n in ("v", "g", "b")}
                         for l in ts.layers]}
    return js, jax.tree_util.tree_map(jnp.asarray, params), ts


@pytest.fixture(scope="module")
def flagship():
    """The flagship surface pair and 2,048 seeded points with the JAX Pallas
    kernel's sdf (interpret mode) and the port's plain sdf."""
    js, params, ts = _surfaces(FLAGSHIP)
    x = np.random.RandomState(3).uniform(-1, 1, (2048, 3)).astype(np.float32)
    want = np.asarray(jax_fused_sdf_forward(js, params, jnp.asarray(x), tile=512,
                                            interpret=True))
    plain = sdf_forward_plain(ts, torch.tensor(x)).numpy()
    return ts, torch.tensor(x), want, plain


@pytest.mark.parametrize("value,rounded", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),       # just below the tie
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
    (0.0, 0.0),
    (3.0e-39, 3.0e-39 - (3.0e-39 % 2.0 ** -136)),  # subnormal: 10 bits kept too
])
def test_tf32_rounding_is_exact(value, rounded):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    want = torch.tensor([rounded], dtype=torch.float32)
    assert torch.equal(got, want), (float(got), float(want))
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_split_reconstructs_flagship_weights(flagship):
    """big + small gives back every flagship weight and bias within 2^-21
    of its magnitude (the dropped part is small's rounding, ~2^-22)."""
    ts = flagship[0]
    for layer in ts.layers:
        for w in (effective_weight(layer).detach(), layer.b.detach()):
            big, small = split(w)
            assert int(big.view(torch.int32).bitwise_and(0x1FFF).abs().max()) == 0
            err = ((big.double() + small.double()) - w.double()).abs()
            assert bool((err <= 2.0 ** -21 * w.double().abs()).all()), float(err.max())


def test_split_fp32_forward_matches_jax_and_plain(flagship):
    """The emulated kernel 4 on the flagship surface (2,048 points): within
    1e-5 of max|sdf| of JAX's Pallas kernel and of the port's plain
    version."""
    ts, x, want, plain = flagship
    got = emulate_sdf_forward(ts, x).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= LIMIT * scale, np.abs(got - want).max() / scale
    assert np.abs(got - plain).max() <= LIMIT * np.abs(plain).max()


def test_single_tf32_product_misses_the_limit(flagship):
    """Negative control: the same forward with one TF32 product per layer
    (no correction terms) is beyond 1e-5 of max|sdf|, so the check sees TF32
    rounding."""
    ts, x, want, plain = flagship
    got = emulate_sdf_forward(ts, x, terms=1).numpy()
    assert np.abs(got - plain).max() > LIMIT * np.abs(plain).max()
    assert np.abs(got - want).max() > LIMIT * np.abs(want).max()


def test_split_fp32_weight_gradient_reduction():
    """One hidden layer's weight-gradient sum W_bar = sum_rows A (x) B at
    kernel 3's operand widths (256 x 256) over 32,768 workspace rows, against
    float64: split-fp32 within 4x the error of a plain fp32 sum (and 1e-5 of
    max|ref|), a single TF32 product more than 10x beyond it. A is
    gradient-like (signed), B activation-like (Softplus outputs,
    non-negative); partial sums over 4,096 rows are added in a fixed order,
    as the kernel's split-K partials are."""
    rng = np.random.RandomState(7)
    A = torch.tensor(rng.randn(32768, 256).astype(np.float32))
    B = torch.tensor(np.abs(rng.randn(32768, 256)).astype(np.float32) * 0.05)
    ref = A.double().t() @ B.double()

    def reduce(terms):
        if terms == 0:  # plain fp32
            parts = [A[r:r + 4096].t() @ B[r:r + 4096] for r in range(0, 32768, 4096)]
        else:
            parts = [mma(A[r:r + 4096].t().contiguous(), B[r:r + 4096], terms)
                     for r in range(0, 32768, 4096)]
        out = torch.zeros(256, 256)
        for p in parts:
            out = out + p
        return float((out.double() - ref).abs().max() / ref.abs().max())

    fp32, split3, single = reduce(0), reduce(3), reduce(1)
    assert split3 <= 4 * fp32 and split3 <= LIMIT, (split3, fp32)
    assert single > 10 * split3, (single, split3)


def _records(ts):
    return surface_pack.pack(ts).meta.tolist()


@pytest.mark.parametrize("cfg", [
    FLAGSHIP,
    dict(W=60, D=4, skips=[2], W_geo_feat=60, radius_init=0.5, embed_multires=4),
    dict(W=64, D=4, skips=[1, 3], W_geo_feat=64, radius_init=0.5, embed_multires=-1),
], ids=["flagship", "W60", "no_encoding"])
def test_pack_layout_and_padding(cfg):
    """The tensor-core pack: K and N padded to multiples of 8, every block at
    a multiple of 32 floats, W^T [K][N], W [N][K] and b [N] equal to the
    effective weights with zeros in every padded row and column, the big and
    small planes the exact TF32 split of the fp32 plane, the skip flags, and
    the encoding and activation row counts the kernels size their shared
    memory by."""
    ts = ImplicitSurface(**cfg)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    perturb_parameters(ts, torch.Generator().manual_seed(1))
    pk = surface_pack.pack(ts)
    assert pk.c_pad == surface_pack.pad8(ts.input_ch) and pk.c_pad % 8 == 0
    hidden = [max(surface_pack.pad8(i), surface_pack.pad8(o)) for i, o in ts.dims[:-1]]
    assert pk.rows == max(hidden + [surface_pack.pad8(ts.dims[-1][0])])
    assert pk.params.numel() == 3 * pk.plane
    fp32, big, small = pk.params.view(3, pk.plane)
    want_big, want_small = surface_pack.split_tf32(fp32)
    assert torch.equal(big, want_big) and torch.equal(small, want_small)
    covered = torch.zeros_like(fp32, dtype=torch.bool)
    for l, (rec, layer) in enumerate(zip(pk.meta.tolist(), ts.layers)):
        K, N, o, i, off_wT, off_w, off_b, skip = rec
        w = effective_weight(layer).detach()
        assert (o, i) == tuple(w.shape) and skip == int(l in cfg["skips"])
        assert K == surface_pack.pad8(i) and N == surface_pack.pad8(o)
        assert K % 8 == N % 8 == 0
        assert off_wT % 32 == off_w % 32 == off_b % 32 == 0
        assert off_wT + K * N <= off_w and off_w + N * K <= off_b
        wT = fp32[off_wT:off_wT + K * N].view(K, N)
        wf = fp32[off_w:off_w + N * K].view(N, K)
        assert torch.equal(wT[:i, :o], w.t()) and torch.equal(wf[:o, :i], w)
        assert not wT[i:].any() and not wT[:, o:].any()
        assert not wf[o:].any() and not wf[:, i:].any()
        assert torch.equal(fp32[off_b:off_b + o], layer.b.detach())
        assert not fp32[off_b + o:off_b + N].any()
        for a, n in ((off_wT, K * N), (off_w, N * K), (off_b, N)):
            covered[a:a + n] = True
    assert not fp32[~covered].any()


def test_pack_refuses_what_the_kernels_do_not_take():
    with pytest.raises(NotImplementedError):
        surface_pack.pack(ImplicitSurface(W=1040, D=4, skips=[2], W_geo_feat=64))
    with pytest.raises(NotImplementedError):
        surface_pack.pack(ImplicitSurface(W=64, D=4, skips=[2], W_geo_feat=1040))
    with pytest.raises(ValueError):
        surface_pack.pack(ImplicitSurface(W=64, D=4, skips=[0], W_geo_feat=64))


def _small_surface():
    ts = ImplicitSurface(W=64, D=4, skips=[2], W_geo_feat=64, radius_init=0.5,
                         embed_multires=4)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    return ts


def _hit(ts, before_pack):
    """Whether `packed_surface` returned the kept pack without packing."""
    n = surface_pack.packed_surface.packs
    got = surface_pack.packed_surface(ts)
    return got is before_pack and surface_pack.packed_surface.packs == n, got


def _fresh(ts, got):
    """The kept pack equals a pack made now."""
    now = surface_pack.pack(ts)
    return torch.equal(got.params, now.params)


def test_pack_cache_hits_while_the_weights_are_unchanged():
    ts = _small_surface()
    first = surface_pack.packed_surface(ts)
    for _ in range(3):
        hit, got = _hit(ts, first)
        assert hit
    # a deep copy is another surface: packed on its own
    other = copy.deepcopy(ts)
    n = surface_pack.packed_surface.packs
    assert surface_pack.packed_surface(other) is not first
    assert surface_pack.packed_surface.packs == n + 1


def _adam_step(ts):
    opt = torch.optim.Adam(ts.parameters(), lr=1e-3)
    ts.mlp(torch.rand(16, 3))[0].sum().backward()
    opt.step()


def _bridge_load(ts):
    tree = bridge._layers_to_tree(ts.layers)
    tree["layers"][1]["b"] = tree["layers"][1]["b"] + 0.5
    bridge.load_surface_tree(ts, tree)


def _state_dict_load(ts):
    sd = {k: v + 0.25 for k, v in ts.state_dict().items()}
    ts.load_state_dict(sd)


def _data_swap(ts):
    ts.layers[2].b.data = ts.layers[2].b.data + 1.0


@pytest.mark.parametrize("update", [
    _adam_step, _bridge_load, _state_dict_load,
    lambda ts: perturb_parameters(ts, torch.Generator().manual_seed(5)),
    _data_swap,
], ids=["adam_step", "bridge_load", "load_state_dict", "perturb_parameters", "data_swap"])
def test_pack_cache_misses_after_an_update(update):
    """After an in-place optimizer step, a bridge load, load_state_dict,
    perturb_parameters or a tensor swapped in through `.data`, the next call
    packs again, and the pack it keeps holds the new weights."""
    ts = _small_surface()
    first = surface_pack.packed_surface(ts)
    update(ts)
    hit, got = _hit(ts, first)
    assert not hit and got is not first
    assert _fresh(ts, got) and not torch.equal(got.params, first.params)
    assert _hit(ts, got)[0]


def _phase2_ok(got, ref):
    """chip_smoke.py phase 2's gates: sdf and h within 1e-4, nablas within
    2e-4 + 2e-3 |ref|."""
    sdf, nab, h = (torch.tensor(np.array(t)) for t in ref)
    return (float((got[0] - sdf).abs().max()) <= 1e-4
            and float((got[2] - h).abs().max()) <= 1e-4
            and bool(((got[1] - nab).abs() <= 2e-4 + 2e-3 * nab.abs()).all()))


@pytest.mark.parametrize("cfg,n", [(FLAGSHIP, 1024), (W60, 1000), (SIREN, 512)],
                         ids=["flagship", "W60", "sine"])
def test_split_fp32_nablas_forward_matches_jax_and_plain(cfg, n):
    """The emulated kernel 1 on its kept pack against JAX's Pallas nablas
    kernel (interpret mode) and the port's plain version, at phase 2's
    gates: the flagship (a skip, 257 final outputs, so one of them off the
    product), W = 60 (padded rows, a ragged last tile for JAX) and the SIREN
    surface (slopes 30 cos(30 a); 257 final outputs too)."""
    js, params, ts = _surfaces(cfg)
    pk = surface_pack.packed_surface(ts)
    K, N, out_dim = pk.meta.tolist()[ts.D][:3]
    assert out_dim == cfg["W_geo_feat"] + 1 and (N > NMAX) == (out_dim > NMAX)
    x = np.random.RandomState(4).uniform(-1, 1, (n, 3)).astype(np.float32)
    want = jax_fused_nablas(js, params, jnp.asarray(x), tile=256, interpret=True)
    plain = forward_with_nablas_plain(ts, torch.tensor(x))
    got = emulate_nablas_forward(ts, torch.tensor(x))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _phase2_ok(got, want) and _phase2_ok(got, plain)


class _KernelQuery:
    """Kernel 2's sdf query on the CPU: the emulated split-fp32 sdf-only
    forward plus the sphere prior, as `forward` of a surface for
    `neus_upsample_plain`, which runs the upsampler's scalar stages."""

    def __init__(self, surface):
        self.surface = surface

    def forward(self, pts):
        flat = pts.reshape(-1, 3)
        sdf = emulate_sdf_forward(self.surface, flat)
        if self.surface.sphere_residual:
            sdf = sdf + sphere_sdf(flat, self.surface.radius_init)
        return sdf.reshape(pts.shape[:-1])


def _phase3_share(got, ref, d_coarse, span):
    """chip_smoke.py phase 3's measure in det mode: the share of d_all
    entries beyond 1e-3 of the ray's span, up to one u = 1.0 tie entry per
    round per ray in the last coarse section exempt."""
    off = (got - ref).abs() > 1e-3 * span
    tie = off & (got >= d_coarse[:, -2:-1]) & (ref >= d_coarse[:, -2:-1])
    exempt = tie & (tie.sum(1, keepdim=True) <= 4)
    return float((off & ~exempt).float().mean())


@pytest.mark.parametrize("cfg", [
    dict(W=64, D=4, skips=[2], W_geo_feat=64, radius_init=0.5, embed_multires=4),
    dict(W=64, D=3, skips=[], W_geo_feat=64, radius_init=0.5, embed_multires=-1,
         use_siren=True),
], ids=["W64", "sine"])
def test_split_fp32_upsample_queries_match_jax(cfg):
    """Kernel 2 with every sdf query (64 coarse points a ray, then 16 a
    round) through the emulated split-fp32 forward, on 64 rays and the det
    uniforms: against JAX's Pallas upsampler (interpret mode) and the plain
    version, at most 0.1% of d_all beyond 1e-3 of the span (phase 3)."""
    js, params, ts = _surfaces(cfg)
    rng = np.random.RandomState(0)
    th = rng.uniform(-0.35, 0.35, (64, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape))
    near, far = jax_near_far(jnp.asarray(o), jnp.asarray(d), r=1.0)
    dc = np.asarray(near * (1 - jnp.linspace(0.0, 1.0, 64)) + far * jnp.linspace(0.0, 1.0, 64))
    u = _uniforms(64, 4, 16, False, None, torch.device("cpu"))
    want = np.asarray(jax_fused_upsample(js, params, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(dc), jnp.asarray(u.numpy()), n_iters=4,
                                         n_per_iter=16, tile=16, interpret=True))
    args = (torch.tensor(o), torch.tensor(d), torch.tensor(dc), u)
    got = fused_upsample.neus_upsample_plain(_KernelQuery(ts), *args, n_iters=4, n_per_iter=16)
    plain = fused_upsample.neus_upsample_plain(ts, *args, n_iters=4, n_per_iter=16)
    assert got.shape == (64, 128) and bool(torch.isfinite(got).all())
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    dct = torch.tensor(dc)
    span = dct[:, -1:] - dct[:, :1]
    assert _phase3_share(got, torch.tensor(want), dct, span) <= 1e-3
    assert _phase3_share(got, plain, dct, span) <= 1e-3


def test_pack_cache_holds_the_storages_it_keyed_on():
    """Two `.data` swaps: after the first, the storage the kept entry was
    keyed on has no other owner; the entry holds it, so no new tensor can be
    given its pointer (which, at version 0, would pass for the old key).
    After the second swap the next call packs the current values."""
    ts = _small_surface()
    b = ts.layers[2].b
    surface_pack.packed_surface(ts)
    keyed = b.data_ptr()
    b.data = b.data + 1.0
    assert all(torch.empty_like(b).data_ptr() != keyed for _ in range(64))
    second = surface_pack.packed_surface(ts)
    assert _fresh(ts, second)
    b.data = torch.full_like(b, 3.0)
    hit, got = _hit(ts, second)
    assert not hit and _fresh(ts, got)


def test_pack_cache_does_not_see_writes_through_data():
    """A write through `p.data` moves neither the pointer nor `p`'s version,
    so the kept pack comes back stale (as `packed_surface` documents); the
    same write to `p` itself under no_grad is seen."""
    ts = _small_surface()
    first = surface_pack.packed_surface(ts)
    b = ts.layers[1].b
    b.data.copy_(b.data + 0.5)
    hit, got = _hit(ts, first)
    assert hit and not _fresh(ts, got)
    with torch.no_grad():
        b.copy_(b + 0.5)
    hit, got = _hit(ts, first)
    assert not hit and _fresh(ts, got)

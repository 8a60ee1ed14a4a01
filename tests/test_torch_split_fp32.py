"""The split-fp32 ("3xTF32") scheme of the tensor-core kernels
(`csrc/surface_mma.cuh`), their weight pack (`ops/surface_pack.py`) and its
cache, on the CPU.

The kernels cannot run here, so their arithmetic is emulated in torch on the
pack they read: `cvt.rna.tf32.f32` by integer operations on the float's bits
(exact; the pack's own `surface_pack.tf32_rna`, also the kernels' rounding),
each operand split into big + small, and every layer product summed per
k-step of 8 as small_a big_b + big_a small_b + big_a big_b, the small terms
first, and added to a running fp32 sum. The emulated sdf-only forward is held to
the JAX package's Pallas kernel (interpret mode) and to the port's plain
version within kernel 4's card limit, 1e-5 of max|sdf|; a single TF32
product is shown to miss that limit, so the check can see TF32 rounding.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
from neurecon_tpu.ops.fused_mlp import fused_sdf_forward as jax_fused_sdf_forward

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import (ImplicitSurface, effective_weight,
                                            perturb_parameters)
from neurecon_tpu_torch.ops import surface_pack
from neurecon_tpu_torch.ops.fused_mlp import sdf_forward_plain

FLAGSHIP = dict(W=256, D=8, skips=[4], W_geo_feat=256, radius_init=0.5, embed_multires=6)
LIMIT = 1e-5  # kernel 4's card check (chip_smoke.py phase 10), of max|sdf|


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


def emulate_sdf_forward(surface, x: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """csrc/sdf_forward.cu on the CPU: its pack (the weights' TF32 parts from
    the pack's big and small planes), its padded activation rows, its skip
    input (the encoding right after h, divided by sqrt(2)), its Softplus
    epilogue (padded outputs written as 0) and its fp32 sdf row, with every
    hidden product through `mma`."""
    pk = surface_pack.pack(surface)
    plane = [pk.params[q * pk.plane:(q + 1) * pk.plane] for q in range(3)]
    params, records = plane[0], pk.meta.tolist()
    C, M = surface.input_ch, x.shape[0]
    emb = torch.zeros(M, pk.c_pad)
    emb[:, :C] = surface.embed_fn(x)
    buf = None
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
        w = [q[off_wT:off_wT + K * N].view(K, N) for q in plane]
        acc = mma(v, w[0], terms, b_parts=(w[1], w[2]))
        y = 100.0 * (acc + params[off_b:off_b + N])
        buf = (torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-y.abs()))) / 100.0
        buf[:, out_dim:] = 0.0
    K, N, _, _, _, off_w, off_b, _ = records[surface.D]
    return buf[:, :K] @ params[off_w:off_w + K] + params[off_b]


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
        surface_pack.pack(ImplicitSurface(W=300, D=4, skips=[2], W_geo_feat=64))
    with pytest.raises(NotImplementedError):
        surface_pack.pack(ImplicitSurface(W=64, D=4, skips=[2], W_geo_feat=300))
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

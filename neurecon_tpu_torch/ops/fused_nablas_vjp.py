"""The surface MLP's (sdf, nablas, h) as a differentiable op: a
`torch.autograd.Function` whose forward is the forward+nablas kernel
(`csrc/nablas_forward.cu`) and whose backward is the CUDA kernel
`csrc/nablas_backward.cu`, with the backward's plain PyTorch version.

Replaces the Pallas kernel `_make_bwd_kernel` of
`neurecon_tpu/ops/fused_nablas_vjp.py` and its `jax.custom_vjp` op. As there,
the op's boundary sits at the *effective* weights: weight norm stays in
torch autograd in front of it, and the `sphere_residual` terms stay outside
it. The backward recomputes everything from x and the weights (the op saves
nothing else) and includes the second-order phi'' terms that the eikonal loss
reaches through nablas. nablas is a primal output, so no double backward is
needed.

The backward is bound by arithmetic (~5.8 MFLOP per point at the flagship
widths); `csrc/nablas_backward.cu` says how it splits the work into a
pass over 128-point tiles (64-point tiles of the wide instantiation for a
surface wider than 256, up to 512, and of the cluster instantiation, two
blocks a tile, up to 1024) and a deterministic reduction of the weight
gradients over all points, through a device-memory workspace, both on
split-fp32 tensor-core products.

The Function takes the kernels for CUDA tensors and the plain versions for
CPU tensors; there is no other route and no fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from neurecon_tpu_torch.ops import _build, fused_nablas, surface_pack
from neurecon_tpu_torch.utils.trace import span

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

_TILE = 128  # points per tile of the tile pass (csrc tc::Narrow; tc::Wide, tc::Cluster 64)
_KT = 16     # workspace rows per k-tile of the reduction (csrc)
_RT = 64     # output tile edge of the reduction (csrc)


def _encoding_derivs(surface, x):
    """Per encoding channel c: the coordinate it reads (r [C]), and at x
    [M, 3] the first and second derivatives d e_c / d x_r, d^2 e_c / d x_r^2
    ([M, C] each), for the encoding [x, sin(f x), cos(f x), ...]."""
    freqs = surface.embed_fn.freq_bands or []
    r = list(range(3))
    J = [torch.ones_like(x)]
    J2 = [torch.zeros_like(x)]
    for f in freqs:
        ph = x * f
        sn, cs = torch.sin(ph), torch.cos(ph)
        r += [0, 1, 2, 0, 1, 2]
        J += [f * cs, -f * sn]
        J2 += [-f * f * sn, -f * f * cs]
    return torch.tensor(r, device=x.device), torch.cat(J, -1), torch.cat(J2, -1)


def nablas_vjp_plain(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h):
    """Plain version of the backward: the four phases of `_make_bwd_kernel`
    written out on whole [M, W] tensors, in the port's [out, in] layout.

    x [M, 3]; ws / bs the effective weights [out, in] and biases of every
    layer; cotangents of sdf [M], nablas [M, 3], h [M, W_geo]. Returns
    (x_bar [M, 3], [W_bar_l], [b_bar_l])."""
    D, skips = surface.D, surface.skips
    inv = 1.0 / math.sqrt(2.0)
    with torch.no_grad():
        M = x.shape[0]
        emb = surface.embed_fn(x)
        C = emb.shape[-1]
        r, J, J2 = _encoding_derivs(surface, x)

        # phase 1: forward, inputs in_l, slopes s_l = phi'(a_l) and the
        # second derivatives phi''(a_l)
        ins, sig, pp = [], [], []
        h = emb
        for l in range(D):
            inp = torch.cat([h, emb], -1) * inv if l in skips else h
            a = inp @ ws[l].t() + bs[l]
            ins.append(inp)
            h, s, s2 = surface.activation_derivs(a)
            sig.append(s)
            pp.append(s2)
        h_D = h

        # phase 2: the nablas sweep, keeping u_l and q_l = u_{l+1} s_l
        us = [None] * (D + 1)
        qs = [None] * D
        us[D] = ws[D][0].expand(M, -1)
        ge = torch.zeros(M, C, dtype=x.dtype, device=x.device)
        for l in range(D - 1, -1, -1):
            qs[l] = us[l + 1] * sig[l]
            g_in = qs[l] @ ws[l]
            if l == 0:
                ge = ge + g_in
            elif l in skips:
                h_dim = g_in.shape[1] - C
                us[l] = g_in[:, :h_dim] * inv
                ge = ge + g_in[:, h_dim:] * inv
            else:
                us[l] = g_in

        # phase 3: n_bar pushed forward through phase 2's chain
        t = cot_nablas[:, r]                       # n_bar of each channel's coordinate
        gebar = t * J
        xbar = torch.zeros(M, 3, dtype=x.dtype, device=x.device)
        xbar.index_add_(1, r, t * ge * J2)         # d^2 e / d x^2 term
        wbars, abar_B = [None] * (D + 1), [None] * D
        ubar = None
        for l in range(D):
            if l == 0:
                gin = gebar
            elif l in skips:
                gin = torch.cat([ubar, gebar], -1) * inv
            else:
                gin = ubar
            qbar = gin @ ws[l].t()
            wbars[l] = qs[l].t() @ gin
            abar_B[l] = qbar * us[l + 1] * pp[l]
            ubar = qbar * sig[l]
        gsdfbar = ubar.sum(0)  # the seed u_D = W_D[0, :] pulls back here

        # phase 4: first-order down-sweep from y_bar = [sdf_bar, h_bar]
        ybar = torch.cat([cot_sdf[:, None], cot_h], -1)
        wbars[D] = ybar.t() @ h_D
        wbars[D][0] += gsdfbar
        bbars = [None] * (D + 1)
        bbars[D] = ybar.sum(0)
        gh = ybar @ ws[D]
        ebar = torch.zeros(M, C, dtype=x.dtype, device=x.device)
        for l in range(D - 1, -1, -1):
            a = gh * sig[l] + abar_B[l]
            bbars[l] = a.sum(0)
            wbars[l] = wbars[l] + a.t() @ ins[l]
            g_in = a @ ws[l]
            if l == 0:
                ebar = ebar + g_in
            elif l in skips:
                h_dim = g_in.shape[1] - C
                gh = g_in[:, :h_dim] * inv
                ebar = ebar + g_in[:, h_dim:] * inv
            else:
                gh = g_in
        xbar.index_add_(1, r, ebar * J)
    return xbar, wbars, bbars


def _round(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _layout(dims, M: int, tile: int = _TILE) -> dict:
    """Workspace and flat-gradient layout of the backward kernel for layers
    of (in, out) `dims`, M points and the tile pass's `tile` points a tile
    (`surface_pack.Pack.tile`): one int64 record per layer (fields in
    csrc/nablas_backward.cu), the workspace size in floats, and the flat
    gradient [W_bar_0 .. W_bar_D | b_bar_0 .. b_bar_D | gsdfbar]. The
    workspace is tile-blocked, [pair][tile][column][tile points]; the
    reduction walks it in k-tiles of 16 rows."""
    D = len(dims) - 1
    m_tiles = (M + tile - 1) // tile
    jobs, work, c_off, bias, out_tiles = [], 0, 0, 0, 0
    for l, (n_in, n_out) in enumerate(dims):
        pairs = 1 if l == D else 2
        ld_a, ld_b = _round(n_out, _RT), _round(n_in, _RT)
        a_off = work
        work += pairs * m_tiles * tile * ld_a
        b_off = work
        work += pairs * m_tiles * tile * ld_b
        jobs.append([a_off, b_off, ld_a, ld_b, n_out, n_in,
                     pairs * m_tiles * tile // _KT, c_off, bias, out_tiles, pairs, 0])
        c_off += n_out * n_in
        bias += n_out
        out_tiles += ((n_out + _RT - 1) // _RT) * ((n_in + _RT - 1) // _RT)
    jobs[D][11] = bias  # gsdfbar after the biases
    nb = bias + dims[D][0]
    k16 = m_tiles * tile // _KT
    return {"jobs": jobs, "work": work, "m_tiles": m_tiles, "nb": nb,
            "bias_flat_off": c_off, "total": c_off + nb, "out_tiles": out_tiles,
            "n_split": max(1, min(32, k16 // 16))}


def _unflatten(flat, dims):
    """The flat gradient -> ([W_bar_l], [b_bar_l]), gsdfbar folded into row
    0 of W_bar_D (the sdf row, whose weights seed the nablas sweep)."""
    wbars, bbars, off = [], [], 0
    for n_in, n_out in dims:
        wbars.append(flat[off:off + n_out * n_in].view(n_out, n_in))
        off += n_out * n_in
    for n_in, n_out in dims:
        bbars.append(flat[off:off + n_out])
        off += n_out
    wbars[-1][0] += flat[off:off + dims[-1][0]]
    return wbars, bbars


def fused_nablas_vjp(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h, packed=None):
    """(x_bar, [W_bar_l], [b_bar_l]) of (sdf, nablas, h) at x [M, 3] for the
    cotangents given, with ws / bs the effective weights and biases: the CUDA
    kernel for a CUDA tensor (reading `packed`, a `surface_pack.Pack` of ws /
    bs, or a pack made here), the plain version for a CPU tensor."""
    with span("op.nablas_vjp"):
        fused_nablas._check(surface, x)
        if x.device.type == "cuda":
            fused_nablas.refuse_nerf_head(surface, "nablas_backward")
        M = x.shape[0]
        cots = [c.float().contiguous() for c in (cot_sdf, cot_nablas, cot_h)]
        for c, shape in zip(cots, ((M,), (M, 3), (M, surface.W_geo_feat))):
            if tuple(c.shape) != shape or c.device != x.device:
                raise ValueError(f"a cotangent is {tuple(c.shape)} on {c.device}; "
                                 f"want {shape} on {x.device}")
        if x.device.type == "cpu":
            return nablas_vjp_plain(surface, x, ws, bs, *cots)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        dims = [tuple(w.shape[::-1]) for w in ws]
        if M == 0:
            return (torch.zeros_like(x), [torch.zeros_like(w) for w in ws],
                    [torch.zeros_like(b) for b in bs])
        dev = x.device
        if packed is None:
            packed = surface_pack.pack(surface, (ws, bs))
        lay = _layout(dims, M, packed.tile)
        rows = max(packed.rows, surface_pack.pad8(dims[-1][1]))
        lib = _build.load("nablas_backward")
        jobs = fused_nablas.upload(torch.tensor(lay["jobs"], dtype=torch.int64), dev)
        work = torch.empty(lay["work"], device=dev)
        bias_part = torch.empty(lay["m_tiles"], lay["nb"], device=dev)
        part = torch.empty(lay["n_split"], lay["total"], device=dev)
        flat = torch.empty(lay["total"], device=dev)
        lib.ntt_nablas_backward_blocks.argtypes = [_I, _I, _I, _I]
        lib.ntt_nablas_backward_blocks.restype = _I
        blocks = lib.ntt_nablas_backward_blocks(packed.c_pad, rows, lay["m_tiles"], packed.kind)
        _build.check(max(-blocks, 0), "nablas_backward (occupancy)")
        if blocks == 0:
            raise NotImplementedError(
                f"nablas_backward: a block for {packed.c_pad} encoding and {rows} activation "
                "rows does not fit in the card's shared memory")
        # a slot of D x rows x the tile's points for each block (each pair)
        slopes = torch.empty(blocks // packed.blocks_per_tile * (len(dims) - 1) * rows
                             * packed.tile, device=dev)
        xbar = torch.empty(M, 3, device=dev)
        fused_nablas_vjp.workspace_bytes = 4 * (work.numel() + bias_part.numel()
                                                + part.numel() + slopes.numel())
        fn = lib.ntt_nablas_backward
        fn.argtypes = [_P, _I, _P, _L, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                       _P, _I, _P, _I, _L, _L, _I, _I, _P, _P, _P, _P]
        fn.restype = _I
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), M, packed.params.data_ptr(), packed.plane,
                packed.meta.data_ptr(), len(dims), surface.input_ch, packed.c_pad, rows,
                packed.act, packed.kind, cots[0].data_ptr(), cots[1].data_ptr(),
                cots[2].data_ptr(), surface.W_geo_feat, jobs.data_ptr(), work.data_ptr(),
                bias_part.data_ptr(), lay["nb"], part.data_ptr(), lay["n_split"],
                lay["total"], lay["bias_flat_off"], lay["out_tiles"], blocks,
                slopes.data_ptr(), flat.data_ptr(), xbar.data_ptr(), stream)
        _build.check(rc, "nablas_backward")
        fused_nablas_vjp.launches += 1
        wbars, bbars = _unflatten(flat, dims)
        return xbar, wbars, bbars


fused_nablas_vjp.launches = 0
fused_nablas_vjp.workspace_bytes = 0


class SurfaceWithNablas(torch.autograd.Function):
    """(sdf [M], nablas [M, 3], h [M, W_geo]) = op(x [M, 3], *ws, *bs), with
    ws / bs the surface's effective weights and biases (the same order as
    `fused_nablas.surface_weights`) and `packed` their `surface_pack.Pack`
    (None on the CPU), which the forward kernel and the backward kernel both
    read."""

    @staticmethod
    def forward(ctx, surface, packed, x, *wb):
        n = len(wb) // 2
        ctx.surface, ctx.packed = surface, packed
        ctx.save_for_backward(x, *wb)
        return fused_nablas.fused_forward_with_nablas(
            surface, x, (list(wb[:n]), list(wb[n:])), packed)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_sdf, g_nablas, g_h):
        x, *wb = ctx.saved_tensors
        n = len(wb) // 2
        M = x.shape[0]
        zeros = (lambda g, *shape: torch.zeros(*shape, device=x.device)
                 if g is None else g)
        xbar, wbars, bbars = fused_nablas_vjp(
            ctx.surface, x, wb[:n], wb[n:], zeros(g_sdf, M),
            zeros(g_nablas, M, 3), zeros(g_h, M, ctx.surface.W_geo_feat), ctx.packed)
        return (None, None, xbar, *wbars, *bbars)


def forward_with_nablas_vjp(surface, x):
    """(sdf, nablas, h) of the surface MLP at flat x [M, 3], differentiable
    in the surface's parameters (through weight norm) and in x. On a card
    both kernels read the surface's kept pack (`surface_pack.packed_surface`:
    in a training step, the pack the upsampler or the sampler made from the
    same parameters), so a step packs its weights once."""
    ws, bs = fused_nablas.surface_weights(surface)
    packed = surface_pack.packed_surface(surface) if x.device.type == "cuda" else None
    return SurfaceWithNablas.apply(surface, packed, x, *ws, *bs)

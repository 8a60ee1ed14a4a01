"""The surface MLP's weights in the layout of the tensor-core kernels
(`csrc/surface_mma.cuh`: the sdf-only forward and the eikonal backward), and
a cache of that pack per surface.

The layout, per layer: W^T [K][N], W [N][K] and b [N] in one fp32 plane,
each block at a multiple of 32 floats, with K and N the layer's input and
output counts padded to multiples of 8 (the MMA's depth and width) and the
padding zero (the kernels write zeros to padded activation rows, which then
meet zero weights). A skip layer's input columns are [h, encoding] as in the
plain forward; the kernels place the encoding right after h. Two more
planes follow at the same offsets: every value's TF32 big part and small
remainder (`split_tf32`), which the kernels' split-fp32 products stage as
they are. One int32 record of 8 per layer: K, N, out_dim, in_dim, offset of
W^T, of W, of b, skip flag.

The kernels of `csrc/surface_mlp.cuh` keep their own layout
(`fused_nablas.pack_surface`).
"""
from __future__ import annotations

import weakref
from typing import NamedTuple

import torch

from neurecon_tpu_torch.ops.fused_nablas import surface_weights, upload

_NMAX = 256   # widest product output (csrc/surface_mma.cuh: 4 column groups of 64)
_SLD = 264    # stage row stride: the widest row a product stages
_ALIGN = 32   # floats between block starts (128 bytes)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on finite fp32 values: keep 10 of the 23 mantissa
    bits, round to nearest, ties away from zero (half of the 13 dropped bits
    added to the bit pattern rounds the magnitude; the mask drops them).
    Exact: integer operations on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small) with big = rna(x), small = rna(x - big): x = big + small
    to within 2^-22 |x|, both exact in TF32."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class Pack(NamedTuple):
    params: torch.Tensor  # fp32 [3 * plane]: the fp32, TF32-big, TF32-small planes
    plane: int            # floats of one plane
    meta: torch.Tensor    # int32 [D + 1, 8]
    c_pad: int            # encoding rows (input_ch padded to 8)
    rows: int             # activation rows of the forward (widest hidden K or N)


def layout(surface) -> dict:
    """The pack's shape for `surface` (no values): the per-layer records,
    the buffer size in floats, `c_pad` and `rows` (the widest hidden K or N,
    and the final layer's K). Shapes the kernels do not take raise
    NotImplementedError (ValueError for a skip at 0)."""
    if 0 in surface.skips:
        raise ValueError("a skip at layer 0 is not supported by the kernels")
    c_pad = pad8(surface.input_ch)
    records, off, rows = [], 0, 0
    for l, (in_dim, out_dim) in enumerate(surface.dims):
        hidden = l < surface.D
        K, N = pad8(in_dim), pad8(out_dim)
        if (hidden and max(in_dim, out_dim) > _NMAX) or N > _SLD or K > _NMAX:
            raise NotImplementedError(
                f"layer {l} ({in_dim} -> {out_dim}) is wider than the kernels "
                f"take (hidden <= {_NMAX}, rows <= {_SLD})")
        off_wT = off
        off_w = _align(off_wT + K * N)
        off_b = _align(off_w + N * K)
        off = _align(off_b + N)
        records.append([K, N, out_dim, in_dim, off_wT, off_w, off_b,
                        int(l in surface.skips)])
        rows = max(rows, K, N if hidden else 0)
    return {"records": records, "size": off, "c_pad": c_pad, "rows": rows}


_INDEX: dict = {}  # (shape signature, device) -> (meta, index, size, c_pad, rows)


def _index(surface, device):
    """The pack's int32 records on `device` and the positions in the buffer
    of every entry of [W_0 .. W_D (each [out, in], row-major) twice (as W^T,
    then as W) | b_0 .. b_D]; made once per shape and device."""
    sig = (tuple(surface.dims), tuple(surface.skips), surface.input_ch,
           str(device))
    hit = _INDEX.get(sig)
    if hit is None:
        lay = layout(surface)
        pos_T, pos_W, pos_b = [], [], []
        for K, N, o, i, off_wT, off_w, off_b, _ in lay["records"]:
            r = torch.arange(i, dtype=torch.int64)[None, :]  # [1, in]
            c = torch.arange(o, dtype=torch.int64)[:, None]  # [out, 1]
            pos_T.append((off_wT + r * N + c).reshape(-1))
            pos_W.append((off_w + c * K + r).reshape(-1))
            pos_b.append(off_b + torch.arange(o, dtype=torch.int64))
        index = torch.cat(pos_T + pos_W + pos_b).to(device)
        meta = upload(torch.tensor(lay["records"], dtype=torch.int32), device)
        hit = _INDEX[sig] = (meta, index, lay["size"], lay["c_pad"], lay["rows"])
    return hit


def pack(surface, weights=None) -> Pack:
    """Weights of `surface` (weight norm resolved; or `weights`, a pair of
    lists of effective [out, in] weights and biases) in the tensor-core
    kernels' layout, on the parameters' device."""
    with torch.no_grad():
        ws, bs = weights if weights is not None else surface_weights(surface)
        device = ws[0].device
        meta, index, size, c_pad, rows = _index(surface, device)
        flat_w = torch.cat([w.float().reshape(-1) for w in ws])
        src = torch.cat([flat_w, flat_w] + [b.float().reshape(-1) for b in bs])
        fp32 = torch.zeros(size, device=device).index_copy_(0, index, src)
        big, small = split_tf32(fp32)
        params = torch.cat([fp32, big, small])
    return Pack(params, size, meta, c_pad, rows)


_PACKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _key(surface):
    return tuple((p.data_ptr(), p._version) for p in surface.parameters())


def packed_surface(surface) -> Pack:
    """`pack(surface)`, kept between calls while the surface's parameters are
    unchanged: the key is each parameter's storage pointer and version
    counter, so an in-place update (an optimizer step, `load_state_dict`,
    `copy_`, `perturb_parameters`) or a tensor swapped in through `.data`
    makes the next call pack again. Counts its packs in `packs`."""
    key = _key(surface)
    hit = _PACKS.get(surface)
    if hit is not None and hit[0] == key:
        return hit[1]
    packed = pack(surface)
    _PACKS[surface] = (key, packed)
    packed_surface.packs += 1
    return packed


packed_surface.packs = 0

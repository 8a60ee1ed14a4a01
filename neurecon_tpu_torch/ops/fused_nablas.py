"""Surface-MLP forward + input gradient (nablas): the CUDA kernel
`csrc/nablas_forward.cu` and its plain PyTorch version.

Replaces the Pallas kernel `_make_nablas_kernel` of
`neurecon_tpu/ops/fused_nablas.py` (entry `fused_forward_with_nablas`). The
kernel is bound by arithmetic (~2 MFLOP per point at the flagship widths);
its source note says how it keeps the reverse sweep's activation slopes in
shared memory. Gradient-free: parameters are constants here (the render).

`fused_forward_with_nablas` takes the kernel for a CUDA tensor and the plain
version for a CPU tensor; there is no other route and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from neurecon_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int


_THREADS = 256   # threads per block: the widest hidden layer (csrc)
_STAGE_LD = 264  # widest padded weight row the kernels stage (csrc)


def effective_weight(layer) -> torch.Tensor:
    """A DenseLayer's [out, in] weight, weight norm resolved."""
    if layer.weight_norm:
        return layer.g * layer.v / torch.linalg.norm(layer.v, dim=1, keepdim=True)
    return layer.w


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def pack_surface(surface):
    """Weights of `surface` (weight norm resolved) in the kernels' layout:
    one contiguous fp32 buffer holding, per layer, W^T [in][ld_wT],
    W [out][ld_w] (rows zero-padded to a multiple of 4 floats, 16-byte
    aligned) and b; an int32 table [D+1, 8] of (in_dim, out_dim, offset of
    W^T, offset of W, offset of b, skip flag, ld_wT, ld_w); and the widest
    activation row count. Everything stays on the parameters' device."""
    if 0 in surface.skips:
        raise ValueError("a skip at layer 0 is not supported by the kernels")
    pieces, meta, off = [], [], 0
    wmax = 0
    with torch.no_grad():
        for l, layer in enumerate(surface.layers):
            w = effective_weight(layer).float()
            out_dim, in_dim = w.shape
            ld_wT, ld_w = _pad4(out_dim), _pad4(in_dim)
            hidden = l < surface.D
            if (max(ld_wT, ld_w) > _STAGE_LD
                    or (hidden and max(out_dim, in_dim) > _THREADS)):
                raise NotImplementedError(
                    f"layer {l} ({in_dim} -> {out_dim}) is wider than the "
                    f"kernels take (hidden <= {_THREADS}, rows <= {_STAGE_LD})")
            skip = int(l in surface.skips)
            if hidden:
                wmax = max(wmax, out_dim, in_dim if skip else 0)
            wT = torch.nn.functional.pad(w.t(), (0, ld_wT - out_dim))
            wp = torch.nn.functional.pad(w, (0, ld_w - in_dim))
            b = torch.nn.functional.pad(layer.b.float(), (0, _pad4(out_dim) - out_dim))
            meta.append([in_dim, out_dim, off, off + wT.numel(),
                         off + wT.numel() + wp.numel(), skip, ld_wT, ld_w])
            pieces += [wT.reshape(-1), wp.reshape(-1), b]
            off += wT.numel() + wp.numel() + b.numel()
        params = torch.cat(pieces).contiguous()
    meta = torch.tensor(meta, dtype=torch.int32, device=params.device)
    return params, meta, wmax


def forward_with_nablas_plain(surface, x: torch.Tensor):
    """Plain version: (sdf [M], nablas [M, 3], h [M, W_geo]) at x [M, 3],
    nablas by autograd on a detached copy of x (works under no_grad)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf, h = surface.mlp(xg)
        (nablas,) = torch.autograd.grad(sdf.sum(), xg)
    return sdf.detach(), nablas, h.detach()


def _check(surface, x):
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"x must be [M, 3], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    for p in surface.parameters():
        if p.device != x.device or p.dtype != torch.float32:
            raise ValueError("surface parameters must be float32 on x's device")


def fused_forward_with_nablas(surface, x: torch.Tensor):
    """(sdf [M], nablas [M, 3], h [M, W_geo]) of the surface MLP at x [M, 3]
    (no sphere_residual term: the caller adds it)."""
    _check(surface, x)
    if x.device.type == "cpu":
        return forward_with_nablas_plain(surface, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M = x.shape[0]
    geo = surface.W_geo_feat
    sdf = torch.empty(M, device=x.device)
    nablas = torch.empty(M, 3, device=x.device)
    h = torch.empty(M, geo, device=x.device)
    if M == 0:
        return sdf, nablas, h
    fn = _build.load("nablas_forward").ntt_nablas_forward
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P]
    fn.restype = _I
    params, meta, wmax = pack_surface(surface)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), M, params.data_ptr(), meta.data_ptr(),
            len(surface.layers), surface.input_ch, max(surface.embed_multires, 0),
            wmax, sdf.data_ptr(), nablas.data_ptr(), h.data_ptr(), geo, stream)
    _build.check(rc, "nablas_forward")
    fused_forward_with_nablas.launches += 1
    return sdf, nablas, h


fused_forward_with_nablas.launches = 0

"""Surface-MLP forward + input gradient (nablas): the CUDA kernel
`csrc/nablas_forward.cu` and its plain PyTorch version.

Replaces the Pallas kernel `_make_nablas_kernel` of
`neurecon_tpu/ops/fused_nablas.py` (entry `fused_forward_with_nablas`). The
kernel is bound by arithmetic (~2 MFLOP per point at the flagship widths);
its source note says where it keeps the reverse sweep's activation slopes.
Gradient-free: parameters are constants here (the render);
`ops/fused_nablas_vjp.py` wraps it, with its backward kernel, for training.

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


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A small host table on `device` without a host-device sync: copied
    from pinned memory, asynchronously, on the current stream (a copy from
    pageable memory would wait for the stream's queued work first)."""
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def surface_weights(surface):
    """The effective weights ([out, in], weight norm resolved) and biases of
    every layer of `surface`, as two lists; differentiable where grad is on."""
    return ([effective_weight(layer) for layer in surface.layers],
            [layer.b for layer in surface.layers])


def pack_surface(surface, weights=None):
    """Weights of `surface` (weight norm resolved; or `weights`, a pair of
    lists of effective weights and biases) in the kernels' layout:
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
        ws, bs = weights if weights is not None else surface_weights(surface)
        for l, (w, b) in enumerate(zip(ws, bs)):
            w = w.float()
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
            b = torch.nn.functional.pad(b.float(), (0, _pad4(out_dim) - out_dim))
            meta.append([in_dim, out_dim, off, off + wT.numel(),
                         off + wT.numel() + wp.numel(), skip, ld_wT, ld_w])
            pieces += [wT.reshape(-1), wp.reshape(-1), b]
            off += wT.numel() + wp.numel() + b.numel()
        params = torch.cat(pieces).contiguous()
    meta = upload(torch.tensor(meta, dtype=torch.int32), params.device)
    return params, meta, wmax


def forward_with_nablas_plain(surface, x: torch.Tensor, weights=None):
    """Plain version: (sdf [M], nablas [M, 3], h [M, W_geo]) at x [M, 3],
    nablas by autograd on a detached copy of x (works under no_grad);
    `weights` as for `pack_surface`. The outputs are detached."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf, h = surface.mlp(xg, weights)
        (nablas,) = torch.autograd.grad(sdf.sum(), xg)
    return sdf.detach(), nablas.detach(), h.detach()


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


def fused_forward_with_nablas(surface, x: torch.Tensor, weights=None):
    """(sdf [M], nablas [M, 3], h [M, W_geo]) of the surface MLP at x [M, 3]
    (no sphere_residual term: the caller adds it); `weights` as for
    `pack_surface`."""
    _check(surface, x)
    if x.device.type == "cpu":
        return forward_with_nablas_plain(surface, x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M = x.shape[0]
    geo = surface.W_geo_feat
    sdf = torch.empty(M, device=x.device)
    nablas = torch.empty(M, 3, device=x.device)
    h = torch.empty(M, geo, device=x.device)
    if M == 0:
        return sdf, nablas, h
    lib = _build.load("nablas_forward")
    params, meta, wmax = pack_surface(surface, weights)
    lib.ntt_nablas_forward_blocks.argtypes = [_I, _I, _I]
    lib.ntt_nablas_forward_blocks.restype = _I
    blocks = lib.ntt_nablas_forward_blocks(surface.input_ch, wmax, M)
    _build.check(max(-blocks, 0), "nablas_forward (occupancy)")
    slopes = torch.empty(blocks * surface.D * wmax * 16, device=x.device)
    fn = lib.ntt_nablas_forward
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P]
    fn.restype = _I
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), M, params.data_ptr(), meta.data_ptr(),
            len(surface.layers), surface.input_ch, max(surface.embed_multires, 0),
            wmax, sdf.data_ptr(), nablas.data_ptr(), h.data_ptr(), geo, blocks,
            slopes.data_ptr(), stream)
    _build.check(rc, "nablas_forward")
    fused_forward_with_nablas.launches += 1
    return sdf, nablas, h


fused_forward_with_nablas.launches = 0

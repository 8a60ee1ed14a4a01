"""Surface-MLP forward + input gradient (nablas): the CUDA kernel
`csrc/nablas_forward.cu` and its plain PyTorch version.

Replaces the Pallas kernel `_make_nablas_kernel` of
`neurecon_tpu/ops/fused_nablas.py` (entry `fused_forward_with_nablas`). The
kernel runs every layer product, forward and nablas sweep, as a split-fp32
tensor-core product over 64-point tiles: a warp-specialised TMA + wgmma
pipeline for every surface whose padded hidden widths are at most 256 (the
narrow tile), and `mma.sync` products for a surface wider than 256, up to
512 (the wide tile), and up to 1024 (the cluster tile, two blocks a tile),
as the pack records; its source note gives the design and what bounds it.
Gradient-free: parameters are constants here (the render, the casters);
`ops/fused_nablas_vjp.py` wraps it, with its backward kernel, for training.
The packed weights are kept between calls while the surface's parameters
are unchanged (`surface_pack.packed_surface`).

`fused_forward_with_nablas` takes the kernel for a CUDA tensor and the plain
version for a CPU tensor; there is no other route and no fallback. It counts
its launches in `launches` and, by the tile that ran
(`surface_pack.TILE_NAMES`: "narrow" is the wgmma pipeline), in
`launches_by_tile`.
"""
from __future__ import annotations

import ctypes

import torch

from neurecon_tpu_torch.ops import _build
from neurecon_tpu_torch.utils.trace import span

_P = ctypes.c_void_p
_I = ctypes.c_int

_RESIDENT: dict = {}  # (card index, c_pad, rows, tile) -> resident blocks

ACT_SOFTPLUS, ACT_SINE = 0, 1  # the kernels' activation codes (csrc)


def activation_code(surface) -> int:
    """The hidden activation of `surface` as the kernels take it, a launch
    argument of every surface-MLP kernel: ACT_SINE for a SIREN surface
    (sin(30 a)), ACT_SOFTPLUS for Softplus(beta=100)."""
    return ACT_SINE if surface.use_siren else ACT_SOFTPLUS


def effective_weight(layer) -> torch.Tensor:
    """A DenseLayer's [out, in] weight, weight norm resolved."""
    if layer.weight_norm:
        return layer.g * layer.v / torch.linalg.norm(layer.v, dim=1, keepdim=True)
    return layer.w


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


def forward_with_nablas_plain(surface, x: torch.Tensor, weights=None):
    """Plain version: (sdf [M], nablas [M, 3], h [M, W_geo]) at x [M, 3],
    nablas by autograd on a detached copy of x (works under no_grad);
    `weights` a pair of lists of effective [out, in] weights and biases
    (the surface's own by default). The outputs are detached."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        sdf, h = surface.mlp(xg, weights)
        (nablas,) = torch.autograd.grad(sdf.sum(), xg)
    return sdf.detach(), nablas.detach(), h.detach()


def refuse_nerf_head(surface, kernel: str):
    """Raise for the NeRF-like head (W_geo_feat <= 0) on a card: the surface
    computes its nablas by autograd (`ImplicitSurface.forward_with_nablas`),
    as the JAX package does; this kernel and the eikonal backward take the
    sdf and geometry-feature rows of a final layer of 1 + W_geo_feat rows."""
    if surface.W_geo_feat <= 0:
        raise NotImplementedError(
            f"{kernel}: the NeRF-like surface head (W_geo_feat {surface.W_geo_feat}) runs its "
            "nablas on autograd (ImplicitSurface.forward_with_nablas), never on this kernel")


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


def resident_blocks(c_pad: int, rows: int, device: torch.device, tile: int) -> int:
    """Blocks of the kernel resident on `device` at once, for this encoding
    height, activation buffer and tile (`Pack.kind`; the cluster tile's
    blocks in pairs); asked of the card (which also sets the kernel's
    shared-memory attributes) once per (card, c_pad, rows, tile) and kept.
    Raises NotImplementedError when a block (a pair) does not fit."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    key = (index, c_pad, rows, int(tile))
    n = _RESIDENT.get(key)
    if n is None:
        lib = _build.load("nablas_forward")
        lib.ntt_nablas_forward_resident.argtypes = [_I, _I, _I]
        lib.ntt_nablas_forward_resident.restype = _I
        with torch.cuda.device(index):
            n = lib.ntt_nablas_forward_resident(c_pad, rows, int(tile))
        _build.check(max(-n, 0), "nablas_forward (occupancy)")
        if n == 0:
            raise NotImplementedError(
                f"nablas_forward: a block for {c_pad} encoding and {rows} activation "
                "rows does not fit in the card's shared memory")
        _RESIDENT[key] = n
    return n


def fused_forward_with_nablas(surface, x: torch.Tensor, weights=None, packed=None):
    """(sdf [M], nablas [M, 3], h [M, W_geo]) of the surface MLP at x [M, 3]
    (no sphere_residual term: the caller adds it); `weights` as for
    `forward_with_nablas_plain`. On a card the kernel reads `packed` (a
    `surface_pack.Pack` of the same weights), else a pack of `weights`, else
    the surface's kept pack."""
    with span("op.nablas_forward"):
        from neurecon_tpu_torch.ops import surface_pack

        _check(surface, x)
        if x.device.type == "cpu":
            return forward_with_nablas_plain(surface, x, weights)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        refuse_nerf_head(surface, "nablas_forward")
        M, geo, dev = x.shape[0], surface.W_geo_feat, x.device
        sdf = torch.empty(M, device=dev)
        nablas = torch.empty(M, 3, device=dev)
        h = torch.empty(M, geo, device=dev)
        if M == 0:
            return sdf, nablas, h
        if packed is None:
            packed = (surface_pack.packed_surface(surface) if weights is None
                      else surface_pack.pack(surface, weights))
        blocks = resident_blocks(packed.c_pad, packed.rows, dev, packed.kind)
        lib = _build.load("nablas_forward")
        scratch = lib.ntt_nablas_forward_scratch_floats
        scratch.argtypes = [_I, _I, _I, _I, _I]
        scratch.restype = ctypes.c_longlong
        slopes = torch.empty(scratch(M, len(surface.layers), packed.rows, packed.kind, blocks),
                             device=dev)
        fn = lib.ntt_nablas_forward
        fn.argtypes = [_P, _I, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                       _I, _I, _P, _P]
        fn.restype = _I
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), M, packed.params.data_ptr(), packed.plane, packed.meta.data_ptr(),
                surface_pack.host_meta(surface), len(surface.layers), surface.input_ch,
                packed.c_pad, packed.rows, packed.act, packed.kind, sdf.data_ptr(),
                nablas.data_ptr(), h.data_ptr(), geo, blocks, slopes.data_ptr(), stream)
        _build.check(rc, "nablas_forward")
        fused_forward_with_nablas.launches += 1
        _LAUNCHES_BY_TILE[surface_pack.TILE_NAMES[packed.kind]] += 1
        return sdf, nablas, h


fused_forward_with_nablas.launches = 0
# keyed by surface_pack.TILE_NAMES (which imports this module); the body counts
# into the dict itself, so a caller that swaps the module's name for a wrapper
# (tools/step_grad_sensitivity.py) still counts the launches
_LAUNCHES_BY_TILE = fused_forward_with_nablas.launches_by_tile = dict.fromkeys(
    ("narrow", "wide", "cluster"), 0)

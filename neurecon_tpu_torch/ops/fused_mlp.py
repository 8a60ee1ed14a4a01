"""Surface-MLP sdf-only forward: the CUDA kernel `csrc/sdf_forward.cu` and
its plain PyTorch version.

Replaces the Pallas kernel `_make_kernel` of `neurecon_tpu/ops/fused_mlp.py`
(entry `fused_sdf_forward`). Forward-only: it serves the gradient-free sdf
queries (mesh grids, ray casters, eval tools, the VolSDF sampler), and its
output carries no graph. The kernel runs the hidden layers as split-fp32
tensor-core products over 64-point tiles: a warp-specialised TMA + wgmma
pipeline for every surface whose padded hidden widths are at most 256 (the
narrow tile), and `mma.sync` products for a surface wider than 256, up to
512 (the wide tile), and up to 1024 (the cluster tile, two blocks a tile),
as the pack records; its source note gives the design and what bounds it.
The packed weights are kept between calls while the surface's parameters
are unchanged (`surface_pack.packed_surface`).

`fused_sdf_forward` takes the kernel for a CUDA tensor and the plain version
for a CPU tensor; there is no other route and no fallback. It counts its
launches in `launches` and, by the tile that ran (`surface_pack.TILE_NAMES`:
"narrow" is the wgmma pipeline), in `launches_by_tile`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from neurecon_tpu_torch.ops import _build
from neurecon_tpu_torch.ops.fused_nablas import _check
from neurecon_tpu_torch.ops.surface_pack import TILE_NAMES, Pack, layout, packed_surface
from neurecon_tpu_torch.utils.trace import span

_P = ctypes.c_void_p
_I = ctypes.c_int

_RESIDENT: dict = {}  # (card index, c_pad, rows, tile) -> resident blocks
_HOST_META: dict = {}  # (dims, skips, input_ch) -> (the pack's records, int32, their address)


@torch.no_grad()
def sdf_forward_plain(surface, x: torch.Tensor) -> torch.Tensor:
    """Plain version: the sdf [M] of the surface MLP at x [M, 3]."""
    return surface.mlp(x)[0]


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
        lib = _build.load("sdf_forward")
        lib.ntt_sdf_forward_resident.argtypes = [_I, _I, _I]
        lib.ntt_sdf_forward_resident.restype = _I
        with torch.cuda.device(index):
            n = lib.ntt_sdf_forward_resident(c_pad, rows, int(tile))
        _build.check(max(-n, 0), "sdf_forward (occupancy)")
        if n == 0:
            raise NotImplementedError(
                f"sdf_forward: a block for {c_pad} encoding and {rows} activation "
                "rows does not fit in the card's shared memory")
        _RESIDENT[key] = n
    return n


def host_meta(surface) -> int:
    """The address of the pack's per-layer records (`surface_pack.layout`)
    as a contiguous int32 [D + 1, 8] array in host memory, made once per
    shape and kept: the narrow tile's launch makes its tensor maps of the
    weights from them (once a pack; the kernel's source keeps them)."""
    key = (tuple(surface.dims), tuple(surface.skips), surface.input_ch)
    meta = _HOST_META.get(key)
    if meta is None:
        records = np.ascontiguousarray(layout(surface)["records"], np.int32)
        meta = _HOST_META[key] = (records, records.ctypes.data)
    return meta[1]


def launch_sdf_forward(surface, x: torch.Tensor, packed: Pack) -> torch.Tensor:
    """The kernel on CUDA x [M, 3] (M > 0) with weights packed by
    `surface_pack.pack`; returns sdf [M]."""
    with span("op.sdf_forward"):
        M = x.shape[0]
        sdf = torch.empty(M, device=x.device)
        blocks = resident_blocks(packed.c_pad, packed.rows, x.device, packed.kind)
        fn = _build.load("sdf_forward").ntt_sdf_forward
        fn.argtypes = [_P, _I, _P, ctypes.c_longlong, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                       _P]
        fn.restype = _I
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), M, packed.params.data_ptr(), packed.plane, packed.meta.data_ptr(),
                host_meta(surface), len(surface.layers), surface.input_ch,
                packed.c_pad, packed.rows, packed.act,
                packed.kind, sdf.data_ptr(), blocks, stream)
        _build.check(rc, "sdf_forward")
        fused_sdf_forward.launches += 1
        fused_sdf_forward.launches_by_tile[TILE_NAMES[packed.kind]] += 1
        return sdf


def fused_sdf_forward(surface, x: torch.Tensor) -> torch.Tensor:
    """sdf [M] of the surface MLP at flat x [M, 3], without the
    sphere_residual prior (the caller adds it). Shapes the kernel refuses
    raise NotImplementedError, but for a narrow surface with more hidden
    layers than the launch has tensor maps for (csrc narrow::MAXD), which
    its launch refuses (RuntimeError)."""
    _check(surface, x)
    if x.device.type == "cpu":
        with span("op.sdf_forward"):
            return sdf_forward_plain(surface, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[0] == 0:
        return torch.empty(0, device=x.device)
    return launch_sdf_forward(surface, x, packed_surface(surface))


fused_sdf_forward.launches = 0
fused_sdf_forward.launches_by_tile = dict.fromkeys(TILE_NAMES, 0)

"""NeuS hierarchical upsampler (`official_solution`): the CUDA kernel
`csrc/neus_upsample.cu` and its plain PyTorch version.

Replaces the Pallas megakernel `_make_upsample_kernel` of
`neurecon_tpu/ops/fused_upsample.py` (entry `fused_neus_upsample`), holding
the semantics of the plain loop in `neurecon_tpu/models/frameworks/neus.py`.
The kernel is bound by its MLP queries (128 points per ray at the flagship
widths), which run as split-fp32 tensor-core products on the surface's kept
pack (`surface_pack.packed_surface`); its source note gives the design.

Both versions take the caller's per-round uniforms, sorted within each round
(the det linspace, or sorted draws): sorting changes the order in which the
samples are drawn, not the sample set, and the merged output is sorted either
way. Both include the sphere_residual prior in the sdf query, as the plain
JAX upsampler does (the JAX Pallas kernel omits it).

`fused_neus_upsample` takes the kernel for CUDA tensors and the plain version
for CPU tensors; there is no other route and no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from neurecon_tpu_torch.ops import _build
from neurecon_tpu_torch.ops.sampling import alpha_to_w, sample_pdf
from neurecon_tpu_torch.ops.surface_pack import packed_surface

_P = ctypes.c_void_p
_I = ctypes.c_int

_SMS: dict = {}  # card index -> SMs


def neus_upsample_plain(surface, rays_o, rays_d, d_coarse, u_rounds, *,
                        n_iters: int, n_per_iter: int):
    """Plain version: the official_solution loop. rays [N, 3] (d unit),
    d_coarse [N, Bc] sorted, u_rounds [N, n_iters * n_per_iter]. Returns the
    sorted d_all [N, Bc + n_iters * n_per_iter]."""
    def query_sdf(d):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        return surface.forward(pts)

    with torch.no_grad():
        _d = d_coarse
        _sdf = query_sdf(_d)
        for i in range(n_iters):
            prev_sdf, next_sdf = _sdf[:, :-1], _sdf[:, 1:]
            prev_z, next_z = _d[:, :-1], _d[:, 1:]
            mid_sdf = 0.5 * (prev_sdf + next_sdf)
            dot_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)
            prev_dot_val = torch.cat(
                [torch.zeros_like(dot_val[:, :1]), dot_val[:, :-1]], dim=-1)
            # min of this section's slope and the previous one's
            dot_val = torch.clamp(torch.minimum(prev_dot_val, dot_val), -10.0, 0.0)
            dist = next_z - prev_z
            prev_esti_sdf = mid_sdf - dot_val * dist * 0.5
            next_esti_sdf = mid_sdf + dot_val * dist * 0.5
            s = 64 * (2 ** i)  # per-round sharpening
            prev_cdf = torch.sigmoid(prev_esti_sdf * s)
            next_cdf = torch.sigmoid(next_esti_sdf * s)
            alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
            w = alpha_to_w(alpha)
            u = u_rounds[:, i * n_per_iter:(i + 1) * n_per_iter]
            d_fine = sample_pdf(_d, w, u)
            sdf_fine = query_sdf(d_fine)
            _d = torch.cat([_d, d_fine], dim=-1)
            _sdf = torch.cat([_sdf, sdf_fine], dim=-1)
            # stable: old samples stay before new ones at equal depth
            _d, order = torch.sort(_d, dim=-1, stable=True)
            _sdf = torch.gather(_sdf, -1, order)
    return _d


def _check(surface, rays_o, rays_d, d_coarse, u_rounds, n_iters, n_per_iter):
    N = rays_o.shape[0]
    want = {"rays_o": (N, 3), "rays_d": (N, 3),
            "d_coarse": (N, d_coarse.shape[-1]),
            "u_rounds": (N, n_iters * n_per_iter)}
    got = {"rays_o": rays_o, "rays_d": rays_d, "d_coarse": d_coarse,
           "u_rounds": u_rounds}
    for name, t in got.items():
        if t.dim() != 2 or tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: want {want[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != rays_o.device:
            raise ValueError(f"{name} is on {t.device}, rays_o on {rays_o.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for p in surface.parameters():
        if p.device != rays_o.device or p.dtype != torch.float32:
            raise ValueError("surface parameters must be float32 on the rays' device")


def _sms(device: torch.device) -> int:
    """The SM count of `device`; the first call per card also sets the
    kernels' shared-memory caps to the card's opt-in maximum."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(index)
    if sms is None:
        fn = _build.load("neus_upsample").ntt_neus_upsample_setup
        fn.argtypes = []
        fn.restype = _I
        with torch.cuda.device(index):
            sms = fn()
        _build.check(max(-sms, 0), "neus_upsample (setup)")
        _SMS[index] = sms
    return sms


def block_shape(N: int, sms: int):
    """(P, R): points per MLP tile and rays per block for N rays. A block of
    8 rays (a round's 8 x 16 new points make one 128-point tile) where that
    gives every SM a block; else 4 rays on 64-point tiles, so that a
    training step's 512 rays make 128 blocks, not 64."""
    return (128, 8) if -(-N // 8) >= sms else (64, 4)


def fused_neus_upsample(surface, rays_o, rays_d, d_coarse, u_rounds, *,
                        n_iters: int, n_per_iter: int):
    """Sorted d_all [N, Bc + n_iters * n_per_iter] of the official_solution
    upsampler (see `neus_upsample_plain` for the arguments). A block that
    does not fit in the card's shared memory (many samples a ray) fails at
    launch."""
    _check(surface, rays_o, rays_d, d_coarse, u_rounds, n_iters, n_per_iter)
    if rays_o.device.type == "cpu":
        return neus_upsample_plain(surface, rays_o, rays_d, d_coarse, u_rounds,
                                   n_iters=n_iters, n_per_iter=n_per_iter)
    if rays_o.device.type != "cuda":
        raise ValueError(f"unsupported device {rays_o.device}")
    N, n_coarse = d_coarse.shape
    dev = rays_o.device
    d_all = torch.empty(N, n_coarse + n_iters * n_per_iter, device=dev)
    if N == 0:
        return d_all
    packed = packed_surface(surface)
    P, R = block_shape(N, _sms(dev))
    fn = _build.load("neus_upsample").ntt_neus_upsample
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_longlong, _P, _I, _I, _I, _I,
                   _I, ctypes.c_float, _I, _I, _P, _P]
    fn.restype = _I
    sphere_r = float(surface.radius_init) if surface.sphere_residual else -1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(rays_o.data_ptr(), rays_d.data_ptr(), d_coarse.data_ptr(), u_rounds.data_ptr(),
            N, n_coarse, n_iters, n_per_iter, packed.params.data_ptr(), packed.plane,
            packed.meta.data_ptr(), len(surface.layers), surface.input_ch, packed.c_pad,
            packed.rows, packed.act, sphere_r, P, R, d_all.data_ptr(), stream)
    _build.check(rc, "neus_upsample")
    fused_neus_upsample.launches += 1
    return d_all


fused_neus_upsample.launches = 0

"""VolSDF §3.4 error-bounded fine sampler: the CUDA kernels of
`csrc/volsdf_fine_sample.cu` (with the sdf-only kernel of `fused_mlp` for the
MLP queries) and the plain PyTorch version.

Replaces the Pallas kernel family of `neurecon_tpu/ops/fused_fine_sample.py`
(entry `fused_fine_sample`), with the semantics of the plain loop
`fine_sample` in `neurecon_tpu/models/frameworks/volsdf.py`:

  * `_make_init_kernel` -> one kernel-4 launch (the coarse query of d_init)
    and `launch_init`, kernel (a) (the rest: sphere-background min, beta+ of
    paper eq. 10, the convergence mask under the net's beta, the checkpoint-0
    opacity draw, the first bounds; plain version `init_plain`);
  * `_make_upsample_query_kernel` -> `launch_draw`, kernel (b), for round 1
    (bounds -> pdf -> the n_up det depths and their points; `draw_plain`),
    and for rounds 2..max_iter the same det draw at the end of the previous
    round's kernel (c); then one kernel-4 launch;
  * `_make_checkpoint_kernel` -> per round `launch_checkpoint`, kernel (c)
    (the stable merge, then the convergence checkpoint, the beta bisection
    and the new bounds, from which it draws the next round's depths; on the
    last round the fallback draw; `checkpoint_plain`, then `draw_plain`).

A call takes the surface's kept pack (`surface_pack.packed_surface`,
packed again only after the weights change) and makes 1 (a) + 1 (b) +
max_iter (c) launches and 1 + max_iter of kernel 4. The MLP queries are ~99%
of the arithmetic; the new kernels are weight-free.

The uniforms of the opacity draws come from the caller, u_fin [N,
(max_iter+2) n_final] in the reference's key order (checkpoint 0,
checkpoints 1..max_iter, then the fallback draw) and unsorted, as
`sample_cdf` consumes them. The interior upsample is deterministic
(linspace(0, 1, n_up + 2), both ends dropped). Gradient-free.

`fused_fine_sample` takes the kernels for CUDA tensors and the plain version
for CPU tensors; there is no other route and no fallback.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from neurecon_tpu_torch.ops import _build
from neurecon_tpu_torch.ops.fused_mlp import launch_sdf_forward
from neurecon_tpu_torch.ops.surface_pack import packed_surface
from neurecon_tpu_torch.ops.sampling import linspace01, sample_cdf, sample_pdf

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# the kernels' largest block (1,024 threads x 14 intervals, `by_shape` in
# csrc/volsdf_fine_sample.cu), whose rows of S entries fit one block's shared
# memory (227 KB)
MAX_SAMPLES = 14336


def sdf_to_sigma(sdf, alpha, beta):
    """§3.1: alpha times the Laplace CDF of -sdf (volsdf.py:40-44)."""
    exp = 0.5 * torch.exp(-torch.abs(sdf) / beta)
    psi = torch.where(sdf >= 0, exp, 1 - exp)
    return alpha * psi


def _r_t(d, sdf, alpha, beta):
    """R(t_k) at the interval starts: [..., P] -> [..., P-1]."""
    sigma = sdf_to_sigma(sdf, alpha, beta)
    delta = d[..., 1:] - d[..., :-1]
    return torch.cat([torch.zeros_like(sdf[..., :1]),
                      torch.cumsum(sigma[..., :-1] * delta, dim=-1)], dim=-1)[..., :-1]


def error_bound(d, sdf, alpha, beta):
    """§3.3: the opacity-approximation error bound per interval, d and sdf
    [..., P] -> [..., P-1]; NaN (from 0 * inf) becomes +inf (volsdf.py:47-65)."""
    sdf_abs = torch.abs(sdf)
    delta = d[..., 1:] - d[..., :-1]
    d_star = torch.clamp(0.5 * (sdf_abs[..., :-1] + sdf_abs[..., 1:] - delta), min=0.0)
    errors = alpha / (4 * beta) * (delta ** 2) * torch.exp(-d_star / beta)
    bounds = torch.exp(-_r_t(d, sdf, alpha, beta)) * (torch.exp(torch.cumsum(errors, -1)) - 1.0)
    return torch.where(torch.isnan(bounds), torch.full_like(bounds, float("inf")), bounds)


def opacity_approx(d, sdf, alpha, beta):
    """1 - exp(-R_t), the opacity CDF of the final draws (volsdf.py:68-75)."""
    return 1.0 - torch.exp(-_r_t(d, sdf, alpha, beta))


def beta_plus_denominator(n0: int, eps: float) -> float:
    """4 (n0 - 1) log(1 + eps) in float32: beta+ = sqrt(far^2 / this) makes the
    uniform sampling's bound equal eps (paper eq. 10)."""
    return float(np.float32(4 * (n0 - 1) * np.log(1 + eps)))


def background_min(sdf, pts, sphere_bg_r):
    """sdf at pts [..., 3], min the background sphere's R - |x| when
    `sphere_bg_r` is given (kernels (a) and (c) take the same min)."""
    if sphere_bg_r is None:
        return sdf
    return torch.minimum(sdf, sphere_bg_r - torch.linalg.norm(pts, dim=-1))


def det_uniforms(n_final: int, n_checkpoints: int, N: int, device=None):
    """The det opacity-draw uniforms: jnp.linspace(0, 1, n_final) for each of
    `n_checkpoints` draws, [N, n_checkpoints * n_final]."""
    return linspace01(n_final, device).repeat(n_checkpoints).expand(N, -1).contiguous()


def _bound_max(d, sdf, alpha, beta):
    return error_bound(d, sdf, alpha, beta).amax(dim=-1)


def _invert_opacity(d, sdf, alpha, beta, u):
    return sample_cdf(d, opacity_approx(d, sdf, alpha, beta), u)


def init_plain(d, sdf, far, alpha_net, beta_net, u0, *, eps: float) -> dict:
    """Plain version of kernel (a), from the coarse depths d [N, n0] and
    their sdf (prior and background min applied): the sampler's state
    {"bounds", "beta" [N, 1], "converged", "iter_usage", "fine"}."""
    beta = torch.sqrt(far ** 2 / torch.tensor(beta_plus_denominator(d.shape[-1], eps)))
    bad = _bound_max(d, sdf, alpha_net, beta_net) > eps
    return {"bounds": torch.clamp(error_bound(d, sdf, 1.0 / beta, beta), 0.0, 1e5),
            "beta": beta, "converged": ~bad,
            "iter_usage": torch.where(bad, -1, 0).int(),
            "fine": _invert_opacity(d, sdf, alpha_net, beta_net, u0)}


def draw_plain(d, bounds, n_up: int):
    """Plain version of kernel (b): n_up det depths [N, n_up] drawn from
    the bounds [N, S-1] of the buffer d [N, S]."""
    u = linspace01(n_up + 2, d.device).expand(d.shape[0], -1)
    return sample_pdf(d, bounds, u)[:, 1:-1].contiguous()


def checkpoint_plain(d, sdf, up, up_sdf, state: dict, alpha_net, beta_net, u_it, u_last, *,
                     it: int, last: bool, eps: float, max_bisection: int):
    """Plain version of kernel (c): the stable merge of (d, sdf) with the new
    depths and their sdf, then round `it`'s checkpoint, bisection and bounds
    (on the last round, the fallback draw and state["beta_out"]); updates
    `state` in place and returns the merged (d, sdf)."""
    d, order = torch.sort(torch.cat([d, up], dim=-1), dim=-1, stable=True)
    sdf = torch.gather(torch.cat([sdf, up_sdf], dim=-1), -1, order)
    mask = ~state["converged"]
    still_bad = _bound_max(d, sdf, alpha_net, beta_net) > eps
    newly = mask & ~still_bad
    cand = _invert_opacity(d, sdf, alpha_net, beta_net, u_it)
    state["fine"] = torch.where(newly[:, None], cand, state["fine"])
    state["iter_usage"] = torch.where(newly, it, state["iter_usage"]).int()
    state["converged"] = state["converged"] | newly
    mask = mask & still_bad

    beta = state["beta"]
    beta_right = beta
    beta_left = torch.full_like(beta, float(beta_net))
    for _ in range(max_bisection):
        beta_tmp = 0.5 * (beta_left + beta_right)
        good = _bound_max(d, sdf, 1.0 / beta_tmp, beta_tmp)[:, None] <= eps
        beta_right = torch.where(good, beta_tmp, beta_right)
        beta_left = torch.where(good, beta_left, beta_tmp)
    beta = state["beta"] = torch.where(mask[:, None], beta_right, beta)
    if not last:
        state["bounds"] = torch.clamp(error_bound(d, sdf, 1.0 / beta, beta), 0.0, 1e5)
        return d, sdf
    conv = state["converged"]
    cand = _invert_opacity(d, sdf, 1.0 / beta, beta, u_last)
    state["fine"] = torch.where(conv[:, None], state["fine"], cand)
    state["iter_usage"] = torch.where(conv, state["iter_usage"], -1).int()
    state["beta_out"] = torch.where(conv, torch.full_like(beta[:, 0], float(beta_net)),
                                    beta[:, 0])
    return d, sdf


@torch.no_grad()
def fine_sample_plain(surface, rays_o, rays_d, d_init, far, alpha_net, beta_net, u_fin, *,
                      eps: float, max_iter: int, max_bisection: int, n_final: int,
                      n_up: int, sphere_bg_r=None):
    """Plain version: the fixed-trip loop of `fine_sample`, stage by stage
    (`init_plain`, then per round `draw_plain` and `checkpoint_plain`). rays
    [N, 3] (d unit), d_init [N, n0] sorted, far [N, 1], alpha_net / beta_net
    the model's scalars, u_fin as in the module note. The sdf query is the
    surface's plain forward (sphere_residual prior included), min R - |x|
    when `sphere_bg_r` is given. Returns (fine [N, n_final], beta_map [N],
    iter_usage [N] int32, -1 where a ray never converged)."""
    N = d_init.shape[0]

    def query(d):
        pts = rays_o[:, None, :] + rays_d[:, None, :] * d[..., None]
        return background_min(surface.forward(pts), pts, sphere_bg_r)

    def u_at(i):
        return u_fin[:, i * n_final:(i + 1) * n_final]

    d = d_init
    sdf = query(d)
    state = init_plain(d, sdf, far.reshape(N, 1), alpha_net, beta_net, u_at(0), eps=eps)
    for it in range(1, max_iter + 1):
        up = draw_plain(d, state["bounds"], n_up)
        d, sdf = checkpoint_plain(d, sdf, up, query(up), state, alpha_net, beta_net, u_at(it),
                                  u_at(max_iter + 1), it=it, last=it == max_iter, eps=eps,
                                  max_bisection=max_bisection)
    return state["fine"], state["beta_out"], state["iter_usage"]


def _lib():
    lib = _build.load("volsdf_fine_sample")
    if not getattr(lib, "_typed", False):
        lib.ntt_volsdf_init.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P]
        lib.ntt_volsdf_draw.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P]
        lib.ntt_volsdf_checkpoint.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
            _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]
        for fn in (lib.ntt_volsdf_init, lib.ntt_volsdf_draw, lib.ntt_volsdf_checkpoint):
            fn.restype = _I
        lib._typed = True
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launch_init(ws, rays_o, rays_d, d_init, raw_sdf, far, ab, u_fin, *, n_final, u_stride,
                eps, beta_c, prior_r, bg_r):
    """Kernel (a) on the coarse query's raw MLP sdf [N * n0]: fills ws's d /
    sdf buffers, bounds, beta, converged, iter_usage and the checkpoint-0
    draw."""
    N, n0 = d_init.shape
    _contiguous(d_init=d_init, raw_sdf=raw_sdf, far=far, ab=ab, u_fin=u_fin)
    rc = _lib().ntt_volsdf_init(
        rays_o.data_ptr(), rays_d.data_ptr(), d_init.data_ptr(), raw_sdf.data_ptr(),
        far.data_ptr(), ab.data_ptr(), u_fin.data_ptr(), N, n0, ws["S"], n_final, u_stride,
        eps, beta_c, prior_r, bg_r, ws["d"][0].data_ptr(), ws["s"][0].data_ptr(),
        ws["bounds"].data_ptr(), ws["beta"].data_ptr(), ws["converged"].data_ptr(),
        ws["iter_usage"].data_ptr(), ws["fine"].data_ptr(), _stream(rays_o))
    _build.check(rc, "volsdf_fine_sample (init)")
    launch_init.launches += 1


def _det_step(n_up: int) -> float:
    """float32(1 / (n_up + 1)): the det uniforms are (j + 1) times it."""
    return float(np.float32(1.0) / np.float32(n_up + 1))


def _draw_outputs(N: int, n_up: int, device):
    return torch.empty(N, n_up, device=device), torch.empty(N * n_up, 3, device=device)


def launch_draw(ws, rays_o, rays_d, src: int, s_in: int, n_up: int):
    """Kernel (b): the n_up det depths [N, n_up] drawn from the bounds of the
    s_in-entry buffer `src`, and their points [N * n_up, 3]."""
    N = rays_o.shape[0]
    nd, pts = _draw_outputs(N, n_up, rays_o.device)
    rc = _lib().ntt_volsdf_draw(
        rays_o.data_ptr(), rays_d.data_ptr(), ws["d"][src].data_ptr(), ws["bounds"].data_ptr(),
        N, s_in, ws["S"], n_up, _det_step(n_up), nd.data_ptr(), pts.data_ptr(),
        _stream(rays_o))
    _build.check(rc, "volsdf_fine_sample (draw)")
    launch_draw.launches += 1
    return nd, pts


def launch_checkpoint(ws, rays_o, rays_d, src: int, s_in: int, nd, raw_new, ab, u_fin, *,
                      it: int, max_iter: int, max_bisection: int, n_final: int, u_stride,
                      eps, prior_r, bg_r):
    """Kernel (c): merge buffer `src` (s_in entries) with the new depths into
    buffer 1 - src, then round `it`'s checkpoint, bisection and bounds, and
    from the bounds the next round's det draw: returns its depths [N, n_up]
    and their points [N * n_up, 3]. On the last round (it == max_iter) the
    fallback draw and beta_out instead, and returns (None, None)."""
    N, n_up = nd.shape
    _contiguous(nd=nd, raw_new=raw_new, ab=ab, u_fin=u_fin)
    dst, last = 1 - src, it == max_iter
    nd_next, pts_next = (None, None) if last else _draw_outputs(N, n_up, rays_o.device)
    rc = _lib().ntt_volsdf_checkpoint(
        rays_o.data_ptr(), rays_d.data_ptr(), ws["d"][src].data_ptr(),
        ws["s"][src].data_ptr(), nd.data_ptr(), raw_new.data_ptr(), ab.data_ptr(),
        u_fin[:, it * n_final:].data_ptr(), u_fin[:, (max_iter + 1) * n_final:].data_ptr(),
        N, s_in, ws["S"], n_up, n_final, u_stride, it, int(last), max_bisection,
        eps, prior_r, bg_r, _det_step(n_up), ws["d"][dst].data_ptr(), ws["s"][dst].data_ptr(),
        ws["beta"].data_ptr(), ws["converged"].data_ptr(), ws["iter_usage"].data_ptr(),
        ws["fine"].data_ptr(), ws["beta_out"].data_ptr(),
        None if last else nd_next.data_ptr(), None if last else pts_next.data_ptr(),
        _stream(rays_o))
    _build.check(rc, "volsdf_fine_sample (checkpoint)")
    launch_checkpoint.launches += 1
    return nd_next, pts_next


launch_init.launches = 0
launch_draw.launches = 0
launch_checkpoint.launches = 0


def workspace(N: int, S: int, n_final: int, device) -> dict:
    """The kernels' per-call buffers: two (d, sdf) pairs [N, S] that the
    merges alternate between, the bounds [N, S] (kernel (a) writes them for
    kernel (b); stride S), the per-ray state and the outputs."""
    return {"S": S,
            "d": torch.empty(2, N, S, device=device),
            "s": torch.empty(2, N, S, device=device),
            "bounds": torch.empty(N, S, device=device),
            "beta": torch.empty(N, device=device),
            "converged": torch.empty(N, dtype=torch.int32, device=device),
            "iter_usage": torch.empty(N, dtype=torch.int32, device=device),
            "fine": torch.empty(N, n_final, device=device),
            "beta_out": torch.empty(N, device=device)}


def _check(surface, rays_o, rays_d, d_init, far, u_fin, max_iter, n_final, n_up):
    N, n0 = d_init.shape
    want = {"rays_o": (N, 3), "rays_d": (N, 3), "d_init": (N, n0), "far": (N, 1),
            "u_fin": (N, (max_iter + 2) * n_final)}
    got = {"rays_o": rays_o, "rays_d": rays_d, "d_init": d_init, "far": far, "u_fin": u_fin}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: want {want[name]}, got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != rays_o.device:
            raise ValueError(f"{name} is on {t.device}, rays_o on {rays_o.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_iter < 1 or n0 < 2 or n_up < 1 or n_final < 1:
        raise ValueError(f"need max_iter >= 1, n0 >= 2, n_up >= 1, n_final >= 1; got "
                         f"{max_iter}, {n0}, {n_up}, {n_final}")
    for p in surface.parameters():
        if p.device != rays_o.device or p.dtype != torch.float32:
            raise ValueError("surface parameters must be float32 on the rays' device")


def fused_fine_sample(surface, rays_o, rays_d, d_init, far, alpha_net, beta_net, u_fin, *,
                      eps: float, max_iter: int, max_bisection: int, n_final: int,
                      n_up: int, sphere_bg_r=None):
    """(fine [N, n_final], beta_map [N], iter_usage [N] int32) of the §3.4
    sampler; the arguments as for `fine_sample_plain` (alpha_net / beta_net
    0-dim tensors on the rays' device, or floats)."""
    _check(surface, rays_o, rays_d, d_init, far, u_fin, max_iter, n_final, n_up)
    if rays_o.device.type == "cpu":
        return fine_sample_plain(surface, rays_o, rays_d, d_init, far, alpha_net, beta_net,
                                 u_fin, eps=eps, max_iter=max_iter,
                                 max_bisection=max_bisection, n_final=n_final, n_up=n_up,
                                 sphere_bg_r=sphere_bg_r)
    if rays_o.device.type != "cuda":
        raise ValueError(f"unsupported device {rays_o.device}")
    dev = rays_o.device
    N, n0 = d_init.shape
    S = n0 + max_iter * n_up
    if S > MAX_SAMPLES:
        raise NotImplementedError(f"{S} samples per ray; the kernels take up to {MAX_SAMPLES}")
    ws = workspace(N, S, n_final, dev)
    if N == 0:
        return ws["fine"], ws["beta_out"], ws["iter_usage"]
    with torch.no_grad():
        ab = torch.stack([torch.as_tensor(alpha_net, device=dev).reshape(()),
                          torch.as_tensor(beta_net, device=dev).reshape(())]).float()
        packed = packed_surface(surface)  # kept while the weights are unchanged
        prior_r = float(surface.radius_init) if surface.sphere_residual else -1.0
        bg_r = -1.0 if sphere_bg_r is None else float(sphere_bg_r)
        kw = {"n_final": n_final, "u_stride": u_fin.shape[1], "eps": float(eps),
              "prior_r": prior_r, "bg_r": bg_r}
        pts = (rays_o[:, None, :] + rays_d[:, None, :] * d_init[..., None]).reshape(-1, 3)
        raw = launch_sdf_forward(surface, pts, packed)
        launch_init(ws, rays_o, rays_d, d_init, raw, far, ab, u_fin,
                    beta_c=beta_plus_denominator(n0, eps), **kw)
        nd, pts = launch_draw(ws, rays_o, rays_d, 0, n0, n_up)
        for it in range(1, max_iter + 1):
            src, s_in = (it - 1) % 2, n0 + (it - 1) * n_up
            raw = launch_sdf_forward(surface, pts, packed)
            nd, pts = launch_checkpoint(ws, rays_o, rays_d, src, s_in, nd, raw, ab, u_fin,
                                        it=it, max_iter=max_iter,
                                        max_bisection=max_bisection, **kw)
    return ws["fine"], ws["beta_out"], ws["iter_usage"]

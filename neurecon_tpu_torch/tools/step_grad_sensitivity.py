"""How far `chip_smoke.py` phase 7's whole-step gradient check moves under
sdf rounding, on one CUDA card:

    python -m neurecon_tpu_torch.tools.step_grad_sensitivity [--seed N] [--nomask]

Phase 7 holds every parameter's gradient of the flagship NeuS ray loss
through the kernels to the plain route's within 5e-4 of its max|ref|. The
NeuS alpha clamps (cdf_prev - cdf_next) / cdf_prev at 0, and the
upsampler's d_all holds sections a few 1e-7 apart, whose sdf difference
rounding decides; a flipped clamp moves that section's sdf cotangent by
~1e-2. This prints, on phase 7's inputs (render_chunk_inputs, 512 rays of
the synthetic scene, d_all from kernel 2): kernel 1's sdf against the plain
version's (share bit-equal, std, max, mean) and the number of sections
whose clamp decision differs; phase 7's measure for routes that take one
piece from the kernels and the rest from the plain versions (kernel 1's
outputs, each of its three outputs alone, kernel 3); and the measure of the
plain route against itself with seeded Gaussian noise of std sigma added to
its sdf, two seeds a sigma. With `--nomask` the same on phase 27's step
(`chip_smoke.nomask_inputs`: NeuS without a mask at
configs/synthetic_quality_nomask.yaml's widths, the NeRF++ background, 512
rays of the envmap scene with their fixed outside jitter), whose gate
(`chip_smoke.NOMASK_GRAD_GATE`) these readings set.
"""
from __future__ import annotations

import argparse
import json
from unittest import mock

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nomask", action="store_true",
                    help="phase 27's no-mask step instead of phase 7's")
    opts = ap.parse_args(argv)
    seed = opts.seed
    import chip_smoke
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio.synthetic import make_synthetic_scene
    from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
    from neurecon_tpu_torch.models.frameworks.neus import _prepare_rays, sdf_to_alpha
    from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp, fused_upsample
    from neurecon_tpu_torch.training import sample_ray_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if opts.nomask:
        c = chip_smoke.nomask_inputs(seed, dev)
        model, rb, d_all, o, d = c["checked"], c["rb"], c["d_all"], c["rays_o"], c["rays_d"]
        ray_loss = get_ray_loss_fn(c["args"], model, c["kw_train"])
        extra = {"u_out": c["u_out"]}
    else:
        c = chip_smoke.render_chunk_inputs(seed, dev)
        model, t = c["checked"], c["t"]
        scene = make_synthetic_scene(n_images=1, H=120, W=160)
        batch = {"c2w": torch.tensor(scene["c2w"][:1], device=dev),
                 "intrinsics": torch.tensor(scene["intrinsics"][:1], device=dev),
                 "rgb": torch.tensor(scene["rgb"][:1], device=dev).reshape(1, -1, 3),
                 "object_mask": torch.tensor(scene["object_mask"][:1],
                                             device=dev).reshape(1, -1)}
        rb = sample_ray_batch(torch.Generator(dev).manual_seed(seed), batch, 120, 160, 512)
        o, d, near, far = _prepare_rays(rb["rays_o"], rb["rays_d"], 1.0)
        d_all = fused_upsample.fused_neus_upsample(
            model.implicit_surface, o, d, (near * (1 - t) + far * t).contiguous(),
            c["u_det"][:512], n_iters=4, n_per_iter=16)
        ray_loss = get_ray_loss_fn(ConfigDict(chip_smoke._train_config("unused", seed)), model,
                                   c["kw_test"])
        extra = {}
    surface = model.implicit_surface
    x = (o[:, None] + d[:, None] * d_all[..., None]).reshape(-1, 3).contiguous()
    k_sdf = fused_nablas.fused_forward_with_nablas(surface, x)[0].view(512, -1)
    p_sdf = fused_nablas.forward_with_nablas_plain(surface, x)[0].view(512, -1)
    err = k_sdf - p_sdf
    s = model.forward_s()
    raw = [cdf[:, :-1] - cdf[:, 1:] for cdf in (sdf_to_alpha(k_sdf, s)[0],
                                                sdf_to_alpha(p_sdf, s)[0])]
    res = {"sdf_bit_equal_share": float((err == 0).float().mean()),
           "sdf_err_std": float(err.std()), "sdf_err_max": float(err.abs().max()),
           "sdf_err_mean": float(err.mean()),
           "clamp_flips": int(((raw[0] > 0) != (raw[1] > 0)).sum())}

    kernel1 = fused_nablas.fused_forward_with_nablas
    kernel3 = fused_nablas_vjp.fused_nablas_vjp

    def plain3(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h, packed=None):
        return fused_nablas_vjp.nablas_vjp_plain(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h)

    def noisy(sigma, noise_seed):
        def plain1(surface, x, weights=None, packed=None):
            sdf, nablas, h = fused_nablas.forward_with_nablas_plain(surface, x, weights)
            g = torch.Generator(x.device).manual_seed(noise_seed)
            return sdf + sigma * torch.randn(sdf.shape, device=x.device, generator=g), nablas, h
        return plain1

    def mixed(pick):  # kernel 1's outputs where pick is true, the plain ones elsewhere
        def route(surface, x, weights=None, packed=None):
            k = kernel1(surface, x, weights, packed)
            p = fused_nablas.forward_with_nablas_plain(surface, x, weights)
            return tuple(a if use else b for a, b, use in zip(k, p, pick))
        route.launches = 0  # kernel 1's wrapper counts on the name it is called by
        return route

    def grads(route1, route3=plain3):
        with mock.patch.object(fused_nablas, "fused_forward_with_nablas", route1), \
                mock.patch.object(fused_nablas_vjp, "fused_nablas_vjp", route3):
            model.zero_grad(set_to_none=True)
            ray_loss(rb, d_all=d_all, **extra)[0].backward()
            return [q.grad.clone() for q in model.parameters()]

    def measure(got, ref):
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(got, ref))

    ref = grads(noisy(0.0, 0))
    res["step"] = "phase 27 (no mask)" if opts.nomask else "phase 7"
    res["phase7_measure"] = {
        "kernel1": measure(grads(kernel1), ref),
        "kernel1_sdf": measure(grads(mixed((True, False, False))), ref),
        "kernel1_nablas": measure(grads(mixed((False, True, False))), ref),
        "kernel1_h": measure(grads(mixed((False, False, True))), ref),
        "kernel3": measure(grads(noisy(0.0, 0), kernel3), ref)}
    res["phase7_measure_plain_with_sdf_noise"] = {
        f"{sigma:g}": [measure(grads(noisy(sigma, k)), ref) for k in (1, 2)]
        for sigma in (1e-8, 3e-8, 1e-7, 3e-7, 1e-6)}
    res["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

"""VolSDF sampling-algorithm validation figure (port of
`neurecon_tpu/tools/test_volsdf_algo.py`): on a closed-form 1-D sdf (a
sphere of radius 1 at depth 3 on the probe ray), the true opacity, its
approximation from N_init samples, the error bound against the actual
error, and where the §3.4 sampler's 64 final depths land.

With `--load_pt` and `--config`, the sdf is a trained VolSDF checkpoint's,
queried along a probe ray through the scene: the sampler then runs as the
port's VolSDF render runs it (`ops/fused_fine_sample.py`: the sdf-only
kernel and kernels (a)-(c) on the card). The closed-form sdf has no MLP to
pack, so it runs the plain sampler (`fine_sample_plain`) on the card's
tensors. Both run on the CUDA card; `--device cpu` runs the plain PyTorch
path on the CPU.

  python -m neurecon_tpu_torch.tools.test_volsdf_algo --save volsdf_algo.png
  python -m neurecon_tpu_torch.tools.test_volsdf_algo --config configs/volsdf.yaml \
      --load_pt logs/exp/ckpts/latest.pt --save volsdf_real.png

`volsdf_algo_numbers` needs no matplotlib; the figure does
(`vis_camera.pyplot`).
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

MAX_ITER, MAX_BISECTION, N_FINAL, N_UP = 5, 10, 64, 128  # the sampler's settings here
PROBE_O = (0.8598, 1.0232, -1.4689)  # the probe ray through a scene (--load_pt)
PROBE_D = (-0.4857, -0.4841, 0.7386)


class SphereSDF(torch.nn.Module):
    """|x - c| - r: the closed-form surface, as the plain sampler queries it."""

    def __init__(self, center=(0.0, 0.0, 3.0), radius=1.0):
        super().__init__()
        self.register_buffer("center", torch.tensor(center, dtype=torch.float32))
        self.radius = float(radius)

    def forward(self, x):
        return torch.linalg.norm(x - self.center, dim=-1) - self.radius


def load_real_sdf(config, load_pt: str, device=None):
    """(VolSDF model, rays_o [1, 3], rays_d [1, 3], learned beta) from a
    trained checkpoint of either package and its config (a yaml path, or a
    config dict)."""
    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.config import ConfigDict, load_yaml
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.utils.checkpoints import read_restricted

    dev = get_device(device)
    cfg = load_yaml(config) if isinstance(config, str) else ConfigDict(copy.deepcopy(config))
    if cfg.model.framework != "VolSDF":
        raise ValueError(f"--load_pt needs a VolSDF config, got {cfg.model.framework}")
    model = get_model(cfg, dev)[0]
    sd = read_restricted(load_pt)
    bridge.load_tree(model, sd["model"] if "model" in sd else sd, strict=False)
    rays_o = torch.tensor([PROBE_O], device=dev)
    rays_d = torch.tensor([PROBE_D], device=dev)
    return model, rays_o, rays_d, float(model.forward_ab()[1])


@torch.no_grad()
def volsdf_algo_numbers(beta_net: float = 0.1, eps: float = 0.1, N_init: int = 128,
                        far: float = 6.0, load_pt: str = None, config=None,
                        device=None, plain: bool = False) -> dict:
    """The figure's numbers: the dense true opacity (`dense_t`, `O_true`),
    the coarse depths `d`, their opacity approximation `O_hat`, its error
    bound `bounds` and actual error `err`, and the sampler's final depths
    `d_fine` [64], `beta_map` and `iter_usage`, with the `beta_net` and
    `eps` used, on `device` (the CUDA card unless the caller names
    another). With `load_pt`, `plain` runs the checkpoint's sdf and the
    sampler through their plain versions (the reference of the kernels'
    run)."""
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.ops import fused_fine_sample as ffs

    dev = get_device(device)
    if load_pt is not None:
        if config is None:
            raise ValueError("--load_pt needs --config")
        model, rays_o, rays_d, beta_net = load_real_sdf(config, load_pt, dev)

        query = model.forward_surface if plain else model.forward_surface_fast

        def sdf1d(t):
            t = torch.as_tensor(np.atleast_1d(t), dtype=torch.float32, device=dev)
            return query(rays_o + rays_d * t[:, None]).cpu().numpy()
    else:
        surface = SphereSDF().to(dev)
        rays_o = torch.zeros(1, 3, device=dev)
        rays_d = torch.tensor([[0.0, 0.0, 1.0]], device=dev)

        def sdf1d(t):
            return np.abs(t - 3.0) - 1.0
    alpha_net = 1.0 / beta_net

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    dense_t = np.linspace(0, far + 2, 20000)
    sigma = ffs.sdf_to_sigma(f32(sdf1d(dense_t)), alpha_net, beta_net).cpu().numpy()
    dt = dense_t[1] - dense_t[0]
    R = np.concatenate([[0.0], np.cumsum(0.5 * (sigma[1:] + sigma[:-1]) * dt)])
    O_true = 1 - np.exp(-R)

    d = np.linspace(0, far, N_init)
    sdf = sdf1d(d)
    bounds = ffs.error_bound(f32(d)[None], f32(sdf)[None], alpha_net, beta_net)[0].cpu().numpy()
    sig = ffs.sdf_to_sigma(f32(sdf), alpha_net, beta_net).cpu().numpy()
    O_hat = 1 - np.exp(-np.cumsum(sig[:-1] * np.diff(d)))
    err = np.abs(np.interp(d[1:], dense_t, O_true) - O_hat)

    d_init = f32(d)[None].contiguous()
    far_t = torch.full((1, 1), float(far), device=dev)
    u_fin = ffs.det_uniforms(N_FINAL, MAX_ITER + 2, 1, dev)
    kw = dict(eps=eps, max_iter=MAX_ITER, max_bisection=MAX_BISECTION, n_final=N_FINAL,
              n_up=N_UP)
    if load_pt is not None:
        sample = ffs.fine_sample_plain if plain else ffs.fused_fine_sample
        fine, beta_map, iter_usage = sample(
            model.implicit_surface, rays_o, rays_d, d_init, far_t, alpha_net, beta_net, u_fin,
            sphere_bg_r=model.sphere_bg_r, **kw)
    else:
        fine, beta_map, iter_usage = ffs.fine_sample_plain(
            surface, rays_o, rays_d, d_init, far_t, alpha_net, beta_net, u_fin, **kw)
    return {"dense_t": dense_t, "O_true": O_true, "d": d, "O_hat": O_hat, "bounds": bounds,
            "err": err, "d_fine": fine[0].cpu().numpy(), "beta_map": float(beta_map[0]),
            "iter_usage": int(iter_usage[0]), "beta_net": beta_net, "eps": eps,
            "within": bool((err <= bounds + 1e-3).all())}


def main(save: str = None, beta_net: float = 0.1, eps: float = 0.1, N_init: int = 128,
         load_pt: str = None, config: str = None, far: float = 6.0, device=None):
    from neurecon_tpu_torch.tools.vis_camera import pyplot

    n = volsdf_algo_numbers(beta_net, eps, N_init, far, load_pt, config, device)
    if load_pt is not None:
        print(f"loaded {load_pt}: learned beta={n['beta_net']:.5f}")
    d = n["d"]
    plt = pyplot(show=save is None)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 8))
    ax1.plot(n["dense_t"], n["O_true"], label="true opacity")
    ax1.step(d[1:], n["O_hat"], where="post", label=f"approx from {N_init} samples")
    ax1.scatter(n["d_fine"], np.zeros(len(n["d_fine"])), s=6, color="red",
                label="fine_sample output")
    ax1.legend()
    ax1.set_xlabel("depth")
    ax1.set_title(f"beta={n['beta_net']}, eps={eps}, iters used={n['iter_usage']}, "
                  f"beta_map={n['beta_map']:.4f}")
    ax2.step(d[1:], n["bounds"], where="post", label="error bound")
    ax2.step(d[1:], n["err"], where="post", label="actual |error|")
    ax2.set_yscale("log")
    ax2.legend()
    ax2.set_xlabel("depth")
    print(f"max error {n['err'].max():.4g} <= max bound {n['bounds'].max():.4g}: {n['within']}")
    if save:
        fig.savefig(save, dpi=120)
        print(f"saved {save}")
    else:
        plt.show()
    return n


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--beta_net", type=float, default=0.1,
                   help="closed-form mode only; --load_pt uses the learned beta")
    p.add_argument("--eps", type=float, default=0.1)
    p.add_argument("--load_pt", type=str, default=None,
                   help="trained VolSDF checkpoint (needs --config)")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--far", type=float, default=6.0)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu (the plain PyTorch path)")
    a = p.parse_args()
    main(a.save, a.beta_net, a.eps, load_pt=a.load_pt, config=a.config, far=a.far,
         device=a.device)

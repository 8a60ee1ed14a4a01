"""One ray per dataset image in 3-D (port of `neurecon_tpu/tools/vis_ray.py`):
a quick check that the ray directions and the camera poses agree.

  python -m neurecon_tpu_torch.tools.vis_ray --config configs/neus.yaml [--save out.png]

`probe_rays` (the numbers: one random pixel's ray per image, through the
port's `get_data` and `get_rays`) needs no matplotlib; the figure does
(`vis_camera.pyplot`). The rays are made on the CUDA card; `--device cpu`
makes them on the CPU.
"""
from __future__ import annotations

import numpy as np


def probe_rays(args, length: float = 2.0, device=None):
    """(origins [n, 3], unit directions [n, 3], segments [n, 2, 3] from each
    origin `length` along its ray) of one ray per image of the dataset, the
    pixel drawn from a generator on `device` (the CUDA card unless the
    caller names another) seeded with the image's index."""
    import torch

    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.ops import get_rays

    dev = get_device(device)
    dataset = get_data(args)
    origins, dirs = [], []
    for i in range(len(dataset)):
        _, model_input, _ = dataset[i]
        rays_o, rays_d, _ = get_rays(
            torch.as_tensor(np.asarray(model_input["c2w"], np.float32), device=dev),
            torch.as_tensor(np.asarray(model_input["intrinsics"], np.float32), device=dev),
            dataset.H, dataset.W, N_rays=1,
            generator=torch.Generator(device=dev).manual_seed(i))
        o = rays_o.reshape(-1, 3)[0].cpu().numpy().astype(np.float64)
        d = rays_d.reshape(-1, 3)[0].cpu().numpy().astype(np.float64)
        origins.append(o)
        dirs.append(d / np.linalg.norm(d))
    o, d = np.asarray(origins), np.asarray(dirs)
    return o, d, np.stack([o, o + length * d], axis=1)


def main_function(args, show: bool = True, save_path: str = None, device=None):
    from neurecon_tpu_torch.tools.vis_camera import pyplot

    o, _, segs = probe_rays(args, device=device)
    plt = pyplot(show)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    for oi, seg in zip(o, segs):
        ax.plot(seg[:, 0], seg[:, 2], -seg[:, 1], linewidth=0.8)
        ax.scatter(oi[0], oi[2], -oi[1], s=8)
    ax.scatter([0], [0], [0], color="red", s=40)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig


def main(argv=None):
    from neurecon_tpu_torch.config import parse_cli

    def extra(parser):
        parser.add_argument("--save", type=str, default=None)
        parser.add_argument("--device", type=str, default=None,
                            help="cuda (the default) or cpu")

    config, _ = parse_cli(extra_args_fn=extra, argv=argv)
    return main_function(config, show=config.get("save", None) is None,
                         save_path=config.get("save", None), device=config.get("device", None))


if __name__ == "__main__":
    main()

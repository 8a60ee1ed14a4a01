"""The eikonal gradient block on the card (port of
`neurecon_tpu/tools/bench_gradblock.py`): the time of grad-wrt-params of a
loss over (sdf, nablas, h) = ImplicitSurface.forward_with_nablas at M
points of [-1, 1]^3 on configs/neus.yaml's surface (D=8, W=256, skip at 4,
6 octaves; the port's geometric init at --seed), through kernels 1 + 3 (the
differentiable op) and through their plain versions (autograd, double
backward), one JSON line each.

The loss touches all three outputs as the NeuS loss does:
mean((|nablas| - 1)^2) + mean(sdf^2) + 1e-3 mean(h^2). The work is counted
analytically in place of XLA's cost analysis: 2 x (the forward and nablas
multiply-adds a point + the eikonal backward's) x M, as chip_smoke.py counts
them (`probe_common.surface_macs`); each row prints TF/s beside the card's
fp32 peak and its 3xTF32 rate (the dense TF32 peak over the three MMAs of a
split-fp32 product), the peaks PERF.md's kernel table uses.

  python -m neurecon_tpu_torch.tools.bench_gradblock [--M 65536] [--K 20]
  python -m neurecon_tpu_torch.tools.bench_gradblock --device cpu --M 256 --width 64 --K 2
"""
from __future__ import annotations

import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_gradblock"


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=20)
    ap.add_argument("--M", type=int, default=65536, help="points")
    ap.add_argument("--width", type=int, default=256, help="surface width")
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.base import ImplicitSurface

    dev = get_device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    s_cfg = dict(pc.NEUS_YAML["model"]["surface"], W=a.width)
    surface = ImplicitSurface(W_geo_feat=a.width, **s_cfg)
    surface.reset_parameters(torch.Generator().manual_seed(a.seed))
    surface = surface.to(dev)
    card = pc.card(dev)
    g = torch.Generator().manual_seed(a.seed + 1)
    x = (torch.rand(a.M, 3, generator=g) * 2 - 1).to(dev)
    macs = pc.surface_macs(surface) + pc.surface_macs(surface, backward=True)
    flops = 2.0 * macs * a.M

    def block():
        surface.zero_grad(set_to_none=True)
        sdf, nablas, h = surface.forward_with_nablas(x)
        loss = (((torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2).mean() + (sdf ** 2).mean()
                + 1e-3 * (h ** 2).mean())
        loss.backward()

    rows = []
    for path, plain in (("kernels 1 + 3", ()), ("plain versions (autograd)",
                                                 ("nablas_forward", "nablas_backward"))):
        with pc.plain_versions(*plain):
            ms = pc.median_ms(block, a.K, dev)
        rows.append(pc.emit(PROBE, path, M=a.M, K=a.K, per_rep_ms=ms,
                            program_gflop=flops / 1e9, achieved_tf_s=flops / (ms * 1e-3) / 1e12,
                            fp32_peak_tf_s=pc.FP32_PEAK / 1e12,
                            split_fp32_peak_tf_s=pc.TF32_PEAK / 3 / 1e12, width=a.width,
                            device=dev.type, card=card))
    return rows


if __name__ == "__main__":
    main()

"""NeuS unbiasedness demo (port of `neurecon_tpu/tools/plot_neus_bias.py`):
NeuS visibility weights against a naive sdf -> sigma baseline on 1-D sdfs,
with the true surfaces marked. The NeuS weights peak at the first zero
crossing; with the two-surface sdf (the second surface occluded by the
first) the naive construction leaks weight to the occluded one. A panel
grid over sample counts N x sharpness s.

  python -m neurecon_tpu_torch.tools.plot_neus_bias --save neus_bias.png

`bias_curves` (the numbers: the NeuS weights through the port's
`frameworks/neus.py::sdf_to_w`, the naive weights, the peak errors) needs
no matplotlib; the figure does (`vis_camera.pyplot`). The NeuS weights are
computed on the CUDA card; `--device cpu` computes them on the CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

NS = (32, 257)  # sample counts of the panel rows


def fake_1d_sdf(d, surface_at=1.3, slope=1.0):
    """A single-surface linear sdf."""
    return slope * (surface_at - d)


def two_surface_sdf(d, border_0=1.3, border_1=1.9):
    """A piecewise sdf with two zero crossings: enter at border_0, exit at
    (border_0 + border_1) / 2, re-enter at border_1 (only the first surface
    should receive visibility weight)."""
    mid = 0.5 * (border_0 + border_1)
    return np.where(d < mid, border_0 - d, d - border_1)


def neus_weights(sdf, s, device=None):
    """The NeuS visibility weights [P-1] of a ray's sdf [P] at sharpness s,
    in float32 as the renderer computes them, on `device` (the CUDA card
    unless the caller names another)."""
    import torch

    from neurecon_tpu_torch import get_device
    from neurecon_tpu_torch.models.frameworks.neus import sdf_to_w

    sdf_t = torch.as_tensor(np.asarray(sdf, np.float32), device=get_device(device))
    _, _, w = sdf_to_w(sdf_t[None], s)
    return w[0].cpu().numpy()


def naive_weights(sdf, d, s):
    """The naive logistic-density sdf -> sigma weights (the biased
    construction NeuS §3.1 argues against)."""
    sigma = s * np.exp(-s * sdf) / (1 + np.exp(-s * sdf)) ** 2
    alpha = 1 - np.exp(-sigma[:-1] * np.diff(d))
    T = np.cumprod(np.concatenate([[1.0], 1 - alpha + 1e-10]))[:-1]
    return alpha * T


def bias_curves(s: float = 64.0, surface_at: float = 1.3, occlusion: bool = True,
                device=None):
    """Every panel's numbers: a list of rows (one per N of NS) of dicts (one
    per s of s/4, s, 4s) with the midpoints `d_mid`, the NeuS and naive
    weights, the true `surfaces` and the NeuS peak's distance to the first
    surface (`peak_err`); the NeuS weights on `device`."""
    rows = []
    for N in NS:
        d = np.linspace(0.0, 2.5, N)
        if occlusion:
            sdf = two_surface_sdf(d, surface_at, surface_at + 0.6)
            surfaces = (surface_at, surface_at + 0.6)
        else:
            sdf = fake_1d_sdf(d, surface_at)
            surfaces = (surface_at,)
        d_mid = 0.5 * (d[1:] + d[:-1])
        row = []
        for s_val in (s / 4.0, s, s * 4.0):
            w = neus_weights(sdf, s_val, device)
            row.append({"N": N, "s": s_val, "d_mid": d_mid, "w_neus": w,
                        "w_naive": naive_weights(sdf, d, s_val), "surfaces": surfaces,
                        "peak_err": float(abs(d_mid[np.argmax(w)] - surfaces[0]))})
        rows.append(row)
    return rows


def main(save: str = None, s: float = 64.0, surface_at: float = 1.3, occlusion: bool = True,
         device=None):
    from neurecon_tpu_torch.tools.vis_camera import pyplot

    rows = bias_curves(s, surface_at, occlusion, device)
    worst = max(p["peak_err"] for row in rows for p in row)
    plt = pyplot(show=save is None)
    fig, axes = plt.subplots(len(rows), len(rows[0]), figsize=(5 * len(rows[0]), 3.2 * len(rows)),
                             sharex=True)
    for r, row in enumerate(rows):
        for c, p in enumerate(row):
            ax = axes[r][c]
            ax.plot(p["d_mid"], p["w_neus"] / (p["w_neus"].max() + 1e-12), label="NeuS (unbiased)")
            ax.plot(p["d_mid"], p["w_naive"] / (p["w_naive"].max() + 1e-12), "--",
                    label="naive sdf->sigma")
            for j, sf in enumerate(p["surfaces"]):
                ax.axvline(sf, color="k", lw=0.8, label="true surface" if j == 0 else None)
            ax.set_title(f"N={p['N']}, s={p['s']:g}: NeuS peak err {p['peak_err']:.3f}",
                         fontsize=9)
    axes[0][0].legend(fontsize=8)
    for ax in axes[-1]:
        ax.set_xlabel("depth")
    for row in axes:
        row[0].set_ylabel("normalized weight")
    fig.suptitle("NeuS unbiased weights vs naive sdf->sigma"
                 + (" (two-surface occlusion SDF)" if occlusion else ""))
    fig.tight_layout()
    print(f"worst NeuS first-surface peak error over the N x s grid: {worst:.4f} "
          f"(grid spacing {2.5 / (min(NS) - 1):.4f})")
    if save:
        fig.savefig(save, dpi=120)
        print(f"saved {save}")
    else:
        plt.show()
    return worst


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--save", type=str, default=None)
    p.add_argument("--s", type=float, default=64.0)
    p.add_argument("--single_surface", action="store_true",
                   help="use the single linear SDF instead of the two-surface occlusion oracle")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the default) or cpu")
    a = p.parse_args()
    main(a.save, a.s, occlusion=not a.single_surface, device=a.device)

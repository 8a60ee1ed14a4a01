"""Camera-extrinsics frustum figure (port of `neurecon_tpu/tools/vis_camera.py`):
a glyph per camera (image-plane rectangle, an up-direction triangle, four
apex-to-corner edges, optional frame axes), jet-colormap colours and index
labels, equal-range axes centred on the scene, in matplotlib's frame
(x, z, -y).

  python -m neurecon_tpu_torch.tools.vis_camera --config configs/neus.yaml \
      [--save out.png] [--frame_axes]

The numbers (`camera_wire_model`, `camera_segments`) need only numpy; the
figure needs matplotlib, imported only where it is drawn (`pyplot`), which
raises an error that says so where matplotlib is not installed.
"""
from __future__ import annotations

import numpy as np


def pyplot(show: bool = False):
    """matplotlib.pyplot, headless (Agg) unless the figure is to be shown.
    Raises RuntimeError where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("drawing a figure needs matplotlib, which is not installed "
                           "here; the tools' numbers need only numpy and torch") from e
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def camera_wire_model(K: np.ndarray, cam_width=0.032, cam_height=0.024,
                      scale_focal=40.0, frame_axes: bool = False):
    """Polyline segments (camera frame) of one camera glyph: a list of [P, 3]
    arrays, the image-plane rectangle, the up-direction triangle, 4
    apex-to-corner edges and (optionally) the 3 frame axes; the focal
    scaling f = scale_focal * 2 / (fx + fy)."""
    f = scale_focal * 2.0 / (K[0, 0] + K[1, 1])
    w, h = cam_width, cam_height
    rect = np.array([[-w, h, f], [w, h, f], [w, -h, f], [-w, -h, f],
                     [-w, h, f]], dtype=np.float64)
    # the triangle above the image plane marks the camera's up (-y)
    tri = np.array([[-w, -h, f], [0, -2 * h, f], [w, -h, f]], dtype=np.float64)
    apex = [np.array([[0, 0, 0], c]) for c in rect[:4]]
    segs = [rect, tri] + apex
    if frame_axes:
        for axis in np.eye(3) * (f / 2):
            segs.append(np.array([[0, 0, 0], axis]))
    return segs


def _to_plot_frame(pts_world: np.ndarray) -> np.ndarray:
    """World (OpenCV convention) -> matplotlib (x, z, -y)."""
    return np.stack([pts_world[..., 0], pts_world[..., 2], -pts_world[..., 1]], axis=-1)


def camera_segments(K, extrinsics, cam_width=0.032, cam_height=0.024, scale_focal=40.0,
                    frame_axes: bool = False):
    """Every camera's glyph in the plot frame: a list (one per w2c matrix of
    `extrinsics` [N, 4, 4]) of lists of [P, 3] polylines, and each camera's
    apex [N, 3]."""
    segs = camera_wire_model(K, cam_width, cam_height, scale_focal, frame_axes)
    out, apexes = [], []
    for w2c in extrinsics:
        c2w = np.linalg.inv(w2c)
        out.append([_to_plot_frame(s @ c2w[:3, :3].T + c2w[:3, 3]) for s in segs])
        apexes.append(_to_plot_frame(c2w[:3, 3]))
    return out, np.asarray(apexes).reshape(-1, 3)


def set_equal_range(ax, lo, hi):
    """Cubic axis limits centred on the drawn content (ax.set_aspect('equal')
    is unreliable on 3-D axes)."""
    mid = (lo + hi) / 2.0
    r = float((hi - lo).max()) / 2.0 or 1.0
    ax.set_xlim(mid[0] - r, mid[0] + r)
    ax.set_ylim(mid[1] - r, mid[1] + r)
    ax.set_zlim(mid[2] - r, mid[2] + r)


def draw_camera(ax, K, cam_width, cam_height, scale_focal, extrinsics,
                annotate: bool = True, frame_axes: bool = False, color=None):
    """Draw one frustum glyph per w2c matrix in `extrinsics` [N, 4, 4];
    per-camera colours walk the jet colormap unless `color` is given.
    Returns (min, max) over the drawn points in the plot frame."""
    from matplotlib import cm

    segs, apexes = camera_segments(K, extrinsics, cam_width, cam_height, scale_focal,
                                   frame_axes)
    n = len(extrinsics)
    colors = ([color] * n if color is not None
              else [cm.jet(x) for x in np.linspace(0.0, 1.0, max(n, 2))])
    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for i, cam in enumerate(segs):
        for p in cam:
            ax.plot(p[:, 0], p[:, 1], p[:, 2], color=colors[i], linewidth=0.9)
            lo, hi = np.minimum(lo, p.min(0)), np.maximum(hi, p.max(0))
        if annotate:
            ax.text(*apexes[i], str(i), color=colors[i], fontsize=8)
    return lo, hi


def visualize(camera_matrix: np.ndarray, extrinsics: np.ndarray, annotate: bool = True,
              frame_axes: bool = False, show: bool = True, save_path: str = None,
              cam_width=0.032, cam_height=0.024, scale_focal=40.0):
    plt = pyplot(show)
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(111, projection="3d")
    lo, hi = draw_camera(ax, camera_matrix, cam_width, cam_height, scale_focal,
                         extrinsics, annotate, frame_axes)
    ax.scatter([0], [0], [0], color="red", s=40)  # the scene's origin
    set_equal_range(ax, np.minimum(lo, 0), np.maximum(hi, 0))
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    ax.set_title("Extrinsic Parameters Visualization")
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig


def main(argv=None):
    from neurecon_tpu_torch.config import parse_cli
    from neurecon_tpu_torch.dataio import get_data

    def extra(parser):
        parser.add_argument("--save", type=str, default=None)
        parser.add_argument("--frame_axes", action="store_true",
                            help="draw per-camera xyz frame axes")

    config, _ = parse_cli(extra_args_fn=extra, argv=argv)
    dataset = get_data(config)
    extr = np.linalg.inv(np.asarray(dataset.c2w_all))
    K = np.asarray(dataset.intrinsics_all[0])[:3, :3]
    return visualize(K, extr, frame_axes=bool(config.get("frame_axes", False)),
                     show=config.get("save", None) is None, save_path=config.get("save", None))


if __name__ == "__main__":
    main()

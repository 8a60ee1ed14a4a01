"""Camera frustums together with the reconstructed surface (port of
`neurecon_tpu/tools/vis_surface_and_cam.py`): a matplotlib 3-D scene with
true-FOV frusta from the image size and intrinsics (half_w = L (W / 2) /
fx), per-camera colours and index labels, the mesh as a Lambertian-shaded
Poly3DCollection, the bounding-sphere wireframe and an RGB frame at the
origin. `--mesh` takes a .ply; `--load_pt` meshes a checkpoint's surface on
the fly (marching tetrahedra on a `--mesh_N`^3 grid queried through the
sdf-only CUDA kernel on the card; `--device cpu` for the plain path).

  python -m neurecon_tpu_torch.tools.vis_surface_and_cam --config configs/neus.yaml \
      --mesh logs/exp/meshes/00010000.ply --save out.png
  python -m neurecon_tpu_torch.tools.vis_surface_and_cam --config configs/neus.yaml \
      --load_pt logs/exp/ckpts/latest.pt --mesh_N 128 --save out.png

The numbers (`frustum_segments`, `extract_mesh_from_ckpt`, `shade_faces`)
need no matplotlib; the figure does (`vis_camera.pyplot`).
"""
from __future__ import annotations

import numpy as np

from neurecon_tpu_torch.tools.vis_camera import _to_plot_frame, pyplot, set_equal_range


def frustum_segments(K, w2c, img_size, frustum_length=0.5):
    """Apex-to-corner edges and the image-plane rectangle of one true-FOV
    frustum (the glyph spans the camera's field of view): a list of [P, 3]
    world-space polylines."""
    W, H = img_size
    half_w = frustum_length * (W / 2.0) / K[0, 0]
    half_h = frustum_length * (H / 2.0) / K[1, 1]
    L = frustum_length
    rect = np.array([[-half_w, -half_h, L], [half_w, -half_h, L],
                     [half_w, half_h, L], [-half_w, half_h, L],
                     [-half_w, -half_h, L]])
    segs = [rect] + [np.array([[0.0, 0.0, 0.0], c]) for c in rect[:4]]
    c2w = np.linalg.inv(w2c)
    return [s @ c2w[:3, :3].T + c2w[:3, 3] for s in segs]


def shade_faces(verts, faces, light=(0.4, -0.6, 0.8), base_color=(0.72, 0.72, 0.78)):
    """(triangles [F, 3, 3] in the plot frame, RGB [F, 3]): each face's
    brightness from its normal and the light, double-sided."""
    tris = verts[faces]
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True) + 1e-12
    lt = np.asarray(light, np.float64)
    lt /= np.linalg.norm(lt)
    lam = np.abs(n @ lt)
    shade = (0.35 + 0.65 * lam)[:, None] * np.asarray(base_color)
    return _to_plot_frame(tris), np.clip(shade, 0, 1)


def draw_shaded_mesh(ax, verts, faces, max_faces=30000, **shading):
    """The mesh as shaded triangles (at most `max_faces`, a seeded subset);
    returns (min, max) of its points in the plot frame."""
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if len(faces) > max_faces:
        faces = faces[np.random.RandomState(0).choice(len(faces), max_faces, replace=False)]
    tris_plot, colors = shade_faces(verts, faces, **shading)
    ax.add_collection3d(Poly3DCollection(tris_plot, facecolors=colors, edgecolors="none"))
    p = tris_plot.reshape(-1, 3)
    return p.min(0), p.max(0)


def draw_sphere_wire(ax, radius, color="red", n=24):
    """The bounding sphere's wireframe."""
    u = np.linspace(0, 2 * np.pi, n)
    v = np.linspace(0, np.pi, n // 2)
    for phi in v[1:-1]:  # latitude circles
        ax.plot(radius * np.cos(u) * np.sin(phi), radius * np.sin(u) * np.sin(phi),
                np.full_like(u, radius * np.cos(phi)), color=color, linewidth=0.3, alpha=0.4)
    for th in u[::3]:  # longitude circles
        ax.plot(radius * np.cos(th) * np.sin(v), radius * np.sin(th) * np.sin(v),
                radius * np.cos(v), color=color, linewidth=0.3, alpha=0.4)


def draw_coord_frame(ax, size=0.5):
    """RGB xyz axes at the origin, in the plot frame."""
    for axis, c in zip(np.eye(3) * size, ("r", "g", "b")):
        p = _to_plot_frame(np.stack([np.zeros(3), axis]))
        ax.plot(p[:, 0], p[:, 1], p[:, 2], color=c, linewidth=2.0)


def extract_mesh_from_ckpt(load_pt, config, N=128, device=None):
    """(verts [V, 3] float32, faces [F, 3] int32) of a checkpoint's surface
    (either package's), in memory: the model's `implicit_surface` queried on
    an N^3 grid over `data.volume_size` (the sdf-only kernel on a card),
    then marching tetrahedra at level 0."""
    import torch

    from neurecon_tpu_torch import bridge, get_device
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.utils.checkpoints import read_restricted
    from neurecon_tpu_torch.utils.mesh import marching_tetrahedra, query_grid

    dev = get_device(device)
    model = get_model(config, dev)[0]
    sd = read_restricted(load_pt)
    bridge.load_tree(model, sd["model"] if "model" in sd else sd, strict=False)
    s = float(config.data.get("volume_size", 2.0))
    with torch.no_grad():
        values = query_grid(model.implicit_surface.forward_query, N, s, device=dev)
        verts, faces = marching_tetrahedra(values, 0.0)
        verts = verts * (s / (N - 1)) - s / 2.0
    return (verts.cpu().numpy().astype(np.float32), faces.cpu().numpy().astype(np.int32))


def main_function(args, mesh_path: str = None, load_pt: str = None, show: bool = True,
                  save_path: str = None, sphere_radius: float = None,
                  camera_size: float = 0.5, device=None):
    from matplotlib import cm

    from neurecon_tpu_torch.dataio import get_data
    from neurecon_tpu_torch.utils.mesh import read_ply

    dataset = get_data(args)
    extr = np.linalg.inv(np.asarray(dataset.c2w_all))
    K = np.asarray(dataset.intrinsics_all[0])
    if mesh_path is not None:
        verts, faces = read_ply(mesh_path)
    elif load_pt is not None:
        verts, faces = extract_mesh_from_ckpt(load_pt, args, N=int(args.get("mesh_N", 128)),
                                              device=device)
    else:
        raise ValueError("need --mesh or --load_pt")

    plt = pyplot(show)
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(111, projection="3d")
    lo, hi = draw_shaded_mesh(ax, verts, faces)
    colors = [cm.jet(x) for x in np.linspace(0, 1, max(len(extr), 2))]
    for i, w2c in enumerate(extr):
        for seg in frustum_segments(K, w2c, (dataset.W, dataset.H), frustum_length=camera_size):
            p = _to_plot_frame(seg)
            ax.plot(p[:, 0], p[:, 1], p[:, 2], color=colors[i], linewidth=0.8)
            lo, hi = np.minimum(lo, p.min(0)), np.maximum(hi, p.max(0))
        apex = _to_plot_frame(np.linalg.inv(w2c)[:3, 3])
        ax.text(apex[0], apex[1], apex[2], str(i), color=colors[i], fontsize=8)
    if sphere_radius is None:
        sphere_radius = float(args.model.get("obj_bounding_radius", 0) or 0)
    if sphere_radius > 0:
        draw_sphere_wire(ax, sphere_radius)
    draw_coord_frame(ax)
    set_equal_range(ax, lo, hi)
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("-y")
    ax.set_title("Surface + cameras")
    if save_path:
        fig.savefig(save_path, dpi=120)
    if show:
        plt.show()
    return fig


def main(argv=None):
    from neurecon_tpu_torch.config import parse_cli

    def extra(parser):
        parser.add_argument("--mesh", type=str, default=None, help="pre-extracted .ply surface")
        parser.add_argument("--load_pt", type=str, default=None,
                            help="trained checkpoint: extract the surface on the fly "
                                 "(--mesh_N sets the grid)")
        parser.add_argument("--mesh_N", type=int, default=128)
        parser.add_argument("--sphere_radius", type=float, default=None)
        parser.add_argument("--camera_size", type=float, default=0.5)
        parser.add_argument("--save", type=str, default=None)
        parser.add_argument("--device", type=str, default=None,
                            help="cuda (the default) or cpu (plain PyTorch path)")

    config, _ = parse_cli(extra_args_fn=extra, argv=argv)
    return main_function(config, mesh_path=config.get("mesh", None),
                         load_pt=config.get("load_pt", None),
                         show=config.get("save", None) is None,
                         save_path=config.get("save", None),
                         sphere_radius=config.get("sphere_radius", None),
                         camera_size=float(config.get("camera_size", 0.5)),
                         device=config.get("device", None))


if __name__ == "__main__":
    main()

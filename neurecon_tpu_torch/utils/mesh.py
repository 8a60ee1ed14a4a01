"""Level-set mesh extraction (port of `neurecon_tpu/utils/mesh.py`): the sdf
grid query and marching tetrahedra on the grid's device, and the binary PLY
writer and reader on the host.

`query_grid` builds the N^3 grid's coordinates on the device one x-slab at a
time, with the JAX package's float32 arithmetic, and keeps the values there.
`marching_tetrahedra` is the JAX package's numpy triangulation (6-tet Kuhn
split of each crossing cube, vertices deduplicated on grid-edge ids) in torch
ops, in float64; it gives the same faces and vertices as the numpy function on
the same grid.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from neurecon_tpu_torch import get_device
from neurecon_tpu_torch.utils.console import log

# 6-tetrahedra decomposition of the unit cube, all sharing diagonal 0-7.
# Cube corners indexed by binary (x, y, z) bits: corner = x<<2 | y<<1 | z.
_TETS = ((0, 5, 1, 7), (0, 1, 3, 7), (0, 3, 2, 7),
         (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7))

_CORNER_OFFSETS = tuple(((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8))


def _case_tables():
    """For each of the 16 inside-masks of a tet, the triangles to emit; each
    triangle is 3 crossing edges, each edge an (inside, outside) corner pair."""
    cases = []
    for case in range(16):
        inside = [i for i in range(4) if (case >> i) & 1]
        outside = [i for i in range(4) if not (case >> i) & 1]
        if len(inside) == 1:
            i = inside[0]
            a, b, c = outside
            tris = [[(i, a), (i, b), (i, c)]]
        elif len(inside) == 3:
            i = outside[0]
            a, b, c = inside
            tris = [[(a, i), (b, i), (c, i)]]
        elif len(inside) == 2:
            i, j = inside
            k, l = outside
            tris = [[(i, k), (i, l), (j, k)], [(j, k), (i, l), (j, l)]]
        else:
            tris = []
        cases.append(tris)
    return cases


_CASES = _case_tables()


def marching_tetrahedra(values, level: float = 0.0):
    """Triangulate the `level` iso-surface of a dense scalar grid.

    values: [Nx, Ny, Nz] tensor (or array), taken in float64 on its device;
    returns (verts [V, 3] float32 in grid-index coordinates, faces [F, 3]
    int32) on that device, wound so that normals point toward values > level.
    """
    values = torch.as_tensor(values).double()
    dev = values.device
    Nx, Ny, Nz = values.shape
    flat = values.reshape(-1)
    empty = (torch.zeros(0, 3, dtype=torch.float32, device=dev),
             torch.zeros(0, 3, dtype=torch.int32, device=dev))

    # crossing cubes only: O(N^2) of the O(N^3) cubes
    cmin = values[:-1, :-1, :-1].clone()
    cmax = cmin.clone()
    for dx, dy, dz in _CORNER_OFFSETS[1:]:
        c = values[dx:Nx - 1 + dx, dy:Ny - 1 + dy, dz:Nz - 1 + dz]
        torch.minimum(cmin, c, out=cmin)
        torch.maximum(cmax, c, out=cmax)
    ci, cj, ck = torch.nonzero((cmin < level) & (cmax >= level), as_tuple=True)
    del cmin, cmax
    if ci.numel() == 0:
        return empty

    corner_ids = torch.stack([((ci + dx) * Ny + (cj + dy)) * Nz + (ck + dz)
                              for dx, dy, dz in _CORNER_OFFSETS], -1)  # [M, 8]

    # per emitted triangle vertex: the inside-corner and outside-corner node
    # ids of the grid edge it sits on
    weights = torch.tensor([1, 2, 4, 8], device=dev)
    tri_a, tri_b = [], []
    for tet in _TETS:
        tet_ids = corner_ids[:, list(tet)]
        inside = flat[tet_ids] < level
        case = (inside.long() * weights).sum(-1)
        for c in range(1, 15):
            sel = torch.nonzero(case == c, as_tuple=True)[0]
            if sel.numel() == 0:
                continue
            ids = tet_ids[sel]
            for tri in _CASES[c]:
                tri_a.append(torch.stack([ids[:, p] for p, _ in tri], -1))  # [S, 3]
                tri_b.append(torch.stack([ids[:, q] for _, q in tri], -1))
    if not tri_a:
        return empty
    tri_a = torch.cat(tri_a, 0)  # [T, 3] inside-corner node id per vertex
    tri_b = torch.cat(tri_b, 0)  # [T, 3] outside-corner node id

    # dedup vertices on undirected grid edges (int64 keys; N = 512 is far
    # below overflow)
    n_nodes = Nx * Ny * Nz
    keys = torch.minimum(tri_a, tri_b) * n_nodes + torch.maximum(tri_a, tri_b)
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    faces = inverse.reshape(-1, 3).to(torch.int32)

    ua, ub = uniq // n_nodes, uniq % n_nodes
    va, vb = flat[ua], flat[ub]
    t = torch.clamp(torch.nan_to_num((level - va) / (vb - va), nan=0.5), 0.0, 1.0)[:, None]

    def coords(ids):
        return torch.stack([ids // (Ny * Nz), (ids // Nz) % Ny, ids % Nz], -1).double()

    ca = coords(ua)
    verts = ca + t * (coords(ub) - ca)

    # consistent winding: normal toward values > level. The unique keys lost
    # the inside/outside order, so the reference direction comes from the
    # pre-dedup tri_a (inside) / tri_b (outside) pairs. The cross and dot
    # products are spelled out in numpy's order of operations.
    fl = faces.long()
    a, b, c = verts[fl[:, 0]], verts[fl[:, 1]], verts[fl[:, 2]]
    u, v = b - a, c - a
    n = torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                     u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                     u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], -1)
    cb, ca3 = coords(tri_b.reshape(-1)).reshape(-1, 3, 3), coords(tri_a.reshape(-1)).reshape(-1, 3, 3)
    ref = ((cb[:, 0] + cb[:, 1] + cb[:, 2]) / 3) - ((ca3[:, 0] + ca3[:, 1] + ca3[:, 2]) / 3)
    flip = (n[:, 0] * ref[:, 0] + n[:, 1] * ref[:, 1] + n[:, 2] * ref[:, 2]) < 0
    faces[flip] = faces[flip].flip(1)
    return verts.float(), faces


def write_ply(filepath: str, verts, faces):
    """Binary little-endian PLY of float32 vertices and int32 triangles."""
    verts = np.ascontiguousarray(np.asarray(verts), np.float32)
    faces = np.ascontiguousarray(np.asarray(faces), np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n")
    face_rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(filepath, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        f.write(face_rec.tobytes())


def read_ply(filepath: str):
    """(verts [V, 3] float32, faces [F, 3] int32) of a file `write_ply` wrote."""
    with open(filepath, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n_v = int([l for l in lines if l.startswith("element vertex")][0].split()[-1])
        n_f = int([l for l in lines if l.startswith("element face")][0].split()[-1])
        verts = np.frombuffer(f.read(n_v * 12), "<f4").reshape(n_v, 3)
        rec = np.frombuffer(f.read(n_f * 13), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
        return verts.copy(), rec["idx"].copy()


def query_grid(surface_fn: Callable, N: int, volume_size: float,
               chunk: int = 256 * 1024, device=None,
               show_progress: bool = False) -> torch.Tensor:
    """surface_fn (pts [n, 3] -> values [n]) on an N^3 grid centred at the
    origin, as an [N, N, N] float32 tensor on `device`.

    The JAX package's slab structure: x-slabs of `rows` planes (~8 blocks of
    `chunk` points each, `rows` dividing N), coordinates made on the device
    as `(x0 + arange(rows)) * step - s / 2` in float32, and surface_fn
    called on `chunk`-point blocks of a slab."""
    s = float(volume_size)
    step = s / (N - 1)
    rows = max(1, min(N, (8 * chunk) // (N * N)))
    while N % rows:
        rows -= 1
    axis = torch.arange(N, dtype=torch.float32, device=device) * step - s / 2.0
    out = torch.empty(N * N * N, dtype=torch.float32, device=device)
    for i, x0 in enumerate(range(0, N, rows)):
        xs = (x0 + torch.arange(rows, dtype=torch.float32, device=device)) * step - s / 2.0
        xi, yi, zi = torch.meshgrid(xs, axis, axis, indexing="ij")
        pts = torch.stack([xi, yi, zi], -1).reshape(-1, 3)
        base = x0 * N * N
        for c0 in range(0, pts.shape[0], chunk):
            blk = pts[c0:c0 + chunk]
            out[base + c0:base + c0 + blk.shape[0]] = surface_fn(blk)
        if show_progress and i % 8 == 0:
            log.info(f"  grid query slab {x0}/{N}")
    return out.reshape(N, N, N)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def extract_mesh(surface_fn: Callable, volume_size: float = 2.0,
                 level: float = 0.0, N: int = 512,
                 filepath: str = "./surface.ply", chunk: int = 256 * 1024,
                 device=None, show_progress: bool = False) -> dict:
    """Grid query -> marching tetrahedra -> .ply, on `device` (the card
    unless "cpu" is asked for) up to the write.

    Returns {"n_verts", "n_faces", "filepath", "grid_s", "triangulate_s",
    "write_s"}; each time ends in a device sync."""
    device = get_device(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        values = query_grid(surface_fn, N, volume_size, chunk, device, show_progress)
        _sync(device)
        t1 = time.perf_counter()
        verts, faces = marching_tetrahedra(values, level)
        del values
        s = float(volume_size)
        verts = verts * (s / (N - 1)) - s / 2.0  # grid index -> world
        verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
    t2 = time.perf_counter()
    write_ply(filepath, verts, faces)
    t3 = time.perf_counter()
    log.info(f"extract_mesh: {len(verts)} verts / {len(faces)} faces -> {filepath} "
             f"(grid {t1 - t0:.2f}s, triangulation {t2 - t1:.2f}s, write {t3 - t2:.2f}s)")
    return {"n_verts": len(verts), "n_faces": len(faces), "filepath": filepath,
            "grid_s": t1 - t0, "triangulate_s": t2 - t1, "write_s": t3 - t2}

"""Camera-path generation for free-viewpoint rendering — pure numpy.

Provides the five path types of the reference CLI (tools/render_view.py
--camera_path): spiral (:280-285), spherical_spiral (:290-331),
small_circle (:337-366), interpolation (:371-386), great_circle (:391-426),
plus the accelerate/cruise/decelerate angle pacing (:88-105).

Decomposition here is orbit-centric: every circular path is "snap the key
camera centers onto a common sphere, spin a start point about an axis by an
angle schedule, look at the focus point" — one Rodrigues rotation helper and
one orbit function serve the three circle paths.
"""
from __future__ import annotations

import math

import numpy as np

from neurecon_tpu_torch.utils.camera import look_at, normalize, view_matrix


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _rodrigues(axis: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """Rotation matrices about unit `axis` [..., 3] by `angles` [...]:
    R = I + sinθ·K + (1-cosθ)·K² (Rodrigues). Broadcasts over leading dims."""
    axis = np.broadcast_to(axis, angles.shape + (3,))
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = np.zeros_like(kx)
    K = np.stack([
        np.stack([zero, -kz, ky], -1),
        np.stack([kz, zero, -kx], -1),
        np.stack([-ky, kx, zero], -1),
    ], -2)
    s = np.sin(angles)[..., None, None]
    c = np.cos(angles)[..., None, None]
    return np.eye(3) + s * K + (1.0 - c) * (K @ K)


def _rotate(axis: np.ndarray, angles: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Rotate pts [..., 3] about axis by angles (leading dims broadcast)."""
    return np.einsum("...ij,...j->...i", _rodrigues(axis, angles), pts)


def _snap_to_sphere(centers: np.ndarray):
    """Project key camera centers onto their common (max-radius) origin-centered
    sphere. Returns (snapped [..., 3], radius)."""
    norms = np.linalg.norm(centers, axis=-1)
    radius = float(np.max(norms))
    return centers * (radius / norms[..., None]), radius


def _chord_to_arc_angle(p0: np.ndarray, p1: np.ndarray, radius: float) -> float:
    """Central angle subtended by the chord p0→p1 on a sphere of `radius`."""
    chord = float(np.linalg.norm(p1 - p0))
    # float roundoff after _snap_to_sphere can push the ratio past 1.0 for
    # near-antipodal key views, which would NaN the whole path
    return float(np.arcsin(np.clip(chord / (2.0 * radius), -1.0, 1.0)) * 2.0)


def smoothed_motion_interpolation(full_range: float, num_samples: int,
                                  uniform_proportion: float = 1 / 3.0):
    """Angle schedule over [0, full_range]: uniform acceleration, constant
    cruise, uniform deceleration (same pacing as ref render_view.py:88-105)."""
    ramp_proportion = (1.0 - uniform_proportion) / 2.0
    n_ramp = max(math.ceil(num_samples * ramp_proportion), 2)
    n_cruise = max(math.ceil(num_samples * uniform_proportion), 2)
    ramp_speed = np.arange(n_ramp)            # v = 0, 1, 2, ...
    ramp_pos = np.cumsum(ramp_speed)           # x = ∫v
    # total sweep = both ramps + cruise at peak speed; scale to full_range
    scale = full_range / (2.0 * ramp_pos.max() + ramp_speed.max() * n_cruise)
    ramp = ramp_pos * scale
    cruise = np.linspace(ramp.max(), full_range - ramp.max(), n_cruise + 2)[1:-1]
    return np.concatenate([ramp, cruise, full_range - np.flip(ramp)])


def _orbit_path(start: np.ndarray, axis: np.ndarray, angles: np.ndarray,
                focus=None) -> np.ndarray:
    """c2w track orbiting `start` about `axis` by `angles`, looking at `focus`
    (origin by default) with up = -axis (paths orbit 'under' their axis)."""
    centers = _rotate(axis, angles, start)
    if focus is None:
        focus = np.zeros_like(centers)
    return look_at(centers, focus, up=-axis)


# ---------------------------------------------------------------------------
# the five path types
# ---------------------------------------------------------------------------

def poses_avg(poses: np.ndarray) -> np.ndarray:
    center = poses[:, :3, 3].mean(0)
    forward = poses[:, :3, 2].sum(0)
    up = poses[:, :3, 1].sum(0)
    return view_matrix(forward, up, center)


def c2w_track_spiral(c2w, up_vec, rads, focus: float, zrate: float, rots: int,
                     N: int):
    """NeRF-style spiral in the average-camera frame, looking at the point
    [0, 0, focus] of that frame; OpenCV convention."""
    rads = np.asarray(list(rads) + [1.0])
    focus_world = c2w[:3, :4] @ np.array([0.0, 0.0, focus, 1.0])
    thetas = np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]
    offsets = np.stack([np.cos(thetas), np.sin(thetas),
                        np.sin(thetas * zrate), np.ones_like(thetas)], -1)
    centers = (offsets * rads) @ c2w[:3, :4].T
    return np.stack([look_at(c, focus_world, up=up_vec) for c in centers])


def path_spiral(c2ws: np.ndarray, num_views: int):
    c2w_center = poses_avg(c2ws)
    up = c2ws[:, :3, 1].sum(0)
    rads = np.percentile(np.abs(c2ws[:, :3, 3]), 30, 0)
    focus_distance = np.mean(np.linalg.norm(c2ws[:, :3, 3], axis=-1))
    return c2w_track_spiral(c2w_center, up, rads, focus_distance * 0.8,
                            zrate=0.0, rots=1, N=num_views)


def _circle_axis(snapped: np.ndarray) -> np.ndarray:
    """Unit normal of the circle through 3 sphere points (CCW seen from it)."""
    return normalize(np.cross(snapped[1] - snapped[0], snapped[2] - snapped[0]))


def path_spherical_spiral(c2ws: np.ndarray, num_views: int, view_ids,
                          up_angle: float = np.pi / 3.0, n_rots: float = 2.2):
    """Spiral on the view sphere: sweep `n_rots` turns about the 3-view circle
    axis while tilting up to `up_angle` toward the pole."""
    assert len(view_ids) == 3
    snapped, _ = _snap_to_sphere(c2ws[list(view_ids), :3, 3])
    axis = _circle_axis(snapped)

    sweep = np.linspace(0.0, 2.0 * np.pi * n_rots, num_views)
    tilt = np.linspace(0.0, up_angle, num_views)

    centers = _rotate(axis, sweep, snapped[0])
    # per-view tilt axis: horizontal (tangent) direction at each center
    tilt_axes = normalize(np.cross(centers, axis[None, :], axis=-1))
    centers = _rotate(tilt_axes, tilt, centers)
    return look_at(centers, np.zeros_like(centers), up=-axis)


def path_small_circle(c2ws: np.ndarray, num_views: int, view_ids):
    """Smoothed sweep along the small circle through 3 key views."""
    assert len(view_ids) == 3
    snapped, radius = _snap_to_sphere(c2ws[list(view_ids), :3, 3])
    axis = _circle_axis(snapped)
    full_angle = _chord_to_arc_angle(snapped[0], snapped[2], radius)
    angles = smoothed_motion_interpolation(full_angle, num_views)
    return _orbit_path(snapped[0], axis, angles)


def path_great_circle(c2ws: np.ndarray, num_views: int, view01):
    """Smoothed sweep along the great circle through 2 key views."""
    assert len(view01) == 2
    snapped, radius = _snap_to_sphere(c2ws[list(view01), :3, 3])
    axis = normalize(np.cross(snapped[0], snapped[1]))
    full_angle = _chord_to_arc_angle(snapped[0], snapped[1], radius)
    angles = smoothed_motion_interpolation(full_angle, num_views)
    return _orbit_path(snapped[0], axis, angles)


def path_interpolation(c2ws: np.ndarray, num_views: int):
    """Slerp rotations + lerp translations through ALL input views."""
    from scipy.interpolate import interp1d
    from scipy.spatial.transform import Rotation, Slerp

    key_times = np.arange(len(c2ws))
    slerp = Slerp(key_times, Rotation.from_matrix(c2ws[:, :3, :3]))
    lerp = interp1d(key_times, c2ws[:, :3, 3], axis=0)
    times = np.arange(num_views, dtype=np.float64) / num_views * (len(c2ws) - 1)
    out = np.broadcast_to(np.eye(4), (num_views, 4, 4)).copy()
    out[:, :3, :3] = slerp(times).as_matrix()
    out[:, :3, 3] = lerp(times)
    return out


def generate_camera_path(camera_path: str, c2ws: np.ndarray, num_views: int,
                         camera_inds: str = "11,15"):
    """Dispatch mirroring render_view's --camera_path choices."""
    if camera_path == "spiral":
        return path_spiral(c2ws, num_views)
    if camera_path == "interpolation":
        return path_interpolation(c2ws, num_views)
    ids = [int(v) for v in str(camera_inds).split(",")]
    if camera_path == "spherical_spiral":
        return path_spherical_spiral(c2ws, num_views, ids)
    if camera_path == "small_circle":
        return path_small_circle(c2ws, num_views, ids)
    if camera_path == "great_circle":
        return path_great_circle(c2ws, num_views, ids[:2])
    raise RuntimeError(
        "choose render type between [spiral, interpolation, small_circle, "
        "great_circle, spherical_spiral]")

"""Camera math: projection-matrix decomposition, pose helpers, quaternions.

Parity: `load_K_Rt_from_P` (reference utils/rend_util.py:8-25) — decomposes
P = K[R|t] into normalized intrinsics and a camera-to-world pose. Implemented
with an RQ decomposition in numpy (no cv2 dependency in the core path), and
verified against cv2.decomposeProjectionMatrix in tests.

Pose helpers (`view_matrix`, `look_at`, OpenCV convention up=[0,-1,0]) mirror
utils/rend_util.py:27-53; quaternion<->rotation mirror rend_util.py:55-93 but
are numpy (host-side camera-path code only).
"""
from __future__ import annotations

import numpy as np


def rq_decomposition(M: np.ndarray):
    """RQ decomposition of a 3x3 matrix: M = R_up @ Q with R_up upper
    triangular and Q orthonormal. Built on QR of the flipped transpose."""
    P = np.flipud(np.eye(3))
    q, r = np.linalg.qr((P @ M).T)
    R_up = P @ r.T @ P
    Q = P @ q.T
    # fix signs so diag(R_up) >= 0
    signs = np.sign(np.diag(R_up))
    signs[signs == 0] = 1.0
    D = np.diag(signs)
    return R_up @ D, D @ Q


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection matrix into (intrinsics 4x4, c2w pose 4x4).

    K is normalized so K[2,2] == 1; pose holds R^T and the camera center,
    matching cv2.decomposeProjectionMatrix-based reference behavior.
    """
    P = np.asarray(P, dtype=np.float64)[:3, :4]
    M = P[:, :3]
    K, R = rq_decomposition(M)
    # ensure a proper rotation (det=+1); a global sign flip of P is harmless
    if np.linalg.det(R) < 0:
        R = -R
    # camera center: P @ [C;1] = 0  =>  C = -M^{-1} p4
    C = -np.linalg.solve(M, P[:, 3])

    K = K / K[2, 2]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.T.astype(np.float32)
    pose[:3, 3] = C.astype(np.float32)
    return intrinsics, pose


def normalize(vec: np.ndarray) -> np.ndarray:
    return vec / (np.linalg.norm(vec, axis=-1, keepdims=True) + 1e-9)


def view_matrix(forward: np.ndarray, up: np.ndarray, cam_location: np.ndarray):
    rot_z = normalize(forward)
    rot_x = normalize(np.cross(up, rot_z))
    rot_y = normalize(np.cross(rot_z, rot_x))
    mat = np.stack((rot_x, rot_y, rot_z, cam_location), axis=-1)
    hom_vec = np.array([[0.0, 0.0, 0.0, 1.0]])
    if mat.ndim > 2:
        hom_vec = np.tile(hom_vec, [mat.shape[0], 1, 1])
    return np.concatenate((mat, hom_vec), axis=-2)


def look_at(cam_location: np.ndarray, point: np.ndarray,
            up=np.array([0.0, -1.0, 0.0])):  # OpenCV convention
    forward = normalize(point - cam_location)
    return view_matrix(forward, up, cam_location)


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[..., 3, 3] -> [..., 4] (w, x, y, z). Assumes trace > -1 poses (as does
    the reference)."""
    R = np.asarray(R)
    w = np.sqrt(np.maximum(1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], 1e-12)) / 2
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([w, x, y, z], axis=-1)


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = np.asarray(q)
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), dtype=q.dtype)
    R[..., 0, 0] = 1 - 2 * (qj ** 2 + qk ** 2)
    R[..., 0, 1] = 2 * (qj * qi - qk * qr)
    R[..., 0, 2] = 2 * (qi * qk + qr * qj)
    R[..., 1, 0] = 2 * (qj * qi + qk * qr)
    R[..., 1, 1] = 1 - 2 * (qi ** 2 + qk ** 2)
    R[..., 1, 2] = 2 * (qj * qk - qi * qr)
    R[..., 2, 0] = 2 * (qk * qi - qj * qr)
    R[..., 2, 1] = 2 * (qj * qk + qi * qr)
    R[..., 2, 2] = 1 - 2 * (qi ** 2 + qj ** 2)
    return R

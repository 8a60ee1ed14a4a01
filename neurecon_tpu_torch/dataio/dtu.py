"""DTU / IDR-style scenes (port of `neurecon_tpu/dataio/dtu.py`).

cameras.npz holds scale_mat_i / world_mat_i; P = world @ scale decomposes to
intrinsics (divided by `downscale`) and a camera-to-world pose. Images
`image/*` preload to host numpy ([H*W, 3] float32 in [0, 1]), masks `mask/*`
to bool [H*W]. With scale_radius > 0 the cameras are rescaled so that the
farthest one sits at scale_radius / 1.1.
"""
from __future__ import annotations

import os

import numpy as np

from neurecon_tpu_torch.utils.camera import load_K_Rt_from_P, rot_to_quat
from neurecon_tpu_torch.utils.console import log
from neurecon_tpu_torch.utils.io import glob_imgs, load_mask, load_rgb


def scale_intrinsics(intrinsics: np.ndarray, downscale: float) -> np.ndarray:
    """fx, fy, cx, cy divided by `downscale` in the input's precision, as
    float32 (the skew is a ratio: kept)."""
    intrinsics = np.array(intrinsics)
    intrinsics[0, 2] /= downscale
    intrinsics[1, 2] /= downscale
    intrinsics[0, 0] /= downscale
    intrinsics[1, 1] /= downscale
    return intrinsics.astype(np.float32)


def rescale_cameras(c2w_all, cam_center_norms, scale_radius: float) -> None:
    """Scale the camera centres in place so the farthest sits at
    scale_radius / 1.1 (no-op for scale_radius <= 0)."""
    if scale_radius > 0:
        scale = scale_radius / max(cam_center_norms) / 1.1
        for c2w in c2w_all:
            c2w[:3, 3] *= scale


class SceneDataset:
    def __init__(self,
                 data_dir: str,
                 downscale: float = 1.0,
                 cam_file: str = None,
                 scale_radius: float = -1,
                 train_cameras: bool = False):
        if not os.path.exists(data_dir):
            raise FileNotFoundError(f"Data directory is empty: {data_dir}")
        self.instance_dir = data_dir
        self.train_cameras = train_cameras
        self.downscale = downscale

        image_paths = sorted(glob_imgs(os.path.join(data_dir, "image")))
        mask_paths = sorted(glob_imgs(os.path.join(data_dir, "mask")))
        self.n_images = len(image_paths)
        if not self.n_images:
            raise FileNotFoundError(f"no images under {os.path.join(data_dir, 'image')}")

        self.cam_file = os.path.join(data_dir, cam_file or "cameras.npz")
        camera_dict = np.load(self.cam_file)
        scale_mats = [camera_dict[f"scale_mat_{i}"].astype(np.float32)
                      for i in range(self.n_images)]
        world_mats = [camera_dict[f"world_mat_{i}"].astype(np.float32)
                      for i in range(self.n_images)]

        self.intrinsics_all, self.c2w_all = [], []
        cam_center_norms = []
        for scale_mat, world_mat in zip(scale_mats, world_mats):
            P = (world_mat @ scale_mat)[:3, :4]
            intrinsics, pose = load_K_Rt_from_P(P)
            cam_center_norms.append(np.linalg.norm(pose[:3, 3]))
            self.intrinsics_all.append(scale_intrinsics(intrinsics, downscale))
            self.c2w_all.append(pose.astype(np.float32))
        rescale_cameras(self.c2w_all, cam_center_norms, scale_radius)

        log.info(f"DTU: loading {self.n_images} images from {data_dir} ...")
        self.rgb_images = []
        for path in image_paths:
            rgb = load_rgb(path, downscale)
            self.H, self.W = rgb.shape[:2]
            self.rgb_images.append(rgb.reshape(-1, 3))
        self.object_masks = [load_mask(p, downscale).reshape(-1) for p in mask_paths]

        self.intrinsics_all = np.stack(self.intrinsics_all)
        self.c2w_all = np.stack(self.c2w_all)
        self.rgb_images = np.stack(self.rgb_images)
        self.object_masks = np.stack(self.object_masks) if self.object_masks else None

    def __len__(self):
        return self.n_images

    def __getitem__(self, idx):
        sample = {"intrinsics": self.intrinsics_all[idx]}
        if self.object_masks is not None:
            sample["object_mask"] = self.object_masks[idx]
        if not self.train_cameras:
            sample["c2w"] = self.c2w_all[idx]
        ground_truth = {"rgb": self.rgb_images[idx]}
        return idx, sample, ground_truth

    def get_scale_mat(self):
        return np.load(self.cam_file)["scale_mat_0"]

    def get_gt_pose(self, scaled: bool = True):
        camera_dict = np.load(self.cam_file)
        c2w_all = []
        for i in range(self.n_images):
            P = camera_dict[f"world_mat_{i}"].astype(np.float32)
            if scaled:
                P = P @ camera_dict[f"scale_mat_{i}"].astype(np.float32)
            _, pose = load_K_Rt_from_P(P[:3, :4])
            c2w_all.append(pose)
        return np.stack(c2w_all)

    def get_pose_init(self):
        """The linear method's pose initializations (`cameras_linear_init.npz`)
        as [N, 7] rows of (quaternion wxyz, translation): the starting point
        of camera-pose optimization."""
        camera_dict = np.load(os.path.join(self.instance_dir, "cameras_linear_init.npz"))
        init_pose = []
        for i in range(self.n_images):
            P = (camera_dict[f"world_mat_{i}"].astype(np.float32)
                 @ camera_dict[f"scale_mat_{i}"].astype(np.float32))[:3, :4]
            _, pose = load_K_Rt_from_P(P)
            init_pose.append(pose)
        init_pose = np.stack(init_pose)
        init_quat = rot_to_quat(init_pose[:, :3, :3])
        return np.concatenate([init_quat, init_pose[:, :3, 3]], axis=1).astype(np.float32)

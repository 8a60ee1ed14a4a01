"""Custom scenes (port of `neurecon_tpu/dataio/custom.py`): `cam.json` with
a 4x4 `P` per image (and an optional `SCALE`), images under `images/`,
optional object masks under `mask/` and masks of pixels to ignore under
`mask_out/` (`masks_ignore`)."""
from __future__ import annotations

import json
import os

import numpy as np

from neurecon_tpu_torch.dataio.dtu import rescale_cameras, scale_intrinsics
from neurecon_tpu_torch.utils.camera import load_K_Rt_from_P
from neurecon_tpu_torch.utils.console import log
from neurecon_tpu_torch.utils.io import load_mask, load_rgb


def _nonempty_dir(path: str) -> bool:
    return os.path.exists(path) and len(os.listdir(path)) > 0


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

        image_dir = os.path.join(data_dir, "images")
        mask_dir = os.path.join(data_dir, "mask")
        mask_ignore_dir = os.path.join(data_dir, "mask_out")
        self.has_mask = _nonempty_dir(mask_dir)
        self.has_mask_out = _nonempty_dir(mask_ignore_dir)

        self.cam_file = os.path.join(data_dir, cam_file or "cam.json")
        with open(self.cam_file) as f:
            camera_dict = json.load(f)
        self.n_images = len(camera_dict)

        cam_center_norms = []
        self.intrinsics_all, self.c2w_all = [], []
        self.rgb_images, self.object_masks, self.masks_ignore = [], [], []
        log.info(f"custom: loading {self.n_images} images from {data_dir} ...")
        for imgname, v in camera_dict.items():
            P = np.array(v["P"], dtype=np.float32).reshape(4, 4)
            if "SCALE" in v:
                P = P @ np.array(v["SCALE"], dtype=np.float32).reshape(4, 4)
            intrinsics, c2w = load_K_Rt_from_P(P[:3, :4])
            cam_center_norms.append(np.linalg.norm(c2w[:3, 3]))
            self.intrinsics_all.append(scale_intrinsics(intrinsics, downscale))
            self.c2w_all.append(c2w.astype(np.float32))

            rgb = load_rgb(os.path.join(image_dir, imgname), downscale)
            self.H, self.W = rgb.shape[:2]
            self.rgb_images.append(rgb.reshape(-1, 3))

            fname_base = os.path.splitext(imgname)[0]
            if self.has_mask:
                self.object_masks.append(load_mask(
                    os.path.join(mask_dir, f"{fname_base}.png"), downscale).reshape(-1))
            if self.has_mask_out:
                self.masks_ignore.append(load_mask(
                    os.path.join(mask_ignore_dir, f"{fname_base}.png"), downscale).reshape(-1))
        rescale_cameras(self.c2w_all, cam_center_norms, scale_radius)

        self.intrinsics_all = np.stack(self.intrinsics_all)
        self.c2w_all = np.stack(self.c2w_all)
        self.rgb_images = np.stack(self.rgb_images)
        self.object_masks = np.stack(self.object_masks) if self.has_mask else None
        self.masks_ignore = np.stack(self.masks_ignore) if self.has_mask_out else None

    def __len__(self):
        return self.n_images

    def __getitem__(self, idx):
        sample = {"intrinsics": self.intrinsics_all[idx]}
        if self.has_mask:
            sample["object_mask"] = self.object_masks[idx]
        if self.has_mask_out:
            sample["mask_ignore"] = self.masks_ignore[idx]
        if not self.train_cameras:
            sample["c2w"] = self.c2w_all[idx]
        return idx, sample, {"rgb": self.rgb_images[idx]}

    def get_gt_pose(self, scaled: bool = True):
        with open(self.cam_file) as f:
            camera_dict = json.load(f)
        c2w_all = []
        for v in camera_dict.values():
            P = np.array(v["P"], dtype=np.float32).reshape(4, 4)
            if scaled and "SCALE" in v:
                P = P @ np.array(v["SCALE"], dtype=np.float32).reshape(4, 4)
            _, c2w = load_K_Rt_from_P(P[:3, :4])
            c2w_all.append(c2w)
        return np.stack(c2w_all)

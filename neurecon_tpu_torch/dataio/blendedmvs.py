"""BlendedMVS scenes (port of `neurecon_tpu/dataio/blendedmvs.py`): MVSNet
`<name>_cam.txt` extrinsics and intrinsics under `cams_normalized/`, images
under `blended_images/` (files named `masked` skipped); no object masks;
optional global camera rescale."""
from __future__ import annotations

import os

import numpy as np

from neurecon_tpu_torch.dataio.dtu import rescale_cameras, scale_intrinsics
from neurecon_tpu_torch.utils.console import log
from neurecon_tpu_torch.utils.io import glob_imgs, load_rgb


def load_cam(filepath: str, interval_scale: float = 1,
             original_blendedmvs: bool = False) -> np.ndarray:
    """MVSNet camera txt -> [2, 4, 4]: [0] the extrinsic (w2c), [1] the
    intrinsic, whose row 3 holds the depth range (d_min, d_interval, d_num,
    d_max) with `original_blendedmvs`."""
    cam = np.repeat(np.eye(4)[None, ...], repeats=2, axis=0)
    with open(filepath) as f:
        words = f.read().split()
    for i in range(4):
        for j in range(4):
            cam[0][i][j] = words[4 * i + j + 1]
    for i in range(3):
        for j in range(3):
            cam[1][i][j] = words[3 * i + j + 18]
    if original_blendedmvs and len(words) >= 29:
        cam[1][3][0] = words[27]
        cam[1][3][1] = float(words[28]) * interval_scale
        cam[1][3][2] = words[29] if len(words) >= 30 else 128
        cam[1][3][3] = (words[30] if len(words) >= 31 else
                        cam[1][3][0] + cam[1][3][1] * float(cam[1][3][2]))
    return cam


def write_cam(filepath: str, cam: np.ndarray):
    with open(filepath, "w") as f:
        f.write("extrinsic\n")
        for i in range(4):
            f.write(" ".join(str(cam[0][i][j]) for j in range(4)) + " \n")
        f.write("\nintrinsic\n")
        for i in range(3):
            f.write(" ".join(str(cam[1][i][j]) for j in range(3)) + " \n")
        f.write("\n" + " ".join(str(cam[1][3][j]) for j in range(4)) + "\n")


class SceneDataset:
    def __init__(self,
                 data_dir: str,
                 downscale: float = 1.0,
                 scale_radius: float = -1,
                 train_cameras: bool = False):
        if not os.path.exists(data_dir):
            raise FileNotFoundError(f"Data directory is empty: {data_dir}")
        self.instance_dir = data_dir
        self.train_cameras = train_cameras
        self.downscale = downscale

        image_dir = os.path.join(data_dir, "blended_images")
        cam_dir = os.path.join(data_dir, "cams_normalized")

        self.intrinsics_all, self.c2w_all, self.rgb_images = [], [], []
        self.basenames = []
        cam_center_norms = []
        log.info(f"BlendedMVS: loading from {data_dir} ...")
        for imgpath in sorted(glob_imgs(image_dir)):
            if "masked" in imgpath:
                continue
            basename = os.path.splitext(os.path.split(imgpath)[-1])[0]
            self.basenames.append(basename)

            extrinsics, intrinsics = load_cam(os.path.join(cam_dir, f"{basename}_cam.txt"))
            c2w = np.linalg.inv(extrinsics).astype(np.float32)
            cam_center_norms.append(np.linalg.norm(c2w[:3, 3]))
            self.intrinsics_all.append(scale_intrinsics(intrinsics.astype(np.float32), downscale))
            self.c2w_all.append(c2w)

            rgb = load_rgb(imgpath, downscale)
            self.H, self.W = rgb.shape[:2]
            self.rgb_images.append(rgb.reshape(-1, 3))
        if not self.rgb_images:
            raise FileNotFoundError(f"no images under {image_dir}")
        rescale_cameras(self.c2w_all, cam_center_norms, scale_radius)

        self.intrinsics_all = np.stack(self.intrinsics_all)
        self.c2w_all = np.stack(self.c2w_all)
        self.rgb_images = np.stack(self.rgb_images)
        self.object_masks = None
        self.n_images = len(self.rgb_images)

    def __len__(self):
        return self.n_images

    def __getitem__(self, idx):
        sample = {"intrinsics": self.intrinsics_all[idx]}
        if not self.train_cameras:
            sample["c2w"] = self.c2w_all[idx]
        return idx, sample, {"rgb": self.rgb_images[idx]}

    def get_gt_pose(self):
        return self.c2w_all

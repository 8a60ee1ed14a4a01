"""Experiment logger (port of `neurecon_tpu/utils/logger.py`): scalars into an
in-memory stats dict, pickled to `stats.p_<rank>`, and images as PNGs.

TensorBoard (`torch.utils.tensorboard`) and `imageio` are imported only when
used, and a missing one does not stop training: without TensorBoard the
logger writes files only, and without imageio an image is saved as a `.npy`
array instead of a PNG.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from neurecon_tpu_torch.utils.console import log


class Logger:
    def __init__(self, log_dir: str, img_dir: Optional[str] = None,
                 monitoring: Optional[str] = None,
                 monitoring_dir: Optional[str] = None, rank: int = 0):
        self.stats = {}
        self.log_dir = log_dir
        self.img_dir = img_dir or os.path.join(log_dir, "imgs")
        self.rank = rank
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.img_dir, exist_ok=True)
        self.tb = None
        if monitoring == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                log.warning(f"tensorboard unavailable ({e}); file-only logging")
            else:
                tb_dir = monitoring_dir or os.path.join(log_dir, "events")
                os.makedirs(tb_dir, exist_ok=True)
                self.tb = SummaryWriter(tb_dir)

    def add(self, category: str, k: str, v, it: int):
        v = float(v)
        self.stats.setdefault(category, {}).setdefault(k, []).append((it, v))
        if self.tb is not None:
            self.tb.add_scalar(f"{category}/{k}", v, it)

    def add_module_param(self, module_name: str, module, it: int):
        """TensorBoard histograms of every parameter of `module`."""
        if self.tb is None:
            return
        for name, p in module.named_parameters():
            self.tb.add_histogram(f"{module_name}/{name}",
                                  p.detach().cpu().numpy().ravel(), it)

    def add_imgs(self, imgs: np.ndarray, class_name: str, it: int):
        """imgs: [B, H, W, C] or [H, W, C] float in [0, 1], HWC."""
        imgs = np.asarray(imgs)
        if imgs.ndim == 3:
            imgs = imgs[None]
        if imgs.shape[-1] == 1:
            imgs = np.repeat(imgs, 3, -1)
        grid = _make_grid(np.clip(imgs, 0.0, 1.0))
        outdir = os.path.join(self.img_dir, class_name)
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{it:08d}_{self.rank}")
        try:
            import imageio.v2 as imageio
        except ImportError:
            np.save(path + ".npy", grid.astype(np.float32))
        else:
            imageio.imwrite(path + ".png", (grid * 255).astype(np.uint8))
        if self.tb is not None:
            self.tb.add_image(class_name, grid, it, dataformats="HWC")

    def _stats_path(self, filename: str) -> str:
        return os.path.join(self.log_dir, f"{filename}_{self.rank}")

    def save_stats(self, filename: str = "stats.p"):
        with open(self._stats_path(filename), "wb") as f:
            pickle.dump(self.stats, f)

    def load_stats(self, filename: str = "stats.p"):
        path = self._stats_path(filename)
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    self.stats = pickle.load(f)
                log.info(f"Logger: loaded stats from {path}")
            except EOFError:
                log.warning(f"Logger: corrupt stats file {path}, starting fresh")


def _make_grid(imgs: np.ndarray) -> np.ndarray:
    """[B, H, W, C] -> one [gh*H, gw*W, C] gallery image."""
    B, H, W, C = imgs.shape
    gw = int(np.ceil(np.sqrt(B)))
    gh = int(np.ceil(B / gw))
    grid = np.zeros((gh * H, gw * W, C), imgs.dtype)
    for i in range(B):
        r, c = divmod(i, gw)
        grid[r * H:(r + 1) * H, c * W:(c + 1) * W] = imgs[i]
    return grid

"""Experiment logger (port of `neurecon_tpu/utils/logger.py`): scalars into an
in-memory stats dict, pickled to `stats.p_<rank>`, and images as PNGs.

TensorBoard (`torch.utils.tensorboard`) and `imageio` are imported only when
used, and a missing one does not stop training: without TensorBoard the
logger writes files only, and without imageio an image is saved as a `.npy`
array instead of a PNG. With `writes=False` (the ranks other than 0 of a run
over several ranks) it keeps its stats in memory and writes nothing.
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
                 monitoring_dir: Optional[str] = None, rank: int = 0,
                 writes: bool = True):
        self.stats = {}
        self.log_dir = log_dir
        self.img_dir = img_dir or os.path.join(log_dir, "imgs")
        self.rank = rank
        self.writes = writes
        self.tb = None
        if not writes:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        os.makedirs(self.img_dir, exist_ok=True)
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
        if not self.writes:
            return
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

    def add_figure(self, fig, class_name: str, it: int):
        """A matplotlib figure as an RGB image (a PNG, or a `.npy` array of
        uint8 without imageio, as `add_imgs`), then closed. matplotlib is
        imported here only."""
        import matplotlib.pyplot as plt

        if self.writes:
            fig.canvas.draw()
            w, h = fig.canvas.get_width_height()
            img = np.frombuffer(fig.canvas.buffer_rgba(), np.uint8).reshape(h, w, 4)[..., :3]
            outdir = os.path.join(self.img_dir, class_name)
            os.makedirs(outdir, exist_ok=True)
            path = os.path.join(outdir, f"{it:08d}_{self.rank}")
            try:
                import imageio.v2 as imageio
            except ImportError:
                np.save(path + ".npy", np.ascontiguousarray(img))
            else:
                imageio.imwrite(path + ".png", img)
            if self.tb is not None:
                self.tb.add_image(class_name, img, it, dataformats="HWC")
        plt.close(fig)

    def _stats_path(self, filename: str) -> str:
        return os.path.join(self.log_dir, f"{filename}_{self.rank}")

    def save_stats(self, filename: str = "stats.p"):
        if not self.writes:
            return
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

"""File helpers (port of part of `neurecon_tpu/utils/io.py`). `imageio` is
imported only when a video is written."""
from __future__ import annotations

import os
import shutil

import numpy as np

from neurecon_tpu_torch.utils.console import log


def cond_mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def backup(backup_dir: str, source_root: str = None):
    """Copy the package's .py sources into `backup_dir` (the experiment's
    record of the code it ran)."""
    if source_root is None:
        source_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cond_mkdir(backup_dir)
    for dirpath, dirnames, filenames in os.walk(source_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        rel = os.path.relpath(dirpath, source_root)
        for fname in filenames:
            if fname.endswith(".py"):
                dst_dir = os.path.join(backup_dir, rel)
                cond_mkdir(dst_dir)
                shutil.copyfile(os.path.join(dirpath, fname),
                                os.path.join(dst_dir, fname))


def save_video(imgs: np.ndarray, fname: str, fps: int = 24, quality: int = 8):
    """imgs: [N, H, W, 3] float in [0, 1] or uint8 -> mp4; an animated GIF at
    the same basename where no mp4 backend is installed."""
    import imageio.v2 as imageio

    imgs = np.asarray(imgs)
    if imgs.dtype != np.uint8:
        imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    try:
        imageio.mimwrite(fname, imgs, fps=fps, quality=quality)
    except Exception:  # no ffmpeg plugin: imageio raises various types
        gif_path = os.path.splitext(fname)[0] + ".gif"
        imageio.mimwrite(gif_path, imgs, duration=1000.0 / fps, loop=0)
        log.warning(f"no mp4 backend; wrote {gif_path} instead")
        fname = gif_path
    return fname

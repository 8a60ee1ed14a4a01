"""File and image helpers (port of `neurecon_tpu/utils/io.py`).

Images load as float32 in [0, 1], HWC. Two decoders read the same bytes:
`imageio` where it can be imported (as the JAX package reads them), else the
port's own PNG reader (`read_png`, zlib + struct + numpy), so that a machine
without imageio still reads PNG scenes; a JPEG there raises. The reader gives
the array imageio gives for the same file, so both routes load the same
scene. Downscaling is always `area_resize`, a numpy implementation of
OpenCV's `INTER_AREA`, so no route needs cv2.
"""
from __future__ import annotations

import contextlib
import functools
import glob
import os
import shutil
import struct
import zlib
from typing import List

import numpy as np

from neurecon_tpu_torch.utils.console import log

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def cond_mkdir(path: str):
    os.makedirs(path, exist_ok=True)


def glob_imgs(path: str) -> List[str]:
    imgs = []
    for ext in ["*.png", "*.jpg", "*.JPEG", "*.JPG"]:
        imgs.extend(glob.glob(os.path.join(path, ext)))
    return imgs


def _unfilter_rows(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters on raw [H, W, bpp] bytes (filters [H]);
    'a' is the pixel to the left, 'b' the one above, 'c' above-left, bytewise
    mod 256. Images of None / Sub / Up rows go row by row, each row in one
    operation. Average and Paeth read the reconstructed left neighbour, so
    such images go by anti-diagonals: pixel (r, x) needs (r, x-1), (r-1, x)
    and (r-1, x-1), all on the two diagonals before it, and each diagonal is
    one vectorised step over the rows it crosses (H + W - 1 steps)."""
    H, W, bpp = raw.shape
    if filters.max(initial=0) <= 2:
        out = np.empty_like(raw)
        prior = np.zeros((W, bpp), np.uint8)
        for r in range(H):
            row, f = raw[r], filters[r]
            if f == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)
            elif f == 2:
                row = row + prior
            out[r] = prior = row
        return out

    # pixel (r, x) of the reconstruction sits at recon[x + r + 1, r + 1]:
    # diagonal d = x + r + 1 is one contiguous slice, and index 0 on either
    # axis is the zero border (the left neighbour of x = 0, the prior of r = 0)
    d_idx = np.arange(W)[None, :] + np.arange(H)[:, None] + 1
    r_idx = np.broadcast_to(np.arange(H)[:, None] + 1, (H, W))
    raw_d = np.zeros((W + H + 1, H + 1, bpp), np.int16)
    raw_d[d_idx, r_idx] = raw
    recon = np.zeros_like(raw_d)
    ft = np.zeros(H + 1, np.int16)
    ft[1:] = filters
    ft = ft[:, None]
    for d in range(1, W + H):
        r0, r1 = max(1, d - W + 1), min(H, d) + 1  # rows (1-based) on diagonal d
        a = recon[d - 1, r0:r1]
        b = recon[d - 1, r0 - 1:r1 - 1]
        c = recon[d - 2, r0 - 1:r1 - 1]
        f = ft[r0:r1]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(f == 4, paeth, np.where(f == 3, (a + b) >> 1,
                                                np.where(f == 2, b, np.where(f == 1, a, 0))))
        recon[d, r0:r1] = (raw_d[d, r0:r1] + pred) & 0xFF
    return recon[d_idx, r_idx].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file to the array imageio (through Pillow) gives, so that
    both routes load the same data: [H, W] grey (uint8, or uint16 at 16
    bits), [H, W, 2] grey + alpha, [H, W, 3] RGB, [H, W, 4] RGBA, a palette
    image as RGB (a tRNS chunk is dropped). At 16 bits Pillow keeps only the
    high byte of a colour or alpha sample (uint8), and gives grey + alpha as
    RGBA. Bit depths 8 and 16, colour types 0, 2, 3, 4 and 6; an interlaced
    file raises ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif ctype == b"PLTE":
            palette = np.frombuffer(chunk, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(chunk)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, ctype, _compression, _filter, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported by the port's PNG reader")
    if depth not in (8, 16) or ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG bit depth {depth} / colour type {ctype} is not "
                         "supported by the port's PNG reader (8 or 16 bits; types 0, 2, "
                         "3, 4, 6)")
    if ctype == 3 and (depth != 8 or palette is None):
        raise ValueError(f"{path}: palette PNG needs 8 bits and a PLTE chunk")
    C, nbytes = _PNG_CHANNELS[ctype], depth // 8
    bpp = C * nbytes
    stream = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if stream.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {stream.size} bytes of image data, want {H * (1 + W * bpp)}")
    stream = stream.reshape(H, 1 + W * bpp)
    filters = stream[:, 0]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    px = _unfilter_rows(stream[:, 1:].reshape(H, W, bpp), filters)
    if ctype == 3:
        return palette[px[..., 0]]
    if nbytes == 1:
        return px[..., 0] if C == 1 else px
    px = px.reshape(H, W, C, 2)
    if C == 1:
        return (px[..., 0, 0].astype(np.uint16) << 8) | px[..., 0, 1]
    high = px[..., 0]
    if C == 2:
        return high[..., [0, 0, 0, 1]]
    return high


@functools.lru_cache(maxsize=None)
def _imageio():
    """imageio's v2 API, or None where it is not installed; logs the decoder
    the process takes, once."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        log.info("images: imageio is not installed; PNG files are read by the port's "
                 "PNG reader (utils/io.py::read_png)")
        return None
    log.info("images: read through imageio")
    return imageio


_decoded = None  # path -> decoded array while `decode_once` is open


@contextlib.contextmanager
def decode_once():
    """Within the block `imread` decodes each file once and hands out the
    same read-only array again (a scene and its val_downscale copy read the
    same files)."""
    global _decoded
    outer = _decoded
    if outer is None:
        _decoded = {}
    try:
        yield
    finally:
        _decoded = outer


def _decode(path: str) -> np.ndarray:
    imageio = _imageio()
    if imageio is not None:
        return np.asarray(imageio.imread(path))
    if os.path.splitext(path)[1].lower() != ".png":
        raise ImportError(f"{path}: imageio is needed to read JPEG and other non-PNG "
                          "images; without it only PNG is read")
    return read_png(path)


def imread(path: str) -> np.ndarray:
    """An image file as imageio gives it (uint8 / uint16 array)."""
    if _decoded is None:
        return _decode(path)
    key = os.path.abspath(path)
    if key not in _decoded:
        img = _decode(path)
        img.setflags(write=False)
        _decoded[key] = img
    return _decoded[key]


def _area_taps(ssize: int, dsize: int):
    """OpenCV's INTER_AREA table for one axis (`computeResizeAreaTab`):
    (output index, source index, float32 weight) per tap, in OpenCV's order."""
    scale = 1.0 / (dsize / ssize)
    di, si, w = [], [], []
    for d in range(dsize):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, ssize - fs1)
        s1, s2 = int(np.ceil(fs1)), int(np.floor(fs2))
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            di.append(d), si.append(s1 - 1), w.append((s1 - fs1) / cell)
        for s in range(s1, s2):
            di.append(d), si.append(s), w.append(1.0 / cell)
        if fs2 - s2 > 1e-3:
            di.append(d), si.append(s2), w.append(min(min(fs2 - s2, 1.0), cell) / cell)
    return np.asarray(di), np.asarray(si), np.asarray(w, np.float32)


def _area_axis(img: np.ndarray, dsize: int, axis: int) -> np.ndarray:
    """Resample `axis` of float32 `img` by the INTER_AREA taps, the taps of
    each output summed in OpenCV's order in float32."""
    di, si, w = _area_taps(img.shape[axis], dsize)
    x = np.moveaxis(img, axis, 0)
    out = np.zeros((dsize,) + x.shape[1:], np.float32)
    first = np.searchsorted(di, np.arange(dsize))
    nth = np.arange(len(di)) - first[di]  # position of each tap within its output
    extra = (1,) * (x.ndim - 1)
    for j in range(int(nth.max()) + 1):
        sel = nth == j
        out[di[sel]] += x[si[sel]] * w[sel].reshape(-1, *extra)
    return np.moveaxis(out, 0, axis)


def area_resize(img: np.ndarray, downscale: float) -> np.ndarray:
    """`cv2.resize(img, (int(W / downscale), int(H / downscale)),
    interpolation=cv2.INTER_AREA)` for float32 [H, W] or [H, W, C] and
    downscale >= 1: each output pixel is the mean of its source block where
    the sizes divide (OpenCV's fast path), else the overlap-weighted mean."""
    if downscale < 1:
        raise ValueError(f"area_resize shrinks images only; downscale {downscale} < 1")
    img = np.asarray(img, np.float32)
    H, W = img.shape[:2]
    dh, dw = int(H / downscale), int(W / downscale)
    sx, sy = 1.0 / (dw / W), 1.0 / (dh / H)
    ix, iy = int(round(sx)), int(round(sy))
    if abs(sx - ix) < np.finfo(np.float64).eps and abs(sy - iy) < np.finfo(np.float64).eps:
        blocks = img[:dh * iy, :dw * ix].reshape(dh, iy, dw, ix, *img.shape[2:])
        total = np.zeros((dh, dw) + img.shape[2:], np.float32)
        for r in range(iy):  # row-major over the block, as OpenCV sums it
            for c in range(ix):
                total += blocks[:, r, :, c]
        return total * np.float32(1.0 / (ix * iy))
    # rows first: OpenCV resamples each source row across, then sums rows
    return _area_axis(_area_axis(img, dw, 1), dh, 0)


def load_rgb(path: str, downscale: float = 1) -> np.ndarray:
    """-> float32 [H, W, 3] in [0, 1]."""
    img = imread(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    elif img.dtype == np.uint16:
        img = img.astype(np.float32) / 65535.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    img = img[..., :3]
    if downscale != 1:
        img = area_resize(img, downscale)
    return img


def load_mask(path: str, downscale: float = 1) -> np.ndarray:
    """-> bool [H, W]: the mean of the first 3 channels (scaled to 255 when
    at most 1), area-resized, above 127.5."""
    alpha = imread(path)
    if alpha.ndim == 3:
        alpha = alpha[..., :3].mean(-1)
    alpha = alpha.astype(np.float32)
    if alpha.max() <= 1.0:
        alpha = alpha * 255.0
    if downscale != 1:
        alpha = area_resize(alpha, downscale)
    return alpha > 127.5


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

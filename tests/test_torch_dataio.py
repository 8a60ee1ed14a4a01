"""The port's file loaders against the JAX package's, on the CPU: the same
scene files in the DTU, BlendedMVS and custom layouts (written by
`chip_smoke.write_scene`) through both `get_data`s at downscale 1, 2 and 1.5;
the loaders' pose helpers; the port's PNG reader against imageio on every
colour type, bit depth and row filter; the area resize against OpenCV's
INTER_AREA; the route without imageio; and `get_data`'s dispatch."""
import os
import struct
import sys
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data

import chip_smoke
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.dataio import get_data
from neurecon_tpu_torch.utils import io as io_util

LAYOUTS = ("DTU", "BlendedMVS", "custom")
N_VIEWS, H, W = 3, 30, 40


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The synthetic sphere scene in each layout; the DTU one also has a
    `cameras_linear_init.npz` (its cameras, moved a little)."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for layout in LAYOUTS:
        d = str(root / layout)
        out[layout] = (d, chip_smoke.write_scene(d, layout, N_VIEWS, H, W))
    cams = dict(np.load(os.path.join(out["DTU"][0], "cameras.npz")))
    rng = np.random.RandomState(0)
    noisy = {k: v + (rng.randn(*v.shape) * 1e-2 if k.startswith("world") else 0)
             for k, v in cams.items()}
    np.savez(os.path.join(out["DTU"][0], "cameras_linear_init.npz"), **noisy)
    return out


def _both(cfg):
    return jax_get_data(JaxConfigDict(cfg)), get_data(ConfigDict(cfg))


@pytest.mark.parametrize("downscale", [1, 2, 1.5])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_loader_matches_jax(scenes, layout, downscale):
    """Every array of the port's SceneDataset equals the JAX loader's on the
    same files: rgb within 1e-6, masks equal, intrinsics and c2w within 1e-6;
    and __getitem__ gives the same sample."""
    root, _ = scenes[layout]
    want, got = _both({"data": {"type": layout, "data_dir": root, "downscale": downscale}})
    assert (got.H, got.W, len(got)) == (want.H, want.W, len(want)) == (
        int(H / downscale), int(W / downscale), N_VIEWS)
    np.testing.assert_allclose(got.rgb_images, want.rgb_images, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.intrinsics_all, want.intrinsics_all, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.c2w_all, want.c2w_all, rtol=0, atol=1e-6)
    for name in ("object_masks", "masks_ignore"):
        a, b = getattr(want, name, None), getattr(got, name, None)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.any() and np.array_equal(a, b), name
    for i in range(N_VIEWS):
        (ia, sa, ga), (ib, sb, gb) = want[i], got[i]
        assert ia == ib and set(sa) == set(sb)
        for k in sa:
            np.testing.assert_allclose(np.asarray(sb[k], np.float64),
                                       np.asarray(sa[k], np.float64), rtol=0, atol=1e-6)
        np.testing.assert_allclose(gb["rgb"], ga["rgb"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_loader_options_and_poses_match_jax(scenes, layout):
    """scale_radius and train_cameras as the JAX loaders take them, and the
    pose helpers: get_gt_pose (scaled and not), get_scale_mat and
    get_pose_init (DTU)."""
    root, _ = scenes[layout]
    cfg = {"data": {"type": layout, "data_dir": root, "downscale": 1, "scale_radius": 2.0}}
    want, got = _both(cfg)
    np.testing.assert_allclose(got.c2w_all, want.c2w_all, rtol=0, atol=1e-6)
    norms = np.linalg.norm(got.c2w_all[:, :3, 3], axis=-1)
    assert abs(norms.max() - 2.0 / 1.1) < 1e-5
    kw = {"train_cameras": True}
    if layout == "DTU":
        from neurecon_tpu.dataio.dtu import SceneDataset as J
        from neurecon_tpu_torch.dataio.dtu import SceneDataset as T
    elif layout == "BlendedMVS":
        from neurecon_tpu.dataio.blendedmvs import SceneDataset as J
        from neurecon_tpu_torch.dataio.blendedmvs import SceneDataset as T
    else:
        from neurecon_tpu.dataio.custom import SceneDataset as J
        from neurecon_tpu_torch.dataio.custom import SceneDataset as T
    a, b = J(root, **kw), T(root, **kw)
    assert "c2w" not in b[0][1] and set(a[0][1]) == set(b[0][1])
    if layout == "BlendedMVS":
        np.testing.assert_allclose(b.get_gt_pose(), a.get_gt_pose(), rtol=0, atol=1e-6)
        return
    for scaled in (True, False):
        np.testing.assert_allclose(b.get_gt_pose(scaled=scaled), a.get_gt_pose(scaled=scaled),
                                   rtol=0, atol=1e-6)
    if layout == "DTU":
        np.testing.assert_array_equal(b.get_scale_mat(), a.get_scale_mat())
        np.testing.assert_allclose(b.get_pose_init(), a.get_pose_init(), rtol=0, atol=1e-6)


def test_blendedmvs_cam_round_trip(tmp_path):
    """write_cam / load_cam as the JAX package's, with the depth-range row of
    `original_blendedmvs`."""
    from neurecon_tpu.dataio.blendedmvs import load_cam as jax_load_cam
    from neurecon_tpu_torch.dataio.blendedmvs import load_cam, write_cam
    cam = np.zeros((2, 4, 4))
    cam[0] = np.linalg.qr(np.random.RandomState(1).randn(4, 4))[0]
    cam[1][:3, :3] = [[500.0, 0, 200], [0, 500, 150], [0, 0, 1]]
    cam[1][3] = (0.5, 0.01, 256, 3.06)
    path = str(tmp_path / "c_cam.txt")
    write_cam(path, cam)
    for orig in (False, True):
        np.testing.assert_array_equal(load_cam(path, 2.0, orig), jax_load_cam(path, 2.0, orig))
    np.testing.assert_allclose(load_cam(path, 1.0, True), cam)


def _png_cases():
    cases = []
    for shape in [(13, 17), (13, 17, 2), (13, 17, 3), (13, 17, 4)]:
        for dtype in (np.uint8, np.uint16):
            cases.append((shape, dtype))
    return cases


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)])
@pytest.mark.parametrize("shape,dtype", _png_cases())
def test_png_reader_matches_imageio(tmp_path, shape, dtype, filters):
    """The port's PNG reader gives imageio's array (dtype and values) for
    colour types 0, 4, 2 and 6 at 8 and 16 bits, under each row filter and
    all five cycled over the rows."""
    rng = np.random.RandomState(len(shape) * 10 + len(filters))
    img = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    path = str(tmp_path / "t.png")
    chip_smoke.write_png(path, img, filters)
    got, want = io_util.read_png(path), imageio.imread(path)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if dtype == np.uint8 or img.ndim == 2:  # lossless where Pillow keeps the bits
        assert np.array_equal(got, img)


@pytest.mark.parametrize("trns", [False, True])
def test_png_reader_palette_and_imageio_written(tmp_path, trns):
    """A palette PNG (colour type 3, with and without tRNS) and files written
    by imageio itself (Pillow's own filter choice) read as imageio reads them."""
    rng = np.random.RandomState(2)
    palette = rng.randint(0, 256, (20, 3)).astype(np.uint8)
    idx = rng.randint(0, 20, (11, 9)).astype(np.uint8)
    path = str(tmp_path / "p.png")
    chip_smoke.write_png(path, idx, palette=palette,
                         trns=rng.randint(0, 256, 12).astype(np.uint8) if trns else None)
    assert np.array_equal(io_util.read_png(path), imageio.imread(path))
    for img in (rng.randint(0, 256, (40, 60, 3)).astype(np.uint8),
                rng.randint(0, 65536, (40, 60)).astype(np.uint16),
                np.tile(np.arange(60, dtype=np.uint8), (40, 1))):
        imageio.imwrite(path, img)
        assert np.array_equal(io_util.read_png(path), img)


@pytest.mark.parametrize("factor", [2, 4, 8, 10, 1.5, 3.7])
def test_area_resize_matches_cv2(factor):
    """area_resize against cv2.resize(INTER_AREA) at the size the loaders ask
    for, on RGB and single-channel float32 images: within 1e-5."""
    rng = np.random.RandomState(3)
    for img in (rng.rand(120, 160, 3).astype(np.float32),
                (rng.rand(120, 160) > 0.5).astype(np.float32) * 255):
        want = cv2.resize(img, (int(160 / factor), int(120 / factor)),
                          interpolation=cv2.INTER_AREA)
        got = io_util.area_resize(img, factor)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, float(img.max())))


def test_loading_without_imageio(tmp_path, monkeypatch):
    """Where imageio cannot be imported, load_rgb and load_mask read PNGs
    through the port's reader to the same arrays; a JPEG raises ImportError
    and an interlaced PNG a ValueError naming the file."""
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    mask = (rng.rand(24, 32) > 0.5).astype(np.uint8) * 255
    p_rgb, p_mask, p_jpg = (str(tmp_path / n) for n in ("a.png", "m.png", "a.jpg"))
    chip_smoke.write_png(p_rgb, rgb)
    chip_smoke.write_png(p_mask, mask)
    imageio.imwrite(p_jpg, rgb)
    want = [(io_util.load_rgb(p_rgb, ds), io_util.load_mask(p_mask, ds)) for ds in (1, 1.5)]
    io_util._imageio.cache_clear()
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    try:
        assert io_util._imageio() is None
        for ds, (w_rgb, w_mask) in zip((1, 1.5), want):
            np.testing.assert_array_equal(io_util.load_rgb(p_rgb, ds), w_rgb)
            np.testing.assert_array_equal(io_util.load_mask(p_mask, ds), w_mask)
        with pytest.raises(ImportError, match="imageio is needed to read JPEG"):
            io_util.load_rgb(p_jpg)
        with open(p_rgb, "rb") as f:
            data = bytearray(f.read())
        ihdr = bytes(data[12:29])[:-1] + b"\x01"  # the IHDR type and data, interlaced
        data[12:33] = ihdr + struct.pack(">I", zlib.crc32(ihdr) & 0xFFFFFFFF)
        p_inter = str(tmp_path / "interlaced.png")
        with open(p_inter, "wb") as f:
            f.write(bytes(data))
        with pytest.raises(ValueError, match="interlaced.png: interlaced"):
            io_util.load_rgb(p_inter)
    finally:
        io_util._imageio.cache_clear()


def test_get_data_dispatch(scenes):
    """DTU by default, BlendedMVS by either name, custom, synthetic; an
    unknown type raises; return_val gives the scene at val_downscale."""
    from neurecon_tpu_torch.dataio import blendedmvs, custom, dtu, synthetic
    for cfg, cls in (({"data_dir": scenes["DTU"][0]}, dtu.SceneDataset),
                     ({"type": "BlendedMVS", "data_dir": scenes["BlendedMVS"][0]},
                      blendedmvs.SceneDataset),
                     ({"type": "blended_mvs", "data_dir": scenes["BlendedMVS"][0]},
                      blendedmvs.SceneDataset),
                     ({"type": "custom", "data_dir": scenes["custom"][0]}, custom.SceneDataset),
                     ({"type": "synthetic", "n_images": 2, "H": 12, "W": 16},
                      synthetic.SceneDataset)):
        ds, val = get_data(ConfigDict({"data": dict(cfg, downscale=1)}), return_val=True,
                           val_downscale=2)
        assert type(ds) is cls and type(val) is cls and (val.H, val.W) == (ds.H // 2, ds.W // 2)
    with pytest.raises(NotImplementedError):
        get_data(ConfigDict({"data": {"type": "nope", "downscale": 1}}))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_get_data_return_val_decodes_once(scenes, layout, monkeypatch):
    """get_data(return_val=True) decodes each image and mask file once, and
    its two datasets equal two separate loads at downscale 1 and 1.5."""
    root, _ = scenes[layout]
    cfg = {"data": {"type": layout, "data_dir": root, "downscale": 1}}
    want = [get_data(ConfigDict(dict(cfg, data=dict(cfg["data"], downscale=ds))))
            for ds in (1, 1.5)]
    decoded = []
    real = io_util._decode
    monkeypatch.setattr(io_util, "_decode", lambda p: decoded.append(p) or real(p))
    got = get_data(ConfigDict(cfg), return_val=True, val_downscale=1.5)
    assert len(decoded) == len(set(decoded)) > 0
    assert io_util._decoded is None  # the memo closes with get_data
    for g, w in zip(got, want):
        for name in ("rgb_images", "object_masks", "masks_ignore", "intrinsics_all", "c2w_all"):
            a, b = getattr(g, name, None), getattr(w, name, None)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=name)

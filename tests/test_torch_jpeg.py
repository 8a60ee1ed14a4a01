"""The port's baseline JPEG decoder (`utils/jpeg.py`) on the CPU: against
Pillow and against the JAX package's `load_rgb` (imageio) on files Pillow
writes here (quality 75 and 95; 4:4:4, 4:2:2 and 4:2:0; grey; optimised
Huffman tables; restart markers; odd sizes; an EXIF orientation tag) and
on a 4:4:0 file of `chip_smoke.write_jpeg`, which Pillow cannot write; the
refusals; `write_jpeg`'s tables and output; and the DTU, BlendedMVS and
custom loaders on JPEG scenes against the JAX loaders, and chip_smoke.py's
two *_blended configs against the files. The port's route is
forced by making `utils/io.py::_imageio` return None, as on a machine
without imageio."""
import os
import sys

import numpy as np
import pytest
import yaml
from PIL import Image

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.utils import io as jax_io

import chip_smoke
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.dataio import get_data
from neurecon_tpu_torch.utils import io as io_util
from neurecon_tpu_torch.utils import jpeg

# islow IDCT, fancy upsampling and the fixed-point colour tables as
# libjpeg-turbo computes them: every sample of every file here is equal to
# Pillow's (measured share 1.0; the gate allows 1 of 255)
EQUAL_SHARE = 1.0


def _image(H, W, grey=False, seed=0):
    """A smooth colour field with noise and a hard-edged patch (edges for
    the chroma filters to meet)."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:H, 0:W] / max(H, W)
    img = np.stack([np.sin(6 * x + 3 * y + k) * 0.4 + 0.5 for k in range(3)], -1)
    img = img + rng.normal(0, 0.05, img.shape)
    img[H // 3:H // 2, W // 4:W // 2] = (0.9, 0.1, 0.2)
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img[..., 1] if grey else img


@pytest.fixture
def port_route(monkeypatch):
    """Images decode through the port's readers, as where imageio is absent."""
    monkeypatch.setattr(io_util, "_imageio", lambda: None)


def _check(path):
    """The port's decode against Pillow's and the JAX load_rgb: max|diff| <= 1
    of 255 and the share of equal samples at EQUAL_SHARE."""
    ref = np.asarray(Image.open(path))
    got = io_util.imread(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref)
    assert diff.max() <= 1 and (diff == 0).mean() >= EQUAL_SHARE
    np.testing.assert_allclose(io_util.load_rgb(path), jax_io.load_rgb(path), rtol=0,
                               atol=1.0 / 255 + 1e-7)


PILLOW_CASES = [((H, W), {"quality": q, "subsampling": ss})
                for (H, W) in ((37, 53), (100, 75)) for q in (75, 95) for ss in (0, 1, 2)]
PILLOW_CASES += [((64, 48), {"quality": 90, "optimize": True}),
                 ((100, 75), {"quality": 90, "restart_marker_blocks": 3}),
                 ((100, 75), {"quality": 85, "restart_marker_rows": 1, "subsampling": 1}),
                 ((23, 9), {"quality": 95, "subsampling": 2})]


@pytest.mark.parametrize("shape,kw", PILLOW_CASES,
                         ids=[f"{s[0]}x{s[1]}-" + "-".join(f"{k}{v}" for k, v in kw.items())
                              for s, kw in PILLOW_CASES])
def test_pillow_files(tmp_path, port_route, shape, kw):
    path = str(tmp_path / "a.jpg")
    Image.fromarray(_image(*shape)).save(path, **kw)
    _check(path)


def test_grey_and_exif_orientation(tmp_path, port_route):
    """A grey file reads as [H, W]; a file tagged EXIF orientation 6 reads
    unrotated, as imageio v2 returns it."""
    p_grey, p_exif = str(tmp_path / "g.JPG"), str(tmp_path / "o.jpeg")
    Image.fromarray(_image(45, 61, grey=True)).save(p_grey, quality=92)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(_image(40, 70)).save(p_exif, quality=90, exif=exif.tobytes())
    assert io_util.imread(p_grey).shape == (45, 61)
    assert io_util.imread(p_exif).shape == (40, 70, 3)
    for p in (p_grey, p_exif):
        _check(p)


@pytest.mark.parametrize("subsampling,restart", [("4:4:0", 0), ("4:4:0", 2), ("4:2:0", 5),
                                                  ("4:4:4", 0)])
def test_write_jpeg_read_by_pillow(tmp_path, port_route, subsampling, restart):
    """`chip_smoke.write_jpeg` writes files Pillow reads (4:4:0 among them,
    which Pillow cannot write), and the port's decode of them is within 1
    of Pillow's."""
    img = _image(50, 67, seed=1)
    path = str(tmp_path / "w.jpg")
    chip_smoke.write_jpeg(path, img, quality=95, subsampling=subsampling, restart=restart)
    _check(path)


def test_write_jpeg_tables_are_pillows(tmp_path):
    """write_jpeg's quantisation tables (scaled by quality as libjpeg scales
    them) and its Huffman tables are the ones Pillow (libjpeg) writes."""
    for q in (50, 75, 95):
        path = str(tmp_path / f"q{q}.jpg")
        Image.fromarray(_image(16, 16)).save(path, quality=q)
        with open(path, "rb") as f:
            fr, _, _ = jpeg._parse_header(f.read(), path)
        scale = 200 - 2 * q
        for t in (0, 1):
            want = np.clip((chip_smoke._JPEG_QT[t] * scale + 50) // 100, 1, 255)
            np.testing.assert_array_equal(fr.qt[t], want)
            assert fr.dc[t] == jpeg._huffman_lut(*chip_smoke._JPEG_DC[t])
            assert fr.ac[t] == jpeg._huffman_lut(*chip_smoke._JPEG_AC[t])


def test_refusals_name_the_file(tmp_path, port_route):
    """Progressive and CMYK files raise a ValueError that names the file and
    the reason; so do a truncated header and a non-JPEG."""
    p_prog, p_cmyk, p_bad = (str(tmp_path / n) for n in ("prog.jpg", "cmyk.jpg", "bad.jpg"))
    Image.fromarray(_image(32, 32)).save(p_prog, quality=90, progressive=True)
    Image.fromarray(_image(32, 32)).convert("CMYK").save(p_cmyk, quality=90)
    with open(p_bad, "wb") as f:
        f.write(b"\x89PNG not a jpeg")
    with pytest.raises(ValueError, match=r"prog\.jpg: SOF2 \(progressive\)"):
        io_util.imread(p_prog)
    with pytest.raises(ValueError, match=r"cmyk\.jpg: JPEG with 4 components"):
        io_util.imread(p_cmyk)
    with pytest.raises(ValueError, match=r"bad\.jpg: not a JPEG"):
        io_util.imread(p_bad)
    with open(p_prog, "rb") as f:
        head = f.read(200)
    with pytest.raises(ValueError, match="cut.jpg"):
        jpeg.decode_jpeg(head[:30], "cut.jpg")


def test_idct_matches_float_idct():
    """The islow IDCT of random blocks against a float64 IDCT of the same
    dequantised coefficients, clamped to [0, 255]: within 1 (islow's fixed
    point rounds each pass), on outputs within libjpeg's range-limit table
    (|x| < 384 before the +128; beyond it the table wraps)."""
    rng = np.random.RandomState(0)
    coef = rng.randint(-30, 31, (500, 64)) * (rng.rand(500, 64) < 0.3)
    coef[:, 0] = rng.randint(-60, 61, 500)
    qt = rng.randint(1, 8, 64)
    got = jpeg.idct_islow(coef, qt).astype(np.float64)
    nat = np.empty_like(coef)
    nat[:, jpeg.ZIGZAG] = coef
    F = (nat * qt).reshape(-1, 8, 8).astype(np.float64)
    n = np.arange(8)
    C = np.sqrt(np.where(n[:, None] == 0, 1 / 8, 2 / 8)) * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    ref = np.einsum("ux,nuv,vy->nxy", C, F, C)
    inside = np.abs(ref) < 380
    assert inside.mean() > 0.99 and (np.abs(ref) > 128).any()
    assert np.abs(got - np.clip(ref + 128, 0, 255))[inside].max() <= 1.0


def test_glob_imgs_order_matches_jax(tmp_path):
    """glob_imgs collects *.png, *.jpg, *.JPEG and *.JPG in the JAX package's
    order (and nothing else)."""
    for name in ("b.jpg", "a.JPG", "c.png", "d.JPEG", "e.jpeg", "f.bmp", "g.Jpg"):
        open(tmp_path / name, "wb").close()
    assert io_util.glob_imgs(str(tmp_path)) == jax_io.glob_imgs(str(tmp_path))


def test_log_names_the_jpeg_route(monkeypatch):
    """Without imageio the log's "images:" line names both of the port's
    readers."""
    lines = []
    io_util._imageio.cache_clear()
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    monkeypatch.setattr(io_util.log, "info", lines.append)
    try:
        assert io_util._imageio() is None
    finally:
        io_util._imageio.cache_clear()
    assert any("utils/jpeg.py::read_jpeg" in ln and "read_png" in ln for ln in lines)


@pytest.fixture(scope="module")
def jpeg_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("jpeg_scenes")
    out = {}
    for layout in ("DTU", "BlendedMVS", "custom"):
        d = str(root / layout)
        out[layout] = (d, chip_smoke.write_scene(d, layout, 3, 36, 52, background="envmap",
                                                 fmt="jpg"))
    return out


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("layout", ["DTU", "BlendedMVS", "custom"])
def test_loaders_on_jpeg_scenes_match_jax(jpeg_scenes, port_route, layout, downscale):
    """The three loaders read a JPEG scene (images as JPEG, masks as PNG)
    through the port's decoders to the JAX loaders' arrays (imageio): rgb
    equal, masks equal, intrinsics and poses within 1e-6; and the decoded
    images are within 30 dB of the arrays written."""
    root, scene = jpeg_scenes[layout]
    assert any(f.endswith(".jpg") for f in os.listdir(os.path.join(
        root, {"DTU": "image", "BlendedMVS": "blended_images", "custom": "images"}[layout])))
    cfg = {"data": {"type": layout, "data_dir": root, "downscale": downscale}}
    want, got = jax_get_data(JaxConfigDict(cfg)), get_data(ConfigDict(cfg))
    assert (got.H, got.W, len(got)) == (want.H, want.W, len(want))
    np.testing.assert_array_equal(got.rgb_images, want.rgb_images)
    for name in ("object_masks", "masks_ignore"):
        a, b = getattr(got, name, None), getattr(want, name, None)
        assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), name
    np.testing.assert_allclose(got.intrinsics_all, want.intrinsics_all, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.c2w_all, want.c2w_all, rtol=0, atol=1e-6)
    if downscale == 1:
        enc = scene["encoded"].reshape(len(got), -1, 3).astype(np.float64)
        mse = np.mean((got.rgb_images * 255.0 - enc) ** 2)
        assert 10 * np.log10(255.0 ** 2 / mse) >= 30.0


@pytest.mark.parametrize("name,attr", [("neus_nomask_blended.yaml", "NEUS_NOMASK_BLENDED"),
                                       ("volsdf_nerfpp_blended.yaml", "VOLSDF_NERFPP_BLENDED")])
def test_chip_smoke_blended_configs_are_the_files(name, attr):
    """Phase 37 trains the two *_blended configs as the files hold them."""
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "configs", name)) as f:
        assert getattr(chip_smoke, attr) == yaml.safe_load(f)

"""The port's render slice against the JAX package: `volume_render_rays` on
identical rays, and `render_view` on a checkpoint written by the JAX trainer's
CheckpointIO (with its optax state), on the CPU. Also: the port imports
without JAX, optax, PyYAML, imageio, TensorBoard or the JAX package, and
the trainer's logger and config writer work without them."""
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models.frameworks.neus import compute_ray_samples
from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.tools.camera_paths import generate_camera_path as jax_camera_path
from neurecon_tpu.training import render_full_image as jax_render_full_image
from neurecon_tpu.utils.checkpoints import CheckpointIO as JaxCheckpointIO

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model
from neurecon_tpu_torch.tools import render_view
from neurecon_tpu_torch.utils.checkpoints import CheckpointIO, load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(sphere_residual=False):
    """A small NeuS (the W=64 widths of __graft_entry__._framework_args) on
    a 24x32 synthetic sphere scene."""
    return {
        "expname": "torch_port",
        "data": {"type": "synthetic", "downscale": 1, "n_images": 4, "H": 24,
                 "W": 32, "val_rayschunk": 256, "obj_bounding_radius": 1.0},
        "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                  "W_geometry_feature": 64, "N_samples": 32, "N_importance": 32,
                  "N_upsample_iters": 2,
                  "surface": {"D": 4, "W": 64, "skips": [2], "radius_init": 0.5,
                              "embed_multires": 4,
                              "sphere_residual": sphere_residual},
                  "radiance": {"D": 2, "W": 64, "skips": [], "embed_multires": -1,
                               "embed_multires_view": 2}},
        "training": {"with_mask": True, "w_mask": 1.0, "w_eikonal": 0.1,
                     "speed_factor": 10.0, "lr": 5e-4, "num_iters": 100,
                     "scheduler": {"type": "warmupcosine", "warmup_steps": 10}},
    }


def _models(sphere_residual=False, perturb=False):
    jm, _, jkw_train, jkw_test, jfactory = jax_get_model(JaxConfigDict(_cfg(sphere_residual)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    # a trained-looking sharp s, so the render is not a blur
    params["ln_s"] = jnp.asarray([0.45], jnp.float32)
    tm, _, tkw_test, tfactory = get_model(ConfigDict(_cfg(sphere_residual)), "cpu")
    bridge.load_tree(tm, jax.tree_util.tree_map(np.asarray, params))
    if perturb:  # noise on every weight, octave columns included
        perturb_parameters(tm, torch.Generator().manual_seed(1))
        params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    return jm, params, jkw_test, jfactory, tm, tkw_test, tfactory


def _rays(n, seed=0):
    rng = np.random.RandomState(seed)
    th = rng.uniform(-0.3, 0.3, (n, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1).astype(np.float32)
    d *= rng.uniform(0.8, 1.2, (n, 1)).astype(np.float32)  # unnormalized
    o = np.ascontiguousarray(np.broadcast_to(np.array([0.1, -0.1, -3.0], np.float32),
                                             d.shape))
    return o, d


def test_volume_render_rays_matches_jax():
    _check_volume_render(perturb=False)


def test_volume_render_rays_matches_jax_perturbed_weights():
    _check_volume_render(perturb=True)


def _check_volume_render(perturb):
    jm, params, jkw, jfactory, tm, tkw, tfactory = _models(perturb=perturb)
    kw = {k: v for k, v in jkw.items() if k not in ("rayschunk",)}
    o, d = _rays(96)
    key = jax.random.PRNGKey(4)
    j_render = jax.jit(jfactory(detailed_output=True, calc_normal=True, **kw))
    d_all_j = np.asarray(jax.jit(functools.partial(compute_ray_samples, jm, **kw))(
        params, jnp.asarray(o), jnp.asarray(d), key))
    _, _, want = j_render(params, jnp.asarray(o), jnp.asarray(d), key)
    t_render = tfactory(detailed_output=True, calc_normal=True,
                        **{k: v for k, v in tkw.items() if k != "rayschunk"})
    with torch.no_grad():  # the render (training differentiates the same fn)
        _, _, got = t_render(torch.tensor(o), torch.tensor(d))

    # the port's own upsampler: same samples but for rare det plateau moves
    # (see test_torch_kernels.py); rgb then agrees to the JAX package's
    # own render-equivalence bound (tests/test_fused_upsample.py)
    span = 2.0
    off = np.abs(got["d_all"].numpy() - d_all_j) > 1e-4 * span
    assert off.mean() < 0.03
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]), atol=2e-3)

    # on JAX's own samples (the d_all seam) the compositor agrees tightly:
    # fp32 sums in another order through both MLPs
    with torch.no_grad():
        _, _, got = t_render(torch.tensor(o), torch.tensor(d), d_all=torch.tensor(d_all_j))
    for k, atol in (("rgb", 1e-5), ("mask_volume", 1e-5), ("depth_volume", 1e-4),
                    ("normals_volume", 1e-4), ("implicit_surface", 1e-5),
                    ("visibility_weights", 1e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["implicit_nablas"].numpy(),
                               np.asarray(want["implicit_nablas"]), rtol=2e-3, atol=2e-4)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint as the JAX trainer writes it: params + optax state."""
    jm, _, _, _, _ = jax_get_model(JaxConfigDict(_cfg()))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    params["ln_s"] = jnp.asarray([0.45], jnp.float32)
    opt_state = optax.adam(1e-3).init(params)
    d = str(tmp_path_factory.mktemp("ckpts"))
    path = JaxCheckpointIO(d).save("latest.pt", global_step=7, model=params,
                                   opt_state=opt_state)
    return path


def _view_args(path, outdir):
    args = ConfigDict(_cfg())
    args.update({"load_pt": path, "outdir": outdir, "num_views": 2,
                 "camera_path": "interpolation",
                 "rayschunk": 300, "device": "cpu"})
    return args


def test_render_view_on_jax_checkpoint(jax_checkpoint, tmp_path):
    frames = render_view.render_frames(_view_args(jax_checkpoint, str(tmp_path)),
                                       device="cpu")

    # the JAX package's render of the same checkpoint and camera path
    jargs = JaxConfigDict(_cfg())
    jm, _, _, jkw, jfactory = jax_get_model(jargs)
    import pickle
    with open(jax_checkpoint, "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f)["model"])
    ds = jax_get_data(jargs)
    c2ws = jax_camera_path("interpolation", np.asarray(ds.c2w_all), 2)
    render_fn = jfactory(detailed_output=False, calc_normal=True,
                         **{k: v for k, v in jkw.items() if k != "rayschunk"})
    for i, c2w in enumerate(c2ws):
        o, d, _ = jax_get_rays(None, jnp.asarray(c2w, jnp.float32),
                               jnp.asarray(ds.intrinsics_all[0]), ds.H, ds.W)
        ret = jax_render_full_image(render_fn, params, o, d, jax.random.PRNGKey(i),
                                    rayschunk=300)
        # det-plateau sample moves bound the rgb at the JAX package's own
        # render-equivalence tolerance; normals see the same moves
        np.testing.assert_allclose(frames["rgb"][i], ret["rgb"].reshape(ds.H, ds.W, 3),
                                   atol=2e-3)
        np.testing.assert_allclose(
            frames["normal"][i], ret["normals_volume"].reshape(ds.H, ds.W, 3) / 2 + 0.5,
            atol=2e-3)
    assert frames["rgb"].shape == (2, 24, 32, 3)
    assert np.isfinite(frames["depth"]).all()


def test_render_view_writes_videos_and_port_checkpoint(jax_checkpoint, tmp_path):
    data = load_checkpoint(jax_checkpoint)  # optax state stubbed, not imported
    assert data["global_step"] == 7
    # re-save in the port's format and render through the CLI function
    path = CheckpointIO(str(tmp_path)).save("port.pt", 7, model=data["model"])
    render_view.main_function(_view_args(path, str(tmp_path)))
    vids = [f for f in os.listdir(tmp_path) if f.startswith("torch_port_rgb_")]
    assert vids, os.listdir(tmp_path)


def test_entry_points_need_a_card_unless_cpu_is_asked(jax_checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _view_args(jax_checkpoint, str(tmp_path))
    with pytest.raises(RuntimeError, match="--device cpu"):
        render_view.render_frames(args)  # device=None: the card


def test_port_imports_without_jax(jax_checkpoint):
    code = (
        "import sys, pkgutil, importlib, tempfile\n"
        "for m in ('jax', 'jaxlib', 'optax', 'yaml', 'neurecon_tpu', 'imageio',\n"
        "          'tensorboard', 'torch.utils.tensorboard'):\n"
        "    sys.modules[m] = None\n"
        "import neurecon_tpu_torch as P\n"
        "for info in pkgutil.walk_packages(P.__path__, 'neurecon_tpu_torch.'):\n"
        "    importlib.import_module(info.name)\n"
        "import chip_smoke\n"
        "import neurecon_tpu_torch.train, neurecon_tpu_torch.utils.logger as L\n"
        "import numpy as np\n"
        "lg = L.Logger(tempfile.mkdtemp(), monitoring='tensorboard')\n"
        "lg.add_imgs(np.zeros((4, 5, 3)), 'val/x', 0)\n"
        "from neurecon_tpu_torch.config import ConfigDict, save_config\n"
        "save_config(ConfigDict({'a': {'b': [1, 2]}}), tempfile.mktemp())\n"
        "from neurecon_tpu_torch.utils.checkpoints import load_checkpoint\n"
        "ck = load_checkpoint(sys.argv[1])\n"
        "assert ck['global_step'] == 7 and 'implicit_surface' in ck['model']\n"
        "print('IMPORT_OK')\n")
    out = subprocess.run([sys.executable, "-c", code, jax_checkpoint], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert "IMPORT_OK" in out.stdout, out.stderr[-3000:]

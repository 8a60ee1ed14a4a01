"""The port's visualisation and supervision tools (`neurecon_tpu_torch/tools/`:
vis_camera, vis_ray, vis_surface_and_cam, plot_neus_bias, test_volsdf_algo,
supervise) against the JAX package's tools, on the CPU: each tool's numbers
on the same inputs (the camera glyphs, the true-FOV frusta, the checkpoint
mesh, the NeuS bias curves, the 1-D oracle's bound, error and samples), the
figures written with Agg under pytest's tmp dir, the error a figure raises
without matplotlib, and the supervisor's stall-kill-restart and its
no-restart flag with dummy children and sub-second stalls."""
import copy
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.models.frameworks.volsdf import error_bound as jax_error_bound
from neurecon_tpu.models.frameworks.volsdf import fine_sample as jax_fine_sample
from neurecon_tpu.models.frameworks.volsdf import sdf_to_sigma as jax_sdf_to_sigma
from neurecon_tpu.tools import plot_neus_bias as jax_bias
from neurecon_tpu.tools import vis_camera as jax_vis_camera
from neurecon_tpu.tools import vis_surface_and_cam as jax_vsc

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.dataio import get_data
from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model
from neurecon_tpu_torch.tools import (plot_neus_bias, supervise, test_volsdf_algo,
                                      vis_camera, vis_ray, vis_surface_and_cam)
from neurecon_tpu_torch.utils.checkpoints import CheckpointIO
from tests.test_torch_parallel import _case_cfg


def _scene_cfg():
    return _case_cfg("neus_mask")


def _ckpt(tmp, cfg):
    """A checkpoint of the case's model with seeded noise (its surface a
    perturbed sphere of radius 0.5)."""
    model = get_model(ConfigDict(copy.deepcopy(cfg)), "cpu", seed=0)[0]
    perturb_parameters(model, torch.Generator().manual_seed(1), scale=0.02)
    io = CheckpointIO(checkpoint_dir=str(tmp))
    return io.save("tool.pt", global_step=3, model=bridge.model_to_tree(model))


def _png(path):
    with open(path, "rb") as f:
        return f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("frame_axes", [False, True])
def test_camera_wire_model_matches_jax(frame_axes):
    K = np.array([[300.0, 0, 160], [0, 310.0, 120], [0, 0, 1]])
    got = vis_camera.camera_wire_model(K, frame_axes=frame_axes)
    want = jax_vis_camera.camera_wire_model(K, frame_axes=frame_axes)
    assert len(got) == len(want) == (9 if frame_axes else 6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_camera_segments_and_frusta_match_jax():
    """The glyphs of the scene's cameras in the plot frame, and each
    camera's true-FOV frustum, equal to the JAX tools' numbers."""
    ds = get_data(ConfigDict(_scene_cfg()))
    extr = np.linalg.inv(np.asarray(ds.c2w_all, np.float64))
    K = np.asarray(ds.intrinsics_all[0], np.float64)
    segs, apexes = vis_camera.camera_segments(K[:3, :3], extr)
    wire = jax_vis_camera.camera_wire_model(K[:3, :3])
    for i, w2c in enumerate(extr):
        c2w = np.linalg.inv(w2c)
        for got, seg in zip(segs[i], wire):
            want = jax_vis_camera._to_plot_frame(seg @ c2w[:3, :3].T + c2w[:3, 3])
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(apexes[i], jax_vis_camera._to_plot_frame(c2w[:3, 3]))
        for got, want in zip(vis_surface_and_cam.frustum_segments(K, w2c, (ds.W, ds.H), 0.4),
                             jax_vsc.frustum_segments(K, w2c, (ds.W, ds.H), 0.4)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("occlusion", [True, False])
def test_bias_curves_match_jax(occlusion):
    """Every panel's NeuS weights (float32 on both sides) within 1e-6, the
    naive weights equal, and the same peak errors; the NeuS peak sits
    within a sample spacing of the first surface."""
    rows = plot_neus_bias.bias_curves(64.0, 1.3, occlusion, device="cpu")
    for row in rows:
        for p in row:
            d = np.linspace(0.0, 2.5, p["N"])
            sdf = (jax_bias.two_surface_sdf(d, 1.3, 1.9) if occlusion
                   else jax_bias.fake_1d_sdf(d, 1.3))
            np.testing.assert_allclose(p["w_neus"], jax_bias.neus_weights(sdf, p["s"]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_array_equal(p["w_naive"], jax_bias.naive_weights(sdf, d, p["s"]))
            d_mid = 0.5 * (d[1:] + d[:-1])
            want_peak = abs(d_mid[np.argmax(jax_bias.neus_weights(sdf, p["s"]))] - 1.3)
            assert p["peak_err"] == pytest.approx(want_peak)
            assert p["peak_err"] <= 2.5 / (p["N"] - 1)


def test_volsdf_oracle_matches_jax():
    """The closed-form 1-D oracle: the error bound, the approximation's
    opacity and error to rel 1e-5, the bound above the error, and the plain
    sampler's 64 final depths within 1e-4 of JAX's `fine_sample` (the
    per-round inverse-CDF lerps in another fp32 order), the rounds used and
    the beta map equal."""
    n = test_volsdf_algo.volsdf_algo_numbers(beta_net=0.1, eps=0.1, device="cpu")
    d = np.linspace(0, 6.0, 128)
    sdf = np.abs(d - 3.0) - 1.0
    bounds = np.asarray(jax_error_bound(jnp.asarray(d)[None], jnp.asarray(sdf)[None],
                                        10.0, 0.1))[0]
    np.testing.assert_allclose(n["bounds"], bounds, rtol=1e-5, atol=1e-12)
    sig = np.asarray(jax_sdf_to_sigma(jnp.asarray(sdf), 10.0, 0.1))
    np.testing.assert_allclose(n["O_hat"], 1 - np.exp(-np.cumsum(sig[:-1] * np.diff(d))),
                               rtol=1e-5, atol=1e-7)
    assert n["within"]

    def sdf_3d(pts):
        return jnp.linalg.norm(pts - jnp.array([0.0, 0.0, 3.0]), axis=-1) - 1.0

    fine, beta_map, iters = jax.jit(lambda: jax_fine_sample(
        sdf_3d, jnp.asarray(d)[None], jnp.zeros((1, 3)), jnp.array([[0.0, 0.0, 1.0]]),
        10.0, 0.1, jnp.full((1, 1), 6.0), key=jax.random.PRNGKey(0), eps=0.1, max_iter=5,
        max_bisection=10, final_N_importance=64, N_up=128, perturb=False))()
    np.testing.assert_allclose(n["d_fine"], np.asarray(fine[0]), rtol=0, atol=1e-4)
    assert n["iter_usage"] == int(iters[0])
    assert n["beta_map"] == pytest.approx(float(beta_map[0]), rel=1e-6)


def test_checkpoint_mesh_matches_jax(tmp_path):
    """`extract_mesh_from_ckpt` on a port checkpoint (plain path on the
    CPU) against the JAX tool's on the same file: the same faces, the
    vertices within 1e-5."""
    cfg = _scene_cfg()
    cfg["data"]["volume_size"] = 1.6
    ckpt = _ckpt(tmp_path, cfg)
    verts, faces = vis_surface_and_cam.extract_mesh_from_ckpt(ckpt, ConfigDict(cfg), N=24,
                                                              device="cpu")
    j_verts, j_faces = jax_vsc.extract_mesh_from_ckpt(ckpt, JaxConfigDict(cfg), N=24)
    assert len(faces) > 100
    np.testing.assert_array_equal(faces, j_faces)
    np.testing.assert_allclose(verts, j_verts, rtol=0, atol=1e-5)


def test_figures_are_written(tmp_path):
    """Every tool's figure, headless (Agg), as a PNG under tmp: the cameras,
    the probe rays, the surface with the cameras (from a .ply and from a
    checkpoint), the bias grid, the 1-D oracle and a VolSDF checkpoint's
    probe ray (plain sampler on the CPU)."""
    import matplotlib.pyplot as plt

    from neurecon_tpu_torch.utils.mesh import write_ply

    cfg = _scene_cfg()
    args = ConfigDict(copy.deepcopy(cfg))
    ds = get_data(args)
    out = {k: str(tmp_path / f"{k}.png") for k in
           ("cam", "ray", "vsc_ply", "vsc_ckpt", "bias", "oracle", "real")}
    vis_camera.visualize(np.asarray(ds.intrinsics_all[0])[:3, :3],
                         np.linalg.inv(np.asarray(ds.c2w_all)), show=False, save_path=out["cam"])
    o, d, segs = vis_ray.probe_rays(args, device="cpu")
    assert o.shape == d.shape == (len(ds), 3)
    np.testing.assert_allclose(o, np.asarray(ds.c2w_all)[:, :3, 3], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, rtol=1e-6)
    vis_ray.main_function(args, show=False, save_path=out["ray"], device="cpu")
    ckpt = _ckpt(tmp_path, cfg)
    verts, faces = vis_surface_and_cam.extract_mesh_from_ckpt(ckpt, args, N=20, device="cpu")
    ply = str(tmp_path / "m.ply")
    write_ply(ply, verts, faces)
    vis_surface_and_cam.main_function(args, mesh_path=ply, show=False, save_path=out["vsc_ply"])
    args.mesh_N = 20
    vis_surface_and_cam.main_function(args, load_pt=ckpt, show=False, save_path=out["vsc_ckpt"],
                                      device="cpu")
    assert plot_neus_bias.main(save=out["bias"], device="cpu") <= 2.5 / 31
    assert test_volsdf_algo.main(save=out["oracle"], device="cpu")["within"]
    vcfg = _case_cfg("volsdf_mask")
    vpath = str(tmp_path / "volsdf.yaml")
    with open(vpath, "w") as f:
        yaml.safe_dump(vcfg, f)
    vckpt = os.path.join(str(tmp_path), "v")
    os.makedirs(vckpt)
    vm = get_model(ConfigDict(copy.deepcopy(vcfg)), "cpu", seed=0)[0]
    real = test_volsdf_algo.main(
        save=out["real"], N_init=32, config=vpath, device="cpu",
        load_pt=CheckpointIO(checkpoint_dir=vckpt).save("v.pt", model=bridge.model_to_tree(vm)))
    assert real["beta_net"] == pytest.approx(0.1, rel=1e-5)
    assert real["d_fine"].shape == (64,) and np.isfinite(real["d_fine"]).all()
    plt.close("all")
    for k, path in out.items():
        assert _png(path), k


def test_figure_without_matplotlib_says_so(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        vis_camera.pyplot()
    with pytest.raises(RuntimeError, match="needs matplotlib"):
        plot_neus_bias.main(save="unused.png", device="cpu")


# ---- supervise, with dummy children and sub-second stalls ----

FAST = dict(poll_sec=0.05, log=lambda *a: None)
PY = [sys.executable, "-S", "-c"]  # no site import: the children start in ~20 ms


@pytest.fixture(autouse=True)
def _no_restart_delay(monkeypatch):
    """Restart at once (the tool waits 5 s between a child's end and its
    restart)."""
    monkeypatch.setattr(supervise, "RESTART_DELAY", 0.0)


def test_supervise_passes_a_completed_child_through():
    assert supervise.supervise(PY + ["print('ok')"], stall_sec=30, **FAST) == 0


def test_supervise_kills_a_stalled_child_and_restarts_it(tmp_path):
    """A child that stalls (no output) after writing its state is killed
    and started again; the second start sees the state and finishes."""
    state = tmp_path / "state"
    script = (f"import os, sys, time\np = {str(state)!r}\n"
              "if os.path.exists(p):\n    print('resumed'); sys.exit(0)\n"
              "open(p, 'w').write('x')\nprint('first run', flush=True)\ntime.sleep(600)\n")
    t0 = time.time()
    assert supervise.supervise(PY + [script], stall_sec=0.5, max_restarts=5, **FAST) == 0
    assert time.time() - t0 < 60 and state.exists()


def test_supervise_gives_up_after_max_restarts():
    t0 = time.time()
    rc = supervise.supervise(PY + ["import time; time.sleep(600)"], stall_sec=0.3,
                             max_restarts=2, **FAST)
    assert rc != 0 and time.time() - t0 < 60


def test_supervise_no_restart_flag():
    """With restarts on errors off, a crash ends supervision with its code;
    with them on, the child runs again (here: max_restarts times more)."""
    assert supervise.supervise(PY + ["import sys; sys.exit(3)"], stall_sec=30,
                               restart_on_error=False, **FAST) == 3
    starts = []
    rc = supervise.supervise(PY + ["import sys; sys.exit(4)"], stall_sec=30, max_restarts=2,
                             **dict(FAST, log=starts.append))
    assert rc == 4 and sum(m.startswith("[supervise] start") for m in starts) == 3


def test_supervise_cli_usage_names_the_port_trainer(capsys):
    with pytest.raises(SystemExit):
        supervise.main([])
    assert "python -m neurecon_tpu_torch.train" in capsys.readouterr().err

"""What the on-card probes share (`tools/bench_ablate.py`,
`bench_volsdf_ablate.py`, `bench_render_cull.py`, `bench_fused_upsample.py`,
`bench_gradblock.py`, `bench_roadmap.py`, `probe_lax_map.py`): each asks
the card one question and prints one JSON line per row.

  * times: the median over K reps after warm-up, by CUDA events on a card
    (`median_ms`; on the CPU, the host clock);
  * the configs they read, as Python dicts held equal to the files by
    tests/test_torch_probes.py (the card machine has no PyYAML):
    `NEUS_YAML` (configs/neus.yaml) and `LONG_VOLSDF_SPHERE`
    (configs/long_volsdf_sphere.yaml);
  * `plain_versions`: the kernel wrappers replaced by their plain versions
    for one row, so that a row A/Bs a kernel against its plain version (a
    wrapper given a CUDA tensor otherwise launches its kernel);
  * the analytic multiply-add count of the surface MLP and the card's peaks.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

FP32_PEAK = 67e12   # H100 SXM fp32 FLOP/s outside the tensor cores (data sheet)
TF32_PEAK = 495e12  # H100 SXM dense TF32 tensor-core FLOP/s (data sheet)

# configs/neus.yaml's sections as the port reads them (the TPU gates
# fused_samplers / fused_nablas_vjp dropped: a CUDA tensor always launches)
NEUS_YAML = {
    "expname": "neus_37", "device_ids": -1,
    "data": {"N_rays": 512, "batch_size": 1, "cam_file": "cameras_sphere.npz",
             "data_dir": "./data/neus/dtu_scan37", "downscale": 1, "pin_memory": True,
             "val_downscale": 8, "val_rayschunk": 256},
    "model": {"N_nograd_samples": 2048, "N_upsample_iters": 4, "framework": "NeuS",
              "obj_bounding_radius": 1.0, "upsample_algo": "official_solution",
              "variance_init": 0.05,
              "radiance": {"D": 4, "W": 256, "embed_multires": -1, "embed_multires_view": 4,
                           "skips": []},
              "surface": {"D": 8, "W": 256, "embed_multires": 6, "radius_init": 0.5,
                          "skips": [4]}},
    "training": {"ckpt_file": None, "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "i_backup": 50000, "i_save": 900, "i_val": 500, "i_val_mesh": 10000,
                 "log_root_dir": "logs", "lr": 0.0005, "overlap_sampler": False,
                 "monitoring": "tensorboard", "num_iters": 300000,
                 "scheduler": {"type": "warmupcosine", "warmup_steps": 5000},
                 "speed_factor": 10.0, "w_eikonal": 0.1, "w_mask": 1.0, "with_mask": True},
}

# configs/long_volsdf_sphere.yaml, the file bench_volsdf_ablate reads
LONG_VOLSDF_SPHERE = {
    "expname": "long_volsdf_sphere", "device_ids": -1,
    "data": {"type": "synthetic", "batch_size": 1, "data_dir": None, "downscale": 1,
             "n_images": 16, "H": 240, "W": 320, "scale_radius": 2.6, "near": 0.0,
             "far": 6.0, "N_rays": 512, "val_rayschunk": 8192, "val_downscale": 2},
    "model": {"framework": "VolSDF", "obj_bounding_radius": 3.0, "outside_scene": "builtin",
              "max_upsample_iter": 4, "fine_sample_mul": 2, "W_geometry_feature": 256,
              "N_samples": 64, "N_importance": 64,
              "surface": {"radius_init": 1.0, "D": 8, "W": 256, "skips": [4],
                          "embed_multires": 6},
              "radiance": {"D": 4, "W": 256, "skips": [], "embed_multires": -1,
                           "embed_multires_view": -1}},
    "training": {"speed_factor": 10.0, "lr": 5.0e-4, "w_eikonal": 0.1,
                 "log_root_dir": "logs",
                 "scheduler": {"type": "exponential_step", "min_factor": 0.1},
                 "num_iters": 100000, "steps_per_call": 50, "ckpt_file": None,
                 "ckpt_ignore_keys": [], "ckpt_only_use_keys": None,
                 "monitoring": "tensorboard", "i_save": 900, "i_backup": 25000, "i_val": 5000,
                 "i_val_mesh": -1, "i_log": 100},
}

# the YAML keys that select TPU paths in the JAX package; the port has none
TPU_GATES = ("fused_samplers", "fused_nablas_vjp")


def parser(description: str, K=None) -> argparse.ArgumentParser:
    """The probes' common flags: --device (cuda unless asked), --seed
    (weights and inputs) and, for a probe that times (K its default), --K
    (timed reps a row, after warm-up)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    if K is not None:
        ap.add_argument("--K", type=int, default=K, help="timed reps a row (median)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the weights and inputs")
    return ap


def with_width(cfg: dict, width: int) -> dict:
    """A deep copy of `cfg` with the surface, the radiance net and the
    geometry features at `width` (the files' own is 256)."""
    cfg = copy.deepcopy(cfg)
    cfg["model"]["surface"]["W"] = width
    cfg["model"]["radiance"]["W"] = width
    cfg["model"]["W_geometry_feature"] = width
    return cfg


def card(dev: torch.device) -> str:
    """`nvidia-smi`'s name and power limit of the card (every time is kept
    beside it), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown card"


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def median_ms(fn, K: int, dev: torch.device, warmup: int = 1) -> float:
    """Median ms of `fn()` over K reps after `warmup` calls: CUDA events
    around each rep on a card, the host clock with no device on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    times = []
    for _ in range(K):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def emit(probe: str, row: str, out=None, **fields) -> dict:
    """Print one JSON line {"probe", "row", **fields} and return it."""
    rec = {"probe": probe, "row": row, **fields}
    print(json.dumps(rec), file=out or sys.stdout, flush=True)
    return rec


def _plain1(surface, x, weights=None, packed=None):
    from neurecon_tpu_torch.ops import fused_nablas
    return fused_nablas.forward_with_nablas_plain(surface, x, weights)


def _plain3(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h, packed=None):
    from neurecon_tpu_torch.ops import fused_nablas_vjp
    return fused_nablas_vjp.nablas_vjp_plain(surface, x, ws, bs, cot_sdf, cot_nablas, cot_h)


@contextlib.contextmanager
def plain_versions(*kernels: str):
    """Within the block the named kernels' wrappers are their plain versions
    (called by name, as chip_smoke.py's plain runs call them): any of
    "neus_upsample" (kernel 2), "nablas_forward" (1), "nablas_backward" (3),
    "sdf_forward" (4), "fine_sample" (the VolSDF sampler, (a)-(c) and its
    kernel-4 queries)."""
    from neurecon_tpu_torch.ops import (fused_fine_sample, fused_mlp, fused_nablas,
                                        fused_nablas_vjp, fused_upsample)
    table = {"neus_upsample": (fused_upsample, "fused_neus_upsample",
                               fused_upsample.neus_upsample_plain),
             "nablas_forward": (fused_nablas, "fused_forward_with_nablas", _plain1),
             "nablas_backward": (fused_nablas_vjp, "fused_nablas_vjp", _plain3),
             "sdf_forward": (fused_mlp, "fused_sdf_forward", fused_mlp.sdf_forward_plain),
             "fine_sample": (fused_fine_sample, "fused_fine_sample",
                             fused_fine_sample.fine_sample_plain)}
    with contextlib.ExitStack() as stack:
        for k in kernels:
            module, name, plain = table[k]
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def surface_macs(surface, sdf_only: bool = False, backward: bool = False) -> int:
    """Multiply-adds a point of the surface MLP (as chip_smoke.py counts
    them): the forward (every final row, or the sdf row alone) plus the
    nablas sweep back through the hidden layers; `backward`, what the
    eikonal backward needs: six passes over the hidden weights and the
    final layer's weight gradient and down-sweep."""
    hidden = sum(i * o for i, o in surface.dims[:-1])
    i_D, o_D = surface.dims[-1]
    if backward:
        return 6 * hidden + 2 * i_D * o_D
    if sdf_only:
        return hidden + i_D
    return hidden + i_D * o_D + hidden


def front_rays(N: int, dev: torch.device, seed: int = 1):
    """N rays from (0, 0, -3) around +z, directions N(0, 0.1) in x and y
    (the JAX probes' batch), unit length."""
    g = torch.Generator().manual_seed(seed)
    d = torch.cat([torch.randn(N, 2, generator=g) * 0.1, torch.ones(N, 1)], -1)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = torch.zeros(N, 3)
    o[:, 2] = -3.0
    return o.to(dev), d.to(dev)


def model_and_kwargs(cfg: dict, dev: torch.device, seed: int):
    """(args, model, render_kwargs_train) of the framework `cfg` names, the
    model from the port's init at `seed` on `dev`."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks import get_model

    args = ConfigDict(copy.deepcopy(cfg))
    model, kw, _, _ = get_model(args, dev, seed=seed)
    return args, model, kw

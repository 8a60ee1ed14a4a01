"""The general traffic generator: a mix's data file (`benchmark/traffic/
<mix>.json`) says which kind of loop it is and with which parameters, and
this module drives the program (`neurecon_tpu_torch`) with it.

  * kind `train`: a closed loop of training steps, as the program's trainer
    runs them: `step_fn(batch, generator, it)` built as `train.py` builds it
    (`make_pipelined_train_step` over the framework's pipeline functions,
    `make_optimizer`, called without `next_batch`), one image a step in the
    trainer's permuted order. Set-up drives the same step object through
    its first `warmup_steps` steps (which build and load the kernels) and
    keeps what the check compares: the first `checked_steps` losses, the
    first step's gradients as Adam holds them, and the parameters after
    the checked steps.
  * kind `render`: a closed loop of novel-view frames, as the program's
    `render_view` renders them: `render_full_image(render_fn, rays_o,
    rays_d, rayschunk)` with `render_fn` from the framework's render
    factory, `frames` views on a circle at the images' resolution over
    `downscale`; set-up renders one frame. The check renders a sample of
    `check_rays` rays, drawn from the seed among every frame the window
    finished, with the reference.

Every input comes from the seed: the weights, the generator of the steps'
draws, the image order, the camera path and the check's sample.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import math
import time

import numpy as np
import torch

from benchmark import faults
from benchmark.reference import step as ref_step
from benchmark.registry import framework
from benchmark.scene import camera_path, image_rays, make_scene
from benchmark.trace import Profiled
from benchmark.weights import make_weights, port_name


def subseeds(seed: int, n: int) -> list:
    """n independent 31-bit seeds from any whole number."""
    state = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(n)
    return [int(s) >> 1 for s in state]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(cfg: dict, weights: dict, device):
    """The program's model for `cfg` (through `get_model`), its parameters
    set to the benchmark's weights. Returns (args, model, render_kwargs_train,
    render_kwargs_test, render_factory)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks import get_model

    args = ConfigDict(copy.deepcopy(cfg))
    model, kw_train, kw_test, factory = get_model(args, device, seed=0)
    params = dict(model.named_parameters())
    if set(params) != {port_name(k) for k in weights}:
        raise RuntimeError(f"the program's parameters {sorted(params)} are not the "
                           f"benchmark's {sorted(port_name(k) for k in weights)}")
    with torch.no_grad():
        for k, v in weights.items():
            params[port_name(k)].copy_(v)
    return args, model, kw_train, kw_test, factory


class TrainMix:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault=None):
        self.cfg, self.traffic, self.dev, self.fault = cfg, traffic, device, fault
        self.w_seed, self.g_seed, self.order_seed, _ = subseeds(seed, 4)

    def _next_batch(self):
        if self.perm_pos >= len(self.perm):
            self.epoch += 1
            self.perm = np.random.RandomState(self.order_seed + self.epoch).permutation(
                self.n_images)
            self.perm_pos = 0
        idx = int(self.perm[self.perm_pos])
        self.perm_pos += 1
        return idx, {k: v[idx:idx + 1] for k, v in self.data.items()}

    def setup(self):
        from neurecon_tpu_torch.models.base import make_optimizer
        from neurecon_tpu_torch.models.frameworks import get_pipeline_fns
        from neurecon_tpu_torch.parallel.sharding import RayShard
        from neurecon_tpu_torch.training import make_pipelined_train_step

        cfg, dev = self.cfg, self.dev
        self.scene = make_scene(cfg["scene"], dev)
        self.weights = make_weights(cfg, self.w_seed, dev)
        args, model, kw_train, _, _ = build_model(cfg, self.weights, dev)
        kw_train["H"], kw_train["W"] = self.scene["H"], self.scene["W"]
        optimizer, scheduler = make_optimizer(args, model)
        fns = get_pipeline_fns(args, model, kw_train, shard=RayShard(None))
        fns, optimizer = faults.apply_train(self.fault, fns, optimizer, cfg)
        fns = self._recorder(fns)
        self.step_fn = make_pipelined_train_step(fns, model, optimizer, scheduler, group=None)
        self.model, self.optimizer = model, optimizer
        self.data = {k: self.scene[k] for k in ("c2w", "intrinsics", "rgb")}
        if bool(cfg["training"].get("with_mask", False)):
            self.data["object_mask"] = self.scene["object_mask"]
        self.n_images = int(self.data["c2w"].shape[0])
        self.epoch, self.perm_pos = 0, 0
        self.perm = np.random.RandomState(self.order_seed).permutation(self.n_images)
        self.gen = torch.Generator(device=dev).manual_seed(self.g_seed)
        self.it = 0

        names = self.names = {port_name(k): k for k in self.weights}
        params = dict(model.named_parameters())
        checked = int(self.traffic["checked_steps"])
        self.steps, self.losses = [], []
        for k in range(max(checked, int(self.traffic["warmup_steps"]))):
            idx, batch = self._next_batch()
            if k < checked:
                self.steps.append((idx, self.gen.get_state()))
            self.recording = k < checked
            metrics = self.step_fn(batch, self.gen, self.it)
            self.it += 1
            if k < checked:
                self.losses.append(metrics["losses"]["total"].detach().clone())
            if k == 0:  # Adam's first moment after one step is 0.1 g
                self.grads = {names[n]: (optimizer.state[p]["exp_avg"] / 0.1
                                         if "exp_avg" in optimizer.state[p]
                                         else torch.zeros_like(p))
                              for n, p in params.items()}
            if k == checked - 1:
                self.after = {names[n]: p.detach().clone() for n, p in params.items()}
        self.recording = False
        sync(dev)

    def _recorder(self, fns: dict) -> dict:
        """The pipeline functions, keeping while `recording` is set what the
        checked steps produced: the parameters the step started from (by
        their canonical names), what the framework's `recorded` keeps of
        the sampler's output and the loss's extras (NeuS's d_all; VolSDF's
        fine depths and each ray's eikonal sample), and the render's rgb of
        every ray."""
        self.recording, self.record = False, {"follow": [], "rgb": []}
        sample, loss = fns["depth_sample"], fns["loss_with_samples"]
        fw = framework(self.cfg)

        def depth_sample(rb, draws):
            if self.recording:
                self.state = {self.names[n]: p.detach().clone()
                              for n, p in self.model.named_parameters()}
            out = sample(rb, draws)
            if self.recording:
                self.sampled = out
            return out

        def loss_with_samples(rb, samples, draws, generator, it):
            total, (losses, extras) = loss(rb, samples, draws, generator, it)
            if self.recording:
                kept = fw.recorded(self.sampled, extras)
                self.record["follow"].append(
                    {"params": self.state, **{k: v.detach().clone() for k, v in kept.items()}})
                self.record["rgb"].append(extras["rgb"].detach().reshape(-1, 3).clone())
                del self.sampled, self.state
            return total, (losses, extras)

        return dict(fns, depth_sample=depth_sample, loss_with_samples=loss_with_samples)

    @staticmethod
    def _mark(cuda: bool):
        """A step's start: a CUDA event on the device's timeline (so that
        host gaps count), or on the CPU the host clock."""
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def window(self, seconds: float, trace_units: int = 0) -> dict:
        dev = self.dev
        cuda = dev.type == "cuda"
        events, losses = [], []
        prof = Profiled(dev) if trace_units else contextlib.nullcontext()
        sync(dev)
        t0 = time.perf_counter()
        with prof:
            while True:
                events.append(self._mark(cuda))
                _, batch = self._next_batch()
                metrics = self.step_fn(batch, self.gen, self.it)
                losses.append(metrics["losses"]["total"].detach())
                self.it += 1
                if trace_units and len(losses) >= trace_units:
                    prof.units = len(losses)
                    break
                if not trace_units and time.perf_counter() - t0 >= seconds:
                    break
            events.append(self._mark(cuda))
            sync(dev)
        window_s = time.perf_counter() - t0
        n = len(losses)
        steps_ms = [a.elapsed_time(b) if cuda else 1e3 * (b - a)
                    for a, b in zip(events, events[1:])]
        e2e = {"train_rays_per_s": n * int(self.cfg["data"]["N_rays"]) / window_s,
               "train_step_ms_p95": float(np.percentile(steps_ms, 95))}
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": n, "failed": failed, "e2e": e2e,
                "trace": prof.trace if trace_units else None}

    def release(self):
        """Keep what the check compares (on the device), free the rest."""
        follow = self.record["follow"]
        self.prog = {"losses": [float(v) for v in self.losses], "grads": self.grads,
                     "change": {k: self.after[k] - self.weights[k] for k in self.after},
                     "samples": [f["samples"] for f in follow], "rgb": self.record["rgb"],
                     "follow": follow}
        del self.step_fn, self.model, self.optimizer, self.after, self.data
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, dtype=torch.float32, follow=None) -> dict:
        """The reference over the checked steps: their losses, sampler depths
        and rays' rgb, what it keeps as the program's recorder would
        (`follow`), the near-ties it settled the program's way (`ties`), the
        parameter values it took from the program (`adopted`), the first
        step's gradients and the parameters' change. `follow`:
        the program's record of each step (see `train_steps`)."""
        ref = ref_step.train_steps(self.cfg, self.weights, self.scene, self.steps, tf32=tf32,
                                   dtype=dtype, follow=follow)
        return {k: ref[k] for k in ("losses", "grads", "samples", "rgb", "follow", "ties",
                                    "adopted", "change")}

    def check(self, ref=None) -> dict:
        """The numbers compared, against `ref` (by default the reference's,
        following the program's record of each step)."""
        return train_readings(self.prog, ref or self.reference(follow=self.prog["follow"]))


def leaf_gaps(prog: dict, ref: dict, keep) -> dict:
    """Per leaf of `keep`: the gap between the program's norm and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf."""
    norms = {k: float(torch.linalg.norm(ref[k].double())) for k in keep}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(torch.linalg.norm(prog[k].double())) - r) / max(r, med)
            for k, r in norms.items()}


def settled(change: dict, ref_grads: dict) -> dict:
    """Of each leaf's change, the components Adam moves by more than
    round-off (`ref_step.round_off` of the reference's first gradient)."""
    loose = ref_step.round_off(ref_grads)
    return {k: v[~loose[k]] for k, v in change.items()}


def moved_leaves(ref_grads: dict) -> list:
    """The leaves the reference's first gradient moves: those whose norm is
    at least a thousandth of the median leaf's (the others, such as a bias
    that a softmax or a mean cancels, move under Adam by round-off alone)."""
    norms = {k: float(torch.linalg.norm(g.double())) for k, g in ref_grads.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n >= 1e-3 * med]


def _quantiles(pairs, scale=None) -> tuple:
    """The 90th and 99th percentiles over the rays of each ray's widest gap
    (over `scale` per ray); +inf where the program's rays are not the
    reference's."""
    gaps = []
    for i, (p, r) in enumerate(pairs):
        if p.numel() != r.numel():
            return float("inf"), float("inf")
        g = (p.reshape(r.shape).double() - r.double()).abs().amax(-1)
        gaps.append(g if scale is None else g / scale[i].double())
    g = torch.nan_to_num(torch.cat(gaps), nan=float("inf")).cpu()
    return float(torch.quantile(g, 0.9)), float(torch.quantile(g, 0.99))


def train_readings(prog: dict, ref: dict) -> dict:
    """Of the checked steps, with the reference rendering at the program's
    sampled depths: samples_p90 and samples_p99, the 90th and 99th
    percentiles over the rays of the sampler's widest depth gap from the
    reference's own sampler, over the reference's span of the ray; rgb_p99,
    the 99th percentile of each ray's rendered rgb gap (its
    largest channel); loss_gap, the worst step's |loss - reference| over the
    reference, and loss_gap_first, the first step's; grad_gap, the first step's gradients by the worst leaf
    (`leaf_gaps`); change_gap, the parameters' change over the steps,
    likewise, over the components Adam moves by more than round-off
    (`settled`). Over the leaves the reference moves."""
    keep = moved_leaves(ref["grads"])
    spans = [(r.amax(-1) - r.amin(-1)).clamp_min(1e-12) for r in ref["samples"]]
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    out = dict(zip(("samples_p90", "samples_p99"),
                   _quantiles(zip(prog["samples"], ref["samples"]), spans)))
    out["rgb_p99"] = _quantiles(zip(prog["rgb"], ref["rgb"]))[1]
    out["loss_gap"] = loss if math.isfinite(loss) else float("inf")
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    out["loss_gap_first"] = first if math.isfinite(first) else float("inf")
    compared = {"grads": (prog["grads"], ref["grads"]),
                "change": (settled(prog["change"], ref["grads"]),
                           settled(ref["change"], ref["grads"]))}
    for name, q in (("grad_gap", "grads"), ("change_gap", "change")):
        worst = max(leaf_gaps(*compared[q], keep).values())
        out[name] = worst if math.isfinite(worst) else float("inf")
    return out


class RenderMix:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fault=None):
        self.cfg, self.traffic, self.dev, self.fault = cfg, traffic, device, fault
        self.w_seed, self.path_seed, self.sample_seed, _ = subseeds(seed, 4)

    def _frame(self, f: int) -> dict:
        from neurecon_tpu_torch.training import render_full_image

        chunk = int(self.traffic["rayschunk"])
        out = render_full_image(self.render_fn, self.rays_o[f], self.rays_d[f], rayschunk=chunk,
                                generator=torch.Generator(device=self.dev).manual_seed(f))
        return faults.apply_frame(self.fault, out, chunk)

    def setup(self):
        cfg, dev, tr = self.cfg, self.dev, self.traffic
        self.weights = make_weights(cfg, self.w_seed, dev)
        _, model, _, kw_test, factory = build_model(cfg, self.weights, dev)
        kwargs = {k: v for k, v in kw_test.items() if k not in ("H", "W", "rayschunk")}
        self.render_fn = factory(detailed_output=False, calc_normal=True, **kwargs)
        self.model = model
        c2w, intr, H, W = camera_path(cfg["scene"], int(tr["frames"]), int(tr["downscale"]),
                                      self.path_seed, dev)
        rays = [image_rays(c, intr, H, W) for c in c2w]
        self.rays_o = [o.contiguous() for o, _ in rays]
        self.rays_d = [d.contiguous() for _, d in rays]
        self._frame(0)  # builds the kernels, warms every chunk shape
        sync(dev)

    def window(self, seconds: float, trace_units: int = 0) -> dict:
        n_frames = len(self.rays_o)
        self.frames = []
        prof = Profiled(self.dev) if trace_units else contextlib.nullcontext()
        t0 = time.perf_counter()
        with prof:
            while True:
                f = len(self.frames) % n_frames
                out = self._frame(f)
                self.frames.append((f, {k: out[k] for k in ("rgb", "depth_volume",
                                                            "normals_volume")}))
                if trace_units and len(self.frames) >= trace_units:
                    prof.units = len(self.frames)
                    break
                if not trace_units and time.perf_counter() - t0 >= seconds:
                    break
        window_s = time.perf_counter() - t0
        n = len(self.frames)
        failed = sum(not all(np.isfinite(v).all() for v in out.values())
                     for _, out in self.frames)
        return {"attempted": n, "failed": int(failed),
                "e2e": {"render_rays_per_s": n * self.rays_o[0].shape[0] / window_s},
                "trace": prof.trace if trace_units else None}

    def release(self):
        del self.render_fn, self.model
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """`check_rays` of the rays the window rendered, drawn from the seed:
        (frame positions, ray indices)."""
        n_rays = self.rays_o[0].shape[0]
        total = len(self.frames) * n_rays
        k = min(int(self.traffic["check_rays"]), total)
        pick = np.sort(np.random.default_rng(self.sample_seed).choice(total, k, replace=False))
        return pick // n_rays, pick % n_rays

    def reference(self, tf32: bool = False, dtype=torch.float32) -> dict:
        """The reference's rgb, depth and normals at the sampled rays."""
        fi, ri = self._sample()
        view = torch.as_tensor(np.asarray([self.frames[a][0] for a in fi]), device=self.dev)
        at = torch.as_tensor(ri, device=self.dev)
        ref = ref_step.render_rays(self.cfg, self.weights, torch.stack(self.rays_o)[view, at],
                                   torch.stack(self.rays_d)[view, at], tf32=tf32, dtype=dtype)
        return {k: v.cpu() for k, v in ref.items()}

    def outputs(self) -> dict:
        """The program's rgb, depth and normals at the sampled rays."""
        fi, ri = self._sample()
        return {key: torch.as_tensor(np.stack([out[name] for _, out in self.frames])[fi, ri])
                for key, name in (("rgb", "rgb"), ("depth", "depth_volume"),
                                  ("normals", "normals_volume"))}

    def check(self, ref=None) -> dict:
        """The numbers compared, against `ref` (the reference's, by default)."""
        return render_readings(self.outputs(), ref or self.reference())


def render_readings(prog: dict, ref: dict) -> dict:
    """Per sampled ray the gap of its rgb (the largest channel's), its depth
    (over the reference's depth range) and its normal (the largest
    component's) from the reference's; of each, the widest over the rays
    (`*_gap`) and the 99th percentile (`*_p99`)."""
    depth_range = float(ref["depth"].max() - ref["depth"].min()) or 1.0
    gaps = {"rgb": (prog["rgb"].double() - ref["rgb"].double()).abs().amax(-1),
            "depth": (prog["depth"].double() - ref["depth"].double()).abs() / depth_range,
            "normal": (prog["normals"].double() - ref["normals"].double()).abs().amax(-1)}
    out = {}
    for k, g in gaps.items():
        g = torch.nan_to_num(g, nan=float("inf"))
        out[f"{k}_gap"] = float(g.max())
        out[f"{k}_p99"] = float(torch.quantile(g, 0.99))
    return out


KINDS = {"train": TrainMix, "render": RenderMix}
READINGS = {"train": train_readings, "render": render_readings}


def make(cfg: dict, traffic: dict, seed: int, device, fault=None):
    return KINDS[traffic["kind"]](cfg, traffic, seed, device, fault)

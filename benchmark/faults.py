"""Faults planted under the timed path, to show that the check catches them.
The benchmark's own runs plant none; `calibrate.py` reads them on the card
and the tests see `correct` come out false with each.

  * `frozen_state`: the training step returns its state unchanged (Adam's
    step does nothing);
  * `half_batch`: the training step leaves out half of its rays and takes
    its means over the rest;
  * `altered_answer`: answers altered where they are produced: in a
    rendered frame, the colour of the rays of its first chunk moved by 0.1
    (a check that samples the frames' rays finds some of them); in
    training, the colour of the first ray that the loss counts (under an
    object mask, the first that hits), as the L1 term sees it;
  * `shifted_samples`: the sampler's answer altered where it is produced,
    its shapes kept: every depth it returns moved by half a coarse step
    (the framework's `shifted`; NeuS and VolSDF move each ray's depths by
    their span over 2 N_samples).

A cell on one card has no exchange between cards to leave out.
"""
from __future__ import annotations

import torch

from benchmark.registry import framework

TRAIN = ("frozen_state", "half_batch", "altered_answer", "shifted_samples")
RENDER = ("altered_answer",)


def apply_train(fault, fns: dict, optimizer, cfg: dict):
    """(pipeline functions, optimizer) of configuration `cfg` with `fault`
    planted."""
    if fault is None:
        return fns, optimizer
    fns = dict(fns)
    if fault == "frozen_state":
        optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        draw = fns["draw_step"]

        def draw_half(batch, generator):
            rb, draws = draw(batch, generator)
            n = rb["rays_o"].shape[1] // 2
            return ({k: v[:, :n] for k, v in rb.items()},
                    {k: v[:n] for k, v in draws.items()})
        fns["draw_step"] = draw_half
    elif fault == "altered_answer":
        loss = fns["loss_with_samples"]

        def loss_altered(rb, samples, draws, generator, it):
            rb = dict(rb)
            hits = torch.nonzero(rb["target_mask"][0]) if "target_mask" in rb else None
            i = int(hits[0, 0]) if hits is not None and len(hits) else 0
            rb["target_rgb"] = rb["target_rgb"].clone()
            rb["target_rgb"][:, i] -= 0.1  # to the L1 term, the render's rgb + 0.1
            return loss(rb, samples, draws, generator, it)
        fns["loss_with_samples"] = loss_altered
    elif fault == "shifted_samples":
        sample = fns["depth_sample"]

        def sample_shifted(rb, draws):
            return framework(cfg).shifted(cfg, sample(rb, draws))
        fns["depth_sample"] = sample_shifted
    else:
        raise KeyError(fault)
    return fns, optimizer


def apply_frame(fault, frame: dict, rayschunk: int) -> dict:
    """A rendered frame (host arrays) with `fault` planted."""
    if fault is None:
        return frame
    if fault != "altered_answer":
        raise KeyError(fault)
    frame["rgb"] = frame["rgb"].copy()
    frame["rgb"][:rayschunk] += 0.1
    return frame

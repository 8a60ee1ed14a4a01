"""Shared pieces of the benchmark's own tests (run with `pytest benchmark/`;
the tests that need a card are marked `cuda` and skip without one)."""
from __future__ import annotations

import pytest
import torch

from benchmark.registry import Bench, framework


def shrink(cell):
    """`cell` at a size the CPU runs in seconds: a 4-layer surface of width
    32, 16 rays a step, 4 images of 24x32, 2 frames of 12x16, and the
    framework's own keys as its `shrink` sets them. Only for the plain path
    on the CPU; the cells run at their published widths."""
    c = cell.cfg
    c["scene"].update(n_images=4, H=24, W=32)
    m = c["model"]
    m["surface"].update(D=4, W=32, skips=[2], embed_multires=2)
    m["radiance"].update(D=2, W=32)
    m["W_geometry_feature"] = 32
    c["data"]["N_rays"] = 16
    framework(c).shrink(m)
    cell.traffic.update(trace_units=2, check_rays=64, rayschunk=100, frames=2, downscale=2)
    return cell


@pytest.fixture
def small_cell():
    return lambda name: shrink(Bench().cell(name))


@pytest.fixture
def card():
    """The card, or a skip (decided inside the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

"""The check that decides `correct`, driven as a run drives it (the look for
a card skipped, the cells shrunk to the CPU's size, the program on its plain
path) with the cells' own limits: a sound run passes; the control (the
reference in TF32, in the program's place) fails one of the numbers; and so
does each fault planted under the timed path (`faults.py`). On a card, the
control at the cells' own sizes (marked `cuda`)."""
from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, faults, mixes
from benchmark.reference import volsdf
from benchmark.registry import Bench
from benchmark.run import execute

CPU = torch.device("cpu")
CELLS = ("neus.train", "volsdf.train", "neus.render")


def fails(cell, readings: dict) -> bool:
    return any(readings[k] > limit for k, limit in cell.limits.items())


@pytest.mark.parametrize("seed", [11, 2**31 + 5])
@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_cell, name, seed):
    out = execute(small_cell(name), seed, 0.3, False, CPU, 0.0)
    assert out["correct"] is True, out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(small_cell(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(small_cell, name):
    cell = small_cell(name)
    for seed in (1, 2, 3):
        mix, _, got = calibrate.readings(cell, seed, CPU, 0.3)
        ctl = mix.reference(tf32=True)
        control = mixes.READINGS[cell.traffic["kind"]](ctl, calibrate.follow_reference(mix, ctl))
        assert not fails(cell, got)
        assert fails(cell, control), control


FAULTS = [(c, f) for c in CELLS
          for f in (faults.TRAIN if c.endswith(".train") else faults.RENDER)]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(small_cell, name, fault):
    for seed in (4, 5):
        out = execute(small_cell(name), seed, 0.3, False, CPU, 0.0, fault=fault)
        assert out["correct"] is False, (fault, out["checks"])


def test_eikonal_sample_off_a_tie_is_not_correct(small_cell, monkeypatch):
    """A VolSDF program whose loss takes one ray's eikonal point at a sample
    that is not tied with the ray's largest visibility weight fails: the
    reference takes the program's sample only at a near-tie. The program
    here is the reference made to take the moved sample whatever its
    weight."""
    cell = small_cell("volsdf.train")
    mix = mixes.make(cell.cfg, cell.traffic, 6, CPU)
    mix.setup()
    mix.release()
    assert not fails(cell, mix.check())
    moved = [dict(f) for f in mix.prog["follow"]]
    ind = moved[0]["eik_ind"].clone()
    ind[0] = 1 if int(ind[0]) == 0 else 0  # a ray's first sample: far from its surface
    moved[0]["eik_ind"] = ind
    with monkeypatch.context() as m:
        m.setattr(volsdf, "TIE", float("inf"))
        bad = mix.reference(follow=moved)
    assert bad["ties"] == 1
    bad.update(follow=moved, samples=mix.prog["samples"])
    ref = mix.reference(follow=moved)
    assert ref["ties"] == 0
    assert fails(cell, mixes.train_readings(bad, ref)), mixes.train_readings(bad, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_cell_size(card, name):
    cell = Bench().cell(name)
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        mix, _, got = calibrate.readings(cell, seed, card, 3.0)
        ctl = mix.reference(tf32=True)
        control = mixes.READINGS[cell.traffic["kind"]](ctl, calibrate.follow_reference(mix, ctl))
        assert not fails(cell, got), got
        assert fails(cell, control), control

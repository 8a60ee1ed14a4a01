"""Pieces of the reference and the check against their definitions: the
learning-rate schedules against the program's `make_schedule`, the rule by
which the VolSDF reference takes the program's eikonal sample at a
near-tie, the components of a change that Adam moves by round-off, which
alone the reference takes from the program's state, and the lookup of a
framework's module."""
from __future__ import annotations

import copy
import json

import pytest
import torch

from benchmark import mixes
from benchmark.reference import step, volsdf
from benchmark.reference.step import lr_factor
from benchmark.registry import HERE, framework

CPU = torch.device("cpu")

STEPS = [0, 1, 2, 3, 499, 500, 501, 99_999, 100_000, 100_001, 199_999, 200_000, 200_001,
         299_999, 300_000, 399_999, 400_000, 400_001, 449_999, 450_000, 500_000]


def _unisurf_training() -> dict:
    """The training block of the repo's `configs/unisurf.yaml` (neurecon's)."""
    from neurecon_tpu_torch.config import load_yaml

    return dict(load_yaml(str(HERE.parent / "configs" / "unisurf.yaml"))["training"])


def _bench_training(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["training"]


@pytest.mark.parametrize("source", ["unisurf", "neus", "volsdf"])
def test_lr_factor_is_the_programs_schedule(source):
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import make_schedule

    training = _unisurf_training() if source == "unisurf" else _bench_training(source)
    factor = make_schedule(ConfigDict({"training": copy.deepcopy(training)}))
    got = [lr_factor(training, s) for s in STEPS]
    assert got == [factor(s) for s in STEPS]
    if source == "unisurf":  # gamma 0.5 at 200,000 and 400,000, in float32
        assert training["scheduler"]["milestones"] == [200_000, 400_000]
        by_step = dict(zip(STEPS, got))
        assert by_step[199_999] == 1.0 and by_step[200_000] == 0.5
        assert by_step[399_999] == 0.5 and by_step[400_000] == 0.25 == by_step[450_000]


def test_eikonal_index_takes_the_program_only_at_a_near_tie():
    tau = torch.tensor([[0.1, 0.50000, 0.49997, 0.0],    # 6e-5 below the top: a tie
                        [0.1, 0.50000, 0.49990, 0.0],    # 2e-4 below: not
                        [0.2, 0.30000, 0.30000, 0.1],    # equal
                        [0.9, 0.05000, 0.05000, 0.0]])
    own, ties = volsdf.eikonal_index(tau)
    assert own.tolist() == [1, 1, 1, 0] and ties == 0
    got, ties = volsdf.eikonal_index(tau, torch.tensor([2, 2, 2, 1]))
    assert got.tolist() == [2, 1, 2, 0] and ties == 2
    got, ties = volsdf.eikonal_index(tau, own)
    assert got.tolist() == own.tolist() and ties == 0
    # a program that sampled other rays (half its batch) is read against the reference's own
    got, ties = volsdf.eikonal_index(tau, torch.tensor([2, 2]))
    assert got.tolist() == own.tolist() and ties == 0


def test_change_leaves_out_what_adam_moves_by_round_off():
    """A component whose reference first gradient is under 10 Adam eps moves
    by lr g / (|g| + eps): rounding of g at 1e-8 turns its step around, and
    only that component's gap is left out of `change_gap`."""
    lr = 5e-4
    g_ref = torch.tensor([3e-3, -2e-5, 6e-9, 1e-6])
    g_prog = torch.tensor([3e-3, -2e-5, -6e-9, 1e-6])
    move = {k: -lr * g / (g.abs() + step.ADAM_EPS) for k, g in (("p", g_prog), ("r", g_ref))}
    kept = mixes.settled({"b": move["p"]}, {"b": g_ref})["b"]
    assert kept.tolist() == move["p"][[0, 1, 3]].tolist()
    prog = {"grads": {"b": g_prog}, "change": {"b": move["p"]}, "losses": [1.0],
            "samples": [torch.zeros(2, 3)], "rgb": [torch.zeros(2, 3)]}
    ref = dict(prog, grads={"b": g_ref}, change={"b": move["r"]})
    assert abs(float(move["p"][2] - move["r"][2])) > lr / 2
    assert mixes.train_readings(prog, ref)["change_gap"] < 1e-6
    move["p"][1] *= 0.5  # a settled component that moved half as far is seen
    assert mixes.train_readings(prog, ref)["change_gap"] > 1e-2


def _first_component(grads: dict) -> dict:
    masks = {k: torch.zeros_like(g, dtype=torch.bool) for k, g in grads.items()}
    for m in masks.values():
        m.view(-1)[0] = True
    return masks


@pytest.mark.parametrize("name", ["neus.train", "volsdf.train"])
def test_reference_takes_only_round_off_values_from_the_program(small_cell, monkeypatch, name):
    """From the second step on, the reference takes the program's values of
    the components whose first gradient is at round-off (here, by a rule
    patched in, the first component of every leaf) and keeps its own state
    everywhere else: a program state that is off elsewhere changes nothing
    of the reference, and one that is off there changes it."""
    monkeypatch.setattr(step, "round_off", _first_component)
    cell = small_cell(name)
    mix = mixes.make(cell.cfg, cell.traffic, 7, CPU)
    mix.setup()
    mix.release()
    base = mix.reference(follow=mix.prog["follow"])
    loose = _first_component(base["grads"])
    assert base["adopted"] == len(loose) * (len(mix.steps) - 1)

    def shifted(where):
        return [dict(f, params={k: v + 0.5 * where(loose[k]) for k, v in f["params"].items()})
                for f in mix.prog["follow"]]

    got = mix.reference(follow=shifted(lambda m: ~m))
    assert got["losses"] == base["losses"]
    assert all(map(torch.equal, got["samples"] + got["rgb"], base["samples"] + base["rgb"]))
    assert all(torch.equal(got["change"][k], v) for k, v in base["change"].items())
    got = mix.reference(follow=shifted(lambda m: m))
    assert got["losses"][0] == base["losses"][0] and got["losses"][1:] != base["losses"][1:]
    for k, m in loose.items():
        gap = got["change"][k][m] - base["change"][k][m]
        assert torch.allclose(gap, torch.full_like(gap, 0.5), atol=0.01), k


@pytest.mark.parametrize("shared", ["nets", "step", "sampling"])
def test_shared_module_is_not_a_framework(shared):
    with pytest.raises(ValueError, match=f"framework '{shared}'"):
        framework({"model": {"framework": shared}})

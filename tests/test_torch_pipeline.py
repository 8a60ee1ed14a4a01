"""The pipelined training step (`training.overlap_sampler`,
`training.make_pipelined_train_step`) on the CPU.

For NeuS (object mask and mask_ignore), VolSDF (builtin background,
mask_ignore) and UNISURF at W=64 on 64 rays: K = 3 pipelined steps against
the JAX package's pipelined block (`make_sharded_train_block(pipeline_fns=
...)` on a one-device CPU mesh) on the same weights (`bridge.py`), JAX's
ray batches and JAX's uniforms through the seams, and the same lr; steps 2
and 3 sample against the parameters before the update of the step ahead of
them. With lr 0 the pipelined step is bit-equal to the standard one, and so
is K = 1 at any lr. `tools/mutants.py`'s `PIPELINE_MUTANTS` (the sampler
run after Adam) must fail the JAX comparison. Two ranks against one rank
are in `tests/test_torch_parallel.py`, whose spawned ranks run them.
"""
import copy
import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.config import ConfigDict as JaxConfigDict
from neurecon_tpu.dataio import get_data as jax_get_data
from neurecon_tpu.models.base import make_optimizer as jax_make_optimizer
from neurecon_tpu.models.frameworks import get_model as jax_get_model
from neurecon_tpu.models.frameworks import get_pipeline_fns as jax_get_pipeline_fns
from neurecon_tpu.models.frameworks import get_ray_loss_fn as jax_get_ray_loss_fn
from neurecon_tpu.parallel import make_mesh
from neurecon_tpu.parallel.sharding import make_sharded_train_block
from neurecon_tpu.training import TrainState
from neurecon_tpu.training import sample_ray_batch as jax_sample_ray_batch

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.config import ConfigDict
from neurecon_tpu_torch.models.base import make_optimizer, perturb_parameters
from neurecon_tpu_torch.models.frameworks import get_model, get_pipeline_fns, make_trainer
from neurecon_tpu_torch.training import make_pipelined_train_step, make_train_step
from tests.test_torch_parallel import (PARAM_MAX, PARAM_MOVED, PARAM_SHARE, _case_batch,
                                       _case_cfg, _leaves, _paths)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 3
N = 64
CASES = ("neus_mask", "volsdf_mask", "unisurf")
# each loss term of the last step, relative to the total loss (earlier
# slices' 1e-5): UNISURF's loss_reg (~2e-6, a difference of nearly equal
# unit normals) carries fp32 noise of ~5e-5 of itself, below 1e-10 of the
# total
LOSS_REL = 1e-5
# lr of the JAX comparison: one step's staleness of the samples moves the
# last step's losses by 6.6e-4 (VolSDF), 2.9e-3 (UNISURF) and 7.3e-2 (NeuS)
# of the total at it, 66 to 7,314 times LOSS_REL, while the port and JAX
# agree within 1.9e-6 (`report`)
LR = 1e-3


def _cfg(case, lr=LR):
    """The case at W=64 on 64 rays (`test_torch_parallel._case_cfg`), at a
    constant lr (a multistep schedule whose milestone is never reached)."""
    cfg = _case_cfg(case)
    cfg["training"]["lr"] = lr
    cfg["training"]["scheduler"] = {"type": "multistep", "milestones": [1000], "gamma": 0.5}
    return cfg


def _t(x):
    return torch.tensor(np.asarray(x))


def _round_uniforms(key, n, n_iters, n_per):
    """The per-round uniforms JAX's NeuS upsampler draws from `key`, each
    round sorted (`tests/test_torch_kernels.py`)."""
    us = []
    for _ in range(n_iters):
        key, sub = jax.random.split(key)
        us.append(np.sort(np.asarray(jax.random.uniform(sub, (n, n_per))), -1))
    return np.concatenate(us, -1).astype(np.float32)


def jax_draws(case, cfg, k_render, n=N):
    """The uniforms JAX's pipelined step draws from a step's render key, in
    the port's seams: NeuS's `u_up`; VolSDF's `eik_pts` and `u_fin`;
    UNISURF's `uniforms`."""
    m = cfg["model"]
    if case.startswith("neus"):
        key_up, _ = jax.random.split(k_render)
        it = m["N_upsample_iters"]
        return {"u_up": _t(_round_uniforms(key_up, n, it, m["N_importance"] // it))}
    if case.startswith("volsdf"):
        k_fine_parent, k_eik = jax.random.split(k_render)
        box = float(m["obj_bounding_radius"])
        eik = jax.random.uniform(k_eik, (1, n, 1, 3), jnp.float32, -box, box)
        key_fine, _ = jax.random.split(k_fine_parent)
        keys = jax.random.split(key_fine, m["max_upsample_iter"] + 2)
        u = [np.asarray(jax.random.uniform(k, (n, m["N_importance"]))) for k in keys]
        return {"eik_pts": _t(eik).reshape(n, 1, 3), "u_fin": _t(np.concatenate(u, -1))}
    k_r, _ = jax.random.split(k_render)
    k_int, k_free = jax.random.split(k_r)
    k_reg = jax.random.fold_in(k_r, 7)
    return (_t(jax.random.uniform(k_int, (n, m["N_query"]))),
            _t(jax.random.uniform(k_free, (n, m["N_freespace"]))),
            _t(jax.random.uniform(k_reg, (n, 3))))


def _inputs(case, cfg):
    """The port's model with seeded noise on every weight, its JAX twin, K
    ray batches drawn by JAX from the case's scene, and the key."""
    targs = ConfigDict(copy.deepcopy(cfg))
    tm, tkw, _, _ = get_model(targs, "cpu", seed=0)
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    jm, _, jkw, _, _ = jax_get_model(jargs)
    ds = jax_get_data(jargs)
    batch, H, W = _case_batch(case, cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    rbs = [jax_sample_ray_batch(jax.random.PRNGKey(10 + i), jbatch, H, W, N) for i in range(K)]
    for kw in (tkw, jkw):
        kw["H"], kw["W"] = ds.H, ds.W
    return targs, tm, tkw, jargs, jm, jkw, rbs, jax.random.PRNGKey(7)


def run_jax(case, cfg, inputs):
    """The JAX package's K-step pipelined block: the last step's losses and
    the parameters after it."""
    targs, tm, tkw, jargs, jm, jkw, rbs, key = inputs
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(tm))
    opt = jax_make_optimizer(jargs, params)
    data = {k: jnp.stack([rb[k] for rb in rbs]) for k in rbs[0]}
    block = make_sharded_train_block(
        jax_get_ray_loss_fn(jargs, jm, jkw), opt, make_mesh(1),
        lambda d, idx, k: {n: v[idx] for n, v in d.items()},
        pipeline_fns=jax_get_pipeline_fns(jargs, jm, jkw))
    state = TrainState(params=params, opt_state=opt.init(params), step=jnp.asarray(0, jnp.int32))
    state, last = block(state, data, jnp.arange(K), key)
    return ({k: float(v) for k, v in last["losses"].items()},
            jax.tree_util.tree_map(np.asarray, state.params))


def run_port(case, cfg, inputs, training_module=None, pipelined=True, k=K):
    """K steps of the port's pipelined step (`training_module`'s: a mutated
    copy where given) on JAX's ray batches and draws, every step but the
    last handing on its successor's batch (a group of `k`); or, with
    `pipelined` off, the standard step on the same draws. Returns each
    step's losses and the parameters after the last."""
    targs, tm, tkw, _, _, _, rbs, key = inputs
    tm = copy.deepcopy(tm)
    keys = jax.random.split(key, K)
    draws = [jax_draws(case, cfg, jax.random.split(keys[i])[1]) for i in range(K)]
    rbs_t = [{n: _t(v) for n, v in rb.items()} for rb in rbs]
    opt, sched = make_optimizer(targs, tm)
    batches = [{"i": i} for i in range(K)]
    if pipelined:
        fns = dict(get_pipeline_fns(targs, tm, tkw),
                   draw_step=lambda b, g: (rbs_t[b["i"]], draws[b["i"]]))
        mod = training_module or sys.modules["neurecon_tpu_torch.training"]
        step = mod.make_pipelined_train_step(fns, tm, opt, sched)
    else:
        from neurecon_tpu_torch.models.frameworks import get_ray_loss_fn
        ray_loss = get_ray_loss_fn(targs, tm, tkw)

        def loss_fn(b, g, it):
            d = draws[b["i"]]
            return ray_loss(rbs_t[b["i"]], g, it,
                            **(d if isinstance(d, dict) else {"uniforms": d}))
        step = make_train_step(loss_fn, tm, opt, sched)
    losses = []
    for i in range(K):
        if pipelined:
            nxt = batches[i + 1] if (i + 1) % k and i + 1 < K else None
            m = step(batches[i], None, i, next_batch=nxt)
        else:
            m = step(batches[i], None, i)
        losses.append({n: v.item() for n, v in m["losses"].items()})
    return losses, bridge.model_to_tree(tm)


def _params_gap(got, want, p0):
    """(worst share of a leaf's elements beyond PARAM_MOVED of the leaf's
    move, worst max|diff| over the move) against the JAX parameters."""
    share = worst = 0.0
    for g, w, a in zip(_leaves(got), _leaves(want), _leaves(p0)):
        moved = np.abs(w - a).max()
        share = max(share, float((np.abs(g - w) > PARAM_MOVED * moved + 1e-12).mean()))
        worst = max(worst, float(np.abs(g - w).max() / (moved + 1e-30)))
    return share, worst


def _loss_gap(got, want):
    """The worst loss term's gap, over the total loss."""
    return max(abs(got[k] - v) for k, v in want.items()) / abs(want["total"])


@pytest.fixture(scope="module")
def jax_runs():
    torch.set_num_threads(1)  # small tensors: threads only contend with the other workers
    out = {}
    for case in CASES:
        cfg = _cfg(case)
        inputs = _inputs(case, cfg)
        out[case] = (cfg, inputs, run_jax(case, cfg, inputs))
    return out


@pytest.mark.parametrize("case", CASES)
def test_pipelined_steps_match_jax_block(case, jax_runs):
    """The last step's every loss term within 1e-5 of the JAX block's total
    loss, and every parameter leaf within the ranks tests' Adam bounds (at most 1% of its
    elements beyond 1e-3 of how far the JAX leaf moved, none beyond 0.1)."""
    cfg, inputs, (want_losses, want_params) = jax_runs[case]
    losses, params = run_port(case, cfg, inputs)
    assert set(losses[-1]) == set(want_losses)
    assert _loss_gap(losses[-1], want_losses) <= LOSS_REL, (losses[-1], want_losses)
    p0 = bridge.model_to_tree(inputs[1])
    for path, g, w, a in zip(_paths(want_params), _leaves(params), _leaves(want_params),
                             _leaves(p0)):
        moved = np.abs(w - a).max()
        assert moved > 0, path
        off = np.abs(g - w) > PARAM_MOVED * moved + 1e-12
        assert off.mean() <= PARAM_SHARE, (path, off.mean())
        assert np.abs(g - w).max() <= PARAM_MAX * moved + 1e-12, path


def _mutant_training(tmp, name):
    """`neurecon_tpu_torch/training.py` with the mutant's edit, loaded as a
    module of its own (the rest of the package is the real one)."""
    from neurecon_tpu_torch.tools.mutants import PIPELINE_MUTANTS

    rel, text, repl = PIPELINE_MUTANTS[name]
    with open(os.path.join(REPO, "neurecon_tpu_torch", rel)) as f:
        src = f.read()
    assert src.count(text) == 1
    path = os.path.join(str(tmp), "training_mutant.py")
    with open(path, "w") as f:
        f.write(src.replace(text, repl))
    spec = importlib.util.spec_from_file_location("training_mutant", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", CASES)
def test_post_update_sampler_mutant_fails_jax_block(case, jax_runs, tmp_path):
    """The mutant samples the next step's depths after Adam (fresh, as the
    standard step does): its last step's losses leave the JAX block's by
    more than 30 times LOSS_REL (`report` prints by how much: 66 times and
    more)."""
    cfg, inputs, (want_losses, _) = jax_runs[case]
    mod = _mutant_training(tmp_path, "sample_after_update")
    losses, _ = run_port(case, cfg, inputs, training_module=mod)
    assert _loss_gap(losses[-1], want_losses) > 30 * LOSS_REL


@pytest.mark.parametrize("case", CASES)
def test_lr0_pipelined_equals_standard_bitwise(case):
    """With lr 0 the pipelined step samples against the same parameters as
    the standard step: every loss and every parameter bit-equal."""
    cfg = _cfg(case, lr=0.0)
    inputs = _inputs(case, cfg)
    a_losses, a_params = run_port(case, cfg, inputs)
    b_losses, b_params = run_port(case, cfg, inputs, pipelined=False)
    assert a_losses == b_losses
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(a_params), _leaves(b_params)))


@pytest.mark.parametrize("case", CASES)
def test_groups_of_one_equal_standard_bitwise(case):
    """K = 1 (no call hands on a batch): every step samples fresh, and the
    run is bit-equal to the standard step at a non-zero lr."""
    cfg = _cfg(case)
    inputs = _inputs(case, cfg)
    a_losses, a_params = run_port(case, cfg, inputs, k=1)
    b_losses, b_params = run_port(case, cfg, inputs, pipelined=False)
    assert a_losses == b_losses
    assert all(np.array_equal(x, y) for x, y in zip(_leaves(a_params), _leaves(b_params)))


def test_pipelined_draws_equal_standard_draws():
    """Through the framework's own draws (`make_trainer` against
    `make_pipeline_fns`' draw_step) on one image, lr 0, steps_per_call 3:
    the pipelined step draws the same pixels and uniforms in the same order
    from the generator, so the losses are bit-equal to `make_trainer`'s."""
    cfg = _cfg("neus_mask", lr=0.0)
    runs = []
    for pipelined in (False, True):
        args = ConfigDict(copy.deepcopy(cfg))
        model, kw, _, _ = get_model(args, "cpu", seed=0)
        batch, H, W = _case_batch("neus_mask", cfg)
        kw["H"], kw["W"] = H, W
        opt, sched = make_optimizer(args, model)
        gen = torch.Generator().manual_seed(1)
        bs = [dict(batch) for _ in range(4)]
        if pipelined:
            step = make_pipelined_train_step(get_pipeline_fns(args, model, kw), model, opt, sched)
            runs.append([step(bs[i], gen, i, next_batch=bs[i + 1] if i < 2 else None)
                         ["losses"]["total"].item() for i in range(4)])
        else:
            step = make_train_step(make_trainer(args, model, kw), model, opt, sched)
            runs.append([step(bs[i], gen, i)["losses"]["total"].item() for i in range(4)])
        assert gen.initial_seed() == 1
    assert runs[0] == runs[1]


def test_pipelined_step_refuses_another_batch():
    cfg = _cfg("neus_mask")
    args = ConfigDict(copy.deepcopy(cfg))
    model, kw, _, _ = get_model(args, "cpu", seed=0)
    batch, H, W = _case_batch("neus_mask", cfg)
    kw["H"], kw["W"] = H, W
    opt, sched = make_optimizer(args, model)
    step = make_pipelined_train_step(get_pipeline_fns(args, model, kw), model, opt, sched)
    gen = torch.Generator().manual_seed(1)
    step(batch, gen, 0, next_batch=dict(batch))
    with pytest.raises(ValueError, match="next_batch"):
        step(dict(batch), gen, 1)


def report():
    """Print the measures the tests above bound (PERF.md section 6): per
    framework, the port's last-step loss gap to the JAX block (relative) and
    the parameters' share beyond 1e-3 of their move with the worst ratio;
    the mutant's loss gap, as a multiple of LOSS_REL. From the repository
    root: `JAX_PLATFORMS=cpu python -c "from tests.test_torch_pipeline
    import report; report()"`."""
    import tempfile

    torch.set_num_threads(1)
    tmp = tempfile.mkdtemp(prefix="pipeline_report_")
    mod = _mutant_training(tmp, "sample_after_update")
    for case in CASES:
        cfg = _cfg(case)
        inputs = _inputs(case, cfg)
        want_losses, want_params = run_jax(case, cfg, inputs)
        losses, params = run_port(case, cfg, inputs)
        share, worst = _params_gap(params, want_params, bridge.model_to_tree(inputs[1]))
        bad, _ = run_port(case, cfg, inputs, training_module=mod)
        std, _ = run_port(case, cfg, inputs, pipelined=False)
        print(f"{case}: last-step loss rel {_loss_gap(losses[-1], want_losses):.2e}; parameters: "
              f"share beyond 1e-3 of the move {share:.4f}, worst {worst:.3e} of the move; "
              f"the post-update mutant {_loss_gap(bad[-1], want_losses):.2e} "
              f"({_loss_gap(bad[-1], want_losses) / LOSS_REL:.0f} x LOSS_REL); the standard "
              f"step {_loss_gap(std[-1], want_losses):.2e}")

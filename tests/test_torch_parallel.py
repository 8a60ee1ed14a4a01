"""The port's ray-parallel training and rendering over several ranks
(`neurecon_tpu_torch/parallel/`), on the CPU with gloo process groups.

w = 2 and w = 4 ranks against one rank for NeuS (object mask and
mask_ignore, whose counts differ between the blocks), NeuS without a mask
(the NeRF++ background), VolSDF with mask_ignore and UNISURF: the global
loss of each of 3 steps, every gradient leaf and the logged grad norms and
intermediates' stats of step 1, every parameter after 3 Adam steps. The two-
rank step against the JAX package's sharded step on a 2-device mesh, and a
mutant that averages the ranks' masked means against it. The sharded
validation render, `microchunk`, `init_env`, the launcher, and `train.py`
under two ranks.

Ranks are spawned processes that import this module, so it imports neither
JAX nor the port at module level: JAX is imported inside the tests that
need it, the port inside every function (a rank may run a mutated copy).
Each group of cases is one spawn, joined with a time limit.
"""
import copy
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_RAYS = 64
STEPS = 3
TIMEOUT = 120  # seconds a spawned group may take before it is killed
LOSS_REL = 1e-5  # each logged loss, relative (earlier slices' bound)
LEAF_REL = 5e-4  # each gradient leaf's max|diff| / max|ref| (earlier slices')
# each parameter leaf after 3 Adam steps, against how far the one-rank run
# moved it (max|p_3 - p_0|): at most 1% of its elements beyond 1e-3 of that
# (earlier slices' bound), none beyond 0.1. Adam's step g / (|g| + 1e-8)
# turns the rounding of a gradient element near 1e-8, summed from
# cancelling rays' terms in another order, into a visible share of a step:
# on the NeRF++ background's ReLU layers 0.39% of a leaf's elements are
# beyond 1e-3, the worst at 0.070; none beyond 1e-3 in the other cases
# (`report`)
PARAM_MOVED, PARAM_SHARE, PARAM_MAX = 1e-3, 0.01, 0.1


def _small_nets():
    return ({"D": 3, "W": 64, "skips": [1], "radius_init": 0.5, "embed_multires": 4},
            {"D": 2, "W": 64, "skips": [], "embed_multires": -1, "embed_multires_view": 2})


def _case_cfg(case):
    """Each framework case at W=64, 64 rays a step, perturb on (every draw of
    a step exercised), on a 24x32 synthetic scene."""
    surface, radiance = _small_nets()
    data = {"type": "synthetic", "downscale": 1, "n_images": 2, "H": 24, "W": 32,
            "N_rays": N_RAYS, "val_rayschunk": 256}
    sched = {"type": "warmupcosine", "warmup_steps": 2}
    if case in ("neus_mask", "neus_nerfpp"):
        masked = case == "neus_mask"
        if not masked:
            data["background"] = "envmap"
        return {"expname": case, "data": data,
                "model": {"framework": "NeuS", "obj_bounding_radius": 1.0,
                          "W_geometry_feature": 64, "N_samples": 16, "N_importance": 16,
                          "N_upsample_iters": 2, "N_outside": 0 if masked else 4,
                          "perturb": True, "surface": surface, "radiance": radiance},
                "training": {"with_mask": masked, "w_mask": 1.0, "w_eikonal": 0.1,
                             "speed_factor": 10.0, "lr": 5e-4, "num_iters": 20,
                             "scheduler": sched}}
    if case == "volsdf_mask":
        surface["radius_init"] = 1.0
        data.update({"scale_radius": 2.6, "near": 0.0, "far": 6.0})
        return {"expname": case, "data": data,
                "model": {"framework": "VolSDF", "obj_bounding_radius": 3.0,
                          "outside_scene": "builtin", "W_geometry_feature": 64,
                          "N_samples": 8, "N_importance": 8, "fine_sample_mul": 2,
                          "max_upsample_iter": 2, "perturb": True,
                          "surface": surface, "radiance": radiance},
                "training": {"w_eikonal": 0.1, "speed_factor": 10.0, "lr": 5e-4,
                             "num_iters": 20, "w_sdf_anchor": 0.1, "scheduler": sched}}
    assert case == "unisurf"
    surface["radius_init"] = 1.0
    return {"expname": case, "data": data,
            "model": {"framework": "UNISURF", "obj_bounding_radius": 4.0,
                      "W_geometry_feature": 64, "N_steps": 32, "N_query": 8,
                      "N_freespace": 8, "perturb": True, "tau": 0.5,
                      "surface": surface, "radiance": radiance},
            "training": {"lr": 1e-4, "num_iters": 20, "w_reg": 0.01,
                         "perturb_surface_pts": 0.01, "delta_max": 1.0, "delta_min": 0.05,
                         "delta_beta": 1.5e-05, "scheduler": sched}}


CASES = ("neus_mask", "neus_nerfpp", "volsdf_mask", "unisurf")


def _case_batch(case, cfg):
    """One image of the case's scene on the CPU, with a seeded mask_ignore
    (80% of the pixels kept) where the case reads one."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.dataio import get_data

    ds = get_data(ConfigDict(copy.deepcopy(cfg)))
    batch = {"c2w": torch.tensor(np.asarray(ds.c2w_all[:1], np.float32)),
             "intrinsics": torch.tensor(np.asarray(ds.intrinsics_all[:1], np.float32)),
             "rgb": torch.tensor(np.asarray(ds.rgb_images[:1], np.float32)).reshape(1, -1, 3)}
    if case == "neus_mask":
        batch["object_mask"] = torch.tensor(np.asarray(ds.object_masks[:1])).reshape(1, -1)
    if case in ("neus_mask", "volsdf_mask"):
        keep = np.random.RandomState(5).rand(1, ds.H * ds.W) < 0.8
        batch["mask_ignore"] = torch.tensor(keep)
    return batch, ds.H, ds.W


def run_case(case, group=None, pipelined=False):
    """STEPS training steps of a case through the framework's trainer and
    `make_train_step` over `group` (None: one rank); with `pipelined`,
    through its pipeline functions and `make_pipelined_train_step`, the
    STEPS steps one group (steps 2 and 3 sampled ahead). Ranks other than 0
    start from perturbed weights: the step's broadcast must replace them."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import make_optimizer, perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model, get_pipeline_fns, make_trainer
    from neurecon_tpu_torch.parallel import RayShard
    from neurecon_tpu_torch.training import make_pipelined_train_step, make_train_step

    cfg = _case_cfg(case)
    args = ConfigDict(copy.deepcopy(cfg))
    model, kw, _, _ = get_model(args, "cpu", seed=0)
    shard = RayShard(group)
    if shard.rank != 0:
        perturb_parameters(model, torch.Generator().manual_seed(9))
    batch, H, W = _case_batch(case, cfg)
    kw["H"], kw["W"] = H, W
    opt, sched = make_optimizer(args, model)
    own = bridge.model_to_tree(model)
    if pipelined:
        step = make_pipelined_train_step(get_pipeline_fns(args, model, kw, shard=shard), model,
                                         opt, sched, group=group)
    else:
        step = make_train_step(make_trainer(args, model, kw, shard=shard), model, opt, sched,
                               group=group)
    gen = torch.Generator().manual_seed(1)
    out = {"losses": [], "own": own, "p0": bridge.model_to_tree(model)}
    batches = [dict(batch) for _ in range(STEPS)]
    for i in range(STEPS):
        if pipelined:
            m = step(batches[i], gen, i, next_batch=batches[i + 1] if i + 1 < STEPS else None)
        else:
            m = step(batches[i], gen, i)
        out["losses"].append({k: v.item() for k, v in m["losses"].items()})
        if i == 0:
            out["grads"] = bridge.grads_to_tree(model)
            out["grad_norms"] = {k: v.item() for k, v in m["grad_norms"].items()}
            out["extras_stats"] = {k: v.item() for k, v in m["extras_stats"].items()}
    out["params"] = bridge.model_to_tree(model)
    return out


def _render_inputs():
    """The neus_mask model with seeded noise, det render kwargs, and the rays
    of a 24x32 view less one (767: no multiple of w x rayschunk)."""
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.ops import get_rays

    cfg = _case_cfg("neus_mask")
    model, _, kw_test, factory = get_model(ConfigDict(copy.deepcopy(cfg)), "cpu", seed=0)
    perturb_parameters(model, torch.Generator().manual_seed(2))
    batch, H, W = _case_batch("neus_mask", cfg)
    o, d, _ = get_rays(batch["c2w"][0], batch["intrinsics"][0], H, W)
    kw = {k: v for k, v in kw_test.items() if k not in ("H", "W", "rayschunk")}
    return factory(detailed_output=False, calc_normal=True, **kw), o[:-1], d[:-1]


def render_frame(group=None, microchunk=None, rayschunk=120):
    from neurecon_tpu_torch.training import render_full_image

    fn, o, d = _render_inputs()
    return render_full_image(fn, o, d, rayschunk=rayschunk, microchunk=microchunk,
                             group=group, generator=torch.Generator().manual_seed(0))


def _jax_inputs_path(tmp):
    return os.path.join(tmp, "jax_inputs.pkl")


def jax_case_port(group, tmp):
    """The port's sharded step on the JAX test's inputs (written by
    `_jax_reference`): the same weights, ray batch and samples d_all."""
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import make_optimizer
    from neurecon_tpu_torch.models.frameworks import get_model, get_ray_loss_fn
    from neurecon_tpu_torch.parallel import RayShard, make_sharded_train_step

    with open(_jax_inputs_path(tmp), "rb") as f:
        inp = pickle.load(f)
    args = ConfigDict(copy.deepcopy(inp["cfg"]))
    model, kw, _, _ = get_model(args, "cpu", seed=0)
    bridge.load_tree(model, inp["params"])
    opt, sched = make_optimizer(args, model)
    ray_loss = get_ray_loss_fn(args, model, kw, shard=RayShard(group))
    step = make_sharded_train_step(ray_loss, model, opt, sched, group=group)
    rb = {k: torch.tensor(v) for k, v in inp["rb"].items()}
    m = step(rb, None, 0, d_all=torch.tensor(inp["d_all"]))
    return {"losses": {k: v.item() for k, v in m["losses"].items()},
            "grads": bridge.grads_to_tree(model)}


def ddp_bridge(group):
    """The bridge through a DistributedDataParallel wrapper: its tree, its
    load and its gradients are the wrapped model's."""
    from torch.nn.parallel import DistributedDataParallel

    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.frameworks import get_model
    from neurecon_tpu_torch.training import grad_norms_by_module

    model, _, _, _ = get_model(ConfigDict(_case_cfg("neus_mask")), "cpu", seed=0)
    ddp = DistributedDataParallel(model, process_group=group)
    tree = bridge.model_to_tree(ddp)
    same = all(np.array_equal(a, b) for a, b in zip(_leaves(tree), _leaves(
        bridge.model_to_tree(model))))
    zero = {k: (np.zeros_like(v) if isinstance(v, np.ndarray) else v) for k, v in tree.items()}
    zero["implicit_surface"] = tree["implicit_surface"]
    zero["radiance_net"] = tree["radiance_net"]
    bridge.load_tree(ddp, zero)
    loaded = float(model.ln_s.detach()[0]) == 0.0
    model.ln_s.grad = torch.ones_like(model.ln_s)
    grads = bridge.grads_to_tree(ddp)["ln_s"].tolist() == [1.0]
    names = sorted(grad_norms_by_module(ddp)) == ["ln_s"]
    return {"tree": same, "load": loaded, "grads": grads, "grad_norm_names": names}


def seen(group):
    """What this rank sees of its environment."""
    from neurecon_tpu_torch.parallel import distributed

    return {"rank": distributed.get_rank(), "local_rank": distributed.get_local_rank(),
            "world": distributed.get_world_size(),
            "NEURECON_RANK": os.environ.get("NEURECON_RANK"),
            "device": (torch.cuda.current_device() if torch.cuda.is_available() else "cpu")}


def _writes_under(root, record):
    """An audit hook that records every write, directory made and file
    moved or removed under `root`."""
    root = os.path.realpath(root)
    write_bits = os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND | os.O_TRUNC

    def hook(event, args):
        path = None
        if event == "open" and args and isinstance(args[0], (str, bytes, os.PathLike)):
            mode, flags = args[1], args[2]
            if ((isinstance(mode, str) and any(c in mode for c in "wax+"))
                    or (isinstance(flags, int) and flags & write_bits)):
                path = args[0]
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove", "os.rmdir",
                       "shutil.copyfile", "os.symlink", "os.link"):
            path = args[1] if event in ("os.rename", "os.replace", "shutil.copyfile",
                                        "os.symlink", "os.link") else args[0]
        if path is not None and not isinstance(path, int):
            p = os.path.realpath(os.fsdecode(path))
            if p == root or p.startswith(root + os.sep):
                record.append((event, p))

    sys.addaudithook(hook)


def _train_yaml(tmp):
    """configs/synthetic_smoke.yaml cut to W=64 nets, 16 + 16 samples a ray
    and 24x32 images, written under `tmp`."""
    import yaml

    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    surface, radiance = _small_nets()
    cfg["data"].update({"H": 24, "W": 32, "n_images": 4, "val_downscale": 2})
    cfg["model"].update({"N_samples": 16, "N_importance": 16, "N_upsample_iters": 2,
                         "surface": surface, "radiance": radiance})
    cfg["training"]["scheduler"]["warmup_steps"] = 2
    path = os.path.join(tmp, "smoke_w64.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _train_argv(tmp, n_iters, n_rays=32):
    return ["--config", os.path.join(tmp, "smoke_w64.yaml"), "--device", "cpu",
            "--training:num_iters", str(n_iters),
            "--training:log_root_dir", os.path.join(tmp, "runs"),
            "--data:N_rays", str(n_rays), "--training:i_val", "2", "--training:i_log", "1",
            "--training:monitoring", "none"]


def _train_cfg(tmp, n_iters, n_rays=32, *extra):
    from neurecon_tpu_torch import train
    from neurecon_tpu_torch.config import parse_cli

    return parse_cli(argv=_train_argv(tmp, n_iters, n_rays) + list(extra),
                     extra_args_fn=train._extra_args)[0]


def train_two_ranks(group, tmp):
    """train.py on this rank: 4 steps (rank 1 recording any write under the
    experiment root), then a run whose N_rays does not split into the
    ranks' blocks, which must raise before any collective."""
    from neurecon_tpu_torch import train

    record = []
    if torch.distributed.get_rank() != 0:
        _writes_under(os.path.join(tmp, "runs"), record)
    out = train.main_function(_train_cfg(tmp, 4), device="cpu")
    totals = [v for _, v in out["stats"]["losses"]["total_per_step"]]
    try:
        train.main_function(_train_cfg(tmp, 2, n_rays=33), device="cpu")
        odd = None
    except ValueError as e:
        odd = str(e)
    over = _train_cfg(tmp, 4, 32, "--training:overlap_sampler", "true",
                      "--training:steps_per_call", "2")
    over.training["log_root_dir"] = os.path.join(tmp, "runs_overlap")
    over.training["exp_dir"] = os.path.join(tmp, "runs_overlap", "synthetic_smoke")
    over = train.main_function(over, device="cpu")
    return {"it": out["it"], "final_ckpt": out["final_ckpt"], "totals": totals,
            "writes": record, "odd": odd, "world": out["world"],
            "overlap_totals": [v for _, v in over["stats"]["losses"]["total_per_step"]]}


JOBS = {
    "cases": lambda g, tmp: {c: run_case(c, g) for c in CASES},
    "pipeline": lambda g, tmp: {c: run_case(c, g, pipelined=True) for c in CASES},
    "render": lambda g, tmp: {"plain": render_frame(g),
                              "micro": render_frame(g, microchunk=40)},
    "jax": jax_case_port,
    "ddp_bridge": lambda g, tmp: ddp_bridge(g),
    "seen": lambda g, tmp: seen(g),
    "train": train_two_ranks,
}


def _rank_main(rank, world, tmp, jobs, pkg_root):
    """One spawned rank: join the group through `init_env` (a file://
    rendezvous under `tmp`), run the jobs, pickle their results."""
    torch.set_num_threads(1)
    if pkg_root:
        sys.path.insert(0, pkg_root)  # a mutated copy of the package
    os.environ.update({"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"})
    result = {}
    try:
        from neurecon_tpu_torch.parallel import distributed
        distributed.init_env(device="cpu", init_method="file://" + os.path.join(tmp, "rdv"))
        group = distributed.process_group()
        for job in jobs:
            result[job] = JOBS[job](group, tmp)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    except BaseException:
        result["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    sys.exit(1 if "error" in result else 0)


def spawn_start(world, jobs, tmp, pkg_root=None):
    """Start `jobs` on `world` spawned ranks; `spawn_join` collects them."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, jobs, pkg_root))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, tmp, time.monotonic() + TIMEOUT


def spawn_join(started):
    """Each rank's results. A rank still running TIMEOUT seconds after the
    start is killed and fails the caller, as does a rank's error."""
    procs, tmp, deadline = started
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"ranks {hung} still running after {TIMEOUT} s"
    out = []
    for r in range(len(procs)):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {r}:\n{res['error']}"
        out.append(res)
    return out


def spawn(world, jobs, tmp, pkg_root=None):
    return spawn_join(spawn_start(world, jobs, tmp, pkg_root))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


# ---- the spawned groups, once per module ----

@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every spawned group of the module, started at once: the 4-rank cases,
    the two-rank train.py runs, then (after the JAX reference, whose inputs
    they read) the 2-rank cases and the mutant's; the one-rank cases run
    here meanwhile."""
    t4, tt, t2 = (str(tmp_path_factory.mktemp(n)) for n in ("ranks4", "train2", "ranks2"))
    _train_yaml(tt)
    groups = {"ranks4": spawn_start(4, ["seen", "cases", "render"], t4),
              "train2": spawn_start(2, ["train"], tt)}
    _jax_reference(t2)
    groups["ranks2"] = spawn_start(2, ["seen", "cases", "render", "jax", "ddp_bridge",
                                       "pipeline"], t2)
    tm = str(tmp_path_factory.mktemp("mutant"))
    shutil.copy(_jax_inputs_path(t2), _jax_inputs_path(tm))
    groups["mutant"] = spawn_start(2, ["jax"], tm, pkg_root=_mutated_copy(tm))
    torch.set_num_threads(1)
    refs = {c: run_case(c) for c in CASES}
    refs.update({("pipeline", c): run_case(c, pipelined=True) for c in CASES})
    yield groups, refs
    for procs, _, _ in groups.values():
        for p in procs:
            if p.is_alive():
                p.kill()


@pytest.fixture(scope="module")
def ref_cases(started):
    return started[1]


@pytest.fixture(scope="module")
def ranks2(started):
    return spawn_join(started[0]["ranks2"]), started[0]["ranks2"][1]


@pytest.fixture(scope="module")
def ranks4(started):
    return spawn_join(started[0]["ranks4"])


@pytest.fixture
def ranks(request, ranks2, ranks4):
    return {2: ranks2[0], 4: ranks4}[request.param]


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_losses_match_one_rank(ranks, case, ref_cases):
    """The global loss of each of 3 steps, every term, on every rank."""
    ref = ref_cases[case]["losses"]
    for res in ranks:
        got = res["cases"][case]["losses"]
        for i in range(STEPS):
            for k, want in ref[i].items():
                assert abs(got[i][k] - want) <= LOSS_REL * abs(want) + 1e-12, (i, k)


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_gradients_and_stats_match_one_rank(ranks, case, ref_cases):
    """Every gradient leaf of step 1 (5e-4 of max|ref|), the logged grad
    norms (rel 1e-5), and the intermediates' mean / min / max / norm (rel
    1e-5), on every rank."""
    ref = ref_cases[case]
    for res in ranks:
        got = res["cases"][case]
        for path, g, r in zip(_paths(ref["grads"]), _leaves(got["grads"]),
                              _leaves(ref["grads"])):
            assert _rel(g, r) <= LEAF_REL, (path, _rel(g, r))
        assert set(got["grad_norms"]) == set(ref["grad_norms"])
        for k, want in ref["grad_norms"].items():
            assert abs(got["grad_norms"][k] - want) <= LOSS_REL * want, k
        assert set(got["extras_stats"]) == set(ref["extras_stats"]) != set()
        for k, want in ref["extras_stats"].items():
            assert abs(got["extras_stats"][k] - want) <= LOSS_REL * abs(want) + 1e-7, k


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
@pytest.mark.parametrize("case", CASES)
def test_parameters_after_adam_match_one_rank(ranks, case, ref_cases):
    """Every parameter leaf after 3 Adam steps: at most 1% of its elements
    beyond 1e-3 of how far the leaf moved, none beyond 0.1; the ranks hold the same parameters bit for bit, though ranks other than
    0 started from other weights (the broadcast replaced them)."""
    ref = ref_cases[case]
    p0 = _leaves(ref["p0"])
    for res in ranks:
        got = res["cases"][case]
        for path, g, r, a in zip(_paths(ref["params"]), _leaves(got["params"]),
                                 _leaves(ref["params"]), p0):
            moved = np.abs(r - a).max()
            off = np.abs(g - r) > PARAM_MOVED * moved + 1e-12
            assert off.mean() <= PARAM_SHARE, (path, off.mean())
            assert np.abs(g - r).max() <= PARAM_MAX * moved + 1e-12, path
        for a, b in zip(_leaves(got["params"]), _leaves(ranks[0]["cases"][case]["params"])):
            assert np.array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(
        _leaves(ranks[-1]["cases"][case]["own"]), p0))


@pytest.mark.parametrize("case", CASES)
def test_pipelined_two_ranks_match_one_rank(case, ranks2, ref_cases):
    """The pipelined step (`make_pipelined_train_step`, 3 steps in one
    group) on two ranks, each sampling ahead on its block of the global
    draws, against one rank: each step's losses (rel 1e-5) and every
    parameter after the 3 steps (the Adam bounds above), the two ranks
    bit-equal."""
    ref = ref_cases[("pipeline", case)]
    p0 = _leaves(ref["p0"])
    res = ranks2[0]
    for r in res:
        got = r["pipeline"][case]
        for i in range(STEPS):
            for k, want in ref["losses"][i].items():
                assert abs(got["losses"][i][k] - want) <= LOSS_REL * abs(want) + 1e-12, (i, k)
        for path, g, w, a in zip(_paths(ref["params"]), _leaves(got["params"]),
                                 _leaves(ref["params"]), p0):
            moved = np.abs(w - a).max()
            off = np.abs(g - w) > PARAM_MOVED * moved + 1e-12
            assert off.mean() <= PARAM_SHARE, (path, off.mean())
            assert np.abs(g - w).max() <= PARAM_MAX * moved + 1e-12, path
    for a, b in zip(_leaves(res[0]["pipeline"][case]["params"]),
                    _leaves(res[1]["pipeline"][case]["params"])):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_each_rank_sees_its_place(ranks):
    """init_env under launcher variables: each rank's rank, local rank,
    world and NEURECON_RANK (a card's index is not seen on the CPU)."""
    w = len(ranks)
    for r, res in enumerate(ranks):
        assert res["seen"] == {"rank": r, "local_rank": r, "world": w,
                               "NEURECON_RANK": str(r), "device": "cpu"}


@pytest.mark.parametrize("ranks", [2, 4], indirect=True)
def test_sharded_render_matches_one_rank(ranks):
    """A deterministic 767-ray NeuS frame, rayschunk 120 (a multiple of the
    world size; the last chunk padded), split over the ranks by pixel,
    with and without microchunk 40, equals the one-rank frame on every
    rank (atol 1e-6: the blocks' fp32 sums differ only in batch size)."""
    torch.set_num_threads(1)
    want = render_frame()
    assert want["rgb"].shape == (767, 3)
    for res in ranks:
        for got in (res["render"]["plain"], res["render"]["micro"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_microchunk_render_and_its_multiple():
    """microchunk blocks within each chunk give the frame of whole chunks;
    a chunk that is not a multiple of the block raises."""
    torch.set_num_threads(1)
    want = render_frame()
    got = render_frame(microchunk=30)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    with pytest.raises(ValueError, match="multiple of microchunk"):
        render_frame(microchunk=50)


def test_ddp_wrapper_reads_as_the_model(ranks2):
    for res in ranks2[0]:
        assert res["ddp_bridge"] == {"tree": True, "load": True, "grads": True,
                                     "grad_norm_names": True}


# ---- the port's two ranks against the JAX package's sharded step ----

def _jax_reference(tmp):
    """NeuS with the object mask and mask_ignore at W=64 on 64 rays: the
    inputs (weights with seeded noise, JAX's ray batch and samples d_all),
    written for the port's ranks, and the JAX package's sharded step on a
    2-device mesh on them (its gradients kept as the optimizer state)."""
    import jax
    import jax.numpy as jnp
    import optax

    from neurecon_tpu.config import ConfigDict as JaxConfigDict
    from neurecon_tpu.dataio import get_data as jax_get_data
    from neurecon_tpu.models.frameworks.neus import compute_ray_samples
    from neurecon_tpu.models.frameworks.neus import get_model as jax_get_model
    from neurecon_tpu.models.frameworks.neus import make_ray_loss_fn as jax_ray_loss_fn
    from neurecon_tpu.parallel import make_mesh, make_sharded_train_step, shard_rays
    from neurecon_tpu.training import TrainState
    from neurecon_tpu.training import sample_ray_batch as jax_sample_ray_batch

    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.config import ConfigDict
    from neurecon_tpu_torch.models.base import perturb_parameters
    from neurecon_tpu_torch.models.frameworks import get_model

    cfg = _case_cfg("neus_mask")
    cfg["model"]["perturb"] = False
    jargs = JaxConfigDict(copy.deepcopy(cfg))
    jm, _, jkw, _, _ = jax_get_model(jargs)
    tm, _, _, _ = get_model(ConfigDict(copy.deepcopy(cfg)), "cpu", seed=0)
    perturb_parameters(tm, torch.Generator().manual_seed(1))
    with torch.no_grad():
        tm.ln_s.fill_(0.3)
    tree = bridge.model_to_tree(tm)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    ds = jax_get_data(jargs)
    keep = np.random.RandomState(5).rand(1, ds.H * ds.W) < 0.8
    batch = {"c2w": jnp.asarray(ds.c2w_all[:1]), "intrinsics": jnp.asarray(ds.intrinsics_all[:1]),
             "rgb": jnp.asarray(ds.rgb_images[:1]).reshape(1, -1, 3),
             "object_mask": jnp.asarray(ds.object_masks[:1]).reshape(1, -1),
             "mask_ignore": jnp.asarray(keep)}
    rb = jax_sample_ray_batch(jax.random.PRNGKey(3), batch, ds.H, ds.W, N_RAYS)
    key = jax.random.PRNGKey(4)
    kw = {k: v for k, v in jkw.items() if k not in ("H", "W")}
    d_all = np.asarray(compute_ray_samples(jm, params, rb["rays_o"], rb["rays_d"], key, **kw))
    d_all = d_all.reshape(N_RAYS, -1)
    rb_np = {k: np.asarray(v) for k, v in rb.items()}
    with open(_jax_inputs_path(tmp), "wb") as f:
        pickle.dump({"cfg": cfg, "params": tree, "rb": rb_np, "d_all": d_all}, f)

    j_loss = jax_ray_loss_fn(jm, jargs, jkw)

    def loss(p, rb_, k, it):
        rays = {n: v for n, v in rb_.items() if n != "d_all"}
        return j_loss(p, rays, k, it, d_all=rb_["d_all"][0])

    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    keep_grads = optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))
    mesh = make_mesh(2)
    step = make_sharded_train_step(loss, keep_grads, mesh)
    state = TrainState(params=params, opt_state=keep_grads.init(params),
                       step=jnp.asarray(0, jnp.int32))
    rb_j = dict(rb, d_all=jnp.asarray(d_all)[None])
    new, metrics = step(state, shard_rays(mesh, rb_j), key)
    want = {"losses": {k: float(v) for k, v in metrics["losses"].items()},
            "grads": jax.tree_util.tree_map(np.asarray, new.opt_state)}
    with open(os.path.join(tmp, "jax_want.pkl"), "wb") as f:
        pickle.dump(want, f)


def _jax_mismatch(got, tmp):
    """The worst of the losses' relative gaps (against LOSS_REL) and the
    gradient leaves' (against LEAF_REL), each as a multiple of its bound."""
    with open(os.path.join(tmp, "jax_want.pkl"), "rb") as f:
        want = pickle.load(f)
    worst = max(abs(got["losses"][k] - v) / (LOSS_REL * abs(v)) for k, v in want["losses"].items())
    for g, r in zip(_leaves(got["grads"]), _leaves(want["grads"])):
        worst = max(worst, _rel(g, r) / LEAF_REL)
    return worst


def test_two_ranks_match_jax_sharded_step(ranks2):
    """The port's make_sharded_train_step on two ranks against the JAX
    package's on make_mesh(2), same weights, rays and samples: every loss
    term (rel 1e-5; the masked L1 divides by the mask count of the whole
    batch, which differs between the blocks) and every gradient leaf (5e-4
    of max|ref|)."""
    res, tmp = ranks2
    with open(os.path.join(tmp, "jax_want.pkl"), "rb") as f:
        want = pickle.load(f)
    assert set(res[0]["jax"]["losses"]) == set(want["losses"])
    assert len(_leaves(res[0]["jax"]["grads"])) == len(_leaves(want["grads"]))
    for r in res:
        assert _jax_mismatch(r["jax"], tmp) <= 1.0
    # the blocks' counts differ: the per-rank mean is not the global one
    with open(_jax_inputs_path(tmp), "rb") as f:
        rb = pickle.load(f)["rb"]
    m = (rb["target_mask"] & rb["mask_ignore"]).reshape(2, -1).sum(1)
    assert m[0] != m[1]


def _mutated_copy(tmp):
    """A copy of the package under `tmp` with tools/mutants.py's
    `per_rank_masked_mean`: each rank divides by its own mask count and the
    ranks' means are averaged. Returns the copy's root."""
    from neurecon_tpu_torch.tools.mutants import PARALLEL_MUTANTS

    root = os.path.join(tmp, "pkg")
    shutil.copytree(os.path.join(REPO, "neurecon_tpu_torch"),
                    os.path.join(root, "neurecon_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    rel, text, repl = PARALLEL_MUTANTS["per_rank_masked_mean"]
    path = os.path.join(root, "neurecon_tpu_torch", rel)
    with open(path) as f:
        src = f.read()
    assert src.count(text) == 1
    with open(path, "w") as f:
        f.write(src.replace(text, repl))
    return root


def test_per_rank_masked_mean_mutant_fails_jax_case(ranks2, started):
    """The mutant (`_mutated_copy`) on two ranks: the JAX comparison above
    must see it."""
    _, tmp = ranks2
    res = spawn_join(started[0]["mutant"])
    assert _jax_mismatch(res[0]["jax"], tmp) > 1.0


# ---- init_env, the launcher and train.py over two ranks ----

def test_first_node_of_slurm_lists():
    from neurecon_tpu_torch.parallel.distributed import first_node

    assert first_node("gpu-node[01-04]") == "gpu-node01"
    assert first_node("node[3,5-7]") == "node3"
    assert first_node("a-1,b-2") == "a-1"
    assert first_node("gpu-node[01-04],cpu[1-2]") == "gpu-node01"
    assert first_node("host7") == "host7"


def test_init_env_reads_launchers(monkeypatch):
    """torchrun's variables, SLURM's (more than one task), and none: world 1
    with no group made, NEURECON_RANK exported."""
    from neurecon_tpu_torch.parallel import distributed

    for k in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
              "MASTER_PORT", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_NTASKS",
              "SLURM_NODELIST", "SLURM_NTASKS_PER_NODE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NEURECON_RANK", "7")
    assert distributed.launcher_env() is None
    assert distributed.init_env(device="cpu") == (0, 0, 1)
    assert os.environ["NEURECON_RANK"] == "0"
    assert not torch.distributed.is_initialized() and distributed.process_group() is None
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert distributed.launcher_env() is None  # one task: no group, as JAX
    monkeypatch.setenv("SLURM_PROCID", "5")
    monkeypatch.setenv("SLURM_LOCALID", "1")
    monkeypatch.setenv("SLURM_NTASKS", "8")
    monkeypatch.setenv("SLURM_NODELIST", "gpu-node[01-04]")
    assert distributed.launcher_env() == {"rank": 5, "local_rank": 1, "world": 8,
                                          "local_world": 8, "addr": "gpu-node01",
                                          "port": 12355}
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert distributed.launcher_env() == {"rank": 1, "local_rank": 1, "world": 2,
                                          "local_world": 2, "addr": "10.0.0.2",
                                          "port": 29500}
    assert distributed.backend_for("cpu", 2) == "gloo"
    assert distributed.backend_for("cuda", 2) == "gloo"  # no card here: ranks share


@pytest.fixture(scope="module")
def train2(started):
    return spawn_join(started[0]["train2"]), started[0]["train2"][1]


def test_train_py_two_ranks_writes_only_on_rank_0(train2):
    res, tmp = train2
    assert [r["train"]["world"] for r in res] == [2, 2]
    assert res[1]["train"]["writes"] == []
    exp = os.path.dirname(os.path.dirname(res[0]["train"]["final_ckpt"]))
    for name in ("ckpts", "config.yaml", "backup", "stats.p_0"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert os.listdir(os.path.join(exp, "imgs", "val", "predicted_rgb"))
    assert not os.path.exists(os.path.join(exp, "stats.p_1"))


def test_train_py_two_ranks_matches_one_rank(train2, tmp_path):
    """Two ranks' final checkpoint against one rank's (same config, seed and
    draws): each parameter leaf within 1e-3 of how far it moved in 4 steps
    (this NeuS has no ReLU background), and every step's total loss within
    rel 1e-5, on both ranks."""
    from neurecon_tpu_torch import train
    from neurecon_tpu_torch.utils.checkpoints import load_checkpoint

    res, _ = train2
    torch.set_num_threads(1)
    _train_yaml(str(tmp_path))
    one = train.main_function(_train_cfg(str(tmp_path), 4), device="cpu")
    want = [v for _, v in one["stats"]["losses"]["total_per_step"]]
    for r in res:
        assert len(r["train"]["totals"]) == 4
        np.testing.assert_allclose(r["train"]["totals"], want, rtol=LOSS_REL, atol=0)
    got = load_checkpoint(res[0]["train"]["final_ckpt"])["model"]
    ref = load_checkpoint(one["final_ckpt"])["model"]
    from neurecon_tpu_torch import bridge
    from neurecon_tpu_torch.models.frameworks import get_model
    p0 = bridge.model_to_tree(get_model(_train_cfg(str(tmp_path), 4), "cpu", seed=42)[0])
    for path, g, w, a in zip(_paths(ref), _leaves(got), _leaves(ref), _leaves(p0)):
        assert np.abs(g - w).max() <= PARAM_MOVED * np.abs(w - a).max() + 1e-12, path


def test_train_py_overlap_sampler_on_two_ranks(train2):
    """train.py with `training.overlap_sampler` in groups of 2 steps on two
    ranks: 4 finite step losses, the same on both ranks."""
    res, _ = train2
    a, b = (r["train"]["overlap_totals"] for r in res)
    assert len(a) == 4 and np.isfinite(a).all() and a == b


def test_train_py_refuses_uneven_rays_on_every_rank(train2):
    res, _ = train2
    for r in res:
        assert r["train"]["odd"] is not None and "33" in r["train"]["odd"]


def test_train_py_resumes_on_two_ranks_through_the_launcher(train2):
    """`python -m neurecon_tpu_torch.train` started as two ranks by the
    port's launcher (torchrun's variables) resumes the two-rank run's
    checkpoint with its optimizer state and trains to step 6."""
    from neurecon_tpu_torch.parallel.launch import run_local
    from neurecon_tpu_torch.utils.checkpoints import read_restricted

    res, tmp = train2
    argv = _train_argv(tmp, 6)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    with open(os.path.join(tmp, "launch.log"), "w") as log:
        codes = run_local([sys.executable, "-m", "neurecon_tpu_torch.train", *argv], 2,
                          env=env, timeout=TIMEOUT, cwd=REPO, stdout=log,
                          stderr=subprocess.STDOUT)
    with open(os.path.join(tmp, "launch.log")) as f:
        text = f.read()
    assert codes == [0, 0], text[-3000:]
    exp = os.path.dirname(os.path.dirname(res[0]["train"]["final_ckpt"]))
    ck = read_restricted(os.path.join(exp, "ckpts", "final_00000006.pt"))
    assert ck["global_step"] == 6
    assert {float(s["step"]) for s in ck["torch_opt_state"]["state"].values()} == {6.0}
    assert "Start training..., it=4" in text and "it=6 loss" in text


def test_concurrent_builds_keep_their_own_logs(tmp_path, monkeypatch):
    """Two processes building one source at once: each writes its library
    and nvcc log under its own pid, reads back its own log, and moves both
    into place whole (no nvcc: a finished build is stood in for)."""
    from neurecon_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a, b = _build._own_paths("k", 101), _build._own_paths("k", 202)
    assert len({*a, *b}) == 4 and all(p.parent == tmp_path for p in (*a, *b))

    class Done:
        def wait(self):
            return 0
    for pid, text in ((101, "ptxas: 128 registers (first)"), (202, "ptxas: 96 registers")):
        lib, log_path = _build._own_paths("k", pid)
        lib.write_bytes(b"so-%d" % pid)
        log = open(log_path, "w")
        log.write(text)
        _build._finish("k", Done(), lib, log)
        assert _build.build_log("k") == text
        assert (tmp_path / "libk.so").read_bytes() == b"so-%d" % pid
    assert sorted(p.name for p in tmp_path.iterdir()) == ["k.log", "libk.so"]


def report(tmp=None):
    """Print the measures the tests above bound (PERF.md section 6):
    per case and world, the worst loss, gradient-leaf and grad-norm gaps to
    one rank and the parameters' share beyond 1e-3 of their move with the
    worst ratio; the two ranks' gaps to the JAX sharded step and the
    mutant's. From the repository root:
    `python -c "from tests.test_torch_parallel import report; report()"`."""
    import tempfile

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    torch.set_num_threads(1)
    tmp = tmp or tempfile.mkdtemp(prefix="parallel_report_")
    ref = {c: run_case(c) for c in CASES}
    for w in (2, 4):
        res = spawn(w, ["cases"], os.path.join(tmp, f"w{w}"))
        for c in CASES:
            loss = grad = norm = share = worst = 0.0
            for r in res:
                got, want = r["cases"][c], ref[c]
                for i in range(STEPS):
                    for k, v in want["losses"][i].items():
                        loss = max(loss, abs(got["losses"][i][k] - v) / (abs(v) + 1e-30))
                for g, x in zip(_leaves(got["grads"]), _leaves(want["grads"])):
                    grad = max(grad, _rel(g, x))
                for k, v in want["grad_norms"].items():
                    norm = max(norm, abs(got["grad_norms"][k] - v) / v)
                for g, x, a in zip(_leaves(got["params"]), _leaves(want["params"]),
                                   _leaves(want["p0"])):
                    moved = np.abs(x - a).max()
                    share = max(share, float((np.abs(g - x) > PARAM_MOVED * moved).mean()))
                    worst = max(worst, float(np.abs(g - x).max() / moved))
            print(f"w={w} {c}: loss rel {loss:.2e}, gradient leaf {grad:.2e} of max|ref|, "
                  f"grad norm rel {norm:.2e}; parameters: share beyond 1e-3 of the move "
                  f"{share:.4f}, worst {worst:.3e} of the move")
    jt = os.path.join(tmp, "jax")
    os.makedirs(jt)
    _jax_reference(jt)
    res = spawn(2, ["jax"], jt)
    with open(os.path.join(jt, "jax_want.pkl"), "rb") as f:
        want = pickle.load(f)
    got = res[0]["jax"]
    print("two ranks against the JAX sharded step: loss rel "
          + ", ".join(f"{k} {abs(got['losses'][k] - v) / abs(v):.2e}"
                      for k, v in want["losses"].items())
          + f"; worst gradient leaf {max(_rel(g, x) for g, x in zip(_leaves(got['grads']), _leaves(want['grads']))):.2e}"
          f" of max|ref|; {_jax_mismatch(got, jt):.3f} of the bounds")
    mt = os.path.join(tmp, "mutant")
    os.makedirs(mt)
    shutil.copy(_jax_inputs_path(jt), _jax_inputs_path(mt))
    bad = spawn(2, ["jax"], mt, pkg_root=_mutated_copy(mt))[0]["jax"]
    with open(_jax_inputs_path(jt), "rb") as f:
        rb = pickle.load(f)["rb"]
    counts = (rb["target_mask"] & rb["mask_ignore"]).reshape(2, -1).sum(1).tolist()
    print(f"the per-rank masked-mean mutant: loss_img {bad['losses']['loss_img']:.6f} against "
          f"{want['losses']['loss_img']:.6f}, {_jax_mismatch(bad, jt):.1f} times the bounds "
          f"(masked rays a block {counts})")

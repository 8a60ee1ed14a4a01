"""Finds a cell's parts by the names in `BENCHMARK.json`, so that a new
configuration, traffic mix or per-layer metric is new files and new
entries, and no edit:

  * a configuration: the file its entry names (`benchmark/configs/...`);
  * a traffic mix: `benchmark/traffic/<mix>.json`;
  * a per-layer metric: `benchmark/metrics/<metric>.py`, a reader with its
    LAYER, UNIT, SOURCE and MOVES and `read(ctx)`;
  * a cell's limits on the numbers its check compares:
    `benchmark/limits/<cell>.json`;
  * a framework (the configuration's `model.framework`): its reference
    module `benchmark/reference/<framework in lower case>.py`, which holds
    everything of the harness that differs between frameworks (see
    `framework`).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


FRAMEWORK = ("extra_weights", "draws", "train_loss", "render_eval", "recorded", "shifted",
             "points", "sdf_launches", "shrink")


def framework(cfg: dict):
    """The reference module of `cfg`'s framework. It defines:

      * `extra_weights(cfg, gen, device)`: the parameters beyond the surface
        and radiance nets at their init (scalars, or a further net's
        layers), drawn from `gen` after the nets' draws;
      * `draws(cfg, n, gen, device)`: a training step's draws after its
        pixels' rows and columns, in the program's order;
      * `train_loss(nets, params, cfg, rays_o, rays_d, draws, target, mask,
        step, follow)`: one training step's render and loss, ->
        (loss, rgb [N, 3], own, ties): `own` what `recorded` keeps of the
        program, as the reference computes it itself; `follow` the
        program's record of the step (or None); `ties` the rays at which a
        near-tie was settled as the program settled it;
      * `render_eval(nets, params, cfg, rays_o, rays_d)`: the novel-view
        render with its deterministic uniforms, -> rgb, depth, normals;
      * `recorded(sampled, extras)`: what the reference follows of a
        program's step, from its `depth_sample` output and its loss
        extras; `samples` (the sampler's depths) is what the check
        compares with the reference's own sampler;
      * `shifted(cfg, sampled)`: the `depth_sample` output with every depth
        moved half a coarse step (the `shifted_samples` fault);
      * `points(cfg, n_rays, train)`: the points a unit queries by kind
        (`upsample`, `sampler`, `nablas`, `radiance`), and
        `sdf_launches(cfg)`: the sdf-only launches of a sampler call;
      * `shrink(model_cfg)`: the CPU tests' sizes of its own keys.
    """
    name = str(cfg["model"]["framework"]).lower()
    if not name.isidentifier():
        raise ValueError(f"no framework module can be named {name!r}")
    module = importlib.import_module(f"benchmark.reference.{name}")
    missing = [f for f in FRAMEWORK if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f"framework {cfg['model']['framework']!r}: benchmark/reference/"
                         f"{name}.py is not a framework module (it lacks {', '.join(missing)})")
    return module


class Cell:
    def __init__(self, bench: "Bench", entry: dict):
        self.name, self.chips = entry["name"], int(entry["chips"])
        conf = next(c for c in bench.spec["configs"] if c["name"] == entry["config"])
        self.cfg = json.loads((bench.root / conf["file"]).read_text())
        self.traffic = json.loads((bench.here / "traffic" / f"{entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in bench.spec["end_to_end"]
                           if self.name in m.get("workloads", [self.name])]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench.spec["per_layer"]
                          if (self.name in m["workloads"] if "workloads" in m
                              else m["moves"] in names)]
        path = bench.here / "limits" / f"{self.name}.json"
        self.limits = json.loads(path.read_text()) if path.exists() else {}
        self.readers = {m["name"]: bench.reader(m) for m in self.per_layer}


class Bench:
    def __init__(self, root=None):
        self.here = HERE if root is None else Path(root) / "benchmark"
        self.root = self.here.parent
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> Cell:
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return Cell(self, entry)
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def reader(self, metric: dict):
        """The metric's reader module, checked against its entry."""
        path = self.here / "metrics" / f"{metric['name']}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for key in ("layer", "unit", "source", "moves"):
            if getattr(mod, key.upper()) != metric[key]:
                raise ValueError(f"{path.name}: {key} {getattr(mod, key.upper())!r} is not "
                                 f"BENCHMARK.json's {metric[key]!r}")
        return mod

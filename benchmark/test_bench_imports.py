"""Nothing the harness or the reference imports has the top-level name
`jax`, `jaxlib`, `flax` or `neurecon_tpu` (compared whole: the port's
`neurecon_tpu_torch` begins with the JAX package's name), and the reference
imports nothing of the port: read from the sources, and from `sys.modules`
after runs of every cell's kind on the CPU."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from benchmark.registry import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "neurecon_tpu"}


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "neurecon_tpu_torch" not in names
        assert names <= {"__future__", "math", "numpy", "torch", "benchmark"}


_RUN = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark.conftest import shrink
from benchmark.registry import Bench
from benchmark.run import execute, loaded_forbidden
for name in ("neus.train", "volsdf.train", "neus.render"):
    execute(shrink(Bench().cell(name)), 3, 0.2, True, torch.device("cpu"), 0.0)
print(json.dumps({{"forbidden": loaded_forbidden(),
                  "port": "neurecon_tpu_torch" in sys.modules}}))
"""

_REF = """
import json, sys, torch
sys.path.insert(0, {root!r})
from benchmark.conftest import shrink
from benchmark.registry import Bench
from benchmark.reference import step
from benchmark.scene import make_scene
from benchmark.weights import make_weights
cell = shrink(Bench().cell("volsdf.train"))
dev = torch.device("cpu")
scene = make_scene(cell.cfg["scene"], dev)
gen = torch.Generator().manual_seed(1)
step.train_steps(cell.cfg, make_weights(cell.cfg, 1, dev), scene, [(0, gen.get_state())])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _last_json(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(HERE.parent))],
                         capture_output=True, text=True, timeout=600, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runs_load_no_jax():
    got = _last_json(_RUN)
    assert got == {"forbidden": [], "port": True}


def test_reference_loads_nothing_of_the_port():
    mods = set(_last_json(_REF))
    assert not mods & (FORBIDDEN | {"neurecon_tpu_torch"})

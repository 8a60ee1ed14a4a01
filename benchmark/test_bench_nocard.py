"""Without a card a run fails and prints no result; so does a run from a
directory that holds only BENCHMARK.json and the benchmark's files."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

from benchmark.registry import HERE

ARGS = ["-m", "benchmark.run", "--workload", "neus.train", "--seed", "2147483700",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, **env):
    return subprocess.run([sys.executable, *ARGS], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env={**os.environ, **env})


def test_no_card_no_result():
    out = _run(HERE.parent, CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, PYTHONPATH="")
    assert out.returncode != 0
    assert out.stdout.strip() == ""

"""Start one process per rank on this host, as torchrun does: each gets
`RANK`, `LOCAL_RANK`, `WORLD_SIZE`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR` and a
free `MASTER_PORT`. `train.py` starts one rank per visible card this way when
it runs without a launcher on a machine with several cards.

A rank that exits non-zero, or a run past its time limit, ends the others (a
rank left alone would wait in its next collective)."""
from __future__ import annotations

import os
import socket
import subprocess
import time
from typing import List, Optional, Sequence


def free_port() -> int:
    """A TCP port the OS reports free on this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, base: Optional[dict] = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update({"RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
                "LOCAL_WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port)})
    return env


def _end(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + 10
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def run_local(cmd: Sequence[str], world: int, *, env: Optional[dict] = None,
              timeout: Optional[float] = None, cwd: Optional[str] = None,
              stdout=None, stderr=None) -> List[int]:
    """Run `cmd` as `world` ranks; returns their exit codes in rank order.
    When a rank fails the others are ended (their codes are then negative
    signals); past `timeout` seconds every rank is ended and reads 124."""
    port = free_port()
    procs = [subprocess.Popen(list(cmd), env=rank_env(r, world, port, env), cwd=cwd,
                              stdout=stdout, stderr=stderr) for r in range(world)]
    t0 = time.monotonic()
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                return codes
            if any(c not in (None, 0) for c in codes):
                time.sleep(2)  # let the others report their own failure first
                _end(procs)
                return [p.returncode for p in procs]
            if timeout is not None and time.monotonic() - t0 > timeout:
                _end(procs)
                return [124] * world
            time.sleep(0.05)
    finally:
        _end(procs)

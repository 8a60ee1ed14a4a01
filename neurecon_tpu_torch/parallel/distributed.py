"""The process environment of a run over several ranks (port of
`neurecon_tpu/parallel/distributed.py`).

One process (rank) per card. `init_env` reads the launcher's variables,
torchrun's (`RANK`, `LOCAL_RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`) or SLURM's (`SLURM_PROCID`, `SLURM_LOCALID`, `SLURM_NTASKS`,
`SLURM_NODELIST`; the master is the list's first node, the port
`MASTER_PORT` or 12355), makes the card of the local rank current and joins
the default process group: NCCL on the cards, gloo on the CPU, and gloo as
well where more local ranks than cards share them (NCCL refuses two ranks on
one card). Without
launcher variables the world is one process and no group is made, as the
JAX package runs on one local device; torchrun's variables make a group even
for a world of one, SLURM's only for more than one task, as the JAX package
initializes `jax.distributed` only then.

The rank helpers mirror the reference's (`get_rank`, `get_local_rank`,
`get_world_size`, `is_master`), and `init_env` exports `NEURECON_RANK` for
the console logger's master-only filter.
"""
from __future__ import annotations

import os
import re
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


def _env_int(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None and v != "":
            return int(v)
    return default


def first_node(nodelist: str) -> str:
    """The first host of a SLURM node list: `gpu-node[01-04]` -> `gpu-node01`,
    `node[3,5-7]` -> `node3`, `a-1,b-2` -> `a-1`."""
    depth = 0
    for i, ch in enumerate(nodelist):
        depth += (ch == "[") - (ch == "]")
        if ch == "," and depth == 0:
            nodelist = nodelist[:i]
            break
    m = re.match(r"^([^\[]*)\[([^\]]*)\](.*)$", nodelist)
    if m is None:
        return nodelist
    prefix, ranges, rest = m.groups()
    first = ranges.split(",")[0].split("-")[0]
    return prefix + first + (first_node(rest) if "[" in rest else rest)


def launcher_env() -> Optional[dict]:
    """{"rank", "local_rank", "world", "local_world", "addr", "port"} from
    torchrun's variables, else SLURM's (more than one task), else None."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world = _env_int("WORLD_SIZE")
        return {"rank": _env_int("RANK"), "local_rank": _env_int("LOCAL_RANK", default=0),
                "world": world, "local_world": _env_int("LOCAL_WORLD_SIZE", default=world),
                "addr": os.environ.get("MASTER_ADDR", "127.0.0.1"),
                "port": _env_int("MASTER_PORT", default=12355)}
    ntasks = _env_int("SLURM_NTASKS", default=1)
    if "SLURM_PROCID" in os.environ and ntasks > 1:
        addr = os.environ.get("MASTER_ADDR") or first_node(
            os.environ.get("SLURM_NODELIST", "127.0.0.1"))
        return {"rank": _env_int("SLURM_PROCID"),
                "local_rank": _env_int("SLURM_LOCALID", default=0), "world": ntasks,
                "local_world": _env_int("SLURM_NTASKS_PER_NODE", default=ntasks),
                "addr": addr, "port": _env_int("MASTER_PORT", default=12355)}
    return None


def backend_for(device_type: str, local_world: int) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU or where local
    ranks share cards."""
    if device_type != "cuda" or local_world > torch.cuda.device_count():
        return "gloo"
    return "nccl"


def init_env(args=None, seed: int = 42, device=None, init_method: Optional[str] = None):
    """Join the run's process group; returns (rank, local_rank, world).

    `device` (or `args.device`): "cpu" for gloo on the CPU, else the cards:
    the local rank's card (local rank modulo the visible cards) is made
    current before any kernel loads. A group already made (by the caller)
    is kept. `init_method` replaces `tcp://MASTER_ADDR:MASTER_PORT` (a
    `file://` rendezvous, say). `seed` is unused, as in the JAX package."""
    del seed
    if device is None and args is not None:
        device = args.get("device", None)
    device_type = torch.device("cuda" if device is None else device).type
    env = launcher_env()
    if env is not None and device_type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(env["local_rank"] % torch.cuda.device_count())
    if env is not None and not dist.is_initialized():
        dist.init_process_group(
            backend=backend_for(device_type, env["local_world"]),
            init_method=init_method or f"tcp://{env['addr']}:{env['port']}",
            world_size=env["world"], rank=env["rank"], timeout=timedelta(minutes=30))
    os.environ["NEURECON_RANK"] = str(get_rank())
    return get_rank(), get_local_rank(), get_world_size()


def release() -> None:
    """Leave the default group, if one is made."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_group():
    """The default group when one is made, else None (one process)."""
    return dist.group.WORLD if dist.is_initialized() else None


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank() -> int:
    env = launcher_env()
    return env["local_rank"] if env is not None and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_master() -> bool:
    return get_rank() == 0

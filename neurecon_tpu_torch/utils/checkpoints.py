"""Checkpoint IO in the JAX package's format (`neurecon_tpu/utils/checkpoints.py`):
a pickled dict {"global_step", "epoch_idx", "model": pytree of numpy arrays,
...} — so either package reads the other's checkpoints.

A checkpoint written by the JAX trainer also pickles its optax optimizer
state, whose classes would import optax (and JAX) on a plain `pickle.load`.
`load_checkpoint` therefore unpickles with a restricted class lookup: numpy
and builtins resolve as usual, every other class becomes an inert stub, and
only "model" and "global_step" are returned.
"""
from __future__ import annotations

import os
import pickle
from typing import List

from neurecon_tpu_torch.utils.console import log

_ALLOWED_MODULES = ("builtins", "copyreg", "collections", "numpy")


class _Inert:
    """Stand-in for a class outside numpy and builtins (e.g. optax states)."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _ALLOWED_MODULES:
            return super().find_class(module, name)
        return _Inert


def sorted_ckpts(ckpt_dir: str) -> List[str]:
    """Checkpoints ordered oldest -> newest-priority: numbered ascending,
    then latest, then final_*."""
    if not os.path.isdir(ckpt_dir):
        return []
    numbered, latest, final = [], None, None
    for fname in sorted(os.listdir(ckpt_dir)):
        if not (fname.endswith(".pt") or fname.endswith(".ckpt")):
            continue
        base = fname.rsplit(".", 1)[0]
        if base == "latest":
            latest = fname
        elif base.startswith("final_"):
            final = fname
        elif base.isdigit():
            numbered.append(fname)
    out = [os.path.join(ckpt_dir, f) for f in numbered]
    if latest:
        out.append(os.path.join(ckpt_dir, latest))
    if final:
        out.append(os.path.join(ckpt_dir, final))
    return out


def load_checkpoint(path: str) -> dict:
    """{"model": numpy pytree, "global_step": int} of a checkpoint file."""
    with open(path, "rb") as f:
        data = _RestrictedUnpickler(f).load()
    if not isinstance(data, dict) or "model" not in data:
        raise ValueError(f"{path} is not a model checkpoint")
    log.info(f"CheckpointIO: loaded {path} (step {data.get('global_step')})")
    return {"model": data["model"],
            "global_step": int(data.get("global_step", -1))}


class CheckpointIO:
    def __init__(self, checkpoint_dir: str = "./ckpts", allow_mkdir: bool = True):
        self.checkpoint_dir = checkpoint_dir
        if allow_mkdir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    def save(self, filename: str, global_step: int = 0, epoch_idx: int = 0,
             **pytrees):
        """Pickle {"global_step", "epoch_idx", **pytrees}; each pytree is a
        nested dict/list of numpy arrays (see `bridge.model_to_tree`)."""
        outdict = {"global_step": int(global_step), "epoch_idx": int(epoch_idx)}
        outdict.update(pytrees)
        path = os.path.join(self.checkpoint_dir, filename)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(outdict, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: a crash never corrupts `latest`
        log.info(f"CheckpointIO: saved {path}")
        return path

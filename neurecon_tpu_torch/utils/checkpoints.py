"""Checkpoint IO in the JAX package's format (`neurecon_tpu/utils/checkpoints.py`):
a pickled dict {"global_step", "epoch_idx", "model": pytree of numpy arrays,
...} — so either package reads the other's checkpoints.

A checkpoint written by the JAX trainer also pickles its optax optimizer
state, whose classes would import optax (and JAX) on a plain `pickle.load`.
Checkpoints are therefore unpickled with a restricted class lookup: numpy
and builtins resolve as usual, and every other class becomes an inert stub.
So the JAX trainer's optax state cannot be restored here: a resume from such
a checkpoint takes the parameters and `global_step` and restarts Adam's
moments. The port's own trainer saves its torch optimizer state, as numpy,
under `torch_opt_state`, a key the JAX trainer does not read.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

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


def _read(path: str) -> dict:
    with open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()


def load_checkpoint(path: str) -> dict:
    """{"model": numpy pytree, "global_step": int} of a checkpoint file."""
    data = _read(path)
    if not isinstance(data, dict) or "model" not in data:
        raise ValueError(f"{path} is not a model checkpoint")
    log.info(f"CheckpointIO: loaded {path} (step {data.get('global_step')})")
    return {"model": data["model"],
            "global_step": int(data.get("global_step", -1))}


def _filter_keys(d: dict, ignore_keys=None, only_use_keys=None) -> dict:
    ignore_keys = ignore_keys or []
    if only_use_keys is not None and not isinstance(only_use_keys, (list, tuple)):
        only_use_keys = [only_use_keys]
    keep = ((lambda k: k in only_use_keys) if only_use_keys is not None
            else (lambda k: k not in ignore_keys))
    out = {k: v for k, v in d.items() if keep(k)}
    for k in d:
        if k not in out:
            log.info(f"CheckpointIO: ignoring key '{k}'")
    return out


def optimizer_state_to_numpy(optimizer) -> dict:
    """A torch optimizer's state_dict with every tensor as a numpy array."""
    def conv(v):
        if hasattr(v, "detach"):
            return v.detach().cpu().numpy().copy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    return conv(optimizer.state_dict())


def load_optimizer_state(optimizer, state: dict) -> None:
    """Restore `optimizer_state_to_numpy`'s output into `optimizer`."""
    import torch

    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(v.copy())
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v
    optimizer.load_state_dict(conv(state))


class CheckpointIO:
    def __init__(self, checkpoint_dir: str = "./ckpts", allow_mkdir: bool = True):
        self.checkpoint_dir = checkpoint_dir
        if allow_mkdir:
            os.makedirs(checkpoint_dir, exist_ok=True)

    def load_file(self, filename: Optional[str] = None, ignore_keys=None,
                  only_use_keys=None) -> dict:
        """The checkpoint's dict ("model" filtered by top-level key), or {}
        when `filename` is None and the directory holds none. With no
        filename, the candidate with the highest global_step is taken: after
        a crash between a numbered backup and the next `latest`, the backup
        can be ahead of `latest`."""
        if filename is None:
            ckpts = sorted_ckpts(self.checkpoint_dir)
            if not ckpts:
                log.info("CheckpointIO: no checkpoint found, starting fresh")
                return {}
            path = self._newest_by_step(ckpts)
        elif os.path.isabs(filename) or os.path.exists(filename):
            path = filename
        else:
            path = os.path.join(self.checkpoint_dir, filename)
        data = _read(path)
        log.info(f"CheckpointIO: loaded {path} (step {data.get('global_step')})")
        if "model" in data and (ignore_keys or only_use_keys):
            data["model"] = _filter_keys(data["model"], ignore_keys, only_use_keys)
        return data

    @staticmethod
    def _newest_by_step(ckpts: List[str]) -> str:
        """Only the last three candidates can hold the highest step
        (numbered ones are ascending); ties keep the listed order."""
        best, best_step = ckpts[-1], -1
        for path in ckpts[-3:]:
            try:
                step = int(_read(path).get("global_step", 0))
            except Exception as e:  # a file truncated by a crash mid-save
                log.warning(f"CheckpointIO: skipping unreadable {path}: {e}")
                continue
            if step >= best_step:
                best, best_step = path, step
        return best

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

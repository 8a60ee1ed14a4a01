"""Parameters between the JAX package's pytree and the port's modules.

The pytree, as numpy (a checkpoint's "model" entry, or
`jax.tree_util.tree_map(np.asarray, params)`):

    {"ln_s": [1] (NeuS) or "ln_beta": [1] (VolSDF),
     "implicit_surface": {"layers": [{"v", "g", "b"} or {"w", "b"}, ...]},
     "radiance_net": {"layers": [...]}}

Both sides store linear weights as [out, in], so values copy one to one.
"""
from __future__ import annotations

import numpy as np
import torch


def _layers_to_tree(layers):
    out = []
    for layer in layers:
        names = ("v", "g", "b") if layer.weight_norm else ("w", "b")
        out.append({n: getattr(layer, n).detach().cpu().numpy().copy()
                    for n in names})
    return {"layers": out}


def _scalar(model) -> str:
    """The name of the model's learnable scale: ln_s (NeuS), ln_beta (VolSDF)."""
    return "ln_beta" if hasattr(model, "ln_beta") else "ln_s"


def model_to_tree(model) -> dict:
    """The model's parameters as the JAX pytree of numpy arrays."""
    name = _scalar(model)
    return {name: getattr(model, name).detach().cpu().numpy().copy(),
            "implicit_surface": _layers_to_tree(model.implicit_surface.layers),
            "radiance_net": _layers_to_tree(model.radiance_net.layers)}


@torch.no_grad()
def _load_layers(layers, tree, what):
    if len(tree["layers"]) != len(layers):
        raise ValueError(f"{what}: {len(tree['layers'])} layers in the tree, "
                         f"{len(layers)} in the model")
    for i, (layer, p) in enumerate(zip(layers, tree["layers"])):
        names = ("v", "g", "b") if layer.weight_norm else ("w", "b")
        if set(p) != set(names):
            raise ValueError(f"{what}.layers[{i}]: keys {sorted(p)}, want {names}")
        for n in names:
            dst = getattr(layer, n)
            src = torch.tensor(np.asarray(p[n], np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what}.layers[{i}].{n}: shape "
                                 f"{tuple(src.shape)}, want {tuple(dst.shape)}")
            dst.copy_(src)


@torch.no_grad()
def load_tree(model, tree: dict, strict: bool = True) -> None:
    """Copy a JAX NeuS or VolSDF pytree (numpy) into the port's model, in
    place. With strict=False, top-level entries missing from the tree are
    left as they are (a checkpoint loaded with ignore_keys / only_use_keys)."""
    scalar = _scalar(model)
    for name in (scalar, "implicit_surface", "radiance_net"):
        if name not in tree and not strict:
            continue
        if name == scalar:
            getattr(model, name).copy_(torch.tensor(np.asarray(tree[name], np.float32)))
        else:
            _load_layers(getattr(model, name).layers, tree[name], name)


def grads_to_tree(model) -> dict:
    """The parameters' .grad as the JAX pytree of numpy arrays (zeros where a
    parameter has none), to compare leaf by leaf with jax.grad."""
    def g(p):
        return (np.zeros(tuple(p.shape), np.float32) if p.grad is None
                else p.grad.detach().cpu().numpy().copy())

    def layers(mod):
        return {"layers": [{n: g(getattr(layer, n)) for n in
                            (("v", "g", "b") if layer.weight_norm else ("w", "b"))}
                           for layer in mod.layers]}
    name = _scalar(model)
    return {name: g(getattr(model, name)),
            "implicit_surface": layers(model.implicit_surface),
            "radiance_net": layers(model.radiance_net)}


def load_surface_tree(surface, tree: dict) -> None:
    """Copy an `implicit_surface` subtree (numpy) into an ImplicitSurface."""
    _load_layers(surface.layers, tree, "implicit_surface")

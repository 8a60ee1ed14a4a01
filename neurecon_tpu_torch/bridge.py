"""Parameters between the JAX package's pytree and the port's modules.

The pytree, as numpy (a checkpoint's "model" entry, or
`jax.tree_util.tree_map(np.asarray, params)`):

    {"ln_s": [1] (NeuS) or "ln_beta": [1] (VolSDF); UNISURF has neither,
     "implicit_surface": {"layers": [{"v", "g", "b"} or {"w", "b"}, ...]},
     "radiance_net": {"layers": [...]},
     "nerf_outside": {"pts_linears": [{"w", "b"}, ...], "views_linear",
                      "feature_linear", "alpha_linear", "rgb_linear"}}

`nerf_outside` (the NeRF++ background) is there only for NeuS without a
mask and VolSDF with `outside_scene: nerf++`.

Both sides store linear weights as [out, in], so values copy one to one.
"""
from __future__ import annotations

import numpy as np
import torch


def _names(layer):
    return ("v", "g", "b") if layer.weight_norm else ("w", "b")


def _layer_to_tree(layer, leaf):
    return {n: leaf(getattr(layer, n)) for n in _names(layer)}


def _value(p):
    return p.detach().cpu().numpy().copy()


def _grad(p):
    return (np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.detach().cpu().numpy().copy())


def _nets(model) -> tuple:
    """The model's networks by pytree name: the surface, the radiance net
    and, where the model has one, the NeRF++ background."""
    names = ("implicit_surface", "radiance_net")
    if getattr(model, "nerf_outside", None) is not None:
        names += ("nerf_outside",)
    return names


def _layers_to_tree(layers, leaf=_value):
    """{"layers": [...]} of a list of DenseLayers."""
    return {"layers": [_layer_to_tree(l, leaf) for l in layers]}


def _net_to_tree(net, leaf):
    """A network's subtree: {"layers": [...]} for the surface and the
    radiance net, the NeRF pytree for the background."""
    if hasattr(net, "pts_linears"):
        tree = {"pts_linears": [_layer_to_tree(l, leaf) for l in net.pts_linears]}
        tree.update({n: _layer_to_tree(getattr(net, n), leaf) for n in net.HEADS})
        return tree
    return _layers_to_tree(net.layers, leaf)


def _scalars(model) -> tuple:
    """The names of the model's learnable scales: ln_s (NeuS), ln_beta
    (VolSDF), none (UNISURF)."""
    return tuple(n for n in ("ln_s", "ln_beta") if hasattr(model, n))


def _to_tree(model, leaf) -> dict:
    tree = {name: leaf(getattr(model, name)) for name in _scalars(model)}
    tree.update({name: _net_to_tree(getattr(model, name), leaf) for name in _nets(model)})
    return tree


def model_to_tree(model) -> dict:
    """The model's parameters as the JAX pytree of numpy arrays."""
    return _to_tree(model, _value)


@torch.no_grad()
def _load_layer(layer, p, what):
    names = _names(layer)
    if set(p) != set(names):
        raise ValueError(f"{what}: keys {sorted(p)}, want {names}")
    for n in names:
        dst = getattr(layer, n)
        src = torch.tensor(np.asarray(p[n], np.float32))
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}.{n}: shape {tuple(src.shape)}, want {tuple(dst.shape)}")
        dst.copy_(src)


def _load_list(layers, ps, what):
    if len(ps) != len(layers):
        raise ValueError(f"{what}: {len(ps)} layers in the tree, {len(layers)} in the model")
    for i, (layer, p) in enumerate(zip(layers, ps)):
        _load_layer(layer, p, f"{what}[{i}]")


def _load_layers(layers, tree, what):
    """Load {"layers": [...]} into a list of DenseLayers."""
    _load_list(layers, tree["layers"], f"{what}.layers")


def _load_net(net, tree, what):
    if hasattr(net, "pts_linears"):
        want = {"pts_linears", *net.HEADS}
        if set(tree) != want:
            raise ValueError(f"{what}: keys {sorted(tree)}, want {sorted(want)}")
        _load_list(net.pts_linears, tree["pts_linears"], f"{what}.pts_linears")
        for n in net.HEADS:
            _load_layer(getattr(net, n), tree[n], f"{what}.{n}")
    else:
        _load_layers(net.layers, tree, what)


@torch.no_grad()
def load_tree(model, tree: dict, strict: bool = True) -> None:
    """Copy a JAX NeuS, VolSDF or UNISURF pytree (numpy) into the port's
    model, in place, the NeRF++ background included where the model has one.
    With strict=False, top-level entries missing from the tree are left as
    they are (a checkpoint loaded with ignore_keys / only_use_keys)."""
    scalars = _scalars(model)
    for name in (*scalars, *_nets(model)):
        if name not in tree and not strict:
            continue
        if name in scalars:
            getattr(model, name).copy_(torch.tensor(np.asarray(tree[name], np.float32)))
        else:
            _load_net(getattr(model, name), tree[name], name)


def grads_to_tree(model) -> dict:
    """The parameters' .grad as the JAX pytree of numpy arrays (zeros where a
    parameter has none), to compare leaf by leaf with jax.grad."""
    return _to_tree(model, _grad)


def load_surface_tree(surface, tree: dict) -> None:
    """Copy an `implicit_surface` subtree (numpy) into an ImplicitSurface."""
    _load_net(surface, tree, "implicit_surface")

"""The weights of a cell, made on the device from the seed.

The surface takes the IDR geometric sphere init (the program's init, frozen
here): N(0, 2 / out) hidden weights with the octave columns of layer 0 and
of the skip layer at zero, zero biases, a final layer of sqrt(pi / in) plus
1e-4 noise with bias -radius_init. The radiance net takes nn.Linear's
default U(+-1 / sqrt(in)). Every layer then gets the seeded noise that the
program's kernel checks add (`perturb_parameters`): 10% of the layer's RMS
on each weight, 1% on each bias, and a factor 1 + 0.1 N(0, 1) on the weight
norm's g, so that no octave column or geometry row is zero. Weight norm is
stored as v (the perturbed weight) and g (its row norms, scaled).

All draws come from one torch.Generator on the device, in two large calls,
and after them the framework's (`extra_weights` of its reference module;
NeuS's `ln_s` and VolSDF's `ln_beta` at their init draw nothing). Returns
the canonical dict that the program's parameters and the reference are
both loaded from: `surface.<l>.v|g|b`, `radiance.<l>.v|g|b` and the
framework's own, named as the program names them.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference.nets import spec
from benchmark.registry import framework


def make_weights(cfg: dict, seed: int, device) -> dict:
    sp = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    s, r = sp["surface"], sp["radiance"]
    layers = [("surface", l, i, o) for l, (i, o) in enumerate(s["dims"])]
    layers += [("radiance", l, i, o) for l, (i, o) in enumerate(r["dims"])]
    # per layer: the init's normals (surface), the noise on w, b and g
    n_normal = sum((i * o if net == "surface" else 0) + i * o + 2 * o
                   for net, _, i, o in layers)
    n_uniform = sum(i * o + o for net, _, i, o in layers if net == "radiance")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    pos = {"n": 0, "u": 0}

    def take(kind, *shape):
        buf = normal if kind == "n" else uniform
        n = math.prod(shape)
        out = buf[pos[kind]:pos[kind] + n].reshape(shape)
        pos[kind] += n
        return out

    out = {}
    c_in = s["dims"][0][0]
    for net, l, i, o in layers:
        if net == "surface":
            if l == s["D"]:
                w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * take("n", o, i)
                b = torch.full((o,), -s["radius_init"], device=device)
            else:
                w = math.sqrt(2) / math.sqrt(o) * take("n", o, i)
                b = torch.zeros(o, device=device)
                if s["multires"] > 0 and l == 0:
                    w[:, 3:] = 0.0
                elif s["multires"] > 0 and l in s["skips"]:
                    w[:, -(c_in - 3):] = 0.0
        else:
            bound = 1.0 / math.sqrt(i)
            w = (take("u", o, i) * 2 - 1) * bound
            b = (take("u", o) * 2 - 1) * bound
        std = 0.1 * float(w[w != 0].square().mean().sqrt())
        w = w + std * take("n", o, i)
        b = b + 0.01 * take("n", o)
        g = torch.linalg.norm(w, dim=1, keepdim=True) * (1 + 0.1 * take("n", o, 1))
        out[f"{net}.{l}.v"], out[f"{net}.{l}.g"], out[f"{net}.{l}.b"] = w, g, b
    out.update(framework(cfg).extra_weights(cfg, gen, device))
    return {k: v.contiguous() for k, v in out.items()}


NETS = {"surface": "implicit_surface", "radiance": "radiance_net"}


def port_name(name: str) -> str:
    """The program's parameter name of a canonical weight (a framework's
    own weights carry the program's names already)."""
    net, _, rest = name.partition(".")
    return NETS[net] + ".layers." + rest if net in NETS else name

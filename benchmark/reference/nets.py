"""The networks of the reference: the surface MLP (weight norm,
Softplus(beta=100), a skip concat scaled by 1/sqrt(2), sdf row + geometry
rows) with its nablas by autograd, and the radiance net (ReLU, sigmoid rgb).

`spec(cfg)` reads the widths from a configuration as the program's config
dict states them; the parameters are the benchmark's canonical dict
(`surface.<l>.v|g|b`, `radiance.<l>.v|g|b`, and the framework's own
beside them, such as NeuS's `ln_s`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def embed_dim(multires: int) -> int:
    """Channels of the [x, sin(f x), cos(f x), ...] encoding of 3 coordinates."""
    return 3 if multires <= 0 else 3 + 6 * multires


def spec(cfg: dict) -> dict:
    """The shapes of a configuration's surface and radiance nets."""
    m = cfg["model"]
    s, r = m["surface"], m["radiance"]
    W_geo = int(m["W_geometry_feature"])
    c_in = embed_dim(int(s["embed_multires"]))
    D, W, skips = int(s["D"]), int(s["W"]), tuple(s["skips"])
    sdims = []
    for l in range(D + 1):
        out = 1 + W_geo if l == D else (W - c_in if (l + 1) in skips else W)
        sdims.append((c_in if l == 0 else W, out))
    rin = embed_dim(int(r["embed_multires"])) + W_geo
    if r.get("use_view_dirs", True):
        rin += embed_dim(int(r["embed_multires_view"])) + 3
    rD, rW, rskips = int(r["D"]), int(r["W"]), tuple(r["skips"])
    rdims = [(rin if l == 0 else (rin + rW if l in rskips else rW), 3 if l == rD else rW)
             for l in range(rD + 1)]
    return {"W_geo": W_geo,
            "surface": {"D": D, "W": W, "skips": skips, "multires": int(s["embed_multires"]),
                        "dims": sdims, "radius_init": float(s["radius_init"])},
            "radiance": {"D": rD, "skips": rskips, "multires": int(r["embed_multires"]),
                         "multires_view": int(r["embed_multires_view"]), "dims": rdims,
                         "use_view_dirs": bool(r.get("use_view_dirs", True))}}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    i = x.detach().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """The TF32 rounding of an operand, with its cotangent rounded too, so
    every product of the backward (and of the double backward) sees TF32
    operands."""

    @staticmethod
    def forward(ctx, x):
        return tf32_round(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundTF32.apply(g)


def embed(x: torch.Tensor, multires: int) -> torch.Tensor:
    if multires <= 0:
        return x
    freqs = [float(f) for f in np.asarray(2.0 ** np.linspace(0.0, multires - 1, multires),
                                          np.float32)]
    ph = torch.stack([x * f for f in freqs], dim=-2)
    sc = torch.stack([torch.sin(ph), torch.cos(ph)], dim=-2).reshape(*x.shape[:-1], -1)
    return torch.cat([x, sc], dim=-1)


class Nets:
    """The surface and radiance nets on a dict of parameters."""

    def __init__(self, sp: dict, params: dict, tf32: bool = False):
        self.sp, self.p, self.tf32 = sp, params, tf32

    def weight(self, net: str, l: int) -> torch.Tensor:
        v, g = self.p[f"{net}.{l}.v"], self.p[f"{net}.{l}.g"]
        return g * v / torch.linalg.norm(v, dim=1, keepdim=True)

    def linear(self, x, net: str, l: int):
        w = self.weight(net, l)
        if self.tf32:
            x, w = _RoundTF32.apply(x), _RoundTF32.apply(w)
        return F.linear(x, w, self.p[f"{net}.{l}.b"])

    def surface(self, x):
        """x [M, 3] -> (sdf [M], geometry features [M, W_geo])."""
        s = self.sp["surface"]
        emb = embed(x, s["multires"])
        h = emb
        for l in range(s["D"]):
            if l in s["skips"]:
                h = torch.cat([h, emb], dim=-1) / math.sqrt(2)
            h = F.softplus(100.0 * self.linear(h, "surface", l)) / 100.0
        out = self.linear(h, "surface", s["D"])
        return out[:, 0], out[:, 1:]

    def surface_with_nablas(self, x, create_graph: bool):
        """(sdf, nablas, h) at x [M, 3]; with create_graph the nablas carry
        the graph of the eikonal double backward."""
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            sdf, h = self.surface(xg)
            (nablas,) = torch.autograd.grad(sdf.sum(), xg, create_graph=create_graph)
        if not create_graph:
            sdf, nablas, h = sdf.detach(), nablas.detach(), h.detach()
        return sdf, nablas, h

    def radiance(self, x, view_dirs, normals, geo):
        r = self.sp["radiance"]
        parts = [embed(x, r["multires"])]
        if r["use_view_dirs"]:
            parts += [embed(view_dirs, r["multires_view"]), normals]
        parts.append(geo)
        inp = torch.cat(parts, dim=-1)
        h = inp
        for l in range(r["D"] + 1):
            if l in r["skips"]:
                h = torch.cat([h, inp], dim=-1)
            h = self.linear(h, "radiance", l)
            h = torch.sigmoid(h) if l == r["D"] else torch.relu(h)
        return h

"""The work a cell's inputs need, from the configuration's widths and
sample counts alone (never from what the program launches), and the card's
peaks.

A multiply-add is 2 FLOP. The peak is the H100 SXM's dense TF32 rate, the
highest at which the card multiplies float32 operands; bytes move at its
HBM3 bandwidth (NVIDIA's data sheet, at the 700 W limit). Per point, the
surface MLP needs:

  * `sdf`: the hidden layers and the final layer's sdf row (459,008
    multiply-adds at the flagship widths);
  * `nablas`: the hidden layers, every final row, and the nablas sweep back
    through the hidden layers (983,296);
  * `backward`: what the eikonal backward needs given the forward: the
    backprop of the forward and of the nablas sweep through the hidden
    layers (input and weight gradients of each, four passes) and the final
    layer's two (1,966,592). A kernel that recomputes the forward and the
    sweep does 2,884,096; the recompute is not counted.

The radiance net needs its layers' products once forward, and twice more
backward in training (input and weight gradients).
"""
from __future__ import annotations

from benchmark.reference.nets import spec
from benchmark.registry import framework

TF32_PEAK = 495e12   # FLOP/s, H100 SXM dense TF32
HBM_BYTES = 3.35e12  # bytes/s, H100 SXM HBM3


def surface_macs(sp: dict, kind: str) -> int:
    dims = sp["surface"]["dims"]
    hidden = sum(i * o for i, o in dims[:-1])
    i_D, o_D = dims[-1]
    return {"sdf": hidden + i_D, "nablas": 2 * hidden + i_D * o_D,
            "backward": 4 * hidden + 2 * i_D * o_D}[kind]


def radiance_macs(sp: dict) -> int:
    return sum(i * o for i, o in sp["radiance"]["dims"])


def weight_bytes(sp: dict, net: str) -> int:
    return 4 * sum(i * o + o for i, o in sp[net]["dims"])


def frame_rays(cfg: dict, traffic: dict) -> int:
    sc, ds = cfg["scene"], int(traffic["downscale"])
    return (int(sc["H"]) // ds) * (int(sc["W"]) // ds)


def points(cfg: dict, traffic: dict) -> dict:
    """Points a unit of the traffic (a training step, or a rendered frame)
    evaluates, by the framework's count (`points` of its reference module):
    `upsample` (NeuS's sdf-only queries), `sampler` (VolSDF's sdf-only
    queries: the initial depths and every round's new ones, as the
    fixed-trip algorithm queries them), `nablas` (sdf, nablas and geometry
    features), `backward` (the eikonal backward, training only: one a
    `nablas` point), `radiance`; and `rays`."""
    train = traffic["kind"] == "train"
    N = int(cfg["data"]["N_rays"]) if train else frame_rays(cfg, traffic)
    out = {"rays": N, **framework(cfg).points(cfg, N, train)}
    out["backward"] = out["nablas"] if train else 0
    return out


def unit_flops(cfg: dict, traffic: dict) -> float:
    """Every MLP query a unit needs, each once: forward, nablas, backward,
    radiance, and the samplers' gradient-free queries."""
    sp, pt = spec(cfg), points(cfg, traffic)
    rad = 3 if traffic["kind"] == "train" else 1
    return 2.0 * ((pt["upsample"] + pt["sampler"]) * surface_macs(sp, "sdf")
                  + pt["nablas"] * surface_macs(sp, "nablas")
                  + pt["backward"] * surface_macs(sp, "backward")
                  + pt["radiance"] * radiance_macs(sp) * rad)


def kernel_work(cfg: dict, traffic: dict, kernel: str) -> tuple:
    """(FLOP, bytes) a unit needs of one kernel's work: `fused_nablas`
    (kernel 1), `fused_upsample` (kernel 2), `fused_nablas_vjp` (kernel 3),
    `fused_mlp` (kernel 4, the VolSDF sampler's queries). Bytes: each input
    read once and each output written once."""
    sp, pt = spec(cfg), points(cfg, traffic)
    geo = sp["W_geo"]
    wb = weight_bytes(sp, "surface")
    if kernel == "fused_nablas":
        n = pt["nablas"]
        return 2.0 * n * surface_macs(sp, "nablas"), n * (12 + 16 + 4 * geo) + wb
    if kernel == "fused_nablas_vjp":
        n = pt["backward"]
        return 2.0 * n * surface_macs(sp, "backward"), n * (12 + 16 + 4 * geo) + 2 * wb
    if kernel == "fused_upsample":
        rays, n = pt["rays"], pt["upsample"]
        per_ray = 24 + 4 * (n // rays)  # origin and direction in, d_all out
        return 2.0 * n * surface_macs(sp, "sdf"), rays * per_ray + 4 * n + wb
    if kernel == "fused_mlp":
        n = pt["sampler"]
        launches = framework(cfg).sdf_launches(cfg)
        return 2.0 * n * surface_macs(sp, "sdf"), n * 16 + launches * wb
    raise KeyError(kernel)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / TF32_PEAK, nbytes / HBM_BYTES)

"""Network primitives (port of `neurecon_tpu/models/base.py`).

  * Embedder: [x, sin(f0 x), cos(f0 x), sin(f1 x), ...] — raw xyz first, the
    order the geometric init of layer 0 relies on
  * DenseLayer: a linear layer stored as in the JAX pytree, `[out, in]`
    weights with weight norm w = g * v / ||v||_row (`v`, `g`, `b`), or plain
    (`w`, `b`)
  * ImplicitSurface: D+1 layers, skip concat [h, emb]/sqrt(2), IDR geometric
    sphere init, Softplus(beta=100) or (SIREN, no skips) sin(30 a) with the
    SIREN init, final layer = sdf row + geometry rows, optional
    sphere_residual prior sdf = (|x| - r) + f(x)
  * RadianceNet: [x_emb, view_emb, normals, geo] -> ReLU (or SIREN sine) MLP
    -> sigmoid rgb
  * NeRF: the NeRF++ background MLP (plain ReLU layers, a skip that
    concatenates [input, h] after its layer, raw sigma and sigmoid rgb), fed
    the inverted-sphere coordinates (x / r, 1 / r)
  * pretrain_siren_sdf: a SIREN surface fitted to a sphere's sdf before
    training (plain PyTorch, Adam on an L1 loss)
  * make_schedule / make_optimizer: the per-iteration lr factor and Adam with
    per-module learning rates

The NeRF-like (W_geo_feat < 0) surface head is not in the port yet (ROADMAP
Queue A, [A3]).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neurecon_tpu_torch.ops import fused_mlp, fused_nablas, fused_nablas_vjp
from neurecon_tpu_torch.ops.fused_nablas import effective_weight


class Embedder:
    """NeRF-style sin/cos frequency encoding; include_input=True, log-spaced."""

    def __init__(self, input_dim: int, multires: int):
        self.input_dim = input_dim
        self.multires = multires
        if multires < 0:
            self.out_dim = input_dim
            self.freq_bands = None
        else:
            self.freq_bands = [float(f) for f in np.asarray(
                2.0 ** np.linspace(0.0, multires - 1, multires), np.float32)]
            self.out_dim = input_dim + input_dim * multires * 2

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq_bands:  # multires < 0 (none) or 0 (no octaves)
            return x
        # Python scalars: exact, and no host-to-device copy of a table
        phases = torch.stack([x * f for f in self.freq_bands], dim=-2)  # [..., F, C]
        sc = torch.stack([torch.sin(phases), torch.cos(phases)], dim=-2)
        sc = sc.reshape(*x.shape[:-1], self.out_dim - self.input_dim)
        return torch.cat([x, sc], dim=-1)


def get_embedder(multires: int, input_dim: int = 3):
    emb = Embedder(input_dim, multires)
    return emb, emb.out_dim


class DenseLayer(nn.Module):
    """y = x @ W^T + b with the JAX pytree's parameter names and layout."""

    def __init__(self, in_dim: int, out_dim: int, weight_norm: bool):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(out_dim, in_dim))
            self.g = nn.Parameter(torch.empty(out_dim, 1))
        else:
            self.w = nn.Parameter(torch.empty(out_dim, in_dim))
        self.b = nn.Parameter(torch.empty(out_dim))

    @torch.no_grad()
    def set_weight(self, w: torch.Tensor, b: torch.Tensor):
        """Initialize from an effective weight; under weight norm g starts at
        the row norms, so the effective weight equals w."""
        if self.weight_norm:
            self.v.copy_(w)
            self.g.copy_(torch.linalg.norm(w, dim=1, keepdim=True))
        else:
            self.w.copy_(w)
        self.b.copy_(b)

    def forward(self, x):
        return F.linear(x, effective_weight(self), self.b)


def _torch_linear_default(in_dim: int, out_dim: int, gen: torch.Generator):
    """nn.Linear's default init: U(±1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(in_dim)
    w = (torch.rand(out_dim, in_dim, generator=gen) * 2 - 1) * bound
    b = (torch.rand(out_dim, generator=gen) * 2 - 1) * bound
    return w, b


SIREN_W0 = 30.0  # the sine layers' frequency: sin(w0 a)


def init_siren(in_dim: int, out_dim: int, is_first: bool, gen: torch.Generator,
               w0: float = SIREN_W0, c: float = 6.0):
    """A SIREN layer's (w, b): w ~ U(±1/in_dim) on the first layer,
    U(±sqrt(c / in_dim) / w0) on the others; b as nn.Linear's default."""
    _, b = _torch_linear_default(in_dim, out_dim, gen)
    bound = (1.0 / in_dim) if is_first else (math.sqrt(c / in_dim) / w0)
    w = (torch.rand(out_dim, in_dim, generator=gen) * 2 - 1) * bound
    return w, b


@torch.no_grad()
def perturb_parameters(module: nn.Module, gen: torch.Generator, scale: float = 0.1):
    """Add seeded noise to every DenseLayer of `module`, in place: to each
    weight entry `scale` times the RMS of the layer's nonzero weights, to each
    bias 0.1 * `scale`, and under weight norm a factor 1 + 0.1 N(0, 1) on g.

    A stand-in for trained weights where a check must see every weight. The
    geometric init is not one: it zeroes the octave columns of layer 0 and of
    the skip layer and gives all final rows nearly the same weights, so the
    positional encoding and the geometry-feature rows contribute nothing a
    comparison could catch. At the default scale the flagship surface stays a
    bumpy sphere (|grad sdf| about 0.8 on average), and zeroing its octave
    columns moves sdf by up to ~0.2."""
    for layer in module.modules():
        if not isinstance(layer, DenseLayer):
            continue
        dev = layer.b.device

        def noise(*shape):
            return torch.randn(*shape, generator=gen).to(dev)

        w = effective_weight(layer)
        std = scale * float(w[w != 0].square().mean().sqrt())
        layer.set_weight(w + std * noise(*w.shape),
                         layer.b + 0.1 * scale * noise(layer.out_dim))
        if layer.weight_norm:
            layer.g.mul_(1 + 0.1 * noise(layer.out_dim, 1))


def softplus100(x):
    """Softplus(beta=100): max(z,0) + log1p(exp(-|z|)) at z = 100 x, over 100."""
    return F.softplus(100.0 * x) / 100.0


def sine_w0(x, w0: float = SIREN_W0):
    return torch.sin(w0 * x)


class ImplicitSurface(nn.Module):
    """SDF MLP. forward -> sdf (and geometry features); forward_with_nablas
    -> (sdf, d sdf / dx, geometry features), through the forward+nablas
    kernel on a card and its plain version on the CPU; forward_query -> sdf
    alone, gradient-free, through the sdf-only kernel."""

    def __init__(self,
                 W: int = 256,
                 D: int = 8,
                 skips: Sequence[int] = (4,),
                 W_geo_feat: int = 256,
                 input_ch: int = 3,
                 radius_init: float = 1.0,
                 obj_bounding_size: float = 2.0,
                 geometric_init: bool = True,
                 embed_multires: int = 6,
                 weight_norm: bool = True,
                 use_siren: bool = False,
                 sphere_residual: bool = False):
        super().__init__()
        if use_siren and len(skips):
            raise ValueError("a SIREN surface takes no skips")
        if W_geo_feat <= 0:
            raise NotImplementedError(
                "the NeRF-like surface head (W_geo_feat < 0) is not ported "
                "yet (ROADMAP Queue A, [A3])")
        self.W, self.D = W, D
        self.skips = tuple(skips)
        self.W_geo_feat = W_geo_feat
        self.radius_init = radius_init
        self.obj_bounding_size = obj_bounding_size
        self.geometric_init = geometric_init
        self.embed_multires = embed_multires
        self.weight_norm = weight_norm
        self.use_siren = use_siren
        self.sphere_residual = sphere_residual
        self.embed_fn, self.input_ch = get_embedder(embed_multires, input_ch)

        self.dims = []
        for l in range(D + 1):
            if l == D:
                out_dim = 1 + W_geo_feat
            elif (l + 1) in self.skips:
                out_dim = W - self.input_ch  # reduce before skip concat
            else:
                out_dim = W
            in_dim = self.input_ch if l == 0 else W
            self.dims.append((in_dim, out_dim))
        self.layers = nn.ModuleList(
            DenseLayer(i, o, weight_norm) for i, o in self.dims)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        """Geometric sphere init of radius `radius_init` (IDR/SAL), or the
        SIREN init of the hidden layers (a sine net has no geometric init:
        `pretrain_siren_sdf` fits it to a sphere instead)."""
        for l, (in_dim, out_dim) in enumerate(self.dims):
            if self.use_siren and l != self.D:
                self.layers[l].set_weight(*init_siren(in_dim, out_dim, l == 0, gen))
                continue
            w, b = _torch_linear_default(in_dim, out_dim, gen)
            if self.geometric_init and not self.use_siren:
                std = math.sqrt(2) / math.sqrt(out_dim)
                if l == self.D:
                    w = (math.sqrt(math.pi) / math.sqrt(in_dim)
                         + 1e-4 * torch.randn(out_dim, in_dim, generator=gen))
                    b = torch.full((out_dim,), -self.radius_init)
                else:
                    w = std * torch.randn(out_dim, in_dim, generator=gen)
                    b = torch.zeros(out_dim)
                    if self.embed_multires > 0 and l == 0:
                        w[:, 3:] = 0.0  # octave channels start at zero weight
                    elif self.embed_multires > 0 and l in self.skips:
                        # concat order is [h, x_embed]: zero the octave tail
                        w[:, -(self.input_ch - 3):] = 0.0
            self.layers[l].set_weight(w, b)

    def activation(self, a: torch.Tensor) -> torch.Tensor:
        """The hidden layers' activation: sin(30 a) (SIREN) or Softplus(100)."""
        return sine_w0(a) if self.use_siren else softplus100(a)

    def activation_derivs(self, a: torch.Tensor):
        """(phi(a), phi'(a), phi''(a)) of `activation`: sin(w0 a),
        w0 cos(w0 a), -w0^2 sin(w0 a) (SIREN, w0 = SIREN_W0), or Softplus(100),
        s = sigmoid(100 a), 100 s (1 - s)."""
        if self.use_siren:
            sn = sine_w0(a)
            return sn, SIREN_W0 * torch.cos(SIREN_W0 * a), -SIREN_W0 * SIREN_W0 * sn
        s = torch.sigmoid(100.0 * a)
        return softplus100(a), s, 100.0 * s * (1.0 - s)

    def mlp(self, x: torch.Tensor, weights=None):
        """The MLP alone on flat points: x [M, 3] -> (sdf [M], h [M, W_geo]);
        `weights` (lists of effective [out, in] weights and of biases)
        replaces the layers' own."""
        ws, bs = weights if weights is not None else fused_nablas.surface_weights(self)
        emb = self.embed_fn(x)
        h = emb
        for i in range(self.D):
            if i in self.skips:
                h = torch.cat([h, emb], dim=-1) / np.sqrt(2)
            h = self.activation(F.linear(h, ws[i], bs[i]))
        out = F.linear(h, ws[self.D], bs[self.D])
        return out[:, 0], out[:, 1:]

    def forward(self, x: torch.Tensor, return_h: bool = False):
        prefix = x.shape[:-1]
        x_flat = x.reshape(-1, x.shape[-1])
        sdf, h = self.mlp(x_flat)
        if self.sphere_residual:
            sdf = sdf + sphere_sdf(x_flat, self.radius_init)
        sdf = sdf.reshape(prefix)
        return (sdf, h.reshape(prefix + h.shape[-1:])) if return_h else sdf

    def forward_with_nablas(self, x: torch.Tensor):
        """(sdf, nablas, h) at points x [..., 3]. With grad on and trainable
        parameters (or x), through the differentiable op (forward kernel 1,
        backward kernel 3); otherwise kernel 1 alone, building no graph (the
        render)."""
        prefix = x.shape[:-1]
        x_flat = x.reshape(-1, 3)
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            sdf, nablas, h = fused_nablas_vjp.forward_with_nablas_vjp(self, x_flat)
        else:
            sdf, nablas, h = fused_nablas.fused_forward_with_nablas(self, x_flat)
        if self.sphere_residual:
            sdf = sdf + sphere_sdf(x_flat, self.radius_init)
            nablas = nablas + sphere_nablas(x_flat)
        return (sdf.reshape(prefix), nablas.reshape(prefix + (3,)),
                h.reshape(prefix + h.shape[-1:]))

    @torch.no_grad()
    def forward_query(self, x: torch.Tensor) -> torch.Tensor:
        """Gradient-free sdf at points x [..., 3]: the sdf-only kernel on a
        card (its plain version on the CPU), plus the sphere_residual prior.
        Serves the mesh grids, the ray casters and the eval tools."""
        prefix = x.shape[:-1]
        x_flat = x.reshape(-1, 3).contiguous()
        sdf = fused_mlp.fused_sdf_forward(self, x_flat)
        if self.sphere_residual:
            sdf = sdf + sphere_sdf(x_flat, self.radius_init)
        return sdf.reshape(prefix)

    forward_fast = forward_query  # the JAX package's name for the kernel path


def sphere_sdf(x: torch.Tensor, radius: float) -> torch.Tensor:
    """|x| - radius of the sphere_residual prior; the eps keeps the gradient
    finite at the origin."""
    return torch.sqrt(torch.sum(x * x, -1) + 1e-12) - radius


def sphere_nablas(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x * x, -1, keepdim=True) + 1e-12)


class RadianceNet(nn.Module):
    def __init__(self,
                 D: int = 4,
                 W: int = 256,
                 skips: Sequence[int] = (),
                 W_geo_feat: int = 256,
                 embed_multires: int = 6,
                 embed_multires_view: int = 4,
                 use_view_dirs: bool = True,
                 weight_norm: bool = True,
                 use_siren: bool = False):
        super().__init__()
        if use_siren and len(skips):
            raise ValueError("a SIREN radiance net takes no skips")
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.use_view_dirs = use_view_dirs
        self.use_siren = use_siren
        self.weight_norm = weight_norm
        self.embed_fn, input_ch_pts = get_embedder(embed_multires, 3)
        if use_view_dirs:
            self.embed_fn_view, input_ch_views = get_embedder(embed_multires_view, 3)
            self.in_dim_0 = input_ch_pts + input_ch_views + 3 + W_geo_feat
        else:
            self.embed_fn_view = None
            self.in_dim_0 = input_ch_pts + W_geo_feat

        self.dims = []
        for l in range(D + 1):
            out_dim = 3 if l == D else W
            if l == 0:
                in_dim = self.in_dim_0
            elif l in self.skips:
                in_dim = self.in_dim_0 + W
            else:
                in_dim = W
            self.dims.append((in_dim, out_dim))
        self.layers = nn.ModuleList(
            DenseLayer(i, o, weight_norm) for i, o in self.dims)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        for l, (layer, (in_dim, out_dim)) in enumerate(zip(self.layers, self.dims)):
            if self.use_siren and l != self.D:
                layer.set_weight(*init_siren(in_dim, out_dim, l == 0, gen))
            else:
                layer.set_weight(*_torch_linear_default(in_dim, out_dim, gen))

    def forward(self, x, view_dirs, normals, geometry_feature):
        prefix = x.shape[:-1]
        x = self.embed_fn(x.reshape(-1, x.shape[-1]))
        parts = [x]
        if self.use_view_dirs:
            parts += [self.embed_fn_view(view_dirs.reshape(-1, view_dirs.shape[-1])),
                      normals.reshape(-1, normals.shape[-1])]
        parts.append(geometry_feature.reshape(-1, geometry_feature.shape[-1]))
        radiance_input = torch.cat(parts, dim=-1)

        h = radiance_input
        for i in range(self.D + 1):
            if i in self.skips:
                h = torch.cat([h, radiance_input], dim=-1)
            h = self.layers[i](h)
            if i == self.D:
                h = torch.sigmoid(h)
            else:
                h = sine_w0(h) if self.use_siren else torch.relu(h)
        return h.reshape(prefix + (3,))


class NeRF(nn.Module):
    """The vanilla NeRF MLP of the NeRF++ background: D ReLU layers of width
    W on the encoded input (`multires` octaves), whose skip layers
    concatenate [input_pts, h] after their activation; raw sigma from
    `alpha_linear`, and rgb from feature_linear -> [feature, view_emb] ->
    views_linear (W / 2, ReLU) -> rgb_linear -> sigmoid. Returns (sigma
    [...], rgb [..., 3]). Plain layers (no weight norm), initialized as
    nn.Linear is. (The JAX package's net without view dirs has no caller.)"""

    HEADS = ("views_linear", "feature_linear", "alpha_linear", "rgb_linear")

    def __init__(self, D: int = 8, W: int = 256, input_ch: int = 3,
                 input_ch_view: int = 3, multires: int = -1,
                 multires_view: int = -1, skips: Sequence[int] = (4,)):
        super().__init__()
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.embed_fn, self.input_ch = get_embedder(multires, input_ch)
        self.embed_fn_view, self.input_ch_view = get_embedder(multires_view, input_ch_view)
        dims = [(self.input_ch, W)] + [(W + self.input_ch if i in self.skips else W, W)
                                       for i in range(D - 1)]
        self.pts_linears = nn.ModuleList(DenseLayer(i, o, False) for i, o in dims)
        self.views_linear = DenseLayer(self.input_ch_view + W, W // 2, False)
        self.feature_linear = DenseLayer(W, W, False)
        self.alpha_linear = DenseLayer(W, 1, False)
        self.rgb_linear = DenseLayer(W // 2, 3, False)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator):
        for layer in [*self.pts_linears, *(getattr(self, n) for n in self.HEADS)]:
            layer.set_weight(*_torch_linear_default(layer.in_dim, layer.out_dim, gen))

    def forward(self, input_pts, input_views):
        input_pts = self.embed_fn(input_pts)
        h = input_pts
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([input_pts, h], dim=-1)
        sigma = self.alpha_linear(h)
        h = torch.cat([self.feature_linear(h), self.embed_fn_view(input_views)], dim=-1)
        rgb = self.rgb_linear(torch.relu(self.views_linear(h)))
        return sigma[..., 0], torch.sigmoid(rgb)


def outside_nerf() -> NeRF:
    """The background net of NeuS (no mask) and VolSDF (`outside_scene:
    nerf++`): input (x / r, 1 / r), 10 octaves, 4 view octaves, D=8, W=256."""
    return NeRF(input_ch=4, multires=10, multires_view=4)


def pretrain_siren_sdf(surface: ImplicitSurface, num_iters: int = 5000, lr: float = 1.0e-4,
                       batch_points: int = 5000, target_radius: float = 0.5,
                       obj_bounding_size: float = 3.0, generator=None, points=None):
    """Fit a SIREN surface to a sphere's sdf, in place (port of the JAX
    package's `pretrain_siren_sdf`): `num_iters` Adam steps (lr `lr`) on the
    mean L1 between the surface's sdf and |x| - `target_radius` at
    `batch_points` points uniform in [-obj_bounding_size, obj_bounding_size]^3,
    drawn anew each step from `generator` (a torch.Generator on the surface's
    device). `points` (a callable step -> [batch_points, 3] tensor) replaces
    the draws, so that a test can feed the JAX package's. Plain PyTorch
    through `surface.forward`, as in JAX: no kernel. Returns the losses
    [num_iters] (a device tensor)."""
    params = list(surface.parameters())
    device = params[0].device
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses = torch.empty(num_iters, device=device)
    for i in range(num_iters):
        if points is not None:
            pts = points(i)
        else:
            pts = (torch.rand(batch_points, 3, generator=generator, device=device) * 2 - 1
                   ) * obj_bounding_size
        sdf_gt = torch.linalg.norm(pts, dim=-1) - target_radius
        loss = torch.mean(torch.abs(surface.forward(pts) - sdf_gt))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    opt.zero_grad(set_to_none=True)
    return losses


# ---------------------------------------------------------------------------
# LR schedules & optimizer factory
# ---------------------------------------------------------------------------

def make_schedule(args):
    """factor(step) multiplying the base lr, stepped per iteration: the JAX
    package's `make_schedule`, in float32 like its jnp arithmetic."""
    f32 = np.float32
    stype = args.training.scheduler.type
    total = int(args.training.num_iters)
    if stype == "multistep":
        milestones = np.asarray(sorted(args.training.scheduler.milestones))
        gamma = f32(args.training.scheduler.gamma)

        def factor(step):
            return float(gamma ** int(np.sum(step >= milestones)))
    elif stype == "warmupcosine":
        warmup = int(args.training.scheduler.warmup_steps)
        min_factor = float(args.training.scheduler.setdefault("min_factor", 0.1))

        def factor(step):
            step = f32(step)
            if step < warmup:
                return float(step / f32(warmup))
            cos = f32(np.cos(f32(np.pi) * (step - f32(warmup)) / f32(total - warmup)))
            return float((cos + f32(1.0)) * f32(0.5) * f32(1 - min_factor)
                         + f32(min_factor))
    elif stype == "exponential_step":
        min_factor = float(args.training.scheduler.setdefault("min_factor", 0.1))

        def factor(step):
            t = np.clip(f32(step) / f32(total), f32(0), f32(1))
            return float(np.exp(t * np.log(f32(min_factor))))
    else:
        raise NotImplementedError(stype)
    return factor


def make_optimizer(args, model: nn.Module):
    """(Adam, LambdaLR) with the per-iteration schedule. `training.lr` is a
    scalar or a dict of per-top-level-module rates with a 'default' entry
    (`ln_s` or `ln_beta`, `implicit_surface`, `radiance_net`): one param
    group per named module, the rest in the default group.

    torch.optim.Adam with its defaults is optax.adam: b1 0.9, b2 0.999, eps
    1e-8 added outside the square root, bias-corrected moments. LambdaLR
    sets the lr to base * factor(0) at construction and is stepped after each
    optimizer step, so step k runs at factor(k), as optax evaluates the
    schedule at its count (step 0 of warmup-cosine moves nothing)."""
    factor = make_schedule(args)
    lr_cfg = args.training.lr
    params = _top_level_params(model)
    if isinstance(lr_cfg, dict):
        lr_dict = dict(lr_cfg)
        default_lr = float(lr_dict.pop("default"))
        groups = [{"params": ps, "lr": float(lr_dict[name]), "name": name}
                  for name, ps in params.items() if name in lr_dict]
        rest = [p for name, ps in params.items() if name not in lr_dict for p in ps]
        if rest:
            groups.append({"params": rest, "lr": default_lr, "name": "default"})
    else:
        groups = [{"params": list(model.parameters()), "lr": float(lr_cfg),
                   "name": "default"}]
    optimizer = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, factor)
    return optimizer, scheduler


def _top_level_params(model: nn.Module) -> dict:
    """{name: [parameters]} per top-level entry of the JAX pytree."""
    out = {}
    for name, p in model.named_parameters():
        out.setdefault(name.split(".")[0], []).append(p)
    return out


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())

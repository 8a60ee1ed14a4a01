"""Split the VolSDF fine sampler's gap at sharp beta between the sdf-only
kernel and the sampler kernels (a)-(c), on one CUDA card:

    python -m neurecon_tpu_torch.tools.sampler_gap

The flagship surface (D=8, W=256, skip at 4, encoding 6; geometric init,
then seeded noise on every weight), 1,024 rays from (0, 0, -3) inside the
background sphere, n0 = n_up = 512, 6 rounds, 16 final depths, det and
perturb uniforms, beta_net 0.01 and 0.001. Three routes: the kernels
((a)-(c) and kernel 4), the plain sampler, and the plain sampler with
kernel 4 as its only sdf query.
For each pair, one JSON line per beta_net and uniforms gives: the share of
fine depths beyond 1e-4 of the span, the share of rays whose beta map is off
(rtol 1e-3 / atol 1e-5), the share of rays with equal iter_usage. The JAX
package holds its Pallas sampler to its plain one at 2%, 1% and 90%.
"""
from __future__ import annotations

import json
import sys
from unittest import mock

import numpy as np
import torch

from neurecon_tpu_torch.models.base import perturb_parameters
from neurecon_tpu_torch.models.frameworks.neus import NeuS
from neurecon_tpu_torch.ops import fused_fine_sample
from neurecon_tpu_torch.ops.sampling import linspace01

FLAGSHIP = dict(W=256, D=8, skips=[4], radius_init=0.5, embed_multires=6)
N, N0, N_UP, MAX_ITER, N_FINAL, SPAN = 1024, 512, 512, 6, 16, 6.0
BETAS, SEED = (0.01, 0.001), 0


def _surface(dev):
    model = NeuS(W_geo_feat=256, surface_cfg=FLAGSHIP,
                 radiance_cfg=dict(D=1, W=32, skips=[], embed_multires=-1,
                                   embed_multires_view=-1))
    model.reset_parameters(torch.Generator().manual_seed(SEED))
    perturb_parameters(model, torch.Generator().manual_seed(SEED + 1))
    return model.to(dev).implicit_surface


def _rays(dev):
    rng = np.random.RandomState(SEED)
    th = rng.uniform(-0.3, 0.3, (N, 2)).astype(np.float32)
    d = np.stack([np.sin(th[:, 0]), np.sin(th[:, 1]) * np.cos(th[:, 0]),
                  np.cos(th[:, 1]) * np.cos(th[:, 0])], -1)
    o = np.broadcast_to(np.array([0.0, 0.0, -3.0], np.float32), d.shape)
    return (torch.tensor(np.ascontiguousarray(o), device=dev),
            torch.tensor(d, dtype=torch.float32, device=dev))


def _compare(a, b):
    """[share of depths beyond 1e-4 span, share of rays with the beta map
    off, share of rays with equal iter_usage]"""
    return [float(((a[0] - b[0]).abs() > 1e-4 * SPAN).float().mean()),
            float(((a[1] - b[1]).abs() > 1e-5 + 1e-3 * b[1].abs()).float().mean()),
            float((a[2] == b[2]).float().mean())]


def sampler_gap(dev):
    surf = _surface(dev)
    rays_o, rays_d = _rays(dev)
    far = torch.full((N, 1), SPAN, device=dev)
    d_init = (far * linspace01(N0, dev)).contiguous()
    kw = dict(eps=0.1, max_iter=MAX_ITER, max_bisection=10, n_final=N_FINAL, n_up=N_UP,
              sphere_bg_r=3.0)
    for beta in BETAS:
        ab = (torch.tensor(1.0 / beta, device=dev), torch.tensor(beta, device=dev))
        for perturb in (True, False):
            u = (torch.rand(N, (MAX_ITER + 2) * N_FINAL, device=dev,
                            generator=torch.Generator(dev).manual_seed(5)) if perturb
                 else fused_fine_sample.det_uniforms(N_FINAL, MAX_ITER + 2, N, dev))
            args = (surf, rays_o, rays_d, d_init, far, *ab, u)
            got = fused_fine_sample.fused_fine_sample(*args, **kw)
            ref = fused_fine_sample.fine_sample_plain(*args, **kw)
            with mock.patch.object(surf, "forward", surf.forward_query):
                q4 = fused_fine_sample.fine_sample_plain(*args, **kw)
            torch.cuda.synchronize()
            print(json.dumps({"beta_net": beta, "perturb": perturb,
                              "kernels_vs_plain": _compare(got, ref),
                              "plain_with_kernel4_vs_plain": _compare(q4, ref),
                              "kernels_vs_plain_with_kernel4": _compare(got, q4)}),
                  flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    sampler_gap(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's Pallas VolSDF fine sampler (interpret mode, on the CPU)
against its plain `fine_sample` at sharp beta: the share of fine depths
beyond 1e-4 of the span (tests/test_fused_fine_sample.py holds 2%), of beta
maps off (rtol 1e-3, atol 1e-5) and of equal iter_usage, at beta_net 0.01
and 0.001, det and perturb uniforms, n0 = N_up = 512, 6 rounds.

    JAX_PLATFORMS=cpu python tests/jax_sampler_sharp.py [--inputs card|phase14] [--rays N]

`card` (default, 1,024 rays): the inputs of the port's card test
`test_fine_sample_kernels_match_plain` (tests/test_torch_cuda.py): the
flagship surface, geometric init from seed 0 plus seeded noise, rays from
(0, 0, -3), far 6, 16 fine samples, the background sphere of radius 3.
`phase14` (default 256 rays, spread over phase 14's 1,024):
chip_smoke.py phase 14's VolSDF model with seeded noise and rays, 64 fine
samples. Both JAX paths get the same weights (through the port's bridge),
rays and uniforms. Not a tier-1 test (a case takes ~1-2 min, most of it
compiling the interpreted kernel); run from the repository root.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from neurecon_tpu.models.frameworks.volsdf import fine_sample  # noqa: E402
from neurecon_tpu.ops.fused_fine_sample import fused_fine_sample  # noqa: E402
from neurecon_tpu_torch import bridge  # noqa: E402


def _card_inputs(n_rays):
    """(JAX surface, its params, rays_o, rays_d, far, n_final, bg radius)."""
    from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
    from tests.test_torch_cuda import FLAGSHIP, _model, _rays

    ts = _model(FLAGSHIP, 256, torch.device("cpu")).implicit_surface
    js = JaxSurface(W_geo_feat=256, weight_norm=ts.layers[0].weight_norm, **FLAGSHIP)
    params = jax.tree_util.tree_map(jnp.asarray, bridge._layers_to_tree(ts.layers))
    ro, rd = _rays(n_rays, torch.device("cpu"))
    return (js, params, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
            jnp.full((n_rays, 1), 6.0), 16, 3.0)


def _phase14_inputs(n_rays):
    import chip_smoke
    from neurecon_tpu.config import ConfigDict as JaxConfigDict
    from neurecon_tpu.models.frameworks import get_model as jax_get_model

    *_, checked, _, _, _, (ro, rd, far) = chip_smoke.volsdf_check_inputs(0, torch.device("cpu"))
    jm, *_ = jax_get_model(JaxConfigDict(chip_smoke.VOLSDF))
    params = jax.tree_util.tree_map(jnp.asarray, bridge.model_to_tree(checked))
    idx = np.linspace(0, ro.shape[0] - 1, n_rays).astype(int)
    return (jm.implicit_surface, params["implicit_surface"], jnp.asarray(ro.numpy()[idx]),
            jnp.asarray(rd.numpy()[idx]), jnp.asarray(far.numpy()[idx]), 64,
            jm.obj_bounding_radius)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", choices=("card", "phase14"), default="card")
    ap.add_argument("--rays", type=int, default=None)
    opts = ap.parse_args(argv)
    n_rays = opts.rays or (1024 if opts.inputs == "card" else 256)
    torch.set_num_threads(4)
    make = _card_inputs if opts.inputs == "card" else _phase14_inputs
    js, p, rays_o, rays_d, far, n_final, bg = make(n_rays)
    n0, n_up, max_iter = 512, 512, 6
    d_init = far * jnp.linspace(0.0, 1.0, n0)

    def query(x):
        return jnp.minimum(js.forward(p, x), bg - jnp.linalg.norm(x, axis=-1))

    for beta in (0.01, 0.001):
        for perturb in (False, True):
            key = jax.random.PRNGKey(9)
            t0 = time.time()
            ref = jax.jit(lambda: fine_sample(
                query, d_init, rays_o, rays_d, alpha_net=jnp.float32(1.0 / beta),
                beta_net=jnp.float32(beta), far=far, key=key, eps=0.1, max_iter=max_iter,
                max_bisection=10, final_N_importance=n_final, N_up=n_up, perturb=perturb))()
            jax.block_until_ready(ref)
            t1 = time.time()
            keys = jax.random.split(key, max_iter + 2)
            us = [jax.random.uniform(keys[i], (n_rays, n_final)) if perturb else
                  jnp.broadcast_to(jnp.linspace(0.0, 1.0, n_final), (n_rays, n_final))
                  for i in range(max_iter + 2)]
            got = fused_fine_sample(
                js, p, rays_o, rays_d, d_init, far, jnp.float32(1.0 / beta),
                jnp.float32(beta), jnp.concatenate(us, -1), eps=0.1, max_iter=max_iter,
                max_bisection=10, n_final=n_final, n_up=n_up, tile=8, interpret=True,
                sphere_bg_r=bg)
            jax.block_until_ready(got)
            t2 = time.time()
            (rdv, rb, ri), (gdv, gb, gi) = ref, got
            dd = np.abs(np.asarray(gdv) - np.asarray(rdv))
            print(json.dumps({
                "inputs": opts.inputs, "beta_net": beta,
                "mode": "perturb" if perturb else "det", "rays": n_rays,
                "fine_share_beyond_1e-4_span": float((dd > 1e-4 * np.asarray(far)).mean()),
                "fine_max_diff": float(dd.max()),
                "beta_off_share": float((np.abs(np.asarray(gb) - np.asarray(rb))
                                         > 1e-5 + 1e-3 * np.abs(np.asarray(rb))).mean()),
                "iter_usage_equal": float((np.asarray(gi) == np.asarray(ri)).mean()),
                "never_converged": int((np.asarray(ri) < 0).sum()),
                "plain_s": round(t1 - t0, 1), "pallas_interpret_s": round(t2 - t1, 1)}),
                flush=True)


if __name__ == "__main__":
    main()

"""The port's ray and sampling ops and its config loader against the JAX
package, on identical numpy inputs."""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu import config as jax_config
from neurecon_tpu.ops import get_rays as jax_get_rays
from neurecon_tpu.ops import near_far_from_sphere as jax_near_far
from neurecon_tpu.ops import sampling as jax_sampling
from neurecon_tpu.utils.camera import look_at

from neurecon_tpu_torch import config as torch_config
from neurecon_tpu_torch import get_device
from neurecon_tpu_torch.ops import get_rays, near_far_from_sphere, sampling

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..",
                                        "configs", "*.yaml")))

# float32 ops in the same order on both sides; 1e-6 leaves room for a
# last-ulp difference at the magnitudes used (|values| <= ~4)
ATOL = 1e-6


def _camera(seed):
    rng = np.random.RandomState(seed)
    loc = rng.randn(3)
    loc = 3.0 * loc / np.linalg.norm(loc)
    c2w = look_at(loc, np.zeros(3)).astype(np.float32)
    intr = np.eye(4, dtype=np.float32)
    intr[0, 0], intr[1, 1] = 150.0, 140.0
    intr[0, 2], intr[1, 2], intr[0, 1] = 16.0, 12.5, 0.3  # with skew
    return c2w, intr


@pytest.mark.parametrize("seed", [0, 1])
def test_get_rays_and_near_far(seed):
    c2w, intr = _camera(seed)
    H, W = 24, 32
    ro_j, rd_j, _ = jax_get_rays(None, jnp.asarray(c2w), jnp.asarray(intr), H, W,
                                 N_rays=-1)
    ro, rd, inds = get_rays(torch.tensor(c2w), torch.tensor(intr), H, W)
    np.testing.assert_allclose(ro.numpy(), np.asarray(ro_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rd.numpy(), np.asarray(rd_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(inds.numpy(), np.arange(H * W))

    rd_n = rd_j / jnp.linalg.norm(rd_j, axis=-1, keepdims=True)
    near_j, far_j = jax_near_far(ro_j, rd_n, r=1.0)
    near, far = near_far_from_sphere(torch.tensor(np.asarray(ro_j)),
                                     torch.tensor(np.asarray(rd_n)), r=1.0)
    np.testing.assert_allclose(near.numpy(), np.asarray(near_j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(far.numpy(), np.asarray(far_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("side", ["left", "right"])
def test_searchsorted(side):
    rng = np.random.RandomState(2)
    a = np.sort(rng.rand(7, 40).astype(np.float32), axis=-1)
    v = rng.rand(7, 13).astype(np.float32)
    v[:, 0] = a[:, 5]  # exact ties exercise the side semantics
    want = np.asarray(jax_sampling.searchsorted(jnp.asarray(a), jnp.asarray(v), side))
    got = sampling.searchsorted(torch.tensor(a), torch.tensor(v), side).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_same_u(det):
    rng = np.random.RandomState(3)
    bins = np.sort(rng.uniform(0.5, 3.5, (9, 33)).astype(np.float32), axis=-1)
    # weights bounded away from 0: a bin of mass ~1e-5 would scale a cdf
    # ulp by its width / 1e-5 and measure conditioning, not semantics
    w = rng.uniform(0.05, 1.0, (9, 32)).astype(np.float32)
    n = 16
    if det:
        want = jax_sampling.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), n,
                                       det=True)
        u = np.broadcast_to(np.linspace(0, 1, n, dtype=np.float32), (9, n))
    else:
        u = rng.rand(9, n).astype(np.float32)
        w5 = jnp.asarray(w) + 1e-5
        pdf = w5 / jnp.sum(w5, -1, keepdims=True)
        cdf = jnp.concatenate([jnp.zeros((9, 1)), jnp.cumsum(pdf, -1)], -1)
        want = jax_sampling._invert_cdf(jnp.asarray(bins), cdf, jnp.asarray(u), 1e-5)
    got = sampling.sample_pdf(torch.tensor(bins), torch.tensor(w),
                              torch.tensor(np.ascontiguousarray(u)))
    got, want = got.numpy(), np.asarray(want)
    if det:
        # u = 1.0 meets cdf[-1] = 1 +- an ulp, which the two cumsums round
        # differently: the sample lands at the far end or inside the last
        # bin. Held to the last bin; every other u is held tightly below.
        last = got[:, -1]
        assert np.all((last >= bins[:, -2]) & (last <= bins[:, -1]))
        got, want = got[:, :-1], want[:, :-1]
    # the two cumsums round differently in the last ulp, and the lerp
    # (u - cdf_b) / denom scales that by bin width / bin mass: a few ulp of
    # the depth (~1e-6 relative at depths up to 3.5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_like_jax(path):
    args = ["--config", path, "--training:lr", "0.001"]
    a_j, unk_j = jax_config.create_args_parser().parse_known_args(args)
    want = jax_config.load_config(a_j, unk_j).to_dict()
    got, _ = torch_config.parse_cli(argv=args)
    assert got.to_dict() == want
    with pytest.raises(KeyError):
        _ = got["no_such_key"]


def test_device_helper():
    assert get_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            get_device()


@pytest.mark.parametrize("n", [1, 2, 17, 64, 257, 2048])
def test_linspace01_matches_jnp_linspace(n):
    """Bit for bit, as the port's samplers rely on (made without a host
    copy since the pipelined step's side stream runs it)."""
    from neurecon_tpu_torch.ops.sampling import linspace01

    np.testing.assert_array_equal(linspace01(n).numpy(), np.asarray(jnp.linspace(0.0, 1.0, n)))

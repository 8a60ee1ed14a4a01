"""The port's differentiable surface op (`ops/fused_nablas_vjp.py`) against the
JAX package, on the CPU: the plain four-phase backward (what the CUDA kernel
`csrc/nablas_backward.cu` is held to on the card) against the JAX custom-VJP
Pallas op in interpret mode, against the plain `jax.grad` path at the
flagship width, and against torch's own double-backward autograd."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurecon_tpu.models.base import ImplicitSurface as JaxSurface
from neurecon_tpu.ops.fused_nablas_vjp import fused_forward_with_nablas_vjp

from neurecon_tpu_torch import bridge
from neurecon_tpu_torch.models.base import ImplicitSurface, perturb_parameters
from neurecon_tpu_torch.ops import fused_nablas, fused_nablas_vjp

SMALL = dict(W=64, D=3, skips=(1,), W_geo_feat=64, embed_multires=4)
FLAGSHIP = dict(W=256, D=8, skips=(4,), W_geo_feat=256, embed_multires=6)

# Every comparison is rel-to-max per leaf, max|diff| / max|ref| < 2e-4: the
# JAX package's own bound between its kernel and its plain path
# (tests/test_fused_nablas_vjp.py), fp32 sums in another order on each side.
TOL = 2e-4


def _pair(cfg, perturb, seed=0):
    """The JAX surface and the port's with the same weights: the JAX init,
    or (`perturb`) that init plus seeded noise on every weight, so that the
    octave columns and the geometry rows take part."""
    js = JaxSurface(weight_norm=True, **cfg)
    params = jax.jit(js.init)(jax.random.PRNGKey(seed))
    ts = ImplicitSurface(weight_norm=True, **cfg)
    bridge._load_layers(ts.layers, jax.tree_util.tree_map(np.asarray, params),
                        "implicit_surface")
    if perturb:
        perturb_parameters(ts, torch.Generator().manual_seed(seed + 1))
        params = jax.tree_util.tree_map(
            jnp.asarray, bridge._layers_to_tree(ts.layers))
    return js, params, ts


def _points(n, seed=1):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * 0.6


def _loss_terms(sdf, nablas, h, xp):
    """A loss touching every output: sdf directly, the eikonal term on
    nablas (the grad-of-grad path) and an rgb-like term on h
    (tests/test_fused_nablas_vjp.py:_loss_terms, in either framework)."""
    eik = xp.mean((xp.linalg.norm(nablas, axis=-1) - 1.0) ** 2) if xp is jnp else \
        torch.mean((torch.linalg.norm(nablas, dim=-1) - 1.0) ** 2)
    return xp.mean(xp.tanh(sdf) ** 2) + eik + xp.mean(xp.sin(3.0 * h[..., :8]))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def _port_grads(ts, x):
    """Loss, outputs and grads (JAX pytree of the surface, x) through the
    port's op: forward_with_nablas with grad on takes the Function."""
    ts.zero_grad(set_to_none=True)
    xt = torch.tensor(x, requires_grad=True)
    out = ts.forward_with_nablas(xt)
    loss = _loss_terms(*out, torch)
    loss.backward()
    tree = {"layers": [{n: getattr(layer, n).grad.numpy() for n in ("v", "g", "b")}
                       for layer in ts.layers]}
    return loss.item(), [o.detach().numpy() for o in out], tree, xt.grad.numpy()


def _check(got, want):
    loss, outs, tree, gx = got
    loss_j, outs_j, tree_j, gx_j = want
    assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
    for a, b in zip(outs, outs_j):
        assert _rel(a, b) < TOL
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(tree_j),
                            jax.tree_util.tree_leaves(tree)):
        assert _rel(b, a) < TOL, (jax.tree_util.keystr(path), _rel(b, a))
    assert _rel(gx, gx_j) < TOL


def _jax_grads(fn, params, x):
    def loss(p, x_):
        return _loss_terms(*fn(p, x_), jnp)
    outs = jax.jit(fn)(params, jnp.asarray(x))
    val, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    return float(val), [np.asarray(o) for o in outs], gp, np.asarray(gx)


@pytest.mark.parametrize("perturb", [False, True])
def test_plain_backward_matches_jax_kernel_interpret(perturb):
    """W=64, D=3, skip 1, multires 4; M = 37 on a tile of 32, so the JAX
    kernel runs a ragged last tile."""
    js, params, ts = _pair(SMALL, perturb)
    x = _points(37)
    want = _jax_grads(lambda p, x_: fused_forward_with_nablas_vjp(
        js, p, x_, tile=32, interpret=True), params, x)
    _check(_port_grads(ts, x), want)


def test_plain_backward_matches_jax_grad_at_flagship_width():
    js, params, ts = _pair(FLAGSHIP, perturb=True)
    x = _points(300, seed=2)
    want = _jax_grads(js.forward_with_nablas, params, x)
    _check(_port_grads(ts, x), want)


@pytest.mark.parametrize("cfg", [SMALL, dict(SMALL, embed_multires=-1),
                                 dict(SMALL, embed_multires=0)])
def test_plain_backward_matches_torch_double_backward(cfg):
    """The hand derivation against torch's create_graph autograd of the
    same MLP (no JAX), including the encodings without octaves."""
    ts = ImplicitSurface(weight_norm=True, **cfg)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    perturb_parameters(ts, torch.Generator().manual_seed(1))
    x = _points(50, seed=3)
    got = _port_grads(ts, x)

    ts.zero_grad(set_to_none=True)
    xt = torch.tensor(x, requires_grad=True)
    sdf, h = ts.mlp(xt)
    (nablas,) = torch.autograd.grad(sdf.sum(), xt, create_graph=True)
    loss = _loss_terms(sdf, nablas, h, torch)
    assert abs(loss.item() - got[0]) <= 1e-5 * abs(loss.item())
    loss.backward()
    for layer_got, layer in zip(got[2]["layers"], ts.layers):
        for n in ("v", "g", "b"):
            assert _rel(layer_got[n], getattr(layer, n).grad.numpy()) < TOL, n
    assert _rel(got[3], xt.grad.numpy()) < TOL


def test_render_builds_no_graph_and_launches_no_backward():
    """Under no_grad the surface query is the forward alone: no graph."""
    ts = ImplicitSurface(weight_norm=True, **SMALL)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.tensor(_points(20))
    with torch.no_grad():
        out = ts.forward_with_nablas(x)
    assert all(o.grad_fn is None for o in out)
    out = ts.forward_with_nablas(x)
    names, todo = set(), [out[0].grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None:
            names.add(type(fn).__name__)
            todo += [f for f, _ in fn.next_functions]
    assert "SurfaceWithNablasBackward" in names, names


def test_layout_and_unflatten():
    """The kernel's workspace layout: 128-point tiles (the last one ragged),
    reduced in k-tiles of 16 rows, columns padded to 64, two row pairs per
    hidden layer, and the flat gradient with gsdfbar folded into row 0 of the
    final weight."""
    dims = [(39, 256), (256, 217), (256, 257)]
    lay = fused_nablas_vjp._layout(dims, 300)
    assert lay["m_tiles"] == 3 and lay["n_split"] == 1
    a_off, b_off, ld_a, ld_b, n_out, n_in, k_tiles, c_off, bias, tile, pairs, _ = lay["jobs"][0]
    assert (ld_a, ld_b, k_tiles, pairs) == (256, 64, 2 * 3 * 128 // 16, 2)
    assert lay["jobs"][1][0] == 2 * 3 * 128 * (256 + 64)
    assert lay["jobs"][2][6] == 3 * 128 // 16 and lay["jobs"][2][11] == 256 + 217 + 257
    assert fused_nablas_vjp._layout(dims, 130560)["n_split"] == 32
    assert lay["total"] == 39 * 256 + 256 * 217 + 256 * 257 + 256 + 217 + 257 + 256
    flat = torch.arange(lay["total"], dtype=torch.float32)
    wbars, bbars = fused_nablas_vjp._unflatten(flat.clone(), dims)
    assert [tuple(w.shape) for w in wbars] == [(256, 39), (217, 256), (257, 256)]
    gsd = flat[-256:]
    base = flat[lay["jobs"][2][7]:lay["jobs"][2][7] + 257 * 256].view(257, 256)
    assert torch.equal(wbars[2][0], base[0] + gsd)
    assert torch.equal(wbars[2][1:], base[1:])
    assert torch.equal(bbars[1], flat[lay["bias_flat_off"] + 256:][:217])


def test_empty_and_cpu_routes():
    ts = ImplicitSurface(weight_norm=True, **SMALL)
    ts.reset_parameters(torch.Generator().manual_seed(0))
    ws, bs = fused_nablas.surface_weights(ts)
    x = torch.zeros(0, 3)
    xbar, wbars, bbars = fused_nablas_vjp.fused_nablas_vjp(
        ts, x, ws, bs, torch.zeros(0), torch.zeros(0, 3), torch.zeros(0, 64))
    assert xbar.shape == (0, 3)
    assert all(float(w.abs().sum()) == 0 for w in wbars + bbars)
    before = fused_nablas_vjp.fused_nablas_vjp.launches
    ts.forward_with_nablas(torch.tensor(_points(5)))[0].sum().backward()
    assert fused_nablas_vjp.fused_nablas_vjp.launches == before  # CPU: the plain version

"""The design of the VolSDF sampler's kernels (`csrc/volsdf_fine_sample.cu`),
emulated in torch on the CPU: the det draw of kernels (b) and (c), and the
one-pass sweeps of kernel (a).

The kernels invert the det cdf as a merge: the uniforms u_j = (j + 1) step
ascend, so each thread counts, for each cdf entry of its chunk, the uniforms
at or below it (`det_count`), and writes the index i of every draw with
cdf[i-1] < u_j <= cdf[i]. On a monotone cdf that is the count of cdf
entries below u_j, the index `sample_pdf`'s searchsorted route takes. Where
the chunks' sums let the cdf fall at a chunk boundary, the kernel searches
as before. These tests hold an emulation of that logic, step for step, to
`sample_pdf` and to `torch.searchsorted`, on seeded bounds with zero
bounds, bounds clipped at 1e5 beside them (flat cdf segments), and exact
ties of u with cdf entries.

Kernel (a) runs its two error-bound sweeps (at the net's beta and at beta+)
in one pass over each thread's chunk with one block scan of the four sums,
and takes the opacity cdf 1 - exp(-R) from the net sweep's own exp(-R). The
emulation below sums in the kernel's order (per thread over `chunk_of`'s
partition, the warps' Hillis-Steele scans, then the same scan of the warp
totals) and is held to `init_plain`, and its cdf to a separate opacity pass
bit for bit. This file imports no JAX.
"""
import numpy as np
import pytest
import torch

from neurecon_tpu_torch.ops import fused_fine_sample as ffs
from neurecon_tpu_torch.ops.sampling import linspace01, sample_pdf


def _det_u(j, step):
    """u_j = float32(j + 1) * step, rounded once (the kernels' det_u)."""
    return (torch.as_tensor(j, dtype=torch.float32) + 1.0) * step


def _det_count(c, n_up, step):
    """The number of det uniforms at most c (the kernels' det_count): a
    guess from c (n_up + 1), then steps to the exact count."""
    g = int(min(max(float(np.float32(c) * np.float32(n_up + 1)), 0.0), float(n_up)))
    while g > 0 and float(_det_u(g - 1, step)) > c:
        g -= 1
    while g < n_up and float(_det_u(g, step)) <= c:
        g += 1
    return g


def _chunks(n, threads):
    """Kernel (a)'s partition of n intervals over `threads`: [(k0, cnt)]."""
    c = (n + threads - 1) // threads
    out = []
    for t in range(threads):
        k0 = min(t * c, n)
        out.append((k0, min(k0 + c, n) - k0))
    return out


def _lerp(cdf, bins, lo, u):
    """The kernels' lerp_at: the bracketing entries of index lo, a
    denominator below 1e-5 taken as 1, products rounded apart."""
    P = cdf.shape[0]
    below, above = max(lo - 1, 0), min(lo, P - 1)
    cb, ca, bb, ba = cdf[below], cdf[above], bins[below], bins[above]
    den = ca - cb
    den = torch.where(den < 1e-5, torch.ones_like(den), den)
    t = (u - cb) / den
    return bb + t * (ba - bb)


def emulate_det_draw(cdf, bins, n_up, threads):
    """One ray's det draw as the kernels make it from its cdf [P] (leading
    0 included) and depths [P]: (indices [n_up], depths [n_up], whether the
    search route was taken)."""
    P = cdf.shape[0]
    step = torch.tensor(1.0, dtype=torch.float32) / (n_up + 1)
    u = _det_u(torch.arange(n_up), step)
    parts = [(k0, cnt) for k0, cnt in _chunks(P - 1, threads) if cnt > 0]
    falls = any(float(cdf[k0]) > float(cdf[k0 + 1]) for k0, _ in parts)
    if falls:
        idx = torch.searchsorted(cdf, u, right=False)
    else:
        idx = torch.full((n_up,), -1, dtype=torch.long)
        for k0, cnt in parts:
            m = _det_count(float(cdf[k0]), n_up, step)
            for i in range(cnt):
                m1 = _det_count(float(cdf[k0 + i + 1]), n_up, step)
                idx[m:m1] = k0 + i + 1
                m = m1
            if k0 + cnt == P - 1:
                idx[m:] = P
        assert bool((idx >= 0).all()), "a draw was not written"
    depths = torch.stack([_lerp(cdf, bins, int(i), u[j]) for j, i in enumerate(idx)])
    return idx, depths, falls


def _cdf(bounds):
    """sample_pdf's cdf of bounds [M-1]: [M], a leading 0."""
    w = bounds + 1e-5
    return torch.cat([torch.zeros(1), torch.cumsum(w / w.sum(), 0)])


def _bounds(kind, n, rng):
    if kind == "seeded":
        return torch.tensor(rng.exponential(0.3, n).astype(np.float32))
    if kind == "zeros_beside_1e5":  # flat segments where the 1e-5 steps vanish
        b = np.zeros(n, np.float32)
        b[rng.choice(n, 5, replace=False)] = 1e5
        b[rng.choice(n, n // 10, replace=False)] = rng.uniform(0, 3, n // 10)
        return torch.tensor(b)
    if kind == "all_zero":
        return torch.zeros(n)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["seeded", "zeros_beside_1e5", "all_zero"])
@pytest.mark.parametrize("n,n_up,threads", [(511, 512, 256), (1023, 64, 32), (37, 300, 8)])
def test_merge_draw_equals_searchsorted(kind, n, n_up, threads):
    """On sample_pdf's own cdf (monotone), the merge's indices equal
    searchsorted's (count of cdf < u) entry for entry, and the depths equal
    sample_pdf's bit for bit."""
    rng = np.random.RandomState(n + n_up)
    bounds = _bounds(kind, n, rng)
    bins = torch.sort(torch.tensor(rng.uniform(0, 6, n + 1).astype(np.float32)))[0]
    cdf = _cdf(bounds)
    idx, depths, falls = emulate_det_draw(cdf, bins, n_up, threads)
    assert not falls
    u = linspace01(n_up + 2)[1:-1]
    assert torch.equal(_det_u(torch.arange(n_up), torch.tensor(1.0) / (n_up + 1)), u)
    assert torch.equal(idx, torch.searchsorted(cdf, u, right=False))
    want = sample_pdf(bins[None], bounds[None], linspace01(n_up + 2)[None])[0, 1:-1]
    assert torch.equal(depths, want)


@pytest.mark.parametrize("n,n_up,threads", [(512, 511, 256), (128, 63, 16), (1024, 255, 256)])
def test_merge_draw_at_exact_ties(n, n_up, threads):
    """Equal bounds with n_up + 1 dividing n: every sum is exact, so every
    u_j equals a cdf entry; the draw lands at that entry's depth, as the
    search's "first index with cdf >= u" gives."""
    bounds = torch.full((n,), 1e5)
    bins = torch.linspace(0, 6, n + 1)
    cdf = _cdf(bounds)
    step = torch.tensor(1.0) / (n_up + 1)
    u = _det_u(torch.arange(n_up), step)
    hits = torch.isin(u, cdf)
    assert bool(hits.all())
    idx, depths, falls = emulate_det_draw(cdf, bins, n_up, threads)
    assert not falls
    assert torch.equal(idx, torch.searchsorted(cdf, u, right=False))
    assert torch.equal(depths, bins[idx])
    want = sample_pdf(bins[None], bounds[None], linspace01(n_up + 2)[None])[0, 1:-1]
    assert torch.equal(depths, want)


def test_det_count_matches_brute_force():
    """det_count's guess and steps give the exact count of uniforms at most
    c, at the uniforms themselves, one ulp either side, and outside [0, 1]."""
    for n_up in (1, 7, 64, 511, 512):
        step = torch.tensor(1.0) / (n_up + 1)
        u = _det_u(torch.arange(n_up), step)
        cs = torch.cat([u, torch.nextafter(u, torch.tensor(2.0)),
                        torch.nextafter(u, torch.tensor(-1.0)),
                        torch.tensor([-1.0, 0.0, 1.0, 1.5, float(np.float32(1) - 2 ** -24)])])
        for c in cs.tolist():
            assert _det_count(np.float32(c), n_up, step) == int((u <= c).sum()), (n_up, c)


def test_falling_cdf_takes_the_search():
    """A cdf that falls by an ulp at a chunk boundary (the chunks' sums and
    the block scan round apart) is searched as before: the merge's count
    equals the search's index only on a monotone cdf."""
    n, n_up, threads = 64, 31, 8
    cdf = _cdf(torch.full((n,), 1.0))
    k0 = _chunks(n, threads)[3][0]
    cdf[k0] = torch.nextafter(cdf[k0 + 1], torch.tensor(2.0))  # cdf[k0] > cdf[k0 + 1]
    bins = torch.linspace(0, 1, n + 1)
    idx, _, falls = emulate_det_draw(cdf, bins, n_up, threads)
    assert falls
    u = _det_u(torch.arange(n_up), torch.tensor(1.0) / (n_up + 1))
    assert torch.equal(idx, torch.searchsorted(cdf, u, right=False))


def test_draw_plain_is_the_det_draw():
    """`draw_plain` (the kernels' plain version) is sample_pdf at the det
    uniforms without both ends, which the emulation reproduces."""
    rng = np.random.RandomState(3)
    d = torch.sort(torch.tensor(rng.uniform(0, 6, (3, 200)).astype(np.float32)), -1)[0]
    bounds = torch.tensor(rng.exponential(0.5, (3, 199)).astype(np.float32))
    got = ffs.draw_plain(d, bounds, 100)
    for r in range(3):
        _, depths, _ = emulate_det_draw(_cdf(bounds[r]), d[r], 100, 64)
        assert torch.equal(got[r], depths)


def test_sampler_bounds_count_the_sfu():
    """chip_smoke's bounds of kernels (a)-(c) over one flagship call: with
    every ray bisecting every round (beta_net 0.001, no ray converging),
    kernel (c)'s ~1.7e8 interval-sweeps of 6 MUFU operations bind at the
    special-function unit's 16 a clock per SM (about 0.24 ms at 1.98 GHz),
    above its bytes and fp32 bounds; kernel (b), one det draw, is held to
    its bytes; no bound shrinks when the MUFU count is added."""
    import chip_smoke

    N, n0, n_up, max_iter, n_final = 1024, 512, 512, 6, 64
    never = torch.full((N,), -1, dtype=torch.int32)
    b = chip_smoke._sampler_bounds(N, n0, n_up, max_iter, n_final, never, 1.98e9)
    ms, by, held, without = b["volsdf_checkpoint"]
    mufu = 0
    for it in range(1, max_iter + 1):  # 12 sweeps a round (11 on the last), 6 MUFU an interval
        P, last = n0 + it * n_up, it == max_iter
        mufu += (P - 1) * N * (11 if last else 12) * 6 + N * n_up  # the new samples' sqrt
        mufu += ((P - 1) * N * 3 + N * n_final) if last else N * ((P - 1) + n_up)  # the draws
    assert held == "sfu" and by == "operations"
    assert ms == pytest.approx(1e3 * mufu / (16 * 132 * 1.98e9), rel=1e-9)
    assert 0.2 < ms < 0.3 and without < ms
    assert b["volsdf_draw"][2] == "bytes"
    for v in b.values():
        assert v[0] >= v[3] > 0


# ---- kernel (a): both sweeps and the opacity cdf in one pass


def _thread_sums(x, threads):
    """x [..., n] per-interval terms -> (per-thread sums [..., T] in the
    chunk's order, the terms as [..., T, c]): thread t owns intervals
    [t c, t c + c) of n, c = ceil(n / T), zero-width padding past n."""
    n = x.shape[-1]
    c = -(-n // threads)
    v = torch.zeros(*x.shape[:-1], threads * c)
    v[..., :n] = x
    v = v.view(*x.shape[:-1], threads, c)
    tot = torch.zeros(*x.shape[:-1], threads)
    for i in range(c):
        tot = tot + v[..., i]
    return tot, v


def _hillis_steele(v):
    """Inclusive scan along the last axis, lane k adding lane k - o for o =
    1, 2, 4, ... (the warp shuffles' order)."""
    o = 1
    while o < v.shape[-1]:
        w = v.clone()
        w[..., o:] = v[..., o:] + v[..., :-o]
        v, o = w, 2 * o
    return v


def _scan_block(tot, threads):
    """scan_block's exclusive scan of [..., T]: each warp's scan, then every
    warp adds the scanned total of the warps before it."""
    inc = _hillis_steele(tot.view(*tot.shape[:-1], threads // 32, 32))
    ex = torch.zeros_like(inc)
    ex[..., 1:] = inc[..., :-1]
    warps = _hillis_steele(inc[..., 31])
    ex[..., 1:, :] = warps[..., :-1, None] + ex[..., 1:, :]
    return ex.reshape(tot.shape)


def _terms(d, sdf, alpha, beta):
    """(sigma * delta, the error term) of every interval [..., n], as the
    kernels' `terms` round them."""
    e = 0.5 * torch.exp(-torch.abs(sdf[..., :-1]) / beta)
    sigma = alpha * torch.where(sdf[..., :-1] >= 0, e, 1 - e)
    delta = d[..., 1:] - d[..., :-1]
    dstar = torch.clamp(0.5 * (sdf[..., :-1].abs() + sdf[..., 1:].abs() - delta), min=0.0)
    return sigma * delta, alpha / (4 * beta) * (delta * delta) * torch.exp(-dstar / beta)


def emulate_init(d, sdf, far, alpha_net, beta_net, u, eps, threads=256):
    """Kernel (a)'s sweeps and draws on rays [R, n0] in float32: one pass,
    one scan of four sums (net sigma * delta, net error, beta+ sigma * delta,
    beta+ error, summed apart). Returns the init state and the cdf [R, n0]."""
    n0 = d.shape[-1]
    n = n0 - 1
    beta = torch.sqrt(far * far / torch.tensor(ffs.beta_plus_denominator(n0, eps)))
    terms = torch.stack([*_terms(d, sdf, alpha_net, beta_net), *_terms(d, sdf, 1.0 / beta, beta)],
                        1)  # [R, 4, n]
    tot, v = _thread_sums(terms, threads)
    run = _scan_block(tot, threads)  # [R, 4, T]: R_net, E_net, R_plus, E_plus
    bounds, cdf = [], []
    for i in range(v.shape[-1]):
        run[:, 1] = run[:, 1] + v[:, 1, :, i]
        run[:, 3] = run[:, 3] + v[:, 3, :, i]
        decay = torch.exp(-run[:, 0])
        b = torch.exp(-run[:, 2:3]) * (torch.exp(run[:, 3:4]) - 1)
        bn = decay * (torch.exp(run[:, 1]) - 1)
        bounds.append(torch.stack([bn, b[:, 0]], 1))
        cdf.append(1 - decay)
        run[:, 0] = run[:, 0] + v[:, 0, :, i]
        run[:, 2] = run[:, 2] + v[:, 2, :, i]
    bounds = torch.stack(bounds, -1).flatten(-2)[..., :n]  # [R, 2, n], chunk by chunk
    bounds = torch.where(torch.isnan(bounds), torch.full_like(bounds, float("inf")), bounds)
    cdf = torch.cat([torch.zeros(d.shape[0], 1), torch.stack(cdf, -1).flatten(-2)[:, :n]], -1)
    bad = bounds[:, 0].amax(-1) > eps
    lo = torch.searchsorted(cdf, u.contiguous(), right=False)  # the first cdf >= u
    below, above = (lo - 1).clamp(min=0), lo.clamp(max=n0 - 1)
    cb, ca = cdf.gather(1, below), cdf.gather(1, above)
    bb, ba = d.gather(1, below), d.gather(1, above)
    den = torch.where(ca - cb < 1e-5, torch.ones_like(ca), ca - cb)
    fine = bb + (u - cb) / den * (ba - bb)
    return ({"bounds": torch.clamp(bounds[:, 1], 0.0, 1e5), "beta": beta, "converged": ~bad,
             "iter_usage": torch.where(bad, -1, 0).int(), "fine": fine}, cdf)


def _init_inputs(n0, R=48, n_final=32):
    rng = np.random.RandomState(n0)
    far = torch.tensor(rng.uniform(4.5, 6.0, (R, 1)).astype(np.float32))
    d = (far * linspace01(n0)).contiguous()
    sdf = ((d - 3.0).abs() - 1.0 + torch.tensor(rng.normal(0, 0.02, (R, n0)).astype(np.float32)))
    u = torch.tensor(rng.uniform(0, 1, (R, n_final)).astype(np.float32))
    return d, sdf, far, u


@pytest.mark.parametrize("n0", [2, 50, 512, 2048])
def test_one_pass_init_matches_init_plain(n0):
    """The one-pass emulation of kernel (a) against `init_plain` (its plain
    version, cumsum order) on seeded sdf crossing zero twice a ray, at
    beta_net 0.1 and 0.001: beta bit-equal, the clipped beta+ bounds within
    rtol 1e-4 / atol 1e-6, the convergence flags equal, the fine depths
    within 1e-5 of the span. n0 = 2 is one interval; n0 = 2,048 the chunk
    of 8."""
    d, sdf, far, u = _init_inputs(n0)
    for beta_net in (0.1, 0.001):
        a, b = torch.tensor(1.0 / beta_net), torch.tensor(beta_net)
        got, _ = emulate_init(d, sdf, far, a, b, u, 0.1)
        want = ffs.init_plain(d, sdf, far, a, b, u, eps=0.1)
        assert torch.equal(got["beta"], want["beta"])
        torch.testing.assert_close(got["bounds"], want["bounds"], rtol=1e-4, atol=1e-6)
        assert torch.equal(got["converged"], want["converged"])
        assert torch.equal(got["iter_usage"], want["iter_usage"])
        assert float((got["fine"] - want["fine"]).abs().max()) <= 1e-5 * 6.0


@pytest.mark.parametrize("n0", [2, 50, 512, 2048])
def test_one_pass_cdf_is_the_opacity_pass(n0):
    """The premise of kernel (a)'s one pass: the opacity cdf taken from the
    net sweep's exp(-R), with the four sums scanned together, equals bit for
    bit the cdf of a separate opacity pass (its own sigma * delta, its own
    per-thread sums and scan of that one sum), as kernel (c)'s
    `draw_opacity` makes it."""
    d, sdf, far, u = _init_inputs(n0)
    for beta_net in (0.1, 0.001):
        a, b = torch.tensor(1.0 / beta_net), torch.tensor(beta_net)
        _, cdf = emulate_init(d, sdf, far, a, b, u, 0.1)
        tot, v = _thread_sums(_terms(d, sdf, a, b)[0], 256)
        R = _scan_block(tot, 256)
        steps = []
        for i in range(v.shape[-1]):
            steps.append(1 - torch.exp(-R))
            R = R + v[..., i]
        opacity = torch.cat([torch.zeros(d.shape[0], 1),
                             torch.stack(steps, -1).flatten(-2)[:, :n0 - 1]], -1)
        assert torch.equal(cdf, opacity)

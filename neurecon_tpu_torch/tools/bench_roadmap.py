"""Two questions of the card behind the port's design (port of
`neurecon_tpu/tools/bench_roadmap.py`), one JSON line a row:

(a) Is padding the radiance input free? A chain [N, 289] @ [289, W] then
    D - 1 layers [N, W] @ [W, W] (ReLU between) against the same chain from
    [N, 384] @ [384, W], through cuBLAS (torch.matmul), with TF32 off (the
    port's setting) and on. A speed ratio near 1 says cuBLAS pads K = 289
    itself and explicit padding cannot win.
(b) Do two independent MLP chains overlap on the card? Two W = 256, D = 8
    chains on two CUDA streams against the sum of each alone: the
    concurrency factor (t_a + t_b) / t_both behind
    `training.overlap_sampler`, which runs the next step's sampler on a
    second stream during the backward. Near 1: no compute/compute overlap
    at these sizes (each chain fills the card). On the CPU the two chains
    run one after the other, so the factor is 1 by construction.

Times are medians of --K CUDA-event timings after a warm-up, with the card's
name and power limit.

  python -m neurecon_tpu_torch.tools.bench_roadmap [--K 50]
  python -m neurecon_tpu_torch.tools.bench_roadmap --device cpu --N 256 --K 2
"""
from __future__ import annotations

import contextlib

import torch

from neurecon_tpu_torch.tools import probe_common as pc

PROBE = "bench_roadmap"


def chain(x, ws):
    h = x
    for w in ws:
        h = torch.relu(h @ w)
    return h


def _weights(k_in, W, D, gen, dev):
    ws = [torch.randn(k_in, W, generator=gen) * 0.05]
    ws += [torch.randn(W, W, generator=gen) * 0.06 for _ in range(D - 1)]
    return [w.to(dev) for w in ws]


def main(argv=None) -> list:
    ap = pc.parser(__doc__.splitlines()[0], K=50)
    ap.add_argument("--N", type=int, default=65536, help="rows of the padding chains")
    ap.add_argument("--W", type=int, default=256)
    a = ap.parse_args(argv)
    from neurecon_tpu_torch import get_device

    dev = get_device(a.device)
    card = pc.card(dev)
    gen = torch.Generator().manual_seed(a.seed)
    W, rows = a.W, []
    common = dict(K=a.K, W=W, device=dev.type, card=card)
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            res = {}
            for k_in in (289, 384):
                x = torch.randn(a.N, k_in, generator=gen).to(dev)
                ws = _weights(k_in, W, 4, gen, dev)
                res[k_in] = pc.median_ms(lambda: chain(x, ws), a.K, dev)
                rows.append(pc.emit(PROBE, f"(a) padding: K_in {k_in}, TF32 {tf32}",
                                    ms=res[k_in], N=a.N, D=4, tf32=tf32, **common))
            rows.append(pc.emit(PROBE, f"(a) padding: 289 / 384 time ratio, TF32 {tf32}",
                                ratio=res[289] / res[384], tf32=tf32, **common))
        torch.backends.cuda.matmul.allow_tf32 = False
        n = a.N // 2
        xa, xb = (torch.randn(n, W, generator=gen).to(dev) for _ in range(2))
        wa, wb = (_weights(W, W, 8, gen, dev) for _ in range(2))
        ta = pc.median_ms(lambda: chain(xa, wa), a.K, dev)
        tb = pc.median_ms(lambda: chain(xb, wb), a.K, dev)
        streams = ((torch.cuda.Stream(dev), torch.cuda.Stream(dev)) if dev.type == "cuda"
                   else (None, None))

        def both():
            cur = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
            for s, x, ws in ((streams[0], xa, wa), (streams[1], xb, wb)):
                if s is not None:
                    s.wait_stream(cur)
                with torch.cuda.stream(s) if s is not None else contextlib.nullcontext():
                    chain(x, ws)
            if cur is not None:
                for s in streams:
                    cur.wait_stream(s)
        tab = pc.median_ms(both, a.K, dev)
        rows.append(pc.emit(PROBE, "(b) overlap: two W=256 D=8 chains", chain_a_ms=ta,
                            chain_b_ms=tb, both_ms=tab, concurrency_factor=(ta + tb) / tab,
                            N=n, D=8, **common))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32_was
    return rows


if __name__ == "__main__":
    main()

"""Step-level roofline: where does the fused BGV step's time go?

VERDICT r4 next #3: the n=2^14 step has been flat at ~33k ct-op/s for
two rounds with no component-level accounting.  This harness times the
step's constituent passes as separately-jitted functions on the same
inputs (m=32768, nrns=3, B=1024 by default):

  intt        the keyswitch prologue's per-channel inverse stack
              (nrns GS inverse transforms)
  digits      the RNS-digit forward transforms with the in-kernel
              re-expansion prologue (nrns digits x (nrns-1) fwd NTTs;
              the diagonal channel is free)
  hadamard    ct_mul's 4 products + the 2*nrns^2 hint inner-product
              multiply-accumulates (pure elementwise, no transforms)
  rescale     the exact CRT-domain drop-last rescale on both output
              components (2 x [1 inverse + (nrns-1) forward] + cheap
              elementwise)
  step        the full fused step (the whole is jitted as ONE program,
              so sum(parts) > step means XLA overlaps passes; the gap
              is the fusion/overlap dividend)

Components are timed interleaved round-robin, so drift hits every row
equally.  Usage:
    python -m lol_tpu.bench.steptime [--m 32768] [--rns 3] [--batch 1024]
Prints one JSON line; run it on the GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _mark(msg):
    print(f"[steptime] {msg}", file=sys.stderr, flush=True)


def main() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .. import numtheory as nt, she
    from ..she_batched import (
        BatchedBGV, _addmod_ch, _hint_const_sh, _mulmod_ch, _mulmod_sh_ch,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=32768)
    ap.add_argument("--rns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args()

    m, nrns, B = args.m, args.rns, args.batch
    seed = (os.getpid() * 1_000_003 + int(time.time())) & 0x7FFFFFFF
    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=257, qs=qs, var=2.0)
    _mark(f"setup m={m} nrns={nrns} B={B}")
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    bb = BatchedBGV(params)
    hint = bb.gen_ks_quad_hint(sk, jax.random.PRNGKey(1))
    n = params.ctx.n
    h0, h0s = _hint_const_sh(hint.h0, qs)
    h1, h1s = _hint_const_sh(hint.h1, qs)

    keys = jax.random.split(jax.random.PRNGKey(seed), 4 * nrns)
    c0, c1, d0, d1 = (
        jnp.stack([
            jax.random.randint(k, (n, B), 0, q, dtype=jnp.uint32)
            for k, q in zip(keys[j * nrns:(j + 1) * nrns], qs)
        ])
        for j in range(4)
    )

    step = bb.build_step(hint)

    @jax.jit
    def intt(x):
        return bb._ntt(x, inverse=True)

    @jax.jit
    def digits(xc, x):
        return [bb._digit_crt(xc[i], i, x, qs) for i in range(nrns)]

    @jax.jit
    def hadamard(c0, c1, d0, d1, ds):
        e0 = _mulmod_ch(qs, c0, d0)
        e1 = _addmod_ch(qs, _mulmod_ch(qs, c0, d1), _mulmod_ch(qs, c1, d0))
        for i in range(nrns):
            e0 = _addmod_ch(qs, e0, _mulmod_sh_ch(qs, ds[i], h0[i], h0s[i]))
            e1 = _addmod_ch(qs, e1, _mulmod_sh_ch(qs, ds[i], h1[i], h1s[i]))
        return e0, e1

    rs = bb._rescale_crt()

    @jax.jit
    def rescale2(e0, e1):
        return rs(e0), rs(e1)

    # prepared inputs for each component (materialized up front so the
    # timed windows measure only the component)
    _mark("compile components")
    c1c = intt(c1)
    ds = digits(c1c, c1)
    he0, he1 = hadamard(c0, c1, d0, d1, ds)
    r0, r1 = rescale2(he0, he1)
    s0, s1 = step(c0, c1, d0, d1)
    jax.block_until_ready((c1c, ds, he0, he1, r0, r1, s0, s1))
    _ = np.asarray(s0[0, :1, :1])  # materialization barrier (DESIGN §10)

    legs = {
        "intt": lambda: intt(c1),
        "digits": lambda: digits(c1c, c1),
        "hadamard": lambda: hadamard(c0, c1, d0, d1, ds),
        "rescale": lambda: rescale2(he0, he1),
        "step": lambda: step(c0, c1, d0, d1),
    }
    times: dict[str, list[float]] = {k: [] for k in legs}
    for w in range(args.windows):
        for name, fn in legs.items():
            o = fn()
            jax.block_until_ready(o)
            t0 = time.time()
            for _ in range(args.iters):
                o = fn()
            jax.block_until_ready(o)
            times[name].append((time.time() - t0) / args.iters)
        _mark(f"round {w + 1}/{args.windows}")

    med = {k: statistics.median(v) for k, v in times.items()}
    parts = med["intt"] + med["digits"] + med["hadamard"] + med["rescale"]
    out = {
        "metric": f"fused BGV step ablation, n={n}, {nrns}x30-bit, B={B}",
        "ms_per_call": {k: round(v * 1e3, 3) for k, v in med.items()},
        "pct_of_parts": {
            k: round(100 * med[k] / parts, 1)
            for k in ("intt", "digits", "hadamard", "rescale")
        },
        "parts_sum_ms": round(parts * 1e3, 3),
        "overlap_dividend_pct": round(100 * (1 - med["step"] / parts), 1),
        "step_ops_per_sec": round(B / med["step"]),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()

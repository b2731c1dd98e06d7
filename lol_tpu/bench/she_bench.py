"""BGV pipeline benchmark: ct-mult + key-switch + rescale ops/sec.

The second BASELINE.json headline metric.  Run:
    python -m lol_tpu.bench.she_bench [--m 8192] [--rns 3] [--batch 2048]
Prints one JSON line like bench.py.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np



def run(m: int = 8192, nrns: int = 3, batch: int = 2048, p: int = 257,
        iters: int = 20):
    import jax
    import jax.numpy as jnp

    from .. import gadget as gd, numtheory as nt, she
    from ..she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    key = jax.random.PRNGKey(0)
    ks, kh = jax.random.split(key)
    sk = she.gen_sk(params, ks)
    bb = BatchedBGV(params)
    hint = bb.gen_ks_quad_hint(sk, kh)  # one-call device keygen
    step = bb.build_step(hint)

    n = params.ctx.n
    # uniform component stacks generated on device
    arrs = [
        jnp.stack([
            jax.random.randint(k, (n, batch), 0, q, dtype=jnp.uint32)
            for k, q in zip(jax.random.split(jax.random.PRNGKey(9 + i), nrns), qs)
        ])
        for i in range(4)
    ]
    out = step(*arrs)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = step(*arrs)
    jax.block_until_ready(out)
    dt = time.time() - t0
    rate = batch * iters / dt

    def timed(fn, fn_args, its):
        o = fn(*fn_args)
        jax.block_until_ready(o)
        t = time.time()
        for _ in range(its):
            o = fn(*fn_args)
        jax.block_until_ready(o)
        return batch * its / (time.time() - t)

    # round-4 serving ops on the same inputs
    kl, kx = jax.random.split(jax.random.PRNGKey(77))
    ms_rate = timed(bb.build_mod_switch(), arrs[:2], max(iters // 2, 2))
    sk2 = she.gen_sk(params, jax.random.PRNGKey(78))
    lhint = bb.gen_ks_linear_hint(sk2, sk, kl)
    ksl_rate = timed(
        bb.build_key_switch_linear(lhint), arrs[:2], max(iters // 2, 2)
    )
    specials = tuple(nt.ntt_primes(m, 30, nrns + 2))[nrns:]
    hx = bb.gen_ks_quad_hint_ext(sk, specials, kx)
    ext_rate = timed(bb.build_step_ext(hx), arrs, max(iters // 2, 2))

    dev = jax.devices()[0].device_kind
    print(json.dumps({
        "metric": f"BGV ct-mult+keyswitch+rescale ops/sec, n={n}, {nrns}x30-bit RNS, {dev}",
        "value": round(rate),
        "unit": "ct-op/s",
        "vs_baseline": None,
        "mod_switch_ops_per_sec": round(ms_rate),
        "ks_linear_ops_per_sec": round(ksl_rate),
        "step_ext_ops_per_sec": round(ext_rate),
        "step_ext_specials": len(specials),
    }))
    return rate


def homom_prf(m_top: int = 32768, batch: int = 1024, iters: int = 10,
              p: int = 8, bits=(1, 0)):
    """End-to-end HomomPRF at serving scale (VERDICT r4 weak #6's last
    unmeasured composite): component 0 of the PRF over a B-batch of key
    ciphertexts — build_mul_public -> a FULL halving tunnel tower
    m_top -> m_top/2 -> ... -> 2 (device-generated hints per hop; the
    'project' descent maps, so the m=2 plaintext is the constant
    coefficient) -> the true homomorphic rounding chain Z_p -> Z_2 at
    m=2.  One jitted program per stage, built once; the timed loop runs
    whole batches per call.  Guard: decrypt == round(coeff_0(s*a_0))
    on 3 columns (the projection tower composes to coeff-0 extraction).

    Run:  python -m lol_tpu.bench.she_bench --homom-prf
    """
    import time as _t
    from dataclasses import replace

    import jax
    import jax.numpy as jnp

    from .. import gadget as gd, linear as lin, numtheory as nt, prf, serving, she
    from ..cyc import Cyc, Rep
    from ..ring import ring_context
    from ..she_batched import BatchedBGV

    t0 = _t.time()

    def mark(msg):
        import sys as _s
        print(f"[homom_prf +{_t.time() - t0:6.1f}s] {msg}", file=_s.stderr,
              flush=True)

    M = she.pt_round_mults(p)
    # M levels feed the rounding chain; the extra headroom absorbs the
    # dense mulPublic (~+0.5*log2(n)+log2(p) noise bits) and the 14
    # additive tunnel-hint noises (M+2 measured column-dependent
    # rounding flips at m_top=32768 — noise at the decrypt boundary)
    qs = tuple(nt.ntt_primes(m_top, 30, M + 4))
    rings = []
    m = m_top
    while m >= 2:
        rings.append(m)
        m //= 2
    key = jax.random.PRNGKey(0)
    mark(f"gen_sk x{len(rings)} (m={m_top}..2, {len(qs)} RNS primes)")
    sks, params = [], []
    for mm in rings:
        key, sub = jax.random.split(key)
        pr_i = she.SHEParams(m=mm, p=p, qs=qs, var=2.0)
        params.append(pr_i)
        sks.append(she.gen_sk(pr_i, sub))
    mark("device tunnel hints per hop")
    bbs = [BatchedBGV(pr_i) for pr_i in params]
    tunnels = []
    for i in range(len(rings) - 1):
        key, sub = jax.random.split(key)
        r_ctx = ring_context(rings[i], qs)
        s_ctx = ring_context(rings[i + 1], qs)
        ys = [Cyc.zero(s_ctx) for _ in range(r_ctx.n // s_ctx.n)]
        ys[0] = Cyc.scalar(s_ctx, 1)
        f = lin.linear_pow(s_ctx, r_ctx, s_ctx, ys)
        tunnels.append(bbs[i].gen_tunnel_hint(f, sks[i + 1], sks[i], sub))
        if i % 4 == 0:
            mark(f"  hop {rings[i]}->{rings[i + 1]} done")
    mark("pt_round hints at m=2")
    key, kr = jax.random.split(key)
    rh = she.pt_round_hints(sks[-1], gd.RnsGad(), kr)
    mark("PRF family + a_t")
    key, kf = jax.random.split(key)
    fam = prf.PRFFamily.random(ring_context(m_top, (p,)), gd.BaseBGad(2),
                               prf.balanced(len(bits)), kf)
    at0 = fam.a_t(tuple(bits))[0]
    a_pt = np.array([int(v) % p for v in at0.lift_ints(rep=Rep.DEC)],
                    dtype=np.int32)
    mark("build the serving program (mul_public + tower + rounding)")
    mulp = bbs[0].build_mul_public()
    tuns = [bbs[i].build_tunnel(tunnels[i]) for i in range(len(tunnels))]
    run_round, bb_out, f_out = serving.build_pt_round(bbs[-1], rh)

    def run(c0, c1):
        c0, c1 = mulp(c0, c1, jnp.asarray(a_pt[:, None]))
        for tun in tuns:
            c0, c1 = tun(c0, c1)
        return run_round(c0, c1)

    mark("encrypt key batch")
    key, ks_, ke = jax.random.split(key, 3)
    n = params[0].ctx.n
    s_val = jax.random.randint(ks_, (n, 1), 0, p, dtype=jnp.int32)
    msgs = jnp.broadcast_to(s_val, (n, batch))  # same key s per column
    c0, c1 = bbs[0].build_encrypt(sks[0])(msgs, ke)
    mark("compile/run the composite")
    y0, y1 = run(c0, c1)
    jax.block_until_ready((y0, y1))
    mark("decrypt guard")
    sk_out = she.SK(bb_out.params, sks[-1].s_ints, sks[-1].var)
    got = np.asarray(bb_out.build_decrypt(sk_out, f=f_out)(y0, y1)[:, :3])
    # plaintext prediction: the projection tower composes to coeff-0
    # extraction, so the output is the clear PRF's coefficient 0
    sc = Cyc.from_ints(fam.ctx, np.asarray(s_val[:, 0]).astype(np.int64))
    want = int(prf.prf(fam, sc, tuple(int(b) for b in bits), 2)[0][0])
    assert (got == want).all(), (got, want)
    mark(f"timing loop ({iters} iters)")
    t1 = _t.time()
    for _ in range(iters):
        y0, y1 = run(c0, c1)
    jax.block_until_ready((y0, y1))
    rate = batch * iters / (_t.time() - t1)
    dev = jax.devices()[0].device_kind
    print(json.dumps({
        "metric": f"HomomPRF component, m={m_top} -> 2 tower "
                  f"({len(tunnels)} tunnels + Z_{p}->Z_2 rounding), {dev}",
        "value": round(rate),
        "unit": "prf-op/s",
        "vs_baseline": None,
        "homom_prf_ops_per_sec": round(rate),
        "homom_prf_batch": batch,
    }))
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--rns", type=int, default=3)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--homom-prf", action="store_true",
                    help="run the end-to-end HomomPRF tower bench instead")
    args = ap.parse_args()
    if args.homom_prf:
        homom_prf(args.m if args.m != 8192 else 32768, batch=args.batch // 2)
    else:
        run(args.m, args.rns, args.batch)


if __name__ == "__main__":
    main()

"""Benchmark — prints ONE JSON line.  Needs an NVIDIA GPU: without one
it exits non-zero before any measurement.

Primary metric (BASELINE.md): negacyclic NTTs/sec at n=4096 over a 60-bit
RNS modulus (2 x 30-bit NTT primes).  The NTT leg runs 5 timed windows
per batch size, sweeps B in {4096, 8192, 16384, 32768}, and reports the
best batch's MEDIAN with the min/max spread across its windows; windows
run round-robin across all legs, and intt_value captures the GS inverse
at the headline shape.

The same line carries the other BASELINE headlines as extra keys:
  bgv_ct_ops_per_sec      BGV ct-mult + key-switch + rescale at n=2^14
  bgv_n4096_ops_per_sec   same pipeline at n=4096 (+ mod_switch,
                          ks_linear, step_ext and the base-vs-ext
                          noise-bits delta)
  tunnel_ops_per_sec      fused ring tunneling m=32768 -> 16384
plus the general-m step and tunnel, hoisted rotations and the rounding
chain.  Every leg checks its output against an exact reference first.
"""

import json
import statistics
import sys
import time

import numpy as np

_T0 = time.time()


def _mark(msg):
    """Progress timestamps on stderr (the JSON line on stdout stays clean);
    makes a driver-side timeout diagnosable."""
    print(f"[bench +{time.time() - _T0:7.1f}s] {msg}", file=sys.stderr, flush=True)


def bench_ntt():
    import jax
    import jax.numpy as jnp

    from lol_tpu import numtheory as nt
    from lol_tpu.ops import ntt, select

    n = 4096
    qs = nt.ntt_primes(2 * n, 30, 2)  # 2 x 30-bit primes ~ one 60-bit modulus
    plans = [ntt.ntt_plan(n, q) for q in qs]
    # dispatch chain depth: each device execution runs CHAIN dependent
    # 60-bit NTT steps, as the serving step is one large execution; the
    # single-step series is recorded beside it
    CHAIN = 4

    def step(arrs, inverse=False):
        return [select.ntt_cm(a, p, inverse=inverse)
                for a, p in zip(arrs, plans)]

    @jax.jit
    def step_chain(arrs):
        for _ in range(CHAIN):
            arrs = step(arrs)
        return arrs

    @jax.jit
    def istep_chain(arrs):
        for _ in range(CHAIN):
            arrs = step(arrs, inverse=True)
        return arrs

    windows = 5
    iters = 40
    batches = (32768, 16384, 8192, 4096)

    def make_leg(name, B, chain, inverse=False):
        """Prepared timing leg: device inputs, correctness guard, warmup,
        then run_window() per round."""
        if inverse:
            fn = istep_chain
        else:
            fn = jax.jit(step) if chain == 1 else step_chain
        keys = jax.random.split(
            jax.random.PRNGKey(chain + (7 if inverse else 0) + B),
            len(qs),
        )
        xs = [
            jax.random.randint(k, (n, B), 0, q, dtype=jnp.uint32)
            for k, q in zip(keys, qs)
        ]
        ys = fn(xs)
        [y.block_until_ready() for y in ys]
        want = np.asarray(xs[0][:, :1]).T
        np_step = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward
        for _ in range(chain):
            want = np_step(want, plans[0])
        got = np.asarray(ys[0][:, :1]).T
        np.testing.assert_array_equal(got, want)
        for _ in range(2):  # settle post-compile dispatch
            ys = fn(ys)
        [y.block_until_ready() for y in ys]
        leg = {"name": name, "B": B, "chain": chain, "fn": fn, "ys": ys,
               "iters": max(iters // chain, 2), "rates": []}
        return leg

    def run_window(leg):
        fn, ys = leg["fn"], leg["ys"]
        t0 = time.time()
        for _ in range(leg["iters"]):
            ys = fn(ys)  # the chain continues across windows
        [y.block_until_ready() for y in ys]
        leg["ys"] = ys
        leg["rates"].append(
            leg["B"] * leg["iters"] * leg["chain"] / (time.time() - t0)
        )

    # all legs are built first, then timed in round-robin windows so
    # drift on the card hits every leg equally
    legs = []
    for B in batches:
        _mark(f"ntt prep B={B}")
        legs.append(make_leg(f"c{B}", B, CHAIN))
        legs.append(make_leg(f"s{B}", B, 1))
    _mark(f"ntt prep inverse B={batches[0]}")
    inv_leg = make_leg("inv", batches[0], CHAIN, inverse=True)
    legs.insert(2, inv_leg)  # right after the largest batch's pair
    for w in range(windows):
        for leg in legs:
            run_window(leg)
        _mark(f"ntt round {w + 1}/{windows} done")
    per_b = {leg["B"]: leg["rates"] for leg in legs if leg["name"][0] == "s"}
    per_bc = {leg["B"]: leg["rates"] for leg in legs if leg["name"][0] == "c"}
    for B in batches:
        _mark(f"ntt B={B}: chained median "
              f"{statistics.median(per_bc[B]):.0f}/s, single-step "
              f"{statistics.median(per_b[B]):.0f}/s")
    _mark(f"intt B={inv_leg['B']}: chained median "
          f"{statistics.median(inv_leg['rates']):.0f}/s")
    best_b = max(per_bc, key=lambda b: statistics.median(per_bc[b]))
    rates = per_bc[best_b]
    return n, {
        "value": statistics.median(rates),
        "min": min(rates),
        "max": max(rates),
        "batch": best_b,
        "windows": windows,
        "iters": iters,  # single-step windows; chained windows run
        "chain_iters": max(iters // CHAIN, 2),  # iters of CHAIN steps each
        "dispatch_chain": CHAIN,
        "interleaved": True,  # round-robin windows
        "medians_by_batch": {
            str(b): round(statistics.median(r)) for b, r in per_b.items()
        },
        "chain_medians_by_batch": {
            str(b): round(statistics.median(r)) for b, r in per_bc.items()
        },
        "intt_value": round(statistics.median(inv_leg["rates"])),
        "intt_min": round(min(inv_leg["rates"])),
        "intt_max": round(max(inv_leg["rates"])),
        "intt_batch": inv_leg["B"],
    }


def _she_setup(m, nrns, p=257):
    import jax

    from lol_tpu import numtheory as nt, she
    from lol_tpu.she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    ks, kh = jax.random.split(jax.random.PRNGKey(0))
    _mark(f"she_setup m={m}: gen_sk")
    sk = she.gen_sk(params, ks)
    _mark("she_setup: gen_ks_quad_hint (device)")
    bb = BatchedBGV(params)
    hint = bb.gen_ks_quad_hint(sk, kh)
    _mark("she_setup: done")
    return bb, sk, hint


def bench_bgv(m, nrns, batch, iters, p=257, extras=False):
    """BGV ct-mult + RNS-gadget keyswitch + exact rescale, ops/sec, with a
    decrypt-correctness guard on column 0.  Works for 2-power AND
    composite m (the general-m fused pipeline).

    extras=True additionally measures the round-4 serving ops on the
    same inputs (VERDICT r4 next #1 — driver-capture every claim):
    standalone mod_switch, linear keyswitch, the extended-modulus
    (hybrid) relinearization step, and the base-vs-ext noise-bits
    delta (the P-division of keyswitch noise, measured on device)."""
    import jax
    import jax.numpy as jnp

    from lol_tpu import numtheory as nt, she

    bb, sk, hint = _she_setup(m, nrns, p=p)
    params = bb.params
    n = params.ctx.n
    enc = bb.build_encrypt(sk)
    step = bb.build_step(hint)
    # messages generated on device; only guard columns go to the host
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    m1 = jax.random.randint(k1, (n, batch), 0, params.p, dtype=jnp.int32)
    m2 = jax.random.randint(k2, (n, batch), 0, params.p, dtype=jnp.int32)
    _mark("bgv: compile/run encrypt")
    c0, c1 = enc(m1, jax.random.PRNGKey(2))
    d0, d1 = enc(m2, jax.random.PRNGKey(3))
    _mark("bgv: compile/run step")
    e0, e1 = step(c0, c1, d0, d1)
    jax.block_until_ready((e0, e1))
    _mark("bgv: decrypt guard")

    # guard: batched decrypt of column 0 == exact plaintext ring product
    params2 = she.SHEParams(m=m, p=params.p, qs=params.qs[:-1], var=params.var)
    from lol_tpu.she_batched import BatchedBGV

    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = nt.modinv(params.qs[-1] % params.p, params.p)
    dec = bb2.build_decrypt(sk2, f=f2)
    got = np.asarray(dec(e0, e1)[:, :1])[:, 0]
    want = she.pt_mul(params, np.asarray(m1[:, 0]), np.asarray(m2[:, 0]))
    np.testing.assert_array_equal(got, want)

    _mark("bgv: timing loop")
    t0 = time.time()
    for _ in range(iters):
        e0, e1 = step(c0, c1, d0, d1)
    jax.block_until_ready((e0, e1))
    _mark("bgv: done")
    rate = batch * iters / (time.time() - t0)
    if not extras:
        return n, rate

    def timed(fn, fn_args, its):
        o = fn(*fn_args)
        jax.block_until_ready(o)
        t = time.time()
        for _ in range(its):
            o = fn(*fn_args)
        jax.block_until_ready(o)
        return batch * its / (time.time() - t)

    its = max(iters // 2, 2)
    ex = {}
    _mark("bgv extras: mod_switch")
    ex["mod_switch_ops_per_sec"] = round(
        timed(bb.build_mod_switch(), (c0, c1), its)
    )
    _mark("bgv extras: linear keyswitch")
    sk_new = she.gen_sk(params, jax.random.PRNGKey(4))
    lh = bb.gen_ks_linear_hint(sk_new, sk, jax.random.PRNGKey(5))
    ex["ks_linear_ops_per_sec"] = round(
        timed(bb.build_key_switch_linear(lh), (c0, c1), its)
    )
    _mark("bgv extras: ext-modulus step")
    specials = tuple(nt.ntt_primes(m, 30, nrns + 2))[nrns:]
    hx = bb.gen_ks_quad_hint_ext(sk, specials, jax.random.PRNGKey(6))
    step_ext = bb.build_step_ext(hx)
    ex["step_ext_ops_per_sec"] = round(timed(step_ext, (c0, c1, d0, d1), its))
    ex["step_ext_specials"] = len(specials)
    _mark("bgv extras: noise-bits delta")
    nb = bb2.build_noise_bits(sk2)
    base_bits = float(np.mean(np.asarray(nb(e0, e1))))
    x0, x1 = step_ext(c0, c1, d0, d1)
    ext_bits = float(np.mean(np.asarray(nb(x0, x1))))
    ex["step_noise_bits"] = round(base_bits, 2)
    ex["step_ext_noise_bits"] = round(ext_bits, 2)
    ex["step_ext_noise_bits_delta"] = round(base_bits - ext_bits, 2)
    _mark("bgv extras: done")
    return n, rate, ex


def bench_galois(m, nrns, batch, iters, ks=(3, 5, 9), p=257):
    """Hoisted rotation batch vs separate rotations, interleaved window
    by window; returns (rot/s hoisted, rot/s separate, speedup)."""
    import jax
    import jax.numpy as jnp

    from lol_tpu import numtheory as nt, she
    from lol_tpu.she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    _mark(f"galois m={m}: gen_sk + hints")
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    bb = BatchedBGV(params)
    ghints = {
        k: bb.gen_galois_hint(k, sk, jax.random.fold_in(jax.random.PRNGKey(1), k))
        for k in ks
    }
    gals = bb.build_galois_many(ghints)
    singles = {k: bb.build_galois(ghints[k], k) for k in ks}
    n = params.ctx.n
    keys = jax.random.split(jax.random.PRNGKey(9), 2 * nrns)
    c0, c1 = (
        jnp.stack([
            jax.random.randint(kk, (n, batch), 0, q, dtype=jnp.uint32)
            for kk, q in zip(keys[j * nrns:(j + 1) * nrns], qs)
        ])
        for j in range(2)
    )
    _mark("galois: compile/guard")
    outs = gals(c0, c1)
    jax.block_until_ready(outs)
    # guard: for 2-power m the hoisted outputs are bit-identical to
    # per-k build_galois
    for k in ks:
        a0, a1 = singles[k](c0, c1)
        np.testing.assert_array_equal(
            np.asarray(outs[k][0][:, :, :1]), np.asarray(a0[:, :, :1])
        )
        np.testing.assert_array_equal(
            np.asarray(outs[k][1][:, :, :1]), np.asarray(a1[:, :, :1])
        )
    _mark("galois: interleaved A/B windows")
    tA, tB = [], []
    for _ in range(5):
        t0 = time.time()
        for _ in range(iters):
            outs = gals(c0, c1)
        jax.block_until_ready(outs)
        tA.append(time.time() - t0)
        t0 = time.time()
        for _ in range(iters):
            outs2 = [singles[k](c0, c1) for k in ks]
        jax.block_until_ready(outs2)
        tB.append(time.time() - t0)
    _mark("galois: done")
    rot = len(ks) * batch * iters
    tA_med, tB_med = statistics.median(tA), statistics.median(tB)
    return rot / tA_med, rot / tB_med, tB_med / tA_med


def bench_pt_round(m, p_round, batch, iters):
    """The serving-scale homomorphic rounding chain (VERDICT r4 next #7):
    serving.build_pt_round Z_{p_round} -> Z_pr over a real ring, whole
    batches per device execution; correctness-guarded on 3 columns."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace

    from lol_tpu import numtheory as nt, serving, she
    from lol_tpu.she_batched import BatchedBGV

    M = she.pt_round_mults(p_round)
    qs = tuple(nt.ntt_primes(m, 30, M + 2))
    params = she.SHEParams(m=m, p=p_round, qs=qs, var=2.0)
    _mark(f"pt_round m={m} p={p_round}: gen_sk + {M} device hints")
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    # device keygen per chain prefix
    hints = []
    L0 = len(qs)
    for i in range(M):
        params_i = replace(params, qs=qs[: L0 - i])
        bb_i = BatchedBGV(params_i)
        hints.append(
            bb_i.gen_ks_quad_hint(
                she.SK(params_i, sk.s_ints, sk.var),
                jax.random.fold_in(jax.random.PRNGKey(1), i),
            )
        )
    rh = she.PTRoundHints(tuple(hints))
    bb = BatchedBGV(params)
    _mark("pt_round: build chain")
    run, bb_out, f_out = serving.build_pt_round(bb, rh)
    n = params.ctx.n
    # scalar plaintexts (constant polynomials), as the chain requires
    vals = jax.random.randint(
        jax.random.PRNGKey(11), (batch,), 0, p_round, dtype=jnp.int32
    )
    msgs = jnp.zeros((n, batch), dtype=jnp.int32).at[0].set(vals)
    c0, c1 = bb.build_encrypt(sk)(msgs, jax.random.PRNGKey(2))
    _mark("pt_round: compile/run chain")
    y0, y1 = run(c0, c1)
    jax.block_until_ready((y0, y1))
    _mark("pt_round: decrypt guard")
    pr = bb_out.params.p
    sk_out = she.SK(bb_out.params, sk.s_ints, sk.var)
    dec = bb_out.build_decrypt(sk_out, f=f_out)
    got = np.asarray(dec(y0, y1)[:, :3])
    v3 = np.asarray(vals[:3])
    want = ((2 * v3 * pr + p_round) // (2 * p_round)) % pr
    np.testing.assert_array_equal(got[0], want)
    assert not got[1:].any()
    _mark("pt_round: timing loop")
    t0 = time.time()
    for _ in range(iters):
        y0, y1 = run(c0, c1)
    jax.block_until_ready((y0, y1))
    _mark("pt_round: done")
    return batch * iters / (time.time() - t0)


def bench_tunnel(m_r, m_s, nrns, batch, iters, p=257):
    """Fused device ring tunneling R -> S (E = S tower descent), ops/sec.
    Works for 2-power AND composite towers (general-m device keygen)."""
    import jax
    import jax.numpy as jnp

    from lol_tpu import gadget as gd, linear as lin, numtheory as nt, she
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context
    from lol_tpu.she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m_r, 30, nrns))
    pr = she.SHEParams(m=m_r, p=p, qs=qs, var=2.0)
    ps = she.SHEParams(m=m_s, p=p, qs=qs, var=2.0)
    kr, ks_, kh = jax.random.split(jax.random.PRNGKey(5), 3)
    _mark(f"tunnel m={m_r}->{m_s}: gen_sks")
    sk_r = she.gen_sk(pr, kr)
    sk_s = she.gen_sk(ps, ks_)
    E = ring_context(m_s, qs)
    S = ring_context(m_s, qs)
    R = ring_context(m_r, qs)
    d = R.n // E.n
    ys = [Cyc.zero(S) for _ in range(d)]
    ys[0] = Cyc.scalar(S, 1)  # canonical tower-descent projection
    f = lin.linear_pow(E, R, S, ys)
    bb = BatchedBGV(pr)
    _mark("tunnel: gen_tunnel_hint (device)")
    th = bb.gen_tunnel_hint(f, sk_s, sk_r, kh)
    tun = bb.build_tunnel(th)
    enc = bb.build_encrypt(sk_r)
    msgs = jax.random.randint(
        jax.random.PRNGKey(8), (R.n, batch), 0, pr.p, dtype=jnp.int32
    )
    _mark("tunnel: compile/run")
    c0, c1 = enc(msgs, jax.random.PRNGKey(6))
    e0, e1 = tun(c0, c1)
    jax.block_until_ready((e0, e1))
    _mark("tunnel: timing loop")
    t0 = time.time()
    for _ in range(iters):
        e0, e1 = tun(c0, c1)
    jax.block_until_ready((e0, e1))
    _mark("tunnel: done")
    return batch * iters / (time.time() - t0)


def main():
    import subprocess

    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"bench: no GPU (JAX platform {device.platform!r})",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _mark(f"card: {card}")
    _mark("ntt leg")
    n_ntt, ntt_stats = bench_ntt()
    _mark(f"ntt leg done: {ntt_stats['value']:.0f}/s at B={ntt_stats['batch']}")
    m_she, batch, iters = 32768, 1024, 30  # config 5
    n_bgv, bgv_rate = bench_bgv(m_she, nrns=3, batch=batch, iters=iters)
    # the n=4096 pipeline, plus mod_switch / linear KS / ext-modulus
    # step and the noise delta
    m_4k = 8192
    _, bgv4k_rate, bgv_extras = bench_bgv(
        m_4k, nrns=3, batch=batch, iters=iters, extras=True
    )
    # config-3 composite-m pipeline (m = 2^11 * 3^2, phi = 6144): the
    # 2-axis rides the same NTT on a free reshape, the 3^2 axis a dense
    # matvec
    m_gen = 18432
    n_gen, bgv_gen_rate = bench_bgv(m_gen, nrns=3, batch=batch,
                                    iters=iters, p=7)
    tunnel_rate = bench_tunnel(m_she, m_she // 2, nrns=3, batch=batch,
                               iters=iters)
    # general-m tower tunneling with device-generated hints
    m_gt = (18432, 9216)
    tunnel_gen_rate = bench_tunnel(m_gt[0], m_gt[1], nrns=3, batch=batch,
                                   iters=iters, p=7)
    # hoisted rotations and the serving-scale rounding chain (Z_8 -> Z_2)
    # at the config-5 ring
    m_gal = 32768
    gal_hoist, gal_sep, gal_speedup = bench_galois(m_gal, nrns=3,
                                                   batch=1024, iters=10)
    m_pr = 32768
    pt_round_rate = bench_pt_round(m_pr, p_round=8, batch=1024, iters=10)
    print(
        json.dumps(
            {
                "metric": f"negacyclic NTTs/sec, n={n_ntt}, 60-bit RNS (2x30-bit), {device.device_kind}",
                "value": round(ntt_stats["value"]),
                "unit": "NTT/s",
                "device": {"platform": device.platform,
                           "kind": device.device_kind,
                           "count": len(jax.devices()),
                           "card": card},
                "ntt_min": round(ntt_stats["min"]),
                "ntt_max": round(ntt_stats["max"]),
                "ntt_batch": ntt_stats["batch"],
                "ntt_windows": ntt_stats["windows"],
                "ntt_dispatch_chain": ntt_stats["dispatch_chain"],
                "ntt_medians_by_batch": ntt_stats["medians_by_batch"],
                "ntt_chain_medians_by_batch": ntt_stats["chain_medians_by_batch"],
                "ntt_interleaved_windows": ntt_stats["interleaved"],
                "intt_value": ntt_stats["intt_value"],
                "intt_min": ntt_stats["intt_min"],
                "intt_max": ntt_stats["intt_max"],
                "intt_batch": ntt_stats["intt_batch"],
                "bgv_ct_ops_per_sec": round(bgv_rate),
                "bgv_n": n_bgv,
                "bgv_rns": 3,
                "bgv_n4096_ops_per_sec": round(bgv4k_rate),
                "bgv_general_m_ops_per_sec": round(bgv_gen_rate),
                "bgv_general_m": m_gen,
                "bgv_general_n": n_gen,
                "tunnel_ops_per_sec": round(tunnel_rate),
                "tunnel_rings": f"m={m_she}->m={m_she // 2}",
                "tunnel_general_m_ops_per_sec": round(tunnel_gen_rate),
                "tunnel_general_m_rings": f"m={m_gt[0]}->m={m_gt[1]}",
                **bgv_extras,  # mod_switch/ks_linear/step_ext + noise delta
                "galois_hoisted_rot_per_sec": round(gal_hoist),
                "galois_separate_rot_per_sec": round(gal_sep),
                "galois_hoisted_speedup": round(gal_speedup, 3),
                "galois_rotations": 3,
                "galois_m": m_gal,
                "pt_round_ops_per_sec": round(pt_round_rate),
                "pt_round_p": 8,
                "pt_round_m": m_pr,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())

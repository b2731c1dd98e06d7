"""Per-op microbenchmark table — the criterion/PrettyPrint analog.

Reference: `lol-benches` (`Crypto.Lol.Benchmarks.*` + the Table
pretty-printer, SURVEY.md §3.7): per-Tensor-method timings over an
(op x backend x (m, q-chain)) grid, printed as an aligned table.

Run: python -m lol_tpu.bench.micro [--n 4096] [--batch 1024] [--rns 2]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _time(fn, args, iters=30):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.time() - t0) / iters


def run(n: int = 4096, batch: int = 1024, nrns: int = 2):
    import jax
    import jax.numpy as jnp

    from .. import numtheory as nt, zq
    from ..ops import ntt
    from ..ops import select

    qs = nt.ntt_primes(2 * n, 30, nrns)
    plans = [ntt.ntt_plan(n, q) for q in qs]
    rng = np.random.default_rng(0)
    x_cm = [
        jnp.asarray(rng.integers(0, q, (n, batch), dtype=np.uint64).astype(np.uint32))
        for q in qs
    ]
    x_rm = [xi.T for xi in x_cm]
    dev = jax.devices()[0].device_kind
    rows = []

    def add(op, backend, secs, per="poly", count=batch * nrns):
        rows.append((op, backend, secs * 1e3, count / secs))

    import functools

    jitted_fwd = [ntt._jit_fwd(p) for p in plans]
    jitted_inv = [ntt._jit_inv(p) for p in plans]
    add("crt (fwd NTT)", "xla", _time(lambda *a: [f(x) for f, x in zip(jitted_fwd, x_rm)], ()))
    add("crtInv", "xla", _time(lambda *a: [f(x) for f, x in zip(jitted_inv, x_rm)], ()))
    # the coefficient-major transform: XLA's stages and the implementation
    # the pipeline runs (ops.select; the fused kernel on the GPU)
    cm_runs = {
        "xla": (ntt.ntt_forward_cm, ntt.ntt_inverse_cm),
        select.ntt_backend(): (
            select.ntt_cm, lambda x, p: select.ntt_cm(x, p, inverse=True)),
    }
    for backend, (fwd, inv) in cm_runs.items():
        for op, f in (("crt (fwd, cm)", fwd), ("crtInv (cm)", inv)):
            run_cm = jax.jit(lambda xs, f=f: [f(x, p) for x, p in zip(xs, plans)])
            add(op, backend, _time(run_cm, (x_cm,)))

    mul_j = [
        __import__("jax").jit(lambda a, b, q=q: zq.mul_mod(a, b, q)) for q in qs
    ]
    add("zipWith (*)", "xla", _time(lambda *a: [f(x, x) for f, x in zip(mul_j, x_cm)], ()))
    add_j = [
        __import__("jax").jit(lambda a, b, q=q: zq.add_mod(a, b, q)) for q in qs
    ]
    add("zipWith (+)", "xla", _time(lambda *a: [f(x, x) for f, x in zip(add_j, x_cm)], ()))

    # per-Tensor-method rows (the reference benches each class method)
    from .. import gadget as gd
    from ..ring import ring_context
    import lol_tpu.ring as rg

    ctx = ring_context(2 * n, tuple(qs))
    xr = jnp.stack(x_rm, axis=-2)  # (batch, nrns, n)
    lj = jax.jit(lambda v: rg.l(ctx, v))
    lij = jax.jit(lambda v: rg.l_inv(ctx, v))
    add("l (dec->pow)", "xla", _time(lj, (xr,)))
    add("lInv", "xla", _time(lij, (xr,)))
    gj = jax.jit(lambda v: rg.mul_g_pow(ctx, v))
    add("mulG (pow)", "xla", _time(gj, (xr,)))
    if nrns >= 2:
        rj = jax.jit(ctx.basis.rescale_drop_last)
        add("rescale (RNS)", "xla", _time(rj, (xr,)))
    dj = jax.jit(lambda v: gd.decompose(gd.RnsGad(), ctx.basis, v))
    add("decompose (rns)", "xla", _time(dj, (xr,)))

    # cross-ring index ops + the device Garner lift (r2 additions)
    sub = ring_context(n, tuple(qs))  # index n = half of ctx's 2n
    ej = jax.jit(lambda v: rg.embed_pow(sub, ctx, v))
    tj = jax.jit(lambda v: rg.twace_pow(ctx, sub, v))
    xs_sub = xr[..., : sub.n]
    add("embedPow", "xla", _time(ej, (xs_sub,)))
    add("twacePowDec", "xla", _time(tj, (xr,)))
    ecj = jax.jit(lambda v: rg.embed_crt(sub, ctx, v))
    tcj = jax.jit(lambda v: rg.twace_crt(ctx, sub, v))
    add("embedCRT", "xla", _time(ecj, (xs_sub,)))
    add("twaceCRT", "xla", _time(tcj, (xr,)))
    cj = jax.jit(lambda v: rg.coeffs_pow(ctx, sub, v))
    add("coeffs", "xla", _time(cj, (xr,)))
    liftj = jax.jit(lambda v: ctx.basis.lift_mod_jnp(v, 257))
    add("liftDec mod p", "xla", _time(liftj, (xr,)))

    # device-side keygen: all RNS-gadget hints for one target, one call
    from .. import she
    from ..she_batched import BatchedBGV

    pars = she.SHEParams(m=2 * n, p=257, qs=tuple(qs), var=2.0)
    sk = she.gen_sk(pars, jax.random.PRNGKey(1))
    bbp = BatchedBGV(pars)

    # batched serving-path decrypts + noise extraction (r3 additions);
    # component stacks are (nrns, n, B) coefficient-major
    ccm = jnp.transpose(xr, (1, 2, 0))  # (batch, nrns, n) -> (nrns, n, B)
    dec_l = bbp.build_decrypt(sk)
    dec_m = bbp.build_decrypt(sk, encoding="msd")
    nbits = bbp.build_noise_bits(sk)
    add("decrypt (lsd, device)", "device", _time(dec_l, (ccm, ccm)),
        count=batch)
    add("decrypt (msd, device)", "device", _time(dec_m, (ccm, ccm)),
        count=batch)
    add("noise_bits (device)", "device", _time(nbits, (ccm, ccm)),
        count=batch)
    add(
        "hintGen (quad)", "device",
        _time(lambda k: bbp.gen_ks_quad_hint(sk, k),
              (jax.random.PRNGKey(2),), iters=3),
        count=1,
    )

    # dense odd-axis DFT matvec (general-m CRT leg): broadcast vs int8 limbs
    from ..ops import general as gen

    q0 = qs[0]
    phi = 96
    Md = jnp.asarray(
        rng.integers(0, q0, (phi, phi), dtype=np.uint64).astype(np.uint32)
    )
    xv = jnp.asarray(
        rng.integers(0, q0, (batch, phi), dtype=np.uint64).astype(np.uint32)
    )
    vj = jax.jit(lambda v: gen.matvec_mod_jnp(Md, v, q0, use_int8=False))
    mj = jax.jit(lambda v: gen.matvec_mod_int8(Md, v, q0))
    add(f"denseDFT p{phi}", "bcast", _time(vj, (xv,)), count=batch)
    add(f"denseDFT p{phi}", "int8", _time(mj, (xv,)), count=batch)

    print(f"\nlol_tpu microbench: n={n}, batch={batch}, nrns={nrns}, device={dev}")
    print(f"{'op':<16} {'backend':<8} {'ms/call':>10} {'poly-ops/s':>14}")
    for op, backend, ms, rate in rows:
        print(f"{op:<16} {backend:<8} {ms:>10.3f} {rate:>14,.0f}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rns", type=int, default=2)
    args = ap.parse_args()
    run(args.n, args.batch, args.rns)


if __name__ == "__main__":
    main()

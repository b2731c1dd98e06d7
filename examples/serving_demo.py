"""Serving-path demo: the fused batched BGV pipeline end to end.

Covers the serving surface: batched encrypt -> fused
mul+keyswitch+rescale -> device decrypt in BOTH encodings (LSD and MSD),
device-side noise-budget tracking, the batched encoding switches, the
general-m (composite cyclotomic) fused pipeline, and the round-4 ops:
extended-modulus (hybrid) relinearization, standalone modulus switch +
linear re-encryption, and the batched homomorphic rounding chain.  Runs
on the default device (every NTT implementation is bit-identical).
"""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

import jax.numpy as jnp
import numpy as np

from lol_tpu import numtheory as nt, she
from lol_tpu.she_batched import BatchedBGV


def pipeline(m, p, encoding, B=8):
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    bb = BatchedBGV(params)
    hint = bb.gen_ks_quad_hint(sk, jax.random.PRNGKey(1))  # one-call keygen
    n = params.ctx.n

    rng = np.random.default_rng(0)
    m1 = rng.integers(0, p, (n, B)).astype(np.int32)
    m2 = rng.integers(0, p, (n, B)).astype(np.int32)
    enc = bb.build_encrypt(sk, encoding=encoding)
    c0, c1 = enc(jnp.asarray(m1), jax.random.PRNGKey(2))
    d0, d1 = enc(jnp.asarray(m2), jax.random.PRNGKey(3))

    # one fused step: ct_mul -> RNS-gadget keyswitch -> exact rescale
    e0, e1 = bb.build_step(hint, encoding=encoding)(c0, c1, d0, d1)

    # device decrypt over the dropped-prime chain (encoding-aware)
    params2 = she.SHEParams(m=m, p=p, qs=qs[:-1], var=params.var)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = bb.step_f(1, 1, encoding=encoding)
    dec = BatchedBGV(params2).build_decrypt(
        sk2, f=f2, encoding=encoding
    )
    got = np.asarray(dec(e0, e1))
    ok = all(
        np.array_equal(got[:, b], she.pt_mul(params, m1[:, b], m2[:, b]))
        for b in range(B)
    )
    tag = f"m={m} ({'2-power' if m & (m - 1) == 0 else 'composite'}), {encoding.upper()}"
    print(f"{tag:34} batch of {B} mul+ks+rescale -> decrypt: {'OK' if ok else 'FAIL'}")
    return bb, sk, (c0, c1), m1


def main():
    # 2-power ring, both encodings
    bb, sk, (c0, c1), _ = pipeline(m=256, p=257, encoding="lsd")
    bbm, skm, (mc0, mc1), m1 = pipeline(m=256, p=257, encoding="msd")
    # composite cyclotomic (m = 2^2 * 3^2) through the same fused path
    pipeline(m=36, p=5, encoding="lsd")

    # device-side noise budgets for a whole batch at once (LSD cts)
    bits = np.asarray(bb.build_noise_bits(sk)(c0, c1))
    print(f"fresh-ct noise budgets (device, batch): {np.round(bits, 1)} bits")

    # batched encoding switches: MSD -> LSD -> MSD round-trip decrypts
    l0, l1 = bbm.build_to_lsd()(mc0, mc1)
    r0, r1 = bbm.build_to_msd()(l0, l1)
    f = bbm.to_msd_f(bbm.to_lsd_f(1))
    dec = bbm.build_decrypt(skm, f=f, encoding="msd")
    print("to_lsd -> to_msd round-trip decrypts:",
          np.array_equal(np.asarray(dec(r0, r1)), m1))

    # --- round-4 serving ops -------------------------------------------
    m, p, B = 256, 257, 4
    qs = tuple(nt.ntt_primes(m, 30, 5))
    params = she.SHEParams(m=m, p=p, qs=qs[:3], var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(10))
    bb = BatchedBGV(params)
    rng = np.random.default_rng(1)
    msgs = rng.integers(0, p, (params.ctx.n, B)).astype(np.int32)
    c0, c1 = bb.build_encrypt(sk)(jnp.asarray(msgs), jax.random.PRNGKey(11))

    # extended-modulus (hybrid) relinearization: hints over Q*P, KS
    # noise divided by P
    hx = bb.gen_ks_quad_hint_ext(sk, qs[3:], jax.random.PRNGKey(12))
    e0, e1 = bb.build_step_ext(hx)(c0, c1, c0, c1)
    params2 = she.SHEParams(m=m, p=p, qs=qs[:2], var=2.0)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    dec2 = BatchedBGV(params2).build_decrypt(
        sk2, f=bb.step_f(1, 1)
    )
    ok = all(
        np.array_equal(np.asarray(dec2(e0, e1))[:, b],
                       she.pt_mul(params, msgs[:, b], msgs[:, b]))
        for b in range(B)
    )
    print(f"ext-modulus hybrid keyswitch step (P ~ 2^60): "
          f"{'OK' if ok else 'FAIL'}")

    # standalone exact modulus switch + linear re-encryption
    s0, s1 = bb.build_mod_switch()(c0, c1)
    dec_ms = BatchedBGV(
        she.SHEParams(m=m, p=p, qs=qs[:2], var=2.0)
    ).build_decrypt(sk2, f=bb.mod_switch_f(1))
    sk_new = she.gen_sk(params, jax.random.PRNGKey(13))
    lh = bb.gen_ks_linear_hint(sk_new, sk, jax.random.PRNGKey(14))
    k0, k1 = bb.build_key_switch_linear(lh)(c0, c1)
    dec_new = bb.build_decrypt(sk_new)
    print("standalone mod_switch decrypts:",
          np.array_equal(np.asarray(dec_ms(s0, s1)), msgs),
          "| linear re-encryption decrypts:",
          np.array_equal(np.asarray(dec_new(k0, k1)), msgs))

    # hoisted rotation batch: one decompose shared by all sigma_k
    from lol_tpu import gadget as gd, serving

    ghints = {k: she.ks_galois_hint(k, sk, gd.RnsGad(),
                                    jax.random.PRNGKey(20 + k))
              for k in (3, 5)}
    outs = bb.build_galois_many(ghints)(c0, c1)
    ok = all(
        np.array_equal(
            np.asarray(bb.build_decrypt(sk)(*outs[k])),
            np.asarray(bb.build_decrypt(sk)(*bb.build_galois(ghints[k], k)(c0, c1))),
        )
        for k in (3, 5)
    )
    print(f"hoisted rotation batch (sigma_3, sigma_5): {'OK' if ok else 'FAIL'}")

    # batched homomorphic rounding: Z_8 -> Z_2 over a batch of scalars.
    # The hint bundle is generated ONCE, checkpointed to disk (proto),
    # and the serving process reloads it — the deployment shape.
    import tempfile
    from lol_tpu import io as lio

    p8 = 8
    qs8 = tuple(nt.ntt_primes(32, 30, she.pt_round_mults(p8) + 2))
    params8 = she.SHEParams(m=16, p=p8, qs=qs8, var=2.0)
    sk8 = she.gen_sk(params8, jax.random.PRNGKey(15))
    rh_gen = she.pt_round_hints(sk8, gd.RnsGad(), jax.random.PRNGKey(16))
    with tempfile.NamedTemporaryFile(suffix=".ptroundhints") as fh:
        fh.write(lio.pt_round_hints_to_proto(rh_gen).SerializeToString())
        fh.flush()
        wire = open(fh.name, "rb").read()
    rh = lio.pt_round_hints_from_proto(lio.pb.PTRoundHints.FromString(wire))
    print(f"rounding-hint bundle: {len(rh.hints)} hints, "
          f"{len(wire)} bytes on disk, reloaded for serving")
    vals = [1, 3, 6]
    cts = []
    for b, v in enumerate(vals):
        mm = np.zeros(params8.ctx.n, dtype=np.int64)
        mm[0] = v
        cts.append(she.encrypt(sk8, mm, jax.random.PRNGKey(17 + b)))
    bb8 = BatchedBGV(params8)
    r0_, r1_ = bb8.pack(cts)
    bb_out, f_out, (y0, y1) = serving.batched_pt_round(bb8, rh, r0_, r1_)
    sk_out = she.SK(bb_out.params, sk8.s_ints, sk8.var)
    got = np.asarray(bb_out.build_decrypt(sk_out, f=f_out)(y0, y1))[0]
    want = [((2 * v * 2 + p8) // (2 * p8)) % 2 for v in vals]
    print(f"batched homomorphic rounding Z_8 -> Z_2: {list(got)} "
          f"(expect {want}): {'OK' if list(got) == want else 'FAIL'}")


if __name__ == "__main__":
    main()

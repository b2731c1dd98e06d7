"""Batched BGV pipeline vs the object-level path — column-wise bit-exact."""

import numpy as np
import pytest
import jax

from lol_tpu import gadget as gd
from lol_tpu import numtheory as nt
from lol_tpu import she
from lol_tpu.cyc import Rep
from lol_tpu.she_batched import BatchedBGV

M = 64
QS = tuple(nt.ntt_primes(M, 30, 3))
PARAMS = she.SHEParams(m=M, p=257, qs=QS, var=2.0)


def test_batched_step_matches_object_path(rng):
    key = jax.random.PRNGKey(0)
    ks, kh, *kes = jax.random.split(key, 2 + 8)
    sk = she.gen_sk(PARAMS, ks)
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), kh)
    B = 4
    cts_a, cts_b, msgs = [], [], []
    for b in range(B):
        m1, m2 = she.pt_random(PARAMS, rng), she.pt_random(PARAMS, rng)
        cts_a.append(she.encrypt(sk, m1, kes[2 * b]))
        cts_b.append(she.encrypt(sk, m2, kes[2 * b + 1]))
        msgs.append((m1, m2))

    bb = BatchedBGV(PARAMS)
    c0, c1 = bb.pack(cts_a)
    d0, d1 = bb.pack(cts_b)
    step = bb.build_step(hint)
    e0, e1 = step(c0, c1, d0, d1)

    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    f2 = nt.modinv(QS[-1] % PARAMS.p, PARAMS.p)
    outs = bb2.unpack((e0, e1), f=f2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)

    for b in range(B):
        # object-level reference pipeline
        ref = she.mod_switch(
            she.key_switch_quad_circ(hint, she.ct_mul(cts_a[b], cts_b[b]))
        )
        # bit-exact ciphertext components
        for k in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[k].data),
                np.asarray(ref.cs[k].to_crt().data),
            )
        assert outs[b].f == ref.f
        # and correct decryption
        m1, m2 = msgs[b]
        np.testing.assert_array_equal(
            she.decrypt(sk2, outs[b]), she.pt_mul(PARAMS, m1, m2)
        )


def test_batched_encrypt_decrypts(rng):
    key = jax.random.PRNGKey(3)
    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(4))
    bb = BatchedBGV(PARAMS)
    enc = bb.build_encrypt(sk)
    B = 3
    msgs = rng.integers(0, PARAMS.p, (PARAMS.ctx.n, B)).astype(np.int32)
    import jax.numpy as jnp

    c0, c1 = enc(jnp.asarray(msgs), key)
    cts = bb.unpack((c0, c1))
    for b in range(B):
        np.testing.assert_array_equal(she.decrypt(sk, cts[b]), msgs[:, b])
    # determinism
    d0, d1 = enc(jnp.asarray(msgs), key)
    np.testing.assert_array_equal(np.asarray(c0), np.asarray(d0))


def test_batched_decrypt_matches_host(rng):
    """Device-side Garner lift decrypt == host object decrypt (r1 #4)."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(10))
    bb = BatchedBGV(PARAMS)
    enc = bb.build_encrypt(sk)
    dec = bb.build_decrypt(sk)
    B = 5
    msgs = rng.integers(0, PARAMS.p, (PARAMS.ctx.n, B)).astype(np.int32)
    c0, c1 = enc(jnp.asarray(msgs), jax.random.PRNGKey(11))
    got = np.asarray(dec(c0, c1))
    np.testing.assert_array_equal(got, msgs)
    # with a non-trivial scale factor f (post-modswitch ciphertexts)
    cts = bb.unpack((c0, c1))
    ct2 = she.mod_switch(cts[0])
    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    dec2 = bb2.build_decrypt(sk2, f=ct2.f)
    a0 = np.asarray(ct2.cs[0].to_crt().data)[..., None]
    a1 = np.asarray(ct2.cs[1].to_crt().data)[..., None]
    got2 = np.asarray(dec2(jnp.asarray(a0), jnp.asarray(a1)))[:, 0]
    np.testing.assert_array_equal(got2, she.decrypt(sk2, ct2))


def test_batched_galois_matches_object(rng):
    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(12))
    k = 3
    hint = she.ks_galois_hint(k, sk, gd.RnsGad(), jax.random.PRNGKey(13))
    B = 3
    cts = [she.encrypt(sk, she.pt_random(PARAMS, rng), jax.random.PRNGKey(20 + b))
           for b in range(B)]
    bb = BatchedBGV(PARAMS)
    c0, c1 = bb.pack(cts)
    e0, e1 = bb.build_galois(hint, k)(c0, c1)
    outs = bb.unpack((e0, e1))
    for b in range(B):
        ref = she.ct_galois(hint, k, cts[b])
        for comp in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[comp].data),
                np.asarray(ref.cs[comp].to_crt().data),
            )
        np.testing.assert_array_equal(she.decrypt(sk, outs[b]),
                                      she.decrypt(sk, ref))


def test_batched_galois_hoisted(rng):
    """build_galois_many (hoisted rotations: one decompose shared by
    all sigma_k) — bit-exact vs per-k build_galois at 2-power m (the
    automorphism is a signed coefficient permutation, which commutes
    with centered digit extraction), and decrypt-identical at general m
    (the permuted digits are a valid non-canonical decomposition)."""
    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(240))
    bb = BatchedBGV(PARAMS)
    ks = (3, 5, 63)
    hints = {
        k: she.ks_galois_hint(k, sk, gd.RnsGad(),
                              jax.random.PRNGKey(241 + k))
        for k in ks
    }
    B = 3
    cts = [she.encrypt(sk, she.pt_random(PARAMS, rng),
                       jax.random.PRNGKey(250 + b)) for b in range(B)]
    c0, c1 = bb.pack(cts)
    outs = bb.build_galois_many(hints)(c0, c1)
    for k in ks:
        ref = bb.build_galois(hints[k], k)(c0, c1)
        for got, want in zip(outs[k], ref):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # general m: decrypt equality (digits differ from the canonical ones)
    m = 36
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=5, qs=qs, var=2.0)
    skg = she.gen_sk(params, jax.random.PRNGKey(260))
    bbg = BatchedBGV(params)
    kg = 5  # unit mod 36
    hg = {kg: she.ks_galois_hint(kg, skg, gd.RnsGad(),
                                 jax.random.PRNGKey(261))}
    ctg = she.encrypt(skg, she.pt_random(params, rng),
                      jax.random.PRNGKey(262))
    g0, g1 = bbg.pack([ctg])
    e0, e1 = bbg.build_galois_many(hg)(g0, g1)[kg]
    out = bbg.unpack((e0, e1))[0]
    ref = she.ct_galois(hg[kg], kg, ctg)
    np.testing.assert_array_equal(she.decrypt(skg, out),
                                  she.decrypt(skg, ref))


def test_batched_tunnel_matches_object(rng):
    """Fused device tunnel == she.tunnel, component-wise bit-exact (r1 #2)."""
    from lol_tpu import linear as lin
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context

    me, mr, ms = 16, 64, 32
    qs = tuple(nt.ntt_primes(64, 30, 3))
    E, R, S = (ring_context(m, qs) for m in (me, mr, ms))
    pr = she.SHEParams(m=mr, p=257, qs=qs, var=2.0)
    ps = she.SHEParams(m=ms, p=257, qs=qs, var=2.0)
    kr, ks_, kh, *kes = jax.random.split(jax.random.PRNGKey(30), 8)
    sk_r = she.gen_sk(pr, kr)
    sk_s = she.gen_sk(ps, ks_)
    ys = [Cyc.from_ints(S, rng.integers(-2, 3, S.n)) for _ in range(R.n // E.n)]
    f = lin.linear_pow(E, R, S, ys)
    th = she.tunnel_hint(f, sk_s, sk_r, gd.RnsGad(), kh)
    B = 3
    cts = [she.encrypt(sk_r, she.pt_random(pr, rng), kes[b]) for b in range(B)]
    bb = BatchedBGV(pr)
    c0, c1 = bb.pack(cts)
    e0, e1 = bb.build_tunnel(th)(c0, c1)
    bb_s = bb.target_pipeline(th)
    outs = bb_s.unpack((e0, e1))
    for b in range(B):
        ref = she.tunnel(th, cts[b])
        for comp in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[comp].data),
                np.asarray(ref.cs[comp].to_crt().data),
            )
        np.testing.assert_array_equal(she.decrypt(sk_s, outs[b]),
                                      she.decrypt(sk_s, ref))


def test_config5_scale_smoke(rng):
    """Config 5 at its stated ring scale: m=32768 (n=2^14) batched BGV
    step + fused tunnel down to m=16384, decrypt-correct (VERDICT r1 #2).
    Small batch/XLA path so the CPU suite stays fast."""
    import jax.numpy as jnp
    from lol_tpu import linear as lin
    from lol_tpu.cyc import Cyc, Rep
    from lol_tpu.ring import ring_context

    m, nrns, B = 32768, 2, 4
    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=257, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(50))
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), jax.random.PRNGKey(51))
    bb = BatchedBGV(params)
    enc = bb.build_encrypt(sk)
    n = params.ctx.n
    m1 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    m2 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    c0, c1 = enc(jnp.asarray(m1), jax.random.PRNGKey(52))
    d0, d1 = enc(jnp.asarray(m2), jax.random.PRNGKey(53))
    e0, e1 = bb.build_step(hint)(c0, c1, d0, d1)
    params2 = she.SHEParams(m=m, p=params.p, qs=qs[:-1], var=params.var)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = nt.modinv(qs[-1] % params.p, params.p)
    got = np.asarray(bb2.build_decrypt(sk2, f=f2)(e0, e1))[:, 0]
    aux = ring_context(m, tuple(nt.ntt_primes(m, 29, 2)))
    want = (
        (Cyc.from_ints(aux, m1[:, 0], rep=Rep.DEC)
         * Cyc.from_ints(aux, m2[:, 0], rep=Rep.DEC)).lift_ints(rep=Rep.DEC)
        % params.p
    ).astype(np.int64)
    np.testing.assert_array_equal(got.astype(np.int64), want)

    # fused tunnel m=32768 -> m=16384 on the mul output's chain
    ms = m // 2
    E = S = ring_context(ms, qs[:-1])
    R = ring_context(m, qs[:-1])
    ps = she.SHEParams(m=ms, p=params.p, qs=qs[:-1], var=params.var)
    sk_s = she.gen_sk(ps, jax.random.PRNGKey(54))
    d = R.n // E.n
    ys = [Cyc.zero(S) for _ in range(d)]
    ys[0] = Cyc.scalar(S, 1)
    fmap = lin.linear_pow(E, R, S, ys)
    th = she.tunnel_hint(fmap, sk_s, sk2, gd.RnsGad(), jax.random.PRNGKey(55))
    t0, t1 = bb2.build_tunnel(th)(e0, e1)
    outs = bb2.target_pipeline(th).unpack((t0, t1), f=f2)
    ref = she.tunnel(th, bb2.unpack((e0, e1), f=f2)[0])
    np.testing.assert_array_equal(she.decrypt(sk_s, outs[0]),
                                  she.decrypt(sk_s, ref))


def test_batched_msd_encrypt_decrypt(rng):
    """MSD through the serving path (VERDICT r2 #3): batched MSD encrypt
    -> device MSD decrypt (Garner-digit scaled rounding, no big ints) ==
    host she.decrypt, and roundtrips the messages."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(90))
    bb = BatchedBGV(PARAMS)
    enc = bb.build_encrypt(sk, encoding="msd")
    dec = bb.build_decrypt(sk, encoding="msd")
    B = 5
    msgs = rng.integers(0, PARAMS.p, (PARAMS.ctx.n, B)).astype(np.int32)
    c0, c1 = enc(jnp.asarray(msgs), jax.random.PRNGKey(91))
    np.testing.assert_array_equal(np.asarray(dec(c0, c1)), msgs)
    # device MSD decrypt == host object path, column by column
    cts = bb.unpack((c0, c1), encoding="msd")
    for b in range(B):
        np.testing.assert_array_equal(
            np.asarray(dec(c0, c1))[:, b], she.decrypt(sk, cts[b])
        )
    # object-path MSD ciphertexts decrypt on device too (incl. f != 1)
    ct = she.encrypt_msd(sk, msgs[:, 0], jax.random.PRNGKey(92))
    ct3 = she.ct_add(ct, ct)
    a0 = jnp.asarray(np.asarray(ct3.cs[0].to_crt().data)[..., None])
    a1 = jnp.asarray(np.asarray(ct3.cs[1].to_crt().data)[..., None])
    dec_f = bb.build_decrypt(sk, f=ct3.f, encoding="msd")
    np.testing.assert_array_equal(
        np.asarray(dec_f(a0, a1))[:, 0], she.decrypt(sk, ct3)
    )


def test_batched_msd_step_matches_object_path(rng):
    """Fused MSD step == she.ct_mul(msd,msd) + keyswitch + mod_switch,
    component-wise bit-exact; then a fused tunnel on the MSD output and
    a device MSD decrypt close the loop (VERDICT r2 #3 'done' shape)."""
    from lol_tpu import linear as lin
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context

    key = jax.random.PRNGKey(95)
    ks, kh, *kes = jax.random.split(key, 2 + 6)
    sk = she.gen_sk(PARAMS, ks)
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), kh)
    B = 3
    cts_a, cts_b, msgs = [], [], []
    for b in range(B):
        m1, m2 = she.pt_random(PARAMS, rng), she.pt_random(PARAMS, rng)
        cts_a.append(she.encrypt_msd(sk, m1, kes[2 * b]))
        cts_b.append(she.encrypt_msd(sk, m2, kes[2 * b + 1]))
        msgs.append((m1, m2))
    bb = BatchedBGV(PARAMS)
    c0, c1 = bb.pack(cts_a)
    d0, d1 = bb.pack(cts_b)
    e0, e1 = bb.build_step(hint, encoding="msd")(c0, c1, d0, d1)

    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    f2 = bb.step_f(1, 1, encoding="msd")
    outs = bb2.unpack((e0, e1), f=f2, encoding="msd")
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    dec2 = bb2.build_decrypt(sk2, f=f2, encoding="msd")
    got_dev = np.asarray(dec2(e0, e1))
    for b in range(B):
        ref = she.mod_switch(
            she.key_switch_quad_circ(hint, she.ct_mul(cts_a[b], cts_b[b]))
        )
        assert ref.encoding == "msd" and outs[b].f == ref.f
        for k in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[k].data),
                np.asarray(ref.cs[k].to_crt().data),
            )
        m1, m2 = msgs[b]
        want = she.pt_mul(PARAMS, m1, m2)
        np.testing.assert_array_equal(she.decrypt(sk2, ref), want)
        np.testing.assert_array_equal(got_dev[:, b], want)

    # fused tunnel on the MSD step output (tunnel is encoding-agnostic)
    ms = M // 2
    E = S = ring_context(ms, QS[:-1])
    R = ring_context(M, QS[:-1])
    ps = she.SHEParams(m=ms, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    sk_s = she.gen_sk(ps, jax.random.PRNGKey(96))
    d = R.n // E.n
    ys = [Cyc.zero(S) for _ in range(d)]
    ys[0] = Cyc.scalar(S, 1)
    fmap = lin.linear_pow(E, R, S, ys)
    th = she.tunnel_hint(fmap, sk_s, sk2, gd.RnsGad(), jax.random.PRNGKey(97))
    t0, t1 = bb2.build_tunnel(th)(e0, e1)
    bb_s = bb2.target_pipeline(th)
    out_t = bb_s.unpack((t0, t1), f=f2, encoding="msd")[0]
    ref_t = she.tunnel(th, outs[0])
    np.testing.assert_array_equal(she.decrypt(sk_s, out_t),
                                  she.decrypt(sk_s, ref_t))
    dec_s = bb_s.build_decrypt(sk_s, f=f2, encoding="msd")
    np.testing.assert_array_equal(
        np.asarray(dec_s(t0, t1))[:, 0], she.decrypt(sk_s, ref_t)
    )


def test_batched_add_sub_aligned(rng):
    """build_add/sub with mismatched scale factors == she.ct_add/ct_sub
    (the centered-u alignment), component-wise bit-exact."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(160))
    bb = BatchedBGV(PARAMS)
    B = 3
    cts_a = [she.encrypt(sk, she.pt_random(PARAMS, rng),
                         jax.random.PRNGKey(161 + b)) for b in range(B)]
    # give the second operands a different scale factor via mod-switch
    cts_b0 = [she.encrypt(sk, she.pt_random(PARAMS, rng),
                          jax.random.PRNGKey(170 + b)) for b in range(B)]
    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    cts_a2 = [she.mod_switch(ct) for ct in cts_a]  # f = ql^-1 mod p
    # distinct f on the b side: scale components by 3 and fold into f
    # (c(s) = 3f m' + p e' with m' = 3^-1 m... the pair (3*cs, 3f) is a
    # valid ciphertext of the same message at scale 3f)
    cts_b2 = [
        she.CT(ct.params, ct.ctx, tuple(c * 3 for c in ct.cs),
               f=3 * ct.f % PARAMS.p)
        for ct in (she.mod_switch(ct) for ct in cts_b0)
    ]
    fa, fb = cts_a2[0].f, cts_b2[0].f
    assert fa != fb
    c0, c1 = bb2.pack(cts_a2)
    d0, d1 = bb2.pack(cts_b2)
    for sub in (False, True):
        e0, e1 = bb2.build_add(f_a=fa, f_b=fb, sub=sub)(c0, c1, d0, d1)
        for b in range(B):
            ref = (she.ct_sub if sub else she.ct_add)(cts_a2[b], cts_b2[b])
            assert ref.f == fa
            for got, comp in ((e0, 0), (e1, 1)):
                np.testing.assert_array_equal(
                    np.asarray(got)[..., b],
                    np.asarray(ref.cs[comp].to_crt().data),
                )


def test_batched_public_ops(rng):
    """build_add_public / build_mul_public == she.add_public /
    she.mul_public component-wise, LSD and MSD, incl. f != 1 and the
    (n, 1) broadcast form."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(150))
    bb = BatchedBGV(PARAMS)
    n, B = PARAMS.ctx.n, 3
    pub = rng.integers(0, PARAMS.p, (n, B)).astype(np.int32)
    for encoding, mk in (("lsd", she.encrypt), ("msd", she.encrypt_msd)):
        cts = [mk(sk, she.pt_random(PARAMS, rng),
                  jax.random.PRNGKey(151 + b)) for b in range(B)]
        if encoding == "lsd":  # non-trivial scale factor via mod_switch-less align
            cts = [she.ct_add(ct, ct) for ct in cts]
        c0, c1 = bb.pack(cts)
        f = cts[0].f
        a0, a1 = bb.build_add_public(f=f, encoding=encoding)(
            c0, c1, jnp.asarray(pub)
        )
        m0, m1c = bb.build_mul_public()(c0, c1, jnp.asarray(pub))
        for b in range(B):
            ref_a = she.add_public(cts[b], pub[:, b])
            ref_m = she.mul_public(cts[b], pub[:, b])
            np.testing.assert_array_equal(
                np.asarray(a0)[..., b], np.asarray(ref_a.cs[0].to_crt().data)
            )
            np.testing.assert_array_equal(
                np.asarray(a1)[..., b], np.asarray(ref_a.cs[1].to_crt().data)
            )
            for got, comp in ((m0, 0), (m1c, 1)):
                np.testing.assert_array_equal(
                    np.asarray(got)[..., b],
                    np.asarray(ref_m.cs[comp].to_crt().data),
                )
    # broadcast form: one public value over the whole batch
    one = pub[:, :1]
    b0, b1 = bb.build_mul_public()(c0, c1, jnp.asarray(one))
    ref = she.mul_public(cts[1], one[:, 0])
    np.testing.assert_array_equal(
        np.asarray(b0)[..., 1], np.asarray(ref.cs[0].to_crt().data)
    )


def test_batched_encoding_switches(rng):
    """build_to_lsd / build_to_msd match she.to_lsd / she.to_msd
    component-wise, with the to_lsd_f / to_msd_f scale bookkeeping."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(98))
    bb = BatchedBGV(PARAMS)
    m1 = she.pt_random(PARAMS, rng)
    ct = she.encrypt_msd(sk, m1, jax.random.PRNGKey(99))
    c0, c1 = bb.pack([ct])
    l0, l1 = bb.build_to_lsd()(c0, c1)
    ref = she.to_lsd(ct)
    assert bb.to_lsd_f(ct.f) == ref.f
    for got, comp in ((l0, 0), (l1, 1)):
        np.testing.assert_array_equal(
            np.asarray(got)[..., 0], np.asarray(ref.cs[comp].to_crt().data)
        )
    m0, m1c = bb.build_to_msd()(l0, l1)
    ref2 = she.to_msd(ref)
    assert bb.to_msd_f(ref.f) == ref2.f
    for got, comp in ((m0, 0), (m1c, 1)):
        np.testing.assert_array_equal(
            np.asarray(got)[..., 0], np.asarray(ref2.cs[comp].to_crt().data)
        )
    # and the roundtripped ct still decrypts (device MSD decrypt)
    dec = bb.build_decrypt(sk, f=ref2.f, encoding="msd")
    np.testing.assert_array_equal(np.asarray(dec(m0, m1c))[:, 0],
                                  she.decrypt(sk, ref2))


def test_batched_noise_matches_host(rng):
    """Device error_term residues == host she.error_term mod q_i exactly;
    device noise_bits == host she.noise_bits to float32 accuracy
    (VERDICT r2 #6)."""
    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(100))
    bb = BatchedBGV(PARAMS)
    B = 4
    cts = [she.encrypt(sk, she.pt_random(PARAMS, rng),
                       jax.random.PRNGKey(101 + b)) for b in range(B)]
    # include a high-noise ct (post-mul, keyswitch) to vary magnitudes
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), jax.random.PRNGKey(110))
    cts[-1] = she.key_switch_quad_circ(hint, she.ct_mul(cts[0], cts[1]))
    c0, c1 = bb.pack(cts)
    e_res = np.asarray(bb.build_error_term(sk)(c0, c1))
    bits = np.asarray(bb.build_noise_bits(sk)(c0, c1))
    for b in range(B):
        e_host = she.error_term(sk, cts[b])  # object ints
        for i, q in enumerate(QS):
            want = np.array([int(v) % q for v in e_host], dtype=np.uint32)
            np.testing.assert_array_equal(e_res[i, :, b], want)
        np.testing.assert_allclose(
            bits[b], she.noise_bits(sk, cts[b]), rtol=2e-5, atol=2e-5
        )


def test_batched_noise_long_chain(rng):
    """9-prime chain (Q ~ 2^270): the grouped float32 accumulation must
    not underflow low digit weights (a single global 2^-shift once
    zeroed digit-0 contributions for chains over ~8 primes)."""
    qs9 = tuple(nt.ntt_primes(M, 30, 9))
    params9 = she.SHEParams(m=M, p=257, qs=qs9, var=2.0)
    sk9 = she.gen_sk(params9, jax.random.PRNGKey(120))
    bb9 = BatchedBGV(params9)
    cts = [she.encrypt(sk9, she.pt_random(params9, rng),
                       jax.random.PRNGKey(121 + b)) for b in range(2)]
    c0, c1 = bb9.pack(cts)
    bits = np.asarray(bb9.build_noise_bits(sk9)(c0, c1))
    for b in range(2):
        want = she.noise_bits(sk9, cts[b])
        assert want > 0  # fresh noise ~ a few bits, entirely in digit 0
        np.testing.assert_allclose(bits[b], want, rtol=2e-5, atol=2e-5)


def test_batched_step_ext_matches_object_path(rng):
    """Extended-modulus (hybrid) KS at batch scale (VERDICT r3 #3):
    build_step_ext == she.ct_mul + key_switch_quad_circ_ext +
    mod_switch component-wise, LSD (object-path hint) and MSD
    (device-generated hint); and the P-division of the KS noise is
    visible at batch scale — the ext step's build_noise_bits is
    strictly below the base-gadget step's on identical inputs."""
    all5 = tuple(nt.ntt_primes(M, 30, 5))
    assert all5[:3] == QS
    special = all5[3:]
    key = jax.random.PRNGKey(210)
    ks, kh, khe, kb, *kes = jax.random.split(key, 4 + 8)
    sk = she.gen_sk(PARAMS, ks)
    bb = BatchedBGV(PARAMS)
    hint_obj = she.ks_quad_circ_hint_ext(sk, gd.RnsGad(), kh, special)
    hint_dev = bb.gen_ks_quad_hint_ext(sk, special, khe)
    B = 2
    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    lsd_io = None
    for encoding, mk, hint in (("lsd", she.encrypt, hint_obj),
                               ("msd", she.encrypt_msd, hint_dev)):
        cts_a, cts_b, msgs = [], [], []
        for b in range(B):
            m1, m2 = she.pt_random(PARAMS, rng), she.pt_random(PARAMS, rng)
            cts_a.append(mk(sk, m1, kes[2 * b]))
            cts_b.append(mk(sk, m2, kes[2 * b + 1]))
            msgs.append((m1, m2))
        c0, c1 = bb.pack(cts_a)
        d0, d1 = bb.pack(cts_b)
        e0, e1 = bb.build_step_ext(hint, encoding=encoding)(c0, c1, d0, d1)
        f2 = bb.step_f(1, 1, encoding=encoding)
        outs = bb2.unpack((e0, e1), f=f2, encoding=encoding)
        for b in range(B):
            ref = she.mod_switch(
                she.key_switch_quad_circ_ext(hint, she.ct_mul(cts_a[b],
                                                              cts_b[b]))
            )
            assert outs[b].f == ref.f and outs[b].encoding == ref.encoding
            for k in range(2):
                np.testing.assert_array_equal(
                    np.asarray(outs[b].cs[k].data),
                    np.asarray(ref.cs[k].to_crt().data),
                )
            m1, m2 = msgs[b]
            np.testing.assert_array_equal(
                she.decrypt(sk2, outs[b]), she.pt_mul(PARAMS, m1, m2)
            )
        if encoding == "lsd":
            lsd_io = (c0, c1, d0, d1, e0, e1)
    # noise: base-gadget step vs ext step on the same LSD inputs
    c0, c1, d0, d1, x0, x1 = lsd_io
    hint_base = she.ks_quad_circ_hint(sk, gd.RnsGad(), kb)
    b0, b1 = bb.build_step(hint_base)(c0, c1, d0, d1)
    bits = bb2.build_noise_bits(sk2)
    bits_base = np.asarray(bits(b0, b1))
    bits_ext = np.asarray(bits(x0, x1))
    assert float(bits_ext.mean()) < float(bits_base.mean()), (
        f"ext KS should be quieter: ext={bits_ext}, base={bits_base}"
    )


def test_batched_mod_switch_standalone(rng):
    """build_mod_switch (the rescale factored out of build_step —
    VERDICT r3 #4) == she.mod_switch component-wise, LSD and MSD, with
    the mod_switch_f bookkeeping."""
    import jax.numpy as jnp

    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(180))
    bb = BatchedBGV(PARAMS)
    B = 3
    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    bb2 = BatchedBGV(params2)
    for encoding, mk in (("lsd", she.encrypt), ("msd", she.encrypt_msd)):
        cts = [mk(sk, she.pt_random(PARAMS, rng),
                  jax.random.PRNGKey(181 + b)) for b in range(B)]
        c0, c1 = bb.pack(cts)
        e0, e1 = bb.build_mod_switch(encoding=encoding)(c0, c1)
        for b in range(B):
            ref = she.mod_switch(cts[b])
            if encoding == "lsd":
                assert bb.mod_switch_f(cts[b].f) == ref.f
            else:
                assert ref.f == cts[b].f
            for got, comp in ((e0, 0), (e1, 1)):
                np.testing.assert_array_equal(
                    np.asarray(got)[..., b],
                    np.asarray(ref.cs[comp].to_crt().data),
                )
        # and the switched batch still decrypts on device
        sk2 = she.SK(params2, sk.s_ints, sk.var)
        f2 = bb.mod_switch_f(1) if encoding == "lsd" else 1
        dec2 = bb2.build_decrypt(sk2, f=f2, encoding=encoding)
        got = np.asarray(dec2(e0, e1))
        for b in range(B):
            np.testing.assert_array_equal(
                got[:, b], she.decrypt(sk2, she.mod_switch(cts[b]))
            )


def test_batched_key_switch_linear(rng):
    """build_key_switch_linear (re-encryption at batch scale — VERDICT
    r3 #4) == she.key_switch_linear component-wise, LSD and MSD, with
    both object-path and device-generated hints."""
    sk = she.gen_sk(PARAMS, jax.random.PRNGKey(185))
    sk_new = she.gen_sk(PARAMS, jax.random.PRNGKey(186))
    bb = BatchedBGV(PARAMS)
    B = 3
    for encoding, mk, hint in (
        ("lsd", she.encrypt,
         she.ks_linear_hint(sk_new, sk, gd.RnsGad(), jax.random.PRNGKey(187))),
        ("msd", she.encrypt_msd,
         bb.gen_ks_linear_hint(sk_new, sk, jax.random.PRNGKey(188))),
    ):
        cts = [mk(sk, she.pt_random(PARAMS, rng),
                  jax.random.PRNGKey(190 + b)) for b in range(B)]
        c0, c1 = bb.pack(cts)
        e0, e1 = bb.build_key_switch_linear(hint)(c0, c1)
        outs = bb.unpack((e0, e1), encoding=encoding)
        for b in range(B):
            ref = she.key_switch_linear(hint, cts[b])
            for comp in range(2):
                np.testing.assert_array_equal(
                    np.asarray(outs[b].cs[comp].data),
                    np.asarray(ref.cs[comp].to_crt().data),
                )
            np.testing.assert_array_equal(
                she.decrypt(sk_new, outs[b]), she.decrypt(sk, cts[b])
            )


def test_batched_key_switch_linear_ext(rng):
    """Extended-modulus linear re-encryption (the KSLinearHint side of
    the q'' construction): build_key_switch_linear_ext ==
    she.key_switch_linear_ext component-wise with object-path AND
    device-generated hints; decrypts under the new key; and its KS
    noise is strictly below the base-gadget linear keyswitch's."""
    all5 = tuple(nt.ntt_primes(M, 30, 5))
    special = all5[3:]
    ks_, ks2, kh, khd, kb, *kes = jax.random.split(
        jax.random.PRNGKey(230), 5 + 3
    )
    sk = she.gen_sk(PARAMS, ks_)
    sk_new = she.gen_sk(PARAMS, ks2)
    bb = BatchedBGV(PARAMS)
    hint_obj = she.ks_linear_hint_ext(sk_new, sk, gd.RnsGad(), kh, special)
    hint_dev = bb.gen_ks_linear_hint_ext(sk_new, sk, special, khd)
    B = 3
    cts = [she.encrypt(sk, she.pt_random(PARAMS, rng), kes[b])
           for b in range(B)]
    c0, c1 = bb.pack(cts)
    for hint in (hint_obj, hint_dev):
        e0, e1 = bb.build_key_switch_linear_ext(hint)(c0, c1)
        outs = bb.unpack((e0, e1))
        for b in range(B):
            ref = she.key_switch_linear_ext(hint, cts[b])
            for comp in range(2):
                np.testing.assert_array_equal(
                    np.asarray(outs[b].cs[comp].data),
                    np.asarray(ref.cs[comp].to_crt().data),
                )
            np.testing.assert_array_equal(
                she.decrypt(sk_new, outs[b]), she.decrypt(sk, cts[b])
            )
    # noise: ext vs base-gadget linear keyswitch on the same inputs
    lh = she.ks_linear_hint(sk_new, sk, gd.RnsGad(), kb)
    b0, b1 = bb.build_key_switch_linear(lh)(c0, c1)
    x0, x1 = bb.build_key_switch_linear_ext(hint_dev)(c0, c1)
    bits = bb.build_noise_bits(sk_new)
    assert float(np.asarray(bits(x0, x1)).mean()) < float(
        np.asarray(bits(b0, b1)).mean()
    )


def test_noise_bits_builds_for_very_long_chain():
    """Regression (ADVICE r3): the group-weight computation once called
    float(W) on the running chain product, overflowing for W > ~2^1024
    (chains over ~34 thirty-bit primes).  Building the closure is enough
    to trigger the old failure."""
    qs40 = tuple(nt.ntt_primes(M, 30, 40))
    params40 = she.SHEParams(m=M, p=257, qs=qs40, var=2.0)
    sk40 = she.gen_sk(params40, jax.random.PRNGKey(140))
    BatchedBGV(params40).build_noise_bits(sk40)  # must not raise


def test_batched_general_m_pipeline(rng):
    """Config-3 shape through the SERVING path (VERDICT r2 #4): at a
    composite m = 72 = 2^3 * 3^2, batched encrypt (L then CRT), fused
    step with a device-generated hint, device decrypt (L^-1 then Garner
    lift), fused tunnel down the 72 -> 36 tower — all component-wise
    bit-exact vs the object path."""
    import jax.numpy as jnp
    from lol_tpu import linear as lin
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context

    m = 72
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=5, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    bb = BatchedBGV(params)
    enc = bb.build_encrypt(sk)
    n = params.ctx.n
    B = 4
    m1 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    m2 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    c0, c1 = enc(jnp.asarray(m1), jax.random.PRNGKey(2))
    np.testing.assert_array_equal(np.asarray(bb.build_decrypt(sk)(c0, c1)), m1)

    hint = bb.gen_ks_quad_hint(sk, jax.random.PRNGKey(1))
    d0, d1 = enc(jnp.asarray(m2), jax.random.PRNGKey(3))
    e0, e1 = bb.build_step(hint)(c0, c1, d0, d1)
    params2 = she.SHEParams(m=m, p=params.p, qs=qs[:-1], var=params.var)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = nt.modinv(qs[-1] % params.p, params.p)
    got = np.asarray(bb2.build_decrypt(sk2, f=f2)(e0, e1))
    for b in range(B):
        np.testing.assert_array_equal(
            got[:, b], she.pt_mul(params, m1[:, b], m2[:, b])
        )
    # component-level bit-exactness vs the object path
    cts_a, cts_b = bb.unpack((c0, c1)), bb.unpack((d0, d1))
    outs = bb2.unpack((e0, e1), f=f2)
    ref = she.mod_switch(
        she.key_switch_quad_circ(hint, she.ct_mul(cts_a[0], cts_b[0]))
    )
    for k in range(2):
        np.testing.assert_array_equal(
            np.asarray(outs[0].cs[k].data),
            np.asarray(ref.cs[k].to_crt().data),
        )
    # device noise extraction at general m (DEC-basis lift path)
    e_res = np.asarray(bb.build_error_term(sk)(c0, c1))
    e_host = she.error_term(sk, cts_a[0])
    want = np.array([int(v) % qs[0] for v in e_host], dtype=np.uint32)
    np.testing.assert_array_equal(e_res[0, :, 0], want)

    # fused general-m tunnel down the tower: R=72 -> S=E=36
    ms = 36
    E = S = ring_context(ms, qs[:-1])
    R = ring_context(m, qs[:-1])
    ps = she.SHEParams(m=ms, p=params.p, qs=qs[:-1], var=params.var)
    sk_s = she.gen_sk(ps, jax.random.PRNGKey(5))
    d = R.n // E.n
    ys = [Cyc.from_ints(S, rng.integers(-2, 3, S.n)) for _ in range(d)]
    fmap = lin.linear_pow(E, R, S, ys)
    # DEVICE-generated hints at composite m (VERDICT r3 #1): the same
    # hint set drives both the fused and the object tunnel below, so the
    # bit-exact comparison also certifies the general-m keygen path
    th = bb2.gen_tunnel_hint(fmap, sk_s, sk2, jax.random.PRNGKey(6))
    t0, t1 = bb2.build_tunnel(th)(e0, e1)
    bb_s = bb2.target_pipeline(th)
    outs_t = bb_s.unpack((t0, t1), f=f2)
    ref_t = she.tunnel(th, outs[0])
    for k in range(2):
        np.testing.assert_array_equal(
            np.asarray(outs_t[0].cs[k].data),
            np.asarray(ref_t.cs[k].to_crt().data),
        )
    np.testing.assert_array_equal(she.decrypt(sk_s, outs_t[0]),
                                  she.decrypt(sk_s, ref_t))


def test_batched_general_m_off_233_lattice(rng):
    """VERDICT r3 #7: a batched ring OFF the 2^a*3^b lattice — m = 90 =
    2*3^2*5 puts a p=5 dense axis through BatchedBGV (encrypt -> fused
    step with a device hint -> decrypt), bit-exact vs the object path.
    crt_cm's odd-axis path is shape-generic; this pins it at p >= 5."""
    import jax.numpy as jnp

    m = 90
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=7, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(200))
    bb = BatchedBGV(params)
    enc = bb.build_encrypt(sk)
    n, B = params.ctx.n, 3
    m1 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    m2 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    c0, c1 = enc(jnp.asarray(m1), jax.random.PRNGKey(201))
    np.testing.assert_array_equal(np.asarray(bb.build_decrypt(sk)(c0, c1)), m1)
    hint = bb.gen_ks_quad_hint(sk, jax.random.PRNGKey(202))
    d0, d1 = enc(jnp.asarray(m2), jax.random.PRNGKey(203))
    e0, e1 = bb.build_step(hint)(c0, c1, d0, d1)
    params2 = she.SHEParams(m=m, p=7, qs=qs[:-1], var=2.0)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = nt.modinv(qs[-1] % 7, 7)
    got = np.asarray(bb2.build_decrypt(sk2, f=f2)(e0, e1))
    for b in range(B):
        np.testing.assert_array_equal(
            got[:, b], she.pt_mul(params, m1[:, b], m2[:, b])
        )
    # component-level bit-exactness vs the object path
    cts_a, cts_b = bb.unpack((c0, c1)), bb.unpack((d0, d1))
    outs = bb2.unpack((e0, e1), f=f2)
    ref = she.mod_switch(
        she.key_switch_quad_circ(hint, she.ct_mul(cts_a[0], cts_b[0]))
    )
    for k in range(2):
        np.testing.assert_array_equal(
            np.asarray(outs[0].cs[k].data),
            np.asarray(ref.cs[k].to_crt().data),
        )


def test_batched_general_m_msd(rng):
    """The encoding x ring-shape matrix closes: MSD through the
    general-m fused pipeline (m = 36), bit-exact vs the object path."""
    import jax.numpy as jnp

    m = 36
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=5, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    bb = BatchedBGV(params)
    hint = bb.gen_ks_quad_hint(sk, jax.random.PRNGKey(1))
    n, B = params.ctx.n, 3
    m1 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    m2 = rng.integers(0, params.p, (n, B)).astype(np.int32)
    enc = bb.build_encrypt(sk, encoding="msd")
    c0, c1 = enc(jnp.asarray(m1), jax.random.PRNGKey(2))
    d0, d1 = enc(jnp.asarray(m2), jax.random.PRNGKey(3))
    # MSD encrypt/decrypt roundtrip at composite m
    np.testing.assert_array_equal(
        np.asarray(bb.build_decrypt(sk, encoding="msd")(c0, c1)), m1
    )
    e0, e1 = bb.build_step(hint, encoding="msd")(c0, c1, d0, d1)
    params2 = she.SHEParams(m=m, p=params.p, qs=qs[:-1], var=params.var)
    bb2 = BatchedBGV(params2)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    f2 = bb.step_f(1, 1, encoding="msd")
    got = np.asarray(bb2.build_decrypt(sk2, f=f2, encoding="msd")(e0, e1))
    outs = bb2.unpack((e0, e1), f=f2, encoding="msd")
    cts_a, cts_b = (bb.unpack((a, b), encoding="msd")
                    for a, b in ((c0, c1), (d0, d1)))
    for b in range(B):
        ref = she.mod_switch(
            she.key_switch_quad_circ(hint, she.ct_mul(cts_a[b], cts_b[b]))
        )
        for k in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[k].data),
                np.asarray(ref.cs[k].to_crt().data),
            )
        want = she.pt_mul(params, m1[:, b], m2[:, b])
        np.testing.assert_array_equal(she.decrypt(sk2, ref), want)
        np.testing.assert_array_equal(got[:, b], want)


def test_batched_galois_general_m(rng):
    """Homomorphic Galois automorphism through the general-m fused path
    (slot perm + fused digit keyswitch at composite m) == object path."""
    m = 36
    qs = tuple(nt.ntt_primes(m, 30, 3))
    params = she.SHEParams(m=m, p=5, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(130))
    k = 5  # unit mod 36
    hint = she.ks_galois_hint(k, sk, gd.RnsGad(), jax.random.PRNGKey(131))
    cts = [she.encrypt(sk, she.pt_random(params, rng),
                       jax.random.PRNGKey(132 + b)) for b in range(2)]
    bb = BatchedBGV(params)
    c0, c1 = bb.pack(cts)
    e0, e1 = bb.build_galois(hint, k)(c0, c1)
    outs = bb.unpack((e0, e1))
    for b in range(2):
        ref = she.ct_galois(hint, k, cts[b])
        for comp in range(2):
            np.testing.assert_array_equal(
                np.asarray(outs[b].cs[comp].data),
                np.asarray(ref.cs[comp].to_crt().data),
            )
        np.testing.assert_array_equal(she.decrypt(sk, outs[b]),
                                      she.decrypt(sk, ref))


def test_device_hint_gen_quad_linear_galois(rng):
    """Device-generated hints (one-call keygen) are functionally
    interchangeable with the object-path hints: keyswitched ciphertexts
    decrypt correctly."""
    key = jax.random.PRNGKey(70)
    ks, ks2, kh, kl, kg, ke1, ke2 = jax.random.split(key, 7)
    sk = she.gen_sk(PARAMS, ks)
    bb = BatchedBGV(PARAMS)

    # quad (relinearization): mul -> ks -> modswitch -> decrypt == product
    hint = bb.gen_ks_quad_hint(sk, kh)
    m1, m2 = she.pt_random(PARAMS, rng), she.pt_random(PARAMS, rng)
    ct1, ct2 = she.encrypt(sk, m1, ke1), she.encrypt(sk, m2, ke2)
    out = she.mod_switch(she.key_switch_quad_circ(hint, she.ct_mul(ct1, ct2)))
    params2 = she.SHEParams(m=M, p=PARAMS.p, qs=QS[:-1], var=PARAMS.var)
    sk2 = she.SK(params2, sk.s_ints, sk.var)
    np.testing.assert_array_equal(she.decrypt(sk2, out),
                                  she.pt_mul(PARAMS, m1, m2))
    # and the batched step accepts the device hint
    c0, c1 = bb.pack([ct1])
    d0, d1 = bb.pack([ct2])
    e0, e1 = bb.build_step(hint)(c0, c1, d0, d1)
    f2 = nt.modinv(QS[-1] % PARAMS.p, PARAMS.p)
    outs = BatchedBGV(params2).unpack((e0, e1), f=f2)
    np.testing.assert_array_equal(she.decrypt(sk2, outs[0]),
                                  she.pt_mul(PARAMS, m1, m2))

    # linear: re-encrypt to a fresh key
    sk_new = she.gen_sk(PARAMS, ks2)
    lhint = bb.gen_ks_linear_hint(sk_new, sk, kl)
    moved = she.key_switch_linear(lhint, ct1)
    np.testing.assert_array_equal(she.decrypt(sk_new, moved),
                                  np.asarray(m1) % PARAMS.p)

    # galois: device hint decrypt == object hint decrypt (both sigma_k(m))
    k = 3
    ghint_dev = bb.gen_galois_hint(k, sk, kg)
    ghint_obj = she.ks_galois_hint(k, sk, gd.RnsGad(), kg)
    got = she.decrypt(sk, she.ct_galois(ghint_dev, k, ct1))
    want = she.decrypt(sk, she.ct_galois(ghint_obj, k, ct1))
    np.testing.assert_array_equal(got, want)


def test_device_tunnel_hint(rng):
    """gen_tunnel_hint drives both she.tunnel and the fused device tunnel
    to the same (correct) decryption as a host-generated hint."""
    from lol_tpu import linear as lin
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context

    me, mr, ms = 16, 64, 32
    qs = tuple(nt.ntt_primes(64, 30, 3))
    E, R, S = (ring_context(m, qs) for m in (me, mr, ms))
    pr = she.SHEParams(m=mr, p=257, qs=qs, var=2.0)
    ps = she.SHEParams(m=ms, p=257, qs=qs, var=2.0)
    kr, ks_, kh, ke = jax.random.split(jax.random.PRNGKey(80), 4)
    sk_r = she.gen_sk(pr, kr)
    sk_s = she.gen_sk(ps, ks_)
    ys = [Cyc.from_ints(S, rng.integers(-2, 3, S.n)) for _ in range(R.n // E.n)]
    f = lin.linear_pow(E, R, S, ys)
    bb = BatchedBGV(pr)
    th_dev = bb.gen_tunnel_hint(f, sk_s, sk_r, kh)
    th_obj = she.tunnel_hint(f, sk_s, sk_r, gd.RnsGad(), kh)
    ct = she.encrypt(sk_r, she.pt_random(pr, rng), ke)
    want = she.decrypt(sk_s, she.tunnel(th_obj, ct))
    np.testing.assert_array_equal(
        she.decrypt(sk_s, she.tunnel(th_dev, ct)), want
    )
    c0, c1 = bb.pack([ct])
    e0, e1 = bb.build_tunnel(th_dev)(c0, c1)
    outs = bb.target_pipeline(th_dev).unpack((e0, e1))
    np.testing.assert_array_equal(she.decrypt(sk_s, outs[0]), want)

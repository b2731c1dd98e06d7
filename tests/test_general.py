"""General-m tensor transform identities — Lol TensorTests analog over a
non-2-power (m, q) grid (SURVEY.md §5.1): crt/crtInv roundtrips, direct-
evaluation oracle, cross-basis mulG agreement, L roundtrips, twace/embed."""

import numpy as np
import pytest
import jax.numpy as jnp

from lol_tpu import numtheory as nt, zq
from lol_tpu.factored import fact
from lol_tpu.ops import general as gen

# 51 = 3*17: phi-16 axis hits the int8-limb auto path; 42 = 2*3*7 (three prime
# factors), 49 = 7^2 (odd prime square), 89 (large prime): SURVEY §5's
# named grid shapes (F42/F89-style indices)
MS = [3, 5, 8, 9, 12, 16, 21, 24, 36, 42, 45, 49, 51, 60, 89]


def q_for(m: int) -> int:
    # one 30-bit prime with q = 1 mod lcm(m, small): just q = 1 mod m
    return nt.ntt_primes(m if m % 2 else m, 30, 1)[0]


def rand_poly(rng, m, q, shape=()):
    n = fact(m).phi
    return jnp.asarray(
        rng.integers(0, q, (*shape, n), dtype=np.uint64).astype(np.uint32)
    )


@pytest.mark.parametrize("m", MS)
def test_crt_roundtrip(m, rng):
    q = q_for(m)
    plan = gen.general_plan(m, q)
    x = rand_poly(rng, m, q, (2,))
    np.testing.assert_array_equal(
        np.asarray(gen.crt_inv(plan, gen.crt(plan, x))), np.asarray(x)
    )


@pytest.mark.parametrize("m", [3, 9, 12, 21, 24])
def test_crt_is_direct_evaluation(m, rng):
    """crt(x)[slot u] == sum_j x_j omega^(u * E(j)) — the defining spec."""
    q = q_for(m)
    plan = gen.general_plan(m, q)
    f = fact(m)
    x = np.asarray(rand_poly(rng, m, q))
    got = np.asarray(gen.crt(plan, jnp.asarray(x)))
    omega = nt.principal_root_of_unity(m, q)
    units = gen._global_units(plan)
    # powerful-basis exponents E(j) per flat index
    exps = []
    shape = f.phi_shape
    for flat in range(f.phi):
        idx = np.unravel_index(flat, shape)
        E = sum(
            int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)
        ) % m
        exps.append(E)
    for si, u in enumerate(units):
        want = sum(
            int(x[j]) * pow(omega, int(u) * exps[j] % m, q) for j in range(f.phi)
        ) % q
        assert int(got[si]) == want, f"m={m} slot {si}"


@pytest.mark.parametrize("m", [9, 12, 21, 45])
def test_pointwise_mul_is_ring_mul(m, rng):
    """CRT(a)*CRT(b) == evaluation of the ring product (ring iso spec)."""
    q = q_for(m)
    plan = gen.general_plan(m, q)
    a = rand_poly(rng, m, q)
    b = rand_poly(rng, m, q)
    ca, cb = gen.crt(plan, a), gen.crt(plan, b)
    prod = gen.crt_inv(plan, zq.mul_mod(ca, cb, q))
    # oracle: back to CRT must equal pointwise product
    np.testing.assert_array_equal(
        np.asarray(gen.crt(plan, prod)), np.asarray(zq.mul_mod(ca, cb, q))
    )


@pytest.mark.parametrize("m", MS)
def test_l_roundtrip(m, rng):
    q = q_for(m)
    plan = gen.general_plan(m, q)
    x = rand_poly(rng, m, q)
    np.testing.assert_array_equal(
        np.asarray(gen.l_inv(plan, gen.l(plan, x))), np.asarray(x)
    )
    np.testing.assert_array_equal(
        np.asarray(gen.l(plan, gen.l_inv(plan, x))), np.asarray(x)
    )


@pytest.mark.parametrize("m", MS)
def test_mul_div_g_roundtrips(m, rng):
    q = q_for(m)
    plan = gen.general_plan(m, q)
    x = rand_poly(rng, m, q)
    for mul, div in [
        (gen.mul_g_pow, gen.div_g_pow),
        (gen.mul_g_dec, gen.div_g_dec),
        (gen.mul_g_crt, gen.div_g_crt),
    ]:
        np.testing.assert_array_equal(
            np.asarray(div(plan, mul(plan, x))), np.asarray(x)
        )


@pytest.mark.parametrize("m", [9, 12, 21, 45])
def test_mul_g_cross_basis_agreement(m, rng):
    q = q_for(m)
    plan = gen.general_plan(m, q)
    x = rand_poly(rng, m, q)
    # crt(mulGPow(x)) == mulGCRT(crt(x))
    np.testing.assert_array_equal(
        np.asarray(gen.crt(plan, gen.mul_g_pow(plan, x))),
        np.asarray(gen.mul_g_crt(plan, gen.crt(plan, x))),
    )
    # mulGDec == lInv . mulGPow . l
    np.testing.assert_array_equal(
        np.asarray(gen.mul_g_dec(plan, x)),
        np.asarray(gen.l_inv(plan, gen.mul_g_pow(plan, gen.l(plan, x)))),
    )


TOWERS = [(4, 8), (3, 9), (3, 21), (7, 21), (12, 24), (12, 36), (1, 3), (5, 45), (9, 45)]


@pytest.mark.parametrize("msub,msup", TOWERS)
def test_twace_embed_identity(msub, msup, rng):
    q = nt.ntt_primes(int(np.lcm(msub if msub > 1 else 1, msup)), 30, 1)[0]
    x = rand_poly(rng, msub, q)
    emb = gen.embed_pow(msub, msup, x)
    np.testing.assert_array_equal(
        np.asarray(gen.twace_pow(msub, msup, emb)), np.asarray(x)
    )
    # CRT versions
    ps, pS = gen.general_plan(msub, q), gen.general_plan(msup, q)
    xc = gen.crt(ps, x)
    embc = gen.embed_crt(msub, msup, q, xc)
    np.testing.assert_array_equal(
        np.asarray(gen.twace_crt(msub, msup, q, embc)), np.asarray(xc)
    )
    # pow-embed and crt-embed agree
    np.testing.assert_array_equal(
        np.asarray(gen.crt(pS, emb)), np.asarray(embc)
    )


@pytest.mark.parametrize("msub,msup", [(3, 9), (7, 21), (12, 24), (12, 36), (5, 45)])
def test_twace_pow_agrees_with_crt_path(msub, msup, rng):
    """twacePow == crtInv . twaceCRT . crt — the tweak conventions line up."""
    q = nt.ntt_primes(msup, 30, 1)[0]
    ps, pS = gen.general_plan(msub, q), gen.general_plan(msup, q)
    x = rand_poly(rng, msup, q)
    via_crt = gen.crt_inv(ps, gen.twace_crt(msub, msup, q, gen.crt(pS, x)))
    direct = gen.twace_pow(msub, msup, x)
    np.testing.assert_array_equal(np.asarray(direct), np.asarray(via_crt))


def test_gram_g_dec_properties():
    from lol_tpu.ops.general import gram_g_dec
    from lol_tpu.factored import fact as _fact

    for m in (3, 9, 12, 36):
        G = gram_g_dec(m)
        n = _fact(m).phi
        assert G.shape == (n, n)
        assert np.array_equal(G, G.T)
        evs = np.linalg.eigvalsh(G.astype(np.float64))
        assert evs.min() > 0  # positive definite


def test_gsq_norm_matches_direct_embedding(rng):
    import math
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context

    m = 12
    q = nt.ntt_primes(12, 30, 1)[0]
    ctx = ring_context(m, (q,))
    from lol_tpu.cyc import Rep

    coeffs = rng.integers(-5, 6, ctx.n)
    c = Cyc.from_ints(ctx, coeffs, rep=Rep.DEC)
    got = int(np.atleast_1d(c.gsq_norm())[0])
    # direct: ||sigma(g x)||^2 in complex embedding
    from lol_tpu.ops.general import _dec_basis_complex
    E = _dec_basis_complex(m)
    units = [u for u in range(m) if math.gcd(u, m) == 1]
    w = np.exp(2j * np.pi / m)
    gvals = 1 - np.array([w ** (u * (m // 3)) for u in units])
    v = (E @ coeffs.astype(float)) * gvals
    want = float(np.sum(np.abs(v) ** 2))
    assert abs(got - want) < 1e-3 * max(1.0, want)


def test_general_m_gaussian_statistics():
    import jax
    from lol_tpu import sampling
    from lol_tpu.ring import ring_context

    m = 36
    q = nt.ntt_primes(36, 30, 1)[0]
    ctx = ring_context(m, (q,))
    ints = np.asarray(
        sampling.gaussian_dec_ints(ctx, jax.random.PRNGKey(0), 16.0, (200,))
    )
    assert ints.shape == (200, 12)
    assert abs(float(ints.mean())) < 1.0
    assert 1.0 < float(ints.std()) < 30.0


def test_dec_mixing_factors_reproduce_dense(rng):
    """The tensor-factored mixing (VERDICT r3 #2) == the dense path it
    replaced: kron of per-axis Cholesky factors equals
    cholesky(inv(E^H E)) of the full dense embedding, and its Gram
    reproduces inv(Gram_dec) (both checked at composite m incl. a p=5
    axis); gram_g_dec's per-axis Kronecker == the dense g-twisted
    E^H E construction."""
    import math
    from functools import reduce
    from lol_tpu.factored import fact as _fact

    for m in (12, 36, 90):
        E = gen._dec_basis_complex(m)
        gram = (E.conj().T @ E).real
        dense = np.linalg.cholesky(np.linalg.inv(gram))
        kron = reduce(np.kron, gen.dec_mixing_factors(m))
        np.testing.assert_allclose(kron, dense, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(
            kron @ kron.T, np.linalg.inv(gram), rtol=1e-8, atol=1e-10
        )
        # gram_g_dec vs dense construction over the full embedding
        units = np.array([u for u in range(m) if math.gcd(u, m) == 1])
        gvals = np.ones(len(units), dtype=complex)
        for pp in _fact(m).pps:
            if pp.p == 2:
                continue
            gvals *= 1 - np.exp(2j * np.pi * ((units * (m // pp.p)) % m) / m)
        Eg = E * gvals[:, None]
        Gd = np.rint((Eg.conj().T @ Eg).real).astype(np.int64)
        np.testing.assert_array_equal(gen.gram_g_dec(m), Gd)


def test_matvec_mxu_bit_exact_vs_vpu():
    """The int8-limb matmul path == broadcast path == bigint oracle, over
    moduli spanning 1..4 limbs and shapes around the dispatch threshold."""
    rng = np.random.default_rng(7)
    for q in (251, 65521, 12289, 1032193, nt.ntt_primes(4096, 30, 1)[0]):
        for a, b in ((2, 2), (16, 16), (7, 130), (130, 7), (96, 96)):
            M = rng.integers(0, q, (a, b), dtype=np.uint64).astype(np.uint32)
            x = rng.integers(0, q, (3, 4, b), dtype=np.uint64).astype(np.uint32)
            vpu = gen.matvec_mod_jnp(jnp.asarray(M), jnp.asarray(x), q, use_int8=False)
            mxu = gen.matvec_mod_int8(jnp.asarray(M), jnp.asarray(x), q)
            ref = M.astype(object) @ x.reshape(-1, b).T.astype(object) % q
            np.testing.assert_array_equal(np.asarray(vpu), np.asarray(mxu))
            np.testing.assert_array_equal(
                np.asarray(mxu).reshape(-1, a).T, ref.astype(np.uint32)
            )


def test_general_crt_agrees_with_mxu_forced_axis():
    """Applying the int8-limb matvec on an odd axis == the auto-dispatched crt
    leg for that axis (path choice never affects results)."""
    rng = np.random.default_rng(8)
    m = 45  # odd axes 9 and 5: phi 6 and 4, both below the auto threshold
    q = q_for(m)
    plan = gen.general_plan(m, q)
    x = rand_poly(rng, m, q, (3,))
    for i, ax in enumerate(plan.axes):
        if ax.phi == 1 or ax.ntt2 is not None:
            continue
        vpu = gen._apply_axis(
            plan, x, i,
            lambda v, a=ax: gen.matvec_mod_jnp(jnp.asarray(a.M), v, q, use_int8=False),
        )
        mxu = gen._apply_axis(
            plan, x, i,
            lambda v, a=ax: gen.matvec_mod_int8(jnp.asarray(a.M), v, q),
        )
        np.testing.assert_array_equal(np.asarray(vpu), np.asarray(mxu))


# ---------------------------------------------------------------------------
# coefficient-major (n, B) forms + numpy mirrors (the serving-path layout)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [72, 27, 36])
def test_crt_cm_matches_row_major_and_numpy(m):
    """crt_cm / l_cm (coefficient-major, the she_batched layout) and the
    np_crt numpy mirror == the row-major device transforms, bit-exact,
    including the inverse roundtrip and the pre_digit_q prologue."""
    rng = np.random.default_rng(9)
    q, q2 = nt.ntt_primes(m, 30, 2)
    plan = gen.general_plan(m, q)
    n = plan.fm.phi
    x = rng.integers(0, q, (n, 8), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(gen.crt(plan, jnp.asarray(x.T))).T
    got = np.asarray(gen.crt_cm(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gen.np_crt(plan, x.T).T, want)
    back = np.asarray(gen.crt_cm(plan, jnp.asarray(got), inverse=True))
    np.testing.assert_array_equal(back, x)
    np.testing.assert_array_equal(gen.np_crt(plan, want.T, inverse=True).T, x)
    wl = np.asarray(gen.l(plan, jnp.asarray(x.T))).T
    gl = np.asarray(gen.l_cm(plan, jnp.asarray(x)))
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(
        np.asarray(gen.l_cm(plan, jnp.asarray(gl), inverse=True)), x
    )
    # fused digit prologue == explicit redigit then transform
    from lol_tpu.ops.ntt import redigit

    xs = rng.integers(0, q2, (n, 8), dtype=np.uint64).astype(np.uint32)
    a = np.asarray(gen.crt_cm(plan, jnp.asarray(xs), pre_digit_q=q2))
    b = np.asarray(gen.crt_cm(plan, redigit(jnp.asarray(xs), q2, q)))
    np.testing.assert_array_equal(a, b)

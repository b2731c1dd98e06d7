"""HomomPRF demo (analog of lol-apps HomomPRFMain): evaluate the
key-homomorphic PRF on an *encrypted* key — public linear phase, ring
tunneling down a cyclotomic tower, and TRUE homomorphic rounding
(PTRound) to Z_2 — then check the decrypted bit against the clear PRF
pipeline."""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

from lol_tpu import gadget as gd, linear as lin, numtheory as nt, prf, she
from lol_tpu.cyc import Cyc, Rep
from lol_tpu.ring import ring_context


def main():
    p = 8  # PRF modulus = SHE plaintext modulus = 2^3 (rounding-ready)
    qs = tuple(nt.ntt_primes(64, 30, 6))
    fam = prf.PRFFamily.random(ring_context(32, (p,)), gd.BaseBGad(2),
                               prf.balanced(3), jax.random.PRNGKey(0))
    pr = she.SHEParams(m=32, p=p, qs=qs, var=2.0)
    ps = she.SHEParams(m=2, p=p, qs=qs, var=2.0)
    k1, k2, kh, ke = jax.random.split(jax.random.PRNGKey(1), 4)
    sk_r, sk_s = she.gen_sk(pr, k1), she.gen_sk(ps, k2)
    hints, sk_out = prf.make_eval_hints(
        fam, [sk_r, sk_s], [32, 2], [2], gd.RnsGad(), kh,
        p_final=2, homomorphic_round=True, maps="project",
    )
    rng = np.random.default_rng(2)
    s_pt = rng.integers(0, p, pr.ctx.n).astype(np.int64)  # the PRF key
    ct_s = she.encrypt(sk_r, s_pt, ke)

    ctx8r, ctx8s = ring_context(32, (p,)), ring_context(2, (p,))
    ys = [Cyc.zero(ctx8s) for _ in range(16)]
    ys[0] = Cyc.scalar(ctx8s, 1)
    proj = lin.linear_pow(ctx8s, ctx8r, ctx8s, ys)

    for bits in [(0, 0, 1), (1, 0, 1), (1, 1, 1)]:
        out_ct = prf.homom_prf_component(fam, hints, ct_s, bits, 0)
        got = int(she.decrypt(sk_out, out_ct)[0])
        # clear pipeline: multiply, project to the scalar coeff, round
        a0 = np.array(
            [int(v) % p for v in fam.a_t(bits)[0].lift_ints(rep=Rep.POW)],
            dtype=np.int64,
        )
        a0c = np.where(a0 >= (p + 1) // 2, a0 - p, a0)
        x = Cyc.from_ints(ctx8r, s_pt, rep=Rep.DEC) * Cyc.from_ints(ctx8r, a0c)
        v = int(lin.eval_lin(proj, x).lift_ints(rep=Rep.DEC)[0]) % p
        want = ((v + 2) >> 2) & 1
        status = "OK" if got == want else "MISMATCH"
        print(f"x={bits}: homomorphic bit={got}  clear bit={want}  [{status}]")


if __name__ == "__main__":
    main()

"""Ring-tunneling demo: homomorphically move a ciphertext between rings."""

import sys
sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import numpy as np

from lol_tpu import gadget as gd, linear as lin, numtheory as nt, she
from lol_tpu.cyc import Cyc
from lol_tpu.ring import ring_context


def main():
    me, mr, ms = 16, 32, 64
    qs = tuple(nt.ntt_primes(64, 30, 3))
    E, R, S = (ring_context(m, qs) for m in (me, mr, ms))
    pr = she.SHEParams(m=mr, p=257, qs=qs, var=2.0)
    ps = she.SHEParams(m=ms, p=257, qs=qs, var=2.0)
    key = jax.random.PRNGKey(0)
    kr, ks_, kh, ke = jax.random.split(key, 4)
    sk_r, sk_s = she.gen_sk(pr, kr), she.gen_sk(ps, ks_)

    rng = np.random.default_rng(0)
    ys = [Cyc.from_ints(S, rng.integers(-2, 3, S.n)) for _ in range(R.n // E.n)]
    f = lin.linear_pow(E, R, S, ys)
    th = she.tunnel_hint(f, sk_s, sk_r, gd.RnsGad(), kh)

    m = she.pt_random(pr, rng)
    ct = she.encrypt(sk_r, m, ke)
    out = she.tunnel(th, ct)
    print(f"tunneled ciphertext: ring m={mr} -> m={ms}")
    print("decrypts under target key:", she.decrypt(sk_s, out)[:8], "...")


if __name__ == "__main__":
    main()

"""L1 — Z_q arithmetic over uint32 arrays (the device scalar layer).

Role of the reference's `ZqBasic q Int64` (`lol/Crypto/Lol/Types/Unsafe/
ZqBasic.hs`) plus the C++ scalar kernels (`lol-cpp .../zq.cpp` — SURVEY.md
§3.2/§3.3).  Where the reference does 64-bit modmul with 128-bit
intermediates on the CPU, every device path here stays in 32-bit lanes,
so the design is:

- moduli are primes q with 2 <= q < 2**30 held as *static* Python ints
  (folded into compiled kernels; one kernel specialization per modulus —
  the analog of the reference's per-type-level-q instantiation);
- values live in uint32 arrays, always fully reduced to [0, q);
- 64-bit products are synthesized from the native 32x32->lo32 multiply
  plus a 16-bit-limb mulhi (4 multiplies, Hacker's-Delight style);
- variable*variable modmul uses Barrett reduction (generalized to any
  bit-length k <= 30), constant*variable uses Shoup's trick (precomputed
  companion word, 2 fewer multiplies) — twiddles and public constants
  always carry their Shoup companions.

Every function here is pure jnp on uint32 and is equally valid inside a
Pallas kernel body — the Pallas NTT kernels import these directly, so the
XLA path and the Pallas path share one arithmetic implementation (bit-exact
by construction).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from . import numtheory as nt

U32 = jnp.uint32
MAX_MODULUS_BITS = 30  # q < 2^30: a+b and 3q fit in u32; Barrett mu fits u32

# ---------------------------------------------------------------------------
# uint32 wide-multiply primitives
# ---------------------------------------------------------------------------


def mulhi32(a, b):
    """High 32 bits of the 64-bit product of two uint32 arrays.

    The high word is assembled from four 16x16 partial products (each
    fits u32, carries handled exactly) using only the lo32 multiply that
    every backend has.
    """
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    w0 = a0 * b0
    t = a1 * b0 + (w0 >> 16)  # <= (2^16-1)^2 + (2^16-1) < 2^32
    w1 = (t & 0xFFFF) + a0 * b1  # < 2^32
    return a1 * b1 + (t >> 16) + (w1 >> 16)


def mul32_wide(a, b):
    """(hi, lo) of the 64-bit product; lo is the native wrapping multiply."""
    return mulhi32(a, b), a * b


# ---------------------------------------------------------------------------
# modular primitives (q static per call; shapes broadcast)
# ---------------------------------------------------------------------------


def add_mod(a, b, q):
    s = a + b
    return jnp.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    # a, b in [0, q): wrapping a-b then correct by +q on borrow.
    return jnp.where(a >= b, a - b, a + (jnp.uint32(q) - b))


def neg_mod(a, q):
    return jnp.where(a == 0, a, jnp.uint32(q) - a)


def barrett_mu(q: int) -> int:
    """mu = floor(2^(2k) / q) for k = bitlength(q); fits u32 for k <= 30."""
    k = q.bit_length()
    if not (2 <= q < (1 << MAX_MODULUS_BITS)):
        raise ValueError(f"modulus {q} out of range [2, 2^{MAX_MODULUS_BITS})")
    return (1 << (2 * k)) // q


def mul_mod(a, b, q: int, mu: int | None = None):
    """Barrett modmul: (a*b) mod q for a, b in [0, q), q < 2^30 static.

    Quotient estimate Q in [floor(p/q)-2, floor(p/q)], so r = p - Q*q < 3q
    fits u32 exactly; two conditional subtracts finish the reduction.
    """
    k = q.bit_length()
    if mu is None:
        mu = barrett_mu(q)
    mu = jnp.uint32(mu)
    qq = jnp.uint32(q)
    hi, lo = mul32_wide(a, b)
    # t = floor(p / 2^(k-1)) < 2^(k+1): top bits of the 64-bit product.
    t = (hi << (33 - k)) | (lo >> (k - 1)) if k > 1 else lo
    qhi, qlo = mul32_wide(t, mu)
    quot = (qhi << (31 - k)) | (qlo >> (k + 1))
    r = lo - quot * qq  # wrapping; true value < 3q < 2^32 so exact
    r = jnp.where(r >= qq, r - qq, r)
    r = jnp.where(r >= qq, r - qq, r)
    return r


def reduce_mod(x, q, k: int | None = None, mu=None):
    """x mod q for u32 x with x < 2^(2k), k = bitlength(q) (Barrett).

    Used to re-reduce a residue from one RNS channel into another's
    modulus; valid whenever x < q'^2-ish, in particular for any x < 2^30
    against moduli q >= 2^15.  q may be a traced u32 scalar if its bit
    length k (static) and barrett_mu(q) are passed."""
    if k is None:
        k, mu = q.bit_length(), barrett_mu(q)
    if 2 * k < 30:
        # tiny modulus: fall back to exact integer remainder (rare path)
        return jnp.mod(x, jnp.uint32(q)).astype(jnp.uint32)
    mu = jnp.uint32(mu)
    qq = jnp.uint32(q)
    t = x >> (k - 1)
    qhi, qlo = mul32_wide(t, mu)
    quot = (qhi << (31 - k)) | (qlo >> (k + 1))
    r = x - quot * qq
    r = jnp.where(r >= qq, r - qq, r)
    r = jnp.where(r >= qq, r - qq, r)
    return r


def shoup(w: int, q: int) -> int:
    """Shoup companion word for constant w in [0, q): floor(w * 2^32 / q)."""
    return (int(w) << 32) // q


def shoup_np(w: np.ndarray, q: int) -> np.ndarray:
    """Vectorized Shoup companions for a u32 constant array, entries < q.

    (w << 32) < 2^62 fits int64; the quotient fits u32 since w < q."""
    w64 = w.astype(np.int64)
    if w64.size and int(w64.max()) >= q:
        raise ValueError("shoup_np: entries must be < q")
    return ((w64 << 32) // q).astype(np.uint32)


def mul_mod_shoup(a, w, w_sh, q):
    """(a*w) mod q with precomputed w_sh = floor(w*2^32/q); 5 multiplies.

    Result exact in [0, q) for a in [0, 2^32), w in [0, q).
    """
    qq = jnp.uint32(q)
    hi = mulhi32(a, w_sh)
    r = a * w - hi * qq  # wrapping u32; true value in [0, 2q)
    return jnp.where(r >= qq, r - qq, r)


def mul_shoup_lazy(a, w, w_sh_hi, w_sh_lo, q):
    """Harvey-style lazy Shoup multiply: (a*w) mod-ish q in [0, 2q).

    Same quotient estimate as `mul_mod_shoup` but (1) the final
    conditional subtraction is skipped — callers keep values in a
    [0, 2q)/[0, 4q) redundant form and fully reduce once at the end —
    and (2) the Shoup companion arrives pre-split into 16-bit halves
    (w_sh_hi = w_sh >> 16, w_sh_lo = w_sh & 0xFFFF), which for
    lane-replicated twiddle tables moves 2 ops per butterfly out to
    2 ops per table slice.

    Exact guarantee (Harvey 2014, arXiv:1205.2926 lemma 2 shape): for
    ANY a in [0, 2^32) and w in [0, q), the result is == a*w (mod q)
    and lies in [0, 2q), since floor(a*w_sh/2^32) is floor(a*w/q) or
    floor(a*w/q)-1."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    w0 = a0 * w_sh_lo
    t = a1 * w_sh_lo + (w0 >> 16)
    w1 = (t & 0xFFFF) + a0 * w_sh_hi
    hi = a1 * w_sh_hi + (t >> 16) + (w1 >> 16)
    return a * w - hi * jnp.uint32(q)  # wrapping; true value in [0, 2q)


# ---------------------------------------------------------------------------
# exact numpy mirror (reference backend / plan building)
# ---------------------------------------------------------------------------


def np_mul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """Exact int64 modmul for the CPU oracle (products < 2^60 for q < 2^30)."""
    return (a.astype(np.int64) * b.astype(np.int64) % q).astype(np.uint32)


def np_matvec_mod(A: np.ndarray, x: np.ndarray, q: int) -> np.ndarray:
    """Exact (A @ x) mod q via 15-bit split of A (no int64 overflow).

    A entries and x in [0, q) with q < 2^30; row length up to 2^18.
    """
    A = A.astype(np.int64)
    x = x.astype(np.int64)
    Ah, Al = A >> 15, A & 0x7FFF  # both < 2^15
    # each partial product < 2^45; sums of <=2^18 terms stay < 2^63
    return (((Ah @ x % q) << 15) + Al @ x) % q


# ---------------------------------------------------------------------------
# modulus descriptor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Modulus:
    """A single RNS modulus: static prime q plus derived constants.

    Analog of a type-level `q` with its reflected value and CRT data
    (Lol `Reflects q Int64` + the `CRTrans` instance data).
    """

    q: int

    def __post_init__(self):
        if not (2 <= self.q < (1 << MAX_MODULUS_BITS)):
            raise ValueError(f"Modulus {self.q} out of [2, 2^{MAX_MODULUS_BITS})")

    @property
    def mu(self) -> int:
        return barrett_mu(self.q)

    @property
    def is_prime(self) -> bool:
        return nt.is_prime(self.q)

    def inv(self, a: int) -> int:
        return nt.modinv(a, self.q)

    def has_crt(self, m: int) -> bool:
        """True iff Z_q admits a principal m-th root (m | q-1, q prime)."""
        return self.is_prime and (self.q - 1) % m == 0

    def root_of_unity(self, m: int) -> int:
        return nt.principal_root_of_unity(m, self.q)

    def __repr__(self):
        return f"Modulus({self.q})"


@lru_cache(maxsize=1024)
def modulus(q: int) -> Modulus:
    return Modulus(q)

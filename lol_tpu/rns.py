"""RNS (residue number system) modulus chains.

The reference represents a composite modulus q = q1*q2*... as a *tuple* of
`ZqBasic` components with pair instances for Ring/Reduce/Lift/Rescale
(SURVEY.md §3.2, "RNS via tuples"); dropping a tuple component is its exact
modulus switch.  This design makes the residue axis an explicit leading
array axis: a mod-q ring element is a u32 array of shape (..., nrns, n),
one residue channel per 30-bit prime, and every channel's kernels are
specialized to that prime (the analog of the per-type-level-q instances).

Host-side exact arithmetic (Python ints) lives here too: CRT
reconstruction, centered lift, and the Garner mixed-radix data used by
jnp-side lifts.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax.numpy as jnp
import numpy as np

from . import numtheory as nt
from . import zq
from .zq import Modulus


@dataclass(frozen=True)
class RnsBasis:
    """An ordered chain of distinct co-prime moduli (q_0, ..., q_{L-1}).

    Mirrors the reference's nested-tuple modulus; `drop_last()` is the
    exact rescale/mod-switch step (Lol `Rescale (a,b) b`)."""

    moduli: tuple[Modulus, ...]

    def __post_init__(self):
        qs = [m.q for m in self.moduli]
        if len(set(qs)) != len(qs):
            raise ValueError(f"RnsBasis: duplicate moduli {qs}")
        for i, a in enumerate(qs):
            for b in qs[i + 1 :]:
                import math

                if math.gcd(a, b) != 1:
                    raise ValueError(f"RnsBasis: moduli {a}, {b} not coprime")

    @property
    def qs(self) -> tuple[int, ...]:
        return tuple(m.q for m in self.moduli)

    @property
    def nrns(self) -> int:
        return len(self.moduli)

    @property
    def modulus(self) -> int:
        """The full composite modulus Q = prod q_i (Python int)."""
        Q = 1
        for m in self.moduli:
            Q *= m.q
        return Q

    def drop_last(self) -> "RnsBasis":
        if self.nrns < 2:
            raise ValueError("RnsBasis.drop_last: need >= 2 moduli")
        return RnsBasis(self.moduli[:-1])

    # --- host-side exact conversions ---------------------------------
    def to_rns(self, x) -> np.ndarray:
        """Integer array (any shape, Python ints / object / int64)
        -> uint32 residues with a leading rns axis: (nrns, *x.shape)."""
        xa = np.asarray(x, dtype=object)
        out = np.empty((self.nrns,) + xa.shape, dtype=np.uint32)
        flat = xa.reshape(-1)
        for i, m in enumerate(self.moduli):
            out[i] = np.array(
                [int(v) % m.q for v in flat], dtype=np.uint32
            ).reshape(xa.shape)
        return out

    def to_mixed_radix(self, r: np.ndarray) -> np.ndarray:
        """(nrns, ...) residues -> Garner mixed-radix digits v (uint64),
        with x = v_0 + q_0 v_1 + q_0 q_1 v_2 + ..., v_i in [0, q_i).

        Vectorized over the coefficient axes: the inner Garner recurrence
        v_i = (r_i - v_0 - q_0 v_1 - ...) * (q_0...q_{i-1})^{-1} mod q_i
        runs as O(L^2) whole-array uint64 ops (q < 2^30, so products of a
        residue and a digit fit u64).  This replaced a per-coefficient
        Python CRT loop (VERDICT r1 #4)."""
        r = np.asarray(r, dtype=np.uint64)
        assert r.shape[0] == self.nrns, (r.shape, self.nrns)
        qs = self.qs
        digits = np.empty_like(r)
        digits[0] = r[0]
        for i in range(1, self.nrns):
            qi = np.uint64(qs[i])
            t = r[i]
            for j in range(i):
                # t = (t - v_j) * q_j^{-1} mod q_i
                vj = digits[j] % qi
                t = (t + qi - vj) % qi
                t = (t * np.uint64(nt.modinv(qs[j] % qs[i], qs[i]))) % qi
            digits[i] = t
        return digits

    def from_rns(self, r: np.ndarray) -> np.ndarray:
        """(nrns, ...) residues -> object array of ints in [0, Q)."""
        digits = self.to_mixed_radix(r)
        qs = self.qs
        acc = digits[-1].astype(object)
        for j in range(self.nrns - 2, -1, -1):
            acc = acc * qs[j] + digits[j].astype(object)
        return acc

    def lift_centered(self, r: np.ndarray) -> np.ndarray:
        """(nrns, ...) residues -> object ints in [-Q/2, Q/2) (Lol Lift')."""
        Q = self.modulus
        x = self.from_rns(r)
        return np.where(x >= (Q + 1) // 2, x - Q, x)

    # --- jnp-side ops -------------------------------------------------
    def add(self, a, b):
        """Residue-wise modular add; rns axis is -2, coeff axis -1."""
        return _chanwise(zq.add_mod, self, a, b)

    def sub(self, a, b):
        return _chanwise(zq.sub_mod, self, a, b)

    def neg(self, a):
        return _chan1(zq.neg_mod, self, a)

    def mul(self, a, b):
        return _chanwise(zq.mul_mod, self, a, b)

    def to_mixed_radix_jnp(self, a) -> jnp.ndarray:
        """Device Garner digits of (..., nrns, n) residues: same recurrence
        as `to_mixed_radix`, staged as O(L^2) u32 channel ops under jit."""
        qs = self.qs
        digits = [a[..., 0, :]]
        for i in range(1, self.nrns):
            qi = qs[i]
            t = a[..., i, :]
            for j in range(i):
                vj = zq.reduce_mod(digits[j], qi) if qs[j] > qi else digits[j]
                t = zq.sub_mod(t, vj, qi)
                t = zq.mul_mod(t, jnp.uint32(nt.modinv(qs[j] % qi, qi)), qi)
            digits.append(t)
        return jnp.stack(digits, axis=-2)

    def pos_mod_jnp(self, a, p: int) -> jnp.ndarray:
        """[x]_p for the canonical representative x in [0, Q) of
        (..., nrns, n) residues, fully on device: Horner over the Garner
        mixed-radix digits (no centering — the building block of
        lift_mod_jnp and of the MSD scaled-rounding decrypt)."""
        v = self.to_mixed_radix_jnp(a)
        return self._horner_mod(v, p)

    def _horner_mod(self, v, p: int) -> jnp.ndarray:
        qs = self.qs
        L = self.nrns
        acc = zq.reduce_mod(v[..., L - 1, :], p)
        for j in range(L - 2, -1, -1):
            acc = zq.mul_mod(acc, jnp.uint32(qs[j] % p), p)
            acc = zq.add_mod(acc, zq.reduce_mod(v[..., j, :], p), p)
        return acc

    def lift_mod_jnp(self, a, p: int) -> jnp.ndarray:
        """Centered lift reduced mod p, fully on device (VERDICT r1 #4):
        (..., nrns, n) residues -> (..., n) uint32 values of
        [lift_centered(a)]_p in [0, p).

        Horner over the Garner digits gives x mod p; the centering
        comparison x >= (Q+1)/2 is a lexicographic digit compare against
        the mixed-radix digits of (Q+1)/2 (most-significant first)."""
        v = self.to_mixed_radix_jnp(a)
        qs = self.qs
        L = self.nrns
        acc = self._horner_mod(v, p)
        # mixed-radix digits of the centering threshold T = (Q+1)//2
        T = (self.modulus + 1) // 2
        tdig = []
        for q in qs:
            tdig.append(T % q)
            T //= q
        ge = jnp.zeros(acc.shape, dtype=bool)
        eq = jnp.ones(acc.shape, dtype=bool)
        for i in range(L - 1, -1, -1):
            ti = jnp.uint32(tdig[i])
            vi = v[..., i, :]
            ge = ge | (eq & (vi > ti))
            eq = eq & (vi == ti)
        ge = ge | eq  # x == T counts as high (lift in [-Q/2, Q/2))
        qmodp = jnp.uint32(self.modulus % p)
        return jnp.where(ge, zq.sub_mod(acc, qmodp, p), acc)

    def rescale_drop_last(self, a, dec_basis: bool = False):
        """Exact RNS modulus switch Q -> Q/q_last on (..., nrns, n) arrays.

        b_i = (a_i - [a]_last) * q_last^{-1} mod q_i for i < last, where
        [a]_last is the *centered* residue of a mod q_last (in
        [-q_last/2, q_last/2), matching Lol's tuple Rescale via centered
        Lift'): the result is the exact integer (a - [a]_last)/q_last
        mod Q/q_last, i.e. round-to-nearest of a/q_last.
        """
        qs = self.qs
        ql = qs[-1]
        last = a[..., -1, :]
        is_high = last >= jnp.uint32((ql + 1) // 2)
        outs = []
        for i, qi in enumerate(qs[:-1]):
            inv = nt.modinv(ql % qi, qi)
            # centered residue of a mod q_last, reduced into Z_qi
            li = zq.reduce_mod(last, qi)
            li = jnp.where(is_high, zq.sub_mod(li, jnp.uint32(ql % qi), qi), li)
            d = zq.sub_mod(a[..., i, :], li, qi)
            outs.append(zq.mul_mod(d, jnp.uint32(inv), qi))
        return jnp.stack(outs, axis=-2)


def _chanwise(op, basis: RnsBasis, a, b):
    outs = [op(a[..., i, :], b[..., i, :], m.q) for i, m in enumerate(basis.moduli)]
    return jnp.stack(outs, axis=-2)


def _chan1(op, basis: RnsBasis, a):
    outs = [op(a[..., i, :], m.q) for i, m in enumerate(basis.moduli)]
    return jnp.stack(outs, axis=-2)


@lru_cache(maxsize=256)
def rns_basis(qs: tuple[int, ...]) -> RnsBasis:
    return RnsBasis(tuple(zq.modulus(q) for q in qs))

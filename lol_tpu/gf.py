"""GF(p^d) — finite extension fields for plaintext slot arithmetic.

Analog of `lol/Crypto/Lol/Types/FiniteField.hs` (SURVEY.md §3.2):
GF(p^d) as Z_p[x] / (irreducible poly), with Ring/Field ops, trace, and
Frobenius — used for CRT-slot plaintext arithmetic and PRF outputs.

Host-side exact implementation (int coefficient vectors); slots are tiny
(d <= 64), so field ops never sit on the device hot path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from . import numtheory as nt


@lru_cache(maxsize=256)
def irreducible_poly(p: int, d: int) -> tuple[int, ...]:
    """A monic irreducible polynomial of degree d over Z_p (deterministic:
    first in lexicographic coefficient order).  Lol: class IrreduciblePoly."""
    if not nt.is_prime(p):
        raise ValueError(f"GF: p={p} not prime")
    if d == 1:
        return (0, 1)  # x
    # enumerate monic polys x^d + c_{d-1} x^{d-1} + ... + c_0
    for enc in range(p**d):
        cs = []
        e = enc
        for _ in range(d):
            cs.append(e % p)
            e //= p
        poly = tuple(cs) + (1,)
        if _is_irreducible(poly, p):
            return poly
    raise RuntimeError("no irreducible polynomial found (impossible)")


def _poly_mulmod(a, b, mod, p):
    d = len(mod) - 1
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % p
    # reduce by monic mod
    for i in range(len(out) - 1, d - 1, -1):
        c = out[i]
        if c:
            for j in range(d + 1):
                out[i - d + j] = (out[i - d + j] - c * mod[j]) % p
    return tuple(out[:d]) if len(out) >= d else tuple(out) + (0,) * (d - len(out))


def _poly_powmod(a, e, mod, p):
    d = len(mod) - 1
    r = (1,) + (0,) * (d - 1)
    base = a
    while e:
        if e & 1:
            r = _poly_mulmod(r, base, mod, p)
        base = _poly_mulmod(base, base, mod, p)
        e >>= 1
    return r


def _is_irreducible(poly, p):
    """Rabin's test (d >= 2): x^(p^d) == x mod poly, and x^(p^(d/r)) != x
    for every prime r | d."""
    d = len(poly) - 1
    x = (0, 1) + (0,) * (d - 2)
    if _poly_powmod(x, p**d, poly, p) != x:
        return False
    for r, _ in nt.factorize(d):
        if _poly_powmod(x, p ** (d // r), poly, p) == x:
            return False
    return True


@dataclass(frozen=True)
class GF:
    """An element of GF(p^d): coefficient tuple over Z_p, degree < d."""

    p: int
    d: int
    cs: tuple[int, ...]

    @staticmethod
    def of(p: int, d: int, cs) -> "GF":
        cs = tuple(int(c) % p for c in cs)
        cs = cs + (0,) * (d - len(cs))
        return GF(p, d, cs[:d])

    @staticmethod
    def zero(p: int, d: int) -> "GF":
        return GF.of(p, d, ())

    @staticmethod
    def one(p: int, d: int) -> "GF":
        return GF.of(p, d, (1,))

    def _mod(self):
        return irreducible_poly(self.p, self.d)

    def __add__(self, o: "GF") -> "GF":
        return GF.of(self.p, self.d, [(a + b) % self.p for a, b in zip(self.cs, o.cs)])

    def __sub__(self, o: "GF") -> "GF":
        return GF.of(self.p, self.d, [(a - b) % self.p for a, b in zip(self.cs, o.cs)])

    def __neg__(self) -> "GF":
        return GF.of(self.p, self.d, [(-a) % self.p for a in self.cs])

    def __mul__(self, o: "GF") -> "GF":
        return GF.of(self.p, self.d, _poly_mulmod(self.cs, o.cs, self._mod(), self.p))

    def pow(self, e: int) -> "GF":
        return GF.of(self.p, self.d, _poly_powmod(self.cs, e, self._mod(), self.p))

    def inv(self) -> "GF":
        if all(c == 0 for c in self.cs):
            raise ZeroDivisionError("GF.inv of zero")
        return self.pow(self.p**self.d - 2)

    def frobenius(self) -> "GF":
        """x -> x^p, the field automorphism."""
        return self.pow(self.p)

    def trace(self) -> int:
        """Trace to Z_p: sum of Frobenius conjugates' constant part."""
        acc = GF.zero(self.p, self.d)
        cur = self
        for _ in range(self.d):
            acc = acc + cur
            cur = cur.frobenius()
        # the trace lands in the prime field: constant coefficient
        assert all(c == 0 for c in acc.cs[1:]), "trace not in base field"
        return acc.cs[0]

    def __repr__(self):
        return f"GF({self.p}^{self.d}; {list(self.cs)})"

"""L0 — runtime analog of Lol's type-level `Factored` machinery.

The reference (`lol/Crypto/Lol/Factored.hs`, SURVEY.md §3.1) encodes the
cyclotomic index m at the *type* level (kinds Factored/PrimePower/Prime,
type families FMul/FDiv/FDivides/Coprime, reflection helpers valueFact,
totientFact, valueHatFact, radicalFact, ppsFact).  The idiomatic JAX design
collapses all of that into one frozen, hashable descriptor object validated
at construction time and used as a static key for jit/kernel caches — you
still can never combine elements of different m, but the check is a cheap
runtime equality instead of a compile error.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

from . import numtheory as nt


@dataclass(frozen=True, order=True)
class PrimePower:
    """One p^e factor. Analog of Lol's `PrimePower` kind."""

    p: int
    e: int

    def __post_init__(self):
        if not nt.is_prime(self.p):
            raise ValueError(f"PrimePower: p={self.p} is not prime")
        if self.e < 1:
            raise ValueError(f"PrimePower: e={self.e} must be >= 1")

    @property
    def value(self) -> int:
        return self.p ** self.e

    @property
    def phi(self) -> int:
        """totient of p^e."""
        return (self.p - 1) * self.p ** (self.e - 1)


@dataclass(frozen=True)
class Factored:
    """The m-th cyclotomic index in factored form.

    Reflection API mirrors Lol's: `value` (valueFact), `phi` (totientFact),
    `mhat` (valueHatFact: m/2 if even else m), `radical` (radicalFact),
    `pps` (ppsFact).
    """

    m: int
    pps: tuple[PrimePower, ...] = field(init=False)

    def __post_init__(self):
        if self.m < 1:
            raise ValueError(f"Factored: m={self.m} must be >= 1")
        object.__setattr__(
            self, "pps", tuple(PrimePower(p, e) for p, e in nt.factorize(self.m))
        )

    # --- reflection (Lol: valueFact / totientFact / valueHatFact / ...) ---
    @property
    def value(self) -> int:
        return self.m

    @property
    def phi(self) -> int:
        n = 1
        for pp in self.pps:
            n *= pp.phi
        return n

    @property
    def mhat(self) -> int:
        """m-hat: m/2 for even m else m (the 'tweak' scalar m̂)."""
        return self.m // 2 if self.m % 2 == 0 else self.m

    @property
    def radical(self) -> int:
        r = 1
        for pp in self.pps:
            r *= pp.p
        return r

    @property
    def odd_radical(self) -> int:
        """Product of the odd primes dividing m (the primes appearing in g)."""
        r = 1
        for pp in self.pps:
            if pp.p != 2:
                r *= pp.p
        return r

    # --- divisibility relations (Lol type families FDivides / Coprime) ---
    def divides(self, other: "Factored") -> bool:
        return other.m % self.m == 0

    def coprime(self, other: "Factored") -> bool:
        import math

        return math.gcd(self.m, other.m) == 1

    def gcd(self, other: "Factored") -> "Factored":
        import math

        return Factored(math.gcd(self.m, other.m))

    def lcm(self, other: "Factored") -> "Factored":
        import math

        return Factored(math.lcm(self.m, other.m))

    # --- tensor-shape helpers -------------------------------------------
    @property
    def phi_shape(self) -> tuple[int, ...]:
        """Logical coefficient-tensor shape: one axis per prime power.

        A ring element of R_m is stored as a flat length-phi(m) vector whose
        row-major reshape to `phi_shape` exposes the tensor factorization
        R_m = (x)_i R_{p_i^{e_i}}  (primes ascending).
        """
        return tuple(pp.phi for pp in self.pps) if self.pps else (1,)

    def is_pow2(self) -> bool:
        return self.m == 1 or (len(self.pps) == 1 and self.pps[0].p == 2)

    def __hash__(self):
        return hash(("Factored", self.m))

    def __repr__(self):
        pps = "·".join(
            f"{pp.p}^{pp.e}" if pp.e > 1 else f"{pp.p}" for pp in self.pps
        )
        return f"Factored({self.m}={pps or '1'})"


@lru_cache(maxsize=1024)
def fact(m: int) -> Factored:
    """Interned Factored constructor (Lol's `Fact m` constraint satisfaction)."""
    return Factored(m)

"""L4 — `Cyc`: representation-hiding cyclotomic ring elements.

Analog of `lol/Crypto/Lol/Cyclotomic/Cyc.hs` + `UCyc.hs`/`CycRep.hs`
(SURVEY.md §3.5): a ring element tagged with its current representation
(POW / DEC / CRT), with smart arithmetic that converts only when needed:
`*` forces CRT on both sides; `+` unifies representations; explicit
`to_pow/to_dec/to_crt` are the `advise*` hints.  The reference's lazy
`Scalar`/`Sub` constructors are materialized eagerly here (scalar embed
is O(n) and subring embeds are cheap stride scatters on device; laziness
bought little and cost jit-unfriendly branching).

Data: uint32 (..., nrns, n) arrays (leading axes = batch, vmap-able).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum

import jax.numpy as jnp
import numpy as np

from . import ring as rg
from .ring import RingContext


class Rep(Enum):
    POW = "pow"
    DEC = "dec"
    CRT = "crt"


@dataclass(frozen=True)
class Cyc:
    ctx: RingContext
    rep: Rep
    data: jnp.ndarray  # (..., nrns, n) uint32

    # --- constructors --------------------------------------------------
    @staticmethod
    def from_pow(ctx, data) -> "Cyc":
        return Cyc(ctx, Rep.POW, jnp.asarray(data, dtype=jnp.uint32))

    @staticmethod
    def from_dec(ctx, data) -> "Cyc":
        return Cyc(ctx, Rep.DEC, jnp.asarray(data, dtype=jnp.uint32))

    @staticmethod
    def from_crt(ctx, data) -> "Cyc":
        return Cyc(ctx, Rep.CRT, jnp.asarray(data, dtype=jnp.uint32))

    @staticmethod
    def scalar(ctx, c: int) -> "Cyc":
        """Lol's Scalar constructor (materialized)."""
        return Cyc(ctx, Rep.POW, rg.scalar_pow(ctx, c))

    @staticmethod
    def zero(ctx, batch=()) -> "Cyc":
        return Cyc(ctx, Rep.POW, rg.zero(ctx, batch))

    @staticmethod
    def from_ints(ctx, coeffs, rep: Rep = Rep.POW) -> "Cyc":
        """Integer coefficient vector(s) (any int dtype / object) -> Cyc."""
        arr = ctx.basis.to_rns(np.asarray(coeffs, dtype=object))
        return Cyc(ctx, rep, jnp.asarray(np.moveaxis(arr, 0, -2)))

    # --- representation conversions (Lol toPow/toDec/toCRT) ------------
    def to_pow(self) -> "Cyc":
        if self.rep is Rep.POW:
            return self
        if self.rep is Rep.DEC:
            return Cyc(self.ctx, Rep.POW, rg.l(self.ctx, self.data))
        return Cyc(self.ctx, Rep.POW, rg.crt_inv(self.ctx, self.data))

    def to_dec(self) -> "Cyc":
        if self.rep is Rep.DEC:
            return self
        return Cyc(self.ctx, Rep.DEC, rg.l_inv(self.ctx, self.to_pow().data))

    def to_crt(self) -> "Cyc":
        if self.rep is Rep.CRT:
            return self
        return Cyc(self.ctx, Rep.CRT, rg.crt(self.ctx, self.to_pow().data))

    # --- ring ops -------------------------------------------------------
    def _unify(self, other: "Cyc") -> tuple["Cyc", "Cyc"]:
        if self.ctx != other.ctx:
            raise ValueError(f"Cyc op across rings: {self.ctx} vs {other.ctx}")
        if self.rep is other.rep:
            return self, other
        if Rep.CRT in (self.rep, other.rep):
            return self.to_crt(), other.to_crt()
        return self.to_pow(), other.to_pow()

    def __add__(self, other) -> "Cyc":
        if isinstance(other, int):
            other = Cyc.scalar(self.ctx, other)
        a, b = self._unify(other)
        return Cyc(a.ctx, a.rep, rg.add(a.ctx, a.data, b.data))

    def __sub__(self, other) -> "Cyc":
        if isinstance(other, int):
            other = Cyc.scalar(self.ctx, other)
        a, b = self._unify(other)
        return Cyc(a.ctx, a.rep, rg.sub(a.ctx, a.data, b.data))

    def __neg__(self) -> "Cyc":
        return Cyc(self.ctx, self.rep, rg.neg(self.ctx, self.data))

    def __mul__(self, other) -> "Cyc":
        if isinstance(other, int):
            return Cyc(
                self.ctx, self.rep, rg.mul_scalar_int(self.ctx, self.data, other)
            )
        if self.ctx != other.ctx:
            raise ValueError("Cyc mul across rings")
        if not self.ctx.has_crt():
            return _mul_e_route(self, other)
        a, b = self.to_crt(), other.to_crt()
        return Cyc(a.ctx, Rep.CRT, rg.mul_pointwise(a.ctx, a.data, b.data))

    __rmul__ = __mul__

    # --- g ops ----------------------------------------------------------
    def mul_g(self) -> "Cyc":
        fn = {
            Rep.POW: rg.mul_g_pow,
            Rep.DEC: rg.mul_g_dec,
            Rep.CRT: rg.mul_g_crt,
        }[self.rep]
        return Cyc(self.ctx, self.rep, fn(self.ctx, self.data))

    def div_g(self) -> "Cyc":
        fn = {
            Rep.POW: rg.div_g_pow,
            Rep.DEC: rg.div_g_dec,
            Rep.CRT: rg.div_g_crt,
        }[self.rep]
        return Cyc(self.ctx, self.rep, fn(self.ctx, self.data))

    # --- lifts / reductions (Lol liftCyc / reduce / rescaleCyc) ---------
    def lift_ints(self, rep: Rep = Rep.DEC) -> np.ndarray:
        """Centered integer coefficients (host, exact; Lol liftCyc).

        Default basis is decoding (Lol liftDec — the error-minimizing
        choice); equals powerful for 2-power m."""
        c = self.to_dec() if rep is Rep.DEC else self.to_pow()
        return rg.lift_centered_host(c.ctx, c.data)

    def reduce_to(self, ctx2: RingContext) -> "Cyc":
        """Reduce Z -> Z_q' by lifting and re-reducing (cross-modulus).

        Host path (exact); device fast paths exist for chain prefixes via
        rescale."""
        lifted = self.lift_ints()
        return Cyc.from_ints(ctx2, lifted)

    def rescale_drop_last(self, rep: Rep = Rep.POW) -> "Cyc":
        """Exact RNS modulus switch Q -> Q/q_last (Lol rescaleCyc on a
        pair modulus).  Rounding is coefficient-wise, so a coefficient
        basis must be chosen; Lol's RescaleCyc has both instances —
        rep=POW (default) or rep=DEC (the error-minimizing choice for
        general m; identical for 2-power m where the bases coincide)."""
        c = self.to_dec() if rep is Rep.DEC else self.to_pow()
        ctx2 = rg.ring_context(self.ctx.m, self.ctx.basis.qs[:-1])
        return Cyc(ctx2, rep, self.ctx.basis.rescale_drop_last(c.data))

    # --- subring ops ----------------------------------------------------
    def embed(self, sup_ctx: RingContext) -> "Cyc":
        if self.rep is Rep.CRT:
            return Cyc(
                sup_ctx, Rep.CRT, rg.embed_crt(self.ctx, sup_ctx, self.data)
            )
        c = self.to_pow()
        return Cyc(sup_ctx, Rep.POW, rg.embed_pow(self.ctx, sup_ctx, c.data))

    def twace(self, sub_ctx: RingContext) -> "Cyc":
        if self.rep is Rep.CRT:
            return Cyc(
                sub_ctx, Rep.CRT, rg.twace_crt(self.ctx, sub_ctx, self.data)
            )
        c = self.to_pow()
        return Cyc(sub_ctx, Rep.POW, rg.twace_pow(self.ctx, sub_ctx, c.data))

    def coeffs(self, sub_ctx: RingContext, rep: Rep = Rep.POW) -> list["Cyc"]:
        """Relative coefficient decomposition over sub_ctx (Lol coeffsCyc);
        rep selects powerful- or decoding-basis coefficients (same gather
        table — the relative basis monomials are shared)."""
        c = self.to_pow() if rep is Rep.POW else self.to_dec()
        stack = rg.coeffs_pow(self.ctx, sub_ctx, c.data)
        return [Cyc(sub_ctx, rep, stack[i]) for i in range(stack.shape[0])]

    @staticmethod
    def rel_pow_basis(sup_ctx: RingContext, sub_ctx: RingContext) -> list["Cyc"]:
        """The relative powerful basis monomials b_rel as elements of the
        larger ring (Lol powBasis)."""
        import numpy as _np

        pos = rg.pow_basis(sup_ctx, sub_ctx)
        out = []
        for p_ in pos:
            v = _np.zeros(sup_ctx.n, dtype=_np.int64)
            v[int(p_)] = 1
            out.append(Cyc.from_ints(sup_ctx, v))
        return out

    def galois(self, k: int) -> "Cyc":
        """The Galois automorphism sigma_k : zeta -> zeta^k (gcd(k,m)=1).

        In the CRT basis this is a slot permutation (slot at unit u reads
        the old slot at u*k); underlies slot rotations for packed
        plaintexts (Lol: via ZmStar indexing)."""
        from . import zmstar

        perm = zmstar.automorphism_slot_perm(
            self.ctx.m, self.ctx.basis.qs[0], k
        )
        c = self.to_crt()
        return Cyc(self.ctx, Rep.CRT, c.data[..., jnp.asarray(perm)])

    # --- misc -----------------------------------------------------------
    def gsq_norm(self):
        """||g * self||^2 in the canonical embedding (Lol gSqNorm); the
        Gram form applies to decoding-basis coefficients."""
        return rg.gsq_norm_dec_host(self.ctx, self.to_dec().data)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Cyc):
            return NotImplemented
        if self.ctx != other.ctx:
            return False
        a, b = self._unify(other)
        return bool(jnp.array_equal(a.data, b.data))

    def __repr__(self):
        return f"Cyc({self.ctx}, {self.rep.name}, shape={tuple(self.data.shape)})"


# ---------------------------------------------------------------------------
# E-route multiplication (Lol UCyc rep E / CRTEmbed)
# ---------------------------------------------------------------------------


def _mul_e_route(a: Cyc, b: Cyc) -> Cyc:
    """Exact ring product when the base modulus admits no CRT basis
    (e.g. plaintext rings R_{2^k}): the analog of Lol's `E`
    representation, where `UCyc` multiplies via `CRTEmbed` into a ring
    that *does* have roots of unity (`lol/Crypto/Lol/CRTrans.hs ::
    CRTEmbed`, target `Complex Double`).

    The embedding target here is an auxiliary NTT-friendly RNS
    chain wide enough to hold the exact integer product of the centered
    lifts (exactness is a framework invariant, which floats would break):
    lift -> multiply over aux chain -> lift -> reduce mod the original
    basis.  Coefficient bound: each powerful-basis monomial product
    re-expands with coefficients in {-1,0,1} per prime-power axis, so
    |coeff(xy)| <= n*A*B*2^omega (omega = #odd prime axes); the chain is
    sized to 2x that."""
    ctx = a.ctx
    ai = a.lift_ints(rep=Rep.POW)
    bi = b.lift_ints(rep=Rep.POW)
    amax = max((abs(int(v)) for v in ai.reshape(-1)), default=0)
    bmax = max((abs(int(v)) for v in bi.reshape(-1)), default=0)
    if amax == 0 or bmax == 0:
        return Cyc.zero(ctx)
    omega = sum(1 for pp in ctx.fm.pps if pp.p != 2)
    bound = ctx.n * amax * bmax << (omega + 1)
    divisor = 2 * ctx.n if ctx.fm.is_pow2() else ctx.m
    count, prod = 1, 1
    from . import numtheory as _nt

    while prod <= 2 * bound:
        qs = tuple(_nt.ntt_primes(divisor, 30, count))
        prod = 1
        for q in qs:
            prod *= q
        count += 1
    aux = rg.ring_context(ctx.m, qs)
    pa = Cyc.from_ints(aux, ai, rep=Rep.POW)
    pb = Cyc.from_ints(aux, bi, rep=Rep.POW)
    prod_ints = (pa * pb).lift_ints(rep=Rep.POW)
    return Cyc.from_ints(ctx, prod_ints, rep=Rep.POW)

"""Gadgets: encode / decompose / correct.

Reference: `lol/Crypto/Lol/Gadget.hs` (SURVEY.md §3.2) — `class Gadget gad`
(`gadget`, `encode`), `Decompose` (`decompose`), `Correct` (`correct`),
with gadget types `TrivGad` and `BaseBGad b`, and pair instances tensoring
gadgets across RNS components.

Design: a `GadgetSpec` picks the gadget; decomposition returns a digit
axis that the key-switch inner product contracts with hint ciphertexts.
Besides the reference's TrivGad/BaseBGad we provide `RnsGad`, the
CRT/RNS gadget (digit_i = centered residue mod q_i) whose decomposition
is *free* in RNS form — the idiomatic choice on device, where big-int lifts
are expensive; BaseBGad decomposition over multi-prime chains lifts
through the CRT on the host (oracle path) or per-residue on device for
single-prime chains.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from . import numtheory as nt
from . import zq
from .rns import RnsBasis


class GadgetSpec:
    pass


@dataclass(frozen=True)
class TrivGad(GadgetSpec):
    """gadget = [1]; decompose = centered lift (1 digit)."""


@dataclass(frozen=True)
class BaseBGad(GadgetSpec):
    """gadget = [1, b, b^2, ...] with balanced base-b digits."""

    b: int

    def __post_init__(self):
        if self.b < 2:
            raise ValueError("BaseBGad: b >= 2 required")


@dataclass(frozen=True)
class RnsGad(GadgetSpec):
    """CRT gadget: g_i = (Q/q_i) * [(Q/q_i)^{-1}]_{q_i}; digit_i = [x]_{q_i}."""


def num_digits(spec: GadgetSpec, basis: RnsBasis) -> int:
    Q = basis.modulus
    if isinstance(spec, TrivGad):
        return 1
    if isinstance(spec, BaseBGad):
        ell = 0
        t = 1
        while t < Q:
            t *= spec.b
            ell += 1
        return ell
    if isinstance(spec, RnsGad):
        return basis.nrns
    raise TypeError(spec)


def gadget_ints(spec: GadgetSpec, basis: RnsBasis) -> list[int]:
    """The gadget vector as Python ints mod Q (Lol `gadget`)."""
    Q = basis.modulus
    if isinstance(spec, TrivGad):
        return [1]
    if isinstance(spec, BaseBGad):
        return [pow(spec.b, j) % Q for j in range(num_digits(spec, basis))]
    if isinstance(spec, RnsGad):
        out = []
        for m in basis.moduli:
            Qi = Q // m.q
            out.append(Qi * nt.modinv(Qi % m.q, m.q) % Q)
        return out
    raise TypeError(spec)


def gadget_rns(spec: GadgetSpec, basis: RnsBasis) -> np.ndarray:
    """(ell, nrns) uint32: gadget entries in residue form."""
    g = gadget_ints(spec, basis)
    return np.array(
        [[gi % m.q for m in basis.moduli] for gi in g], dtype=np.uint32
    )


def encode_int(spec: GadgetSpec, basis: RnsBasis, x: int) -> list[int]:
    """x * gadget over Z_Q (Lol `encode`)."""
    Q = basis.modulus
    return [x * g % Q for g in gadget_ints(spec, basis)]


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------


def _signed_digits(v: int, b: int, ell: int) -> list[int]:
    """Balanced base-b digits of integer v: v = sum d_j b^j, d in [-b/2, b/2)."""
    out = []
    for _ in range(ell):
        d = v % b
        if d >= (b + 1) // 2:
            d -= b
        out.append(d)
        v = (v - d) // b
    if v != 0:
        raise ValueError("digit overflow: |v| too large for ell digits")
    return out


def decompose_host(spec: GadgetSpec, basis: RnsBasis, a: np.ndarray) -> np.ndarray:
    """Host oracle: (..., nrns, n) residues -> (ell, ..., nrns, n) digits
    in residue form, satisfying sum_j digits_j * gadget_j = a (mod Q)."""
    a = np.asarray(a)
    lifted = basis.lift_centered(np.moveaxis(a, -2, 0))  # (...,) object ints
    ell = num_digits(spec, basis)
    if isinstance(spec, TrivGad):
        digs = lifted[None]
    elif isinstance(spec, BaseBGad):
        flat = lifted.reshape(-1)
        dd = np.empty((ell, flat.shape[0]), dtype=object)
        for j, v in enumerate(flat):
            for k, d in enumerate(_signed_digits(int(v), spec.b, ell)):
                dd[k, j] = d
        digs = dd.reshape((ell,) + lifted.shape)
    elif isinstance(spec, RnsGad):
        qs = basis.qs
        digs = np.empty((ell,) + lifted.shape, dtype=object)
        for i, qi in enumerate(qs):
            flat = lifted.reshape(-1)
            di = np.array(
                [_center(int(v) % qi, qi) for v in flat], dtype=object
            ).reshape(lifted.shape)
            digs[i] = di
    else:
        raise TypeError(spec)
    # to residue form, rns axis at -2
    out = np.stack([basis.to_rns(d) for d in digs])  # (ell, nrns, ...)
    return np.moveaxis(out, 1, -2).astype(np.uint32)


def decompose_rns_jnp(basis: RnsBasis, a) -> jnp.ndarray:
    """Device-side RnsGad decomposition of (..., nrns, n) -> (nrns, ..., nrns, n).

    digit_i = centered residue [a]_{q_i}, re-expanded into every channel.
    No big-int lift needed — this is why RnsGad is the device-native gadget.
    """
    qs = basis.qs
    digits = []
    for i, qi in enumerate(qs):
        xi = a[..., i, :]
        is_high = xi >= jnp.uint32((qi + 1) // 2)
        chans = []
        for j, qj in enumerate(qs):
            if i == j:
                chans.append(xi)
                continue
            r = zq.reduce_mod(xi, qj) if qi > qj else xi
            r = jnp.where(is_high, zq.sub_mod(r, jnp.uint32(qi % qj), qj), r)
            chans.append(r)
        digits.append(jnp.stack(chans, axis=-2))
    return jnp.stack(digits)


def decompose_base_jnp(spec: BaseBGad, basis: RnsBasis, a) -> jnp.ndarray:
    """Device-side BaseBGad decomposition for single-prime chains.

    (..., 1, n) -> (ell, ..., 1, n): balanced digits of the centered lift,
    computed in int32 (q < 2^30)."""
    if basis.nrns != 1:
        raise ValueError(
            "decompose_base_jnp: device BaseBGad decomposition needs a "
            "single-prime chain; use RnsGad or decompose_host for RNS"
        )
    q = basis.qs[0]
    b = spec.b
    ell = num_digits(spec, basis)
    x = a[..., 0, :].astype(jnp.int32)
    x = jnp.where(x >= (q + 1) // 2, x - q, x)  # centered lift
    outs = []
    for _ in range(ell):
        d = jnp.mod(x, b)
        d = jnp.where(d >= (b + 1) // 2, d - b, d)
        outs.append(jnp.where(d < 0, (d + q).astype(jnp.uint32), d.astype(jnp.uint32)))
        x = (x - d) // b
    return jnp.stack(outs)[..., None, :]


def decompose(spec: GadgetSpec, basis: RnsBasis, a):
    """Device decomposition dispatch (falls back to host oracle shapes)."""
    if isinstance(spec, RnsGad):
        return decompose_rns_jnp(basis, a)
    if isinstance(spec, TrivGad) and basis.nrns == 1:
        return a[None]
    if isinstance(spec, BaseBGad) and basis.nrns == 1:
        return decompose_base_jnp(spec, basis, a)
    return jnp.asarray(decompose_host(spec, basis, np.asarray(a)))


# ---------------------------------------------------------------------------
# error correction (Lol `Correct`; used by gadget tests & KH-PRF)
# ---------------------------------------------------------------------------


def correct_host(spec: GadgetSpec, basis: RnsBasis, noisy: np.ndarray):
    """Given noisy = x*gadget + e (residue form, digit axis 0), recover x
    and the error: Lol `correct`.  Works digit-by-digit from the top for
    BaseBGad; for TrivGad it's the identity; RnsGad correction recovers x
    from the first digit (q_0 channel consistency)."""
    if isinstance(spec, TrivGad):
        x = noisy[0]
        return x, np.zeros_like(noisy)
    if isinstance(spec, BaseBGad):
        # w_j = b^j x + e_j (mod Q).  Syndromes c_j := b*w_j - w_{j+1}
        # = b*e_j - e_{j+1} are recovered exactly by centered lift; then
        # e_{l-1} = centered(-c_{l-2} mod b) (needs |e_j| < b/2, the
        # reference's correctness regime) and back-substitution
        # e_j = (c_j + e_{j+1})/b yields all errors; x = w_0 - e_0.
        b = spec.b
        Q = basis.modulus
        lifted = np.stack(
            [basis.lift_centered(np.moveaxis(d, -2, 0)) for d in noisy]
        )  # (ell, ...) object ints in [-Q/2, Q/2)
        ell = lifted.shape[0]
        shape = lifted.shape[1:]
        flat = lifted.reshape(ell, -1)
        xs = np.empty(flat.shape[1], dtype=object)
        errs = np.empty_like(flat)
        for t in range(flat.shape[1]):
            w = [int(v) for v in flat[:, t]]
            c = [_center((b * w[j] - w[j + 1]) % Q, Q) for j in range(ell - 1)]
            e = [0] * ell
            if ell >= 2:
                e[ell - 1] = _center((-c[ell - 2]) % b, b)
                for j in range(ell - 2, -1, -1):
                    e[j] = (c[j] + e[j + 1]) // b
            for j in range(ell):
                errs[j, t] = e[j]
            xs[t] = (w[0] - e[0]) % Q
        return xs.reshape(shape), errs.reshape((ell,) + shape)
    if isinstance(spec, RnsGad):
        # noisy_j = g_j x + e_j with g_j = 1 mod q_j, 0 mod q_{i!=j}: the
        # off-channel residues of digit j are exactly e_j mod q_i, so e_j
        # is the centered CRT over Q/q_j (correctness regime
        # |e_j| < (Q/q_j)/2); then x mod q_j = noisy_j - e_j in channel j
        # and x follows by CRT across digits.  Degenerate single-prime
        # chains (Q/q_0 = 1) carry no error information: e := 0.
        from .rns import rns_basis as _rns_basis

        qs = basis.qs
        L = len(qs)
        noisy = np.asarray(noisy)
        shape = noisy.shape[1:-2] + noisy.shape[-1:]  # drop digit+rns axes
        if L == 1:
            x = basis.from_rns(np.moveaxis(noisy[0], -2, 0))
            return x, np.zeros((1,) + shape, dtype=object)
        errs = np.empty((L,) + shape, dtype=object)
        x_res = np.empty((L,) + shape, dtype=object)
        for j in range(L):
            others = [i for i in range(L) if i != j]
            sub = _rns_basis(tuple(qs[i] for i in others))
            chans = np.stack(
                [np.asarray(noisy[j][..., i, :], dtype=np.uint64)
                 for i in others]
            )
            e_j = sub.lift_centered(chans)
            errs[j] = e_j
            wj = noisy[j][..., j, :].astype(object)
            x_res[j] = (wj - e_j) % qs[j]
        x = basis.from_rns(x_res)
        return x, errs
    raise TypeError(f"correct not supported for {spec}")


def _center(r: int, q: int) -> int:
    return r - q if r >= (q + 1) // 2 else r

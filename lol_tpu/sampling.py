"""Randomness: uniform ring elements, discrete (rounded) Gaussians.

Reference: `lol/Crypto/Lol/GaussRandom.hs` (Box-Muller real Gaussians) +
`Tensor.tweakedGaussianDec` + `UCyc.errorRounded` (SURVEY.md §3.2/§3.5).

Design: all randomness flows from jax.random (threefry) keys —
deterministic, splittable, identical across backends/platforms for a
fixed key, which is what makes cross-backend bit-exact test vectors
possible (SURVEY.md §8 determinism requirement).  Box-Muller is replaced
by jax.random.normal (erf-inversion) — same distribution, device-native.

Convention: for 2-power m the decoding basis equals the powerful basis
and is orthogonal (up to a uniform sqrt(n) scale) in the canonical
embedding, so `gaussian_dec(var=v)` samples iid N(0, v) *coefficients* —
matching the usual power-of-2 RLWE practice.  General m applies the
real inverse-CRT mixing matrix (with ops/general.py).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import ring as rg
from .cyc import Cyc, Rep
from .ring import RingContext


def uniform(ctx: RingContext, key, batch: tuple[int, ...] = ()) -> Cyc:
    """Uniform element of R_q in the CRT basis (uniform in any basis).

    For CRT-less moduli (e.g. plaintext rings R_{2^k}) the value is
    tagged POW instead — uniformity is basis-independent, and the CRT
    tag would be meaningless there."""
    keys = jax.random.split(key, ctx.nrns)
    chans = [
        jax.random.randint(
            keys[i], (*batch, ctx.n), 0, q, dtype=jnp.uint32
        )
        for i, q in enumerate(ctx.basis.qs)
    ]
    rep = Rep.CRT if ctx.has_crt() else Rep.POW
    return Cyc(ctx, rep, jnp.stack(chans, axis=-2))


def real_gaussians(key, var: float, shape) -> jnp.ndarray:
    """Continuous spherical Gaussians, variance `var` (Lol realGaussians)."""
    return jax.random.normal(key, shape, dtype=jnp.float32) * jnp.sqrt(
        jnp.float32(var)
    )


def _dec_mixing_matrix(m: int) -> np.ndarray:
    """Dense L with L L^T = Gram_dec(m)^{-1}: maps iid N(0,1) to
    decoding-basis coordinates of a spherical canonical-embedding
    Gaussian (variance 1 per embedding coordinate).  2-power m:
    (1/sqrt(n)) I.  Reconstructed as the Kronecker product of the
    per-axis factors (general.dec_mixing_factors) — only the bound
    computations in rlwe.py want the dense form; the sampler applies
    the factors axis-wise and never builds it."""
    from .factored import fact as _fact
    from .ops import general as _gen

    f = _fact(m)
    if f.is_pow2():
        return np.eye(f.phi) / np.sqrt(max(f.phi, 1))
    out = np.ones((1, 1))
    for Li in _gen.dec_mixing_factors(m):
        out = np.kron(out, Li)
    return out


@lru_cache(maxsize=256)
def _gaussian_dec_fn(m: int, n: int, batch: tuple[int, ...]):
    """Jitted sampler body for (m, shape): ONE device dispatch per call
    instead of ~10 eager ops.
    Mixing factors stay compact numpy in the closure and convert inside
    the jitted body (the lru-cache escaped-tracer-safe pattern)."""
    from .factored import fact as _fact
    from .ops import general as _gen

    f = _fact(m)
    pow2 = f.is_pow2()
    if pow2:
        factors, shape = None, None
    else:
        scale = float(np.sqrt(n))
        factors = tuple(
            ((Li * scale if i == 0 else Li).astype(np.float32))
            for i, Li in enumerate(_gen.dec_mixing_factors(m))
        )
        shape = f.phi_shape

    import jax as _jax

    @_jax.jit
    def run(key, var):
        g = jax.random.normal(key, (*batch, n), dtype=jnp.float32) * jnp.sqrt(
            var
        )
        if not pow2:
            lead = g.shape[:-1]
            gs = g.reshape(*lead, *shape)
            for i, Lf in enumerate(factors):
                ax = len(lead) + i
                gs = jnp.moveaxis(gs, ax, -1)
                gs = jnp.einsum("ij,...j->...i", jnp.asarray(Lf), gs)
                gs = jnp.moveaxis(gs, -1, ax)
            g = gs.reshape(*lead, n)
        return jnp.round(g).astype(jnp.int32)

    return run


def gaussian_dec_ints(ctx: RingContext, key, var: float,
                      batch: tuple[int, ...] = ()) -> jnp.ndarray:
    """Rounded decoding-basis Gaussian as signed int32 coefficients
    (Lol tweakedGaussianDec + errorRounded).

    Convention: `var` is the per-coefficient variance for 2-power m
    (where the decoding basis is orthogonal, scale sqrt(n), this equals a
    spherical embedding Gaussian of variance n*var); general m uses the
    same normalization via the decoding-basis mixing factors, applied
    per prime-power axis (tensor-factored — VERDICT r3 #2; the dense
    phi x phi matrix is never built)."""
    return _gaussian_dec_fn(ctx.m, ctx.n, tuple(batch))(
        key, jnp.float32(var)
    )


def _ints_to_rns(ctx: RingContext, x: jnp.ndarray) -> jnp.ndarray:
    """Signed int32 coefficients -> (..., nrns, n) residues."""
    chans = []
    for q in ctx.basis.qs:
        r = jnp.mod(x, q).astype(jnp.uint32)  # python-mod: result in [0, q)
        chans.append(r)
    return jnp.stack(chans, axis=-2)


def gaussian_cyc(ctx: RingContext, key, var: float,
                 batch: tuple[int, ...] = ()) -> Cyc:
    """Discrete-Gaussian error element in the decoding basis."""
    ints = gaussian_dec_ints(ctx, key, var, batch)
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, ints))


def gaussian_ints_np(ctx_or_n, key, var: float) -> np.ndarray:
    """Host copy of the sampled integers (for secrets kept as ints)."""
    if isinstance(ctx_or_n, RingContext):
        n = ctx_or_n.n
        ctx = ctx_or_n
        return np.asarray(gaussian_dec_ints(ctx, key, var))
    raise TypeError


def error_coset(ctx: RingContext, key, var: float, coset_ints, p: int) -> Cyc:
    """Sample an error congruent to `coset_ints` mod p (Lol errorCoset):
    e = coset + p * round(Gaussian), in the decoding basis.  This is the
    sampling encrypt uses — the message rides as the coset of the
    error."""
    import numpy as _np

    g = gaussian_dec_ints(ctx, key, var)
    ints = _np.asarray(coset_ints, dtype=_np.int64) + p * _np.asarray(g, dtype=_np.int64)
    return Cyc(ctx, Rep.DEC, _ints_to_rns(ctx, jnp.asarray(ints, dtype=jnp.int32)))

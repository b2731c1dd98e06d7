"""RRq — the torus R/qZ ("reals mod q") for continuous RLWE samples.

Analog of `lol/Crypto/Lol/Types/Unsafe/RRq.hs` (SURVEY.md §3.2):
Additive-group arithmetic, Reduce (R -> R/qZ), Lift (centered
representative), Rescale (R/qZ -> R/q'Z), and rounding to Z_q.

Device representation: float32 arrays holding centered representatives in
[-q/2, q/2).  (The reference uses Double; on device we stay in f32 — challenge
verification against tight bounds happens on the host in f64/exact.)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def reduce(x, q: float):
    """R -> R/qZ, centered representative."""
    r = jnp.mod(x, q)
    return jnp.where(r >= q / 2, r - q, r)


def lift(x):
    """Centered representative (identity on the canonical rep)."""
    return x


def add(a, b, q: float):
    return reduce(a + b, q)


def neg(a, q: float):
    return reduce(-a, q)


def rescale(x, q: float, q2: float):
    """R/qZ -> R/q2Z: multiply by q2/q (Lol Rescale RRq)."""
    return reduce(x * (q2 / q), q2)


def round_to_zq(x, q: int):
    """R/qZ -> Z_q by coefficient rounding."""
    r = jnp.round(x).astype(jnp.int32)
    return jnp.mod(r, q).astype(jnp.uint32)

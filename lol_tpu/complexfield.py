"""Complex CRT embedding — the char-0 fallback transform.

Analog of `lol/Crypto/Lol/Types/Complex.hs` + the `CRTEmbed` class
(SURVEY.md §3.2): base rings without m-th roots of unity (Z, Q, R/qZ)
embed into C where the CRT always exists; used for continuous-error
paths and sanity checks.

Precision note: the challenge-verification bounds want double
precision, which accelerators run slowly or not at all — so this path is
host-side numpy complex128 (the
reference's C++ complex kernels are also CPU).  Same canonical slot
ordering as the exact transforms (ops/general.py _global_units), so
complex and mod-q CRT outputs correspond slot-for-slot.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

from .factored import fact


@lru_cache(maxsize=256)
def _crt_matrix_c(m: int) -> np.ndarray:
    """(n, n) complex CRT matrix in canonical slot x powerful-basis order."""
    f = fact(m)
    n = f.phi
    shape = f.phi_shape
    exps = np.zeros(n, dtype=np.int64)
    for flat in range(n):
        idx = np.unravel_index(flat, shape)
        exps[flat] = sum(int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)) % m
    units = _canonical_units_c(m)
    w = np.exp(2j * np.pi / max(m, 1))
    return np.array([[w ** ((u * e) % m) for e in exps] for u in units])


@lru_cache(maxsize=256)
def _canonical_units_c(m: int) -> tuple[int, ...]:
    """Canonical slot order WITHOUT needing a modulus: per-axis orders
    matching ops/general.py (2-axis: NTT order via crt_output_exponents;
    odd axes: ascending units), CRT-combined."""
    from .ops import ntt as _ntt

    if m == 1:
        return (0,)
    f = fact(m)
    parts = []
    for pp in f.pps:
        pe = pp.value
        if pp.p == 2 and pp.e >= 2:
            us = (_ntt.crt_output_exponents(pe // 2) % pe).astype(int)
        elif pp.p == 2:
            us = np.array([1])
        else:
            us = np.array([u for u in range(pe) if u % pp.p != 0])
        mi = m // pe
        c = mi * pow(mi, -1, pe) % m
        parts.append((us % pe) * c % m)
    out = parts[0]
    for v in parts[1:]:
        out = np.add.outer(out, v) % m
    return tuple(int(u) for u in out.reshape(-1))


def crt_embed(x: np.ndarray, m: int) -> np.ndarray:
    """Powerful-basis real/int coefficients -> complex CRT slots."""
    M = _crt_matrix_c(m)
    return np.asarray(x, dtype=np.complex128) @ M.T


def crt_embed_inv(y: np.ndarray, m: int) -> np.ndarray:
    """Complex slots -> powerful coefficients (real up to fp error)."""
    M = _crt_matrix_c(m)
    return np.linalg.solve(M, np.asarray(y, dtype=np.complex128).T).T


def round_complex(y: np.ndarray) -> np.ndarray:
    """Round a near-real array to integers (Lol roundComplex)."""
    r = np.asarray(y)
    assert np.max(np.abs(r.imag)) < 1e-6 * max(1.0, float(np.max(np.abs(r)))), \
        "roundComplex: non-negligible imaginary part"
    return np.rint(r.real).astype(np.int64)

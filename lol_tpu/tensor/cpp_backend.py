"""ctypes bindings for the native C++ tensor kernels (lol-cpp analog).

Builds lol_tpu/native/tensor.cpp into a shared library on first use
(g++, into the checkout's gitignored build/ directory) and exposes the
Tensor hot ops over numpy arrays.  Bit-identical to the numpy/jnp/Pallas
paths — same networks, same twiddle tables.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..ops.ntt import NTTPlan

_SRC = Path(__file__).parent.parent / "native" / "tensor.cpp"
_LIB = _SRC.parents[2] / "build" / "liblol_tensor.so"

_u32p = ctypes.POINTER(ctypes.c_uint32)
_f64p = ctypes.POINTER(ctypes.c_double)
_i64p = ctypes.POINTER(ctypes.c_longlong)


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    if (not _LIB.exists()) or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _LIB.parent.mkdir(exist_ok=True)
        tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", str(tmp), str(_SRC)],
            check=True,
        )
        os.replace(tmp, _LIB)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(_LIB))
    for name, args in {
        "zq_mul": [_u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_uint32],
        "zq_add": [_u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_uint32],
        "zq_sub": [_u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_uint32],
        "ntt_fwd": [_u32p, ctypes.c_long, ctypes.c_long, ctypes.c_uint32, _u32p],
        "ntt_inv": [_u32p, ctypes.c_long, ctypes.c_long, ctypes.c_uint32,
                    _u32p, ctypes.c_uint32],
        "axis_matvec": [_u32p, _u32p, _u32p, ctypes.c_long, ctypes.c_long,
                        ctypes.c_uint32],
        "l_fwd": [_u32p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                  ctypes.c_uint32],
        "l_inv": [_u32p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                  ctypes.c_uint32],
        "mul_g_pow": [_u32p, _u32p, ctypes.c_long, ctypes.c_long,
                      ctypes.c_long, ctypes.c_uint32],
        "div_g_pow": [_u32p, _u32p, ctypes.c_long, ctypes.c_long,
                      ctypes.c_long, ctypes.c_uint32, ctypes.c_uint32],
        "gather_idx": [_u32p, _u32p, ctypes.c_long, ctypes.c_long, _i64p,
                       ctypes.c_long],
        "scatter_idx": [_u32p, _u32p, ctypes.c_long, ctypes.c_long, _i64p,
                        ctypes.c_long],
        "strided_sum": [_u32p, _u32p, ctypes.c_long, ctypes.c_long,
                        ctypes.c_long, ctypes.c_uint32],
        "gsq_norm_pow2": [_u32p, _f64p, ctypes.c_long, ctypes.c_long,
                          ctypes.c_uint32],
        "gsq_norm_gram": [_i64p, _i64p, _f64p, ctypes.c_long, ctypes.c_long],
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint32)


def zq_mul(a, b, q: int) -> np.ndarray:
    a, b = _c(a), _c(b)
    out = np.empty_like(a)
    _lib().zq_mul(_ptr(a), _ptr(b), _ptr(out), a.size, q)
    return out


def zq_add(a, b, q: int) -> np.ndarray:
    a, b = _c(a), _c(b)
    out = np.empty_like(a)
    _lib().zq_add(_ptr(a), _ptr(b), _ptr(out), a.size, q)
    return out


def ntt_forward(x, plan: NTTPlan) -> np.ndarray:
    """(..., n) forward negacyclic NTT, in the plan's canonical order."""
    x = _c(x).copy()
    flat = x.reshape(-1, plan.n)
    tw = _c(plan.psi_rev)
    _lib().ntt_fwd(_ptr(flat), flat.shape[0], plan.n, plan.q, _ptr(tw))
    return x


def ntt_inverse(x, plan: NTTPlan) -> np.ndarray:
    x = _c(x).copy()
    flat = x.reshape(-1, plan.n)
    tw = _c(plan.ipsi_rev)
    _lib().ntt_inv(_ptr(flat), flat.shape[0], plan.n, plan.q, _ptr(tw),
                   plan.n_inv)
    return x


def axis_matvec(M, x, q: int) -> np.ndarray:
    """out[..., i] = sum_j M[i, j] x[..., j] mod q (dense odd-prime axis)."""
    M = _c(M)
    x = _c(x)
    phi = M.shape[0]
    flat = x.reshape(-1, phi)
    out = np.empty_like(flat)
    _lib().axis_matvec(_ptr(M), _ptr(flat), _ptr(out), flat.shape[0], phi, q)
    return out.reshape(x.shape)


def l_fwd(x, p: int, inner: int, q: int) -> np.ndarray:
    x = _c(x).copy()
    batch = x.size // ((p - 1) * inner)
    _lib().l_fwd(_ptr(x), batch, p, inner, q)
    return x


def l_inv(x, p: int, inner: int, q: int) -> np.ndarray:
    x = _c(x).copy()
    batch = x.size // ((p - 1) * inner)
    _lib().l_inv(_ptr(x), batch, p, inner, q)
    return x


def mul_g_pow(x, p: int, inner: int, q: int) -> np.ndarray:
    x = _c(x)
    out = np.empty_like(x)
    batch = x.size // ((p - 1) * inner)
    _lib().mul_g_pow(_ptr(x), _ptr(out), batch, p, inner, q)
    return out


def div_g_pow(x, p: int, inner: int, q: int) -> np.ndarray:
    """Exact /g per odd-prime axis (powerful basis; g.cpp divGPow)."""
    from .. import numtheory as nt

    x = _c(x)
    out = np.empty_like(x)
    batch = x.size // ((p - 1) * inner)
    _lib().div_g_pow(_ptr(x), _ptr(out), batch, p, inner, q,
                     nt.modinv(p % q, q))
    return out


def mul_g_dec(x, p: int, inner: int, q: int) -> np.ndarray:
    """·g in the decoding basis: the L-conjugated stencil
    (L^-1 G L; g.cpp mulGDec)."""
    return l_inv(mul_g_pow(l_fwd(x, p, inner, q), p, inner, q), p, inner, q)


def div_g_dec(x, p: int, inner: int, q: int) -> np.ndarray:
    """Exact /g in the decoding basis (g.cpp divGDec)."""
    return l_inv(div_g_pow(l_fwd(x, p, inner, q), p, inner, q), p, inner, q)


def _i64tbl(tbl) -> np.ndarray:
    return np.ascontiguousarray(tbl, dtype=np.int64)


def _tblptr(tbl: np.ndarray):
    return tbl.ctypes.data_as(_i64p)


def twace_pow(x, m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """Tweaked trace, powerful/decoding basis: coordinate gather
    (tensor.cpp twacePowDec analog)."""
    from ..ops import general as gen

    tbl = _i64tbl(gen.embed_pow_table(m_sub, m_sup))
    x = _c(x)
    n_in = x.shape[-1]
    flat = x.reshape(-1, n_in)
    out = np.empty((flat.shape[0], tbl.size), dtype=np.uint32)
    _lib().gather_idx(_ptr(flat), _ptr(out), flat.shape[0], tbl.size,
                      _tblptr(tbl), n_in)
    return out.reshape(*x.shape[:-1], tbl.size)


def embed_pow(x, m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """Embedding R_{m'} -> R_m, powerful basis: coordinate scatter."""
    from ..factored import fact
    from ..ops import general as gen

    tbl = _i64tbl(gen.embed_pow_table(m_sub, m_sup))
    n_out = fact(m_sup).phi
    x = _c(x)
    n_in = x.shape[-1]
    flat = x.reshape(-1, n_in)
    out = np.empty((flat.shape[0], n_out), dtype=np.uint32)
    _lib().scatter_idx(_ptr(flat), _ptr(out), flat.shape[0], n_in,
                       _tblptr(tbl), n_out)
    return out.reshape(*x.shape[:-1], n_out)


def embed_crt(x, m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """CRT-basis embedding: slot replication gather."""
    from ..factored import fact
    from ..ops import general as gen

    tbl = _i64tbl(gen.crt_embed_table(m_sub, m_sup, q))
    x = _c(x)
    n_in = x.shape[-1]
    flat = x.reshape(-1, n_in)
    out = np.empty((flat.shape[0], tbl.size), dtype=np.uint32)
    _lib().gather_idx(_ptr(flat), _ptr(out), flat.shape[0], tbl.size,
                      _tblptr(tbl), n_in)
    return out.reshape(*x.shape[:-1], tbl.size)


def twace_crt(x, m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """CRT-basis tweaked trace: twist, coset-sum, untwist — same
    pre/post tables as ops/general.twace_crt, C++ gather + strided sum."""
    from ..factored import fact
    from ..ops import general as gen

    tbl = gen.crt_embed_table(m_sub, m_sup, q)
    n_sub = fact(m_sub).phi
    n_sup = fact(m_sup).phi
    k = n_sup // n_sub
    pre, post = gen.twace_crt_twists(m_sub, m_sup, q)
    x = _c(x)
    flat = x.reshape(-1, n_sup)
    y = zq_mul(flat, np.broadcast_to(pre, flat.shape), q)
    order = _i64tbl(np.argsort(tbl, kind="stable"))
    g = np.empty_like(y)
    _lib().gather_idx(_ptr(y), _ptr(g), flat.shape[0], n_sup, _tblptr(order),
                      n_sup)
    s = np.empty((flat.shape[0], n_sub), dtype=np.uint32)
    _lib().strided_sum(_ptr(g), _ptr(s), flat.shape[0], n_sub, k, q)
    out = zq_mul(s, np.broadcast_to(post, s.shape), q)
    return out.reshape(*x.shape[:-1], n_sub)


def coeffs_rel(x, m_sub: int, m_sup: int) -> np.ndarray:
    """Relative coefficient decomposition: (d, n_sub) gather stack
    (tensor.cpp coeffs analog)."""
    from ..ops import general as gen

    tbl = gen.rel_coeff_table(m_sub, m_sup)
    x = _c(x)
    n_in = x.shape[-1]
    flat = x.reshape(-1, n_in)
    d, n_sub = tbl.shape
    t64 = _i64tbl(tbl.reshape(-1))
    out = np.empty((flat.shape[0], d * n_sub), dtype=np.uint32)
    _lib().gather_idx(_ptr(flat), _ptr(out), flat.shape[0], d * n_sub,
                      _tblptr(t64), n_in)
    out = out.reshape(*x.shape[:-1], d, n_sub)
    return np.moveaxis(out, -2, 0)


def gsq_norm_pow2(x, q: int) -> np.ndarray:
    x = _c(x)
    flat = x.reshape(-1, x.shape[-1])
    out = np.empty(flat.shape[0], dtype=np.float64)
    _lib().gsq_norm_pow2(_ptr(flat), out.ctypes.data_as(_f64p),
                         flat.shape[0], flat.shape[1], q)
    return out.reshape(x.shape[:-1] or (1,))


def gsq_norm_gram(lifted: np.ndarray, m: int) -> np.ndarray:
    """General-m ||g x||^2 from CENTERED int64 decoding coefficients
    (norm.cpp general path): exact x^T G x with 128-bit accumulation,
    returned as float64 (exact while |result| < 2^53)."""
    from ..ops import general as gen

    G = np.ascontiguousarray(gen.gram_g_dec(m), dtype=np.int64)
    x = np.ascontiguousarray(lifted, dtype=np.int64)
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    out = np.empty(flat.shape[0], dtype=np.float64)
    _lib().gsq_norm_gram(flat.ctypes.data_as(_i64p), G.ctypes.data_as(_i64p),
                         out.ctypes.data_as(_f64p), flat.shape[0], n)
    return out.reshape(x.shape[:-1] or (1,))

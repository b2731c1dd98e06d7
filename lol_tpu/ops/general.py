"""General index-m cyclotomic transforms: the prime-power tensor algebra.

The mathematical heart of the reference (LPR toolkit, ePrint 2013/293;
Lol's Tensor DSL + `lol-cpp` C++ kernels, SURVEY.md §3.3/§3.4): for
m = prod p_i^{e_i}, R_m = (x)_i R_{p_i^{e_i}} and every linear op factors
as a tensor product of per-prime-power transforms applied along the axes
of the coefficient tensor of shape phi_shape = (phi(p_i^{e_i}))_i.

Per-axis transform choices:
- p = 2 axis: the negacyclic NTT network (ops/ntt.py, ops.select) —
  the CRT matrix of R_{2^a} *is* the negacyclic NTT with unit ordering
  u(i) = 2*brv(i)+1 mod 2^a.
- odd p axes (small in practice: 3,5,7,...): dense phi x phi
  matrix-vector products mod q with exact tree-reductions: an int8-limb
  matmul for larger axes, an elementwise modmul + modsum tree below.

CRT slot indexing: slot multi-index (u_1, ..., u_k), axis i enumerating
the units of Z_{p_i^{e_i}} in a *canonical order* (2-axis: NTT order;
odd axes: ascending).  Slot value of ζ_m |-> ω^u with u the CRT-combine
of the per-axis units (ω = canonical principal m-th root mod q).

Basis conversions:
- L (dec -> pow): per odd-prime axis, prefix sums along the prime level
  (L_p = lower-triangular ones, tensored with I_{p^{e-1}}); identity on
  the 2-axis.  lInv: adjacent differences.
- mulG / divG: g = prod_{odd p | m} (1 - ζ_p); per-axis banded stencil
  (pow), conjugated by L (dec), pointwise by CRT(g) (crt).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .. import numtheory as nt
from .. import zq
from ..factored import Factored, PrimePower, fact
from . import ntt


# ---------------------------------------------------------------------------
# modular dense linear algebra (host, exact)
# ---------------------------------------------------------------------------


def _mat_inv_mod(M: np.ndarray, q: int) -> np.ndarray:
    """Exact inverse of a square matrix over Z_q (q prime), Gauss-Jordan.

    Vectorized int64 row eliminations (q < 2^30 so f*row < 2^60 fits);
    the pure-Python version was O(n^3) interpreter ops and took ~25 s at
    n=486."""
    n = M.shape[0]
    A = np.asarray(M, dtype=np.int64) % q
    I = np.eye(n, dtype=np.int64)
    for col in range(n):
        nz = np.nonzero(A[col:, col] % q)[0]
        if nz.size == 0:
            raise ValueError("matrix not invertible mod q")
        piv = col + int(nz[0])
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
            I[[col, piv]] = I[[piv, col]]
        inv = nt.modinv(int(A[col, col]), q)
        A[col] = A[col] * inv % q
        I[col] = I[col] * inv % q
        f = A[:, col].copy()
        f[col] = 0
        A -= np.outer(f, A[col])
        I -= np.outer(f, I[col])
        A %= q
        I %= q
    return I.astype(np.uint32)


def _modsum_tree(x, q, axis=-1):
    """Deterministic exact mod-q sum along `axis` via pairwise folding."""
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    while n > 1:
        if n % 2:
            x = jnp.concatenate(
                [x, jnp.zeros((*x.shape[:-1], 1), dtype=x.dtype)], axis=-1
            )
            n += 1
        x = zq.add_mod(x[..., : n // 2], x[..., n // 2 :], q)
        n //= 2
    return x[..., 0]


INT8_MIN_AXIS = 16  # below this the broadcast path wins (tiny matrices)


def matvec_mod_jnp(M, x, q, use_int8: bool | None = None):
    """(a,b) @ (..., b) -> (..., a) mod q, exact.

    Two bit-identical paths: a broadcast-multiply + deterministic
    mod-sum tree, and an int8-limb matmul (`matvec_mod_int8`) for
    axes large enough to amortize the relayout.  Both are exact integer
    arithmetic, so the dispatch never affects results."""
    if use_int8 is None:
        use_int8 = min(M.shape) >= INT8_MIN_AXIS
    if use_int8:
        return matvec_mod_int8(M, x, q)
    prod = zq.mul_mod(M, x[..., None, :], q)  # (..., a, b)
    return _modsum_tree(prod, q, axis=-1)


def _limbs_needed(q: int) -> int:
    return ((q - 1).bit_length() + 7) // 8


def matvec_mod_int8(M, x, q):
    """Exact (a,b) @ (..., b) -> (..., a) mod q via int8 limb matmuls.

    The reference's dense odd-prime-axis DFT (`lol-cpp .../crt.cpp`
    general-p path, SURVEY §3.3) as integer matmuls: split
    both operands into 8-bit limbs, center to int8, take all limb-pair
    matmuls with int32 accumulation (exact integer dot products), undo the
    centering with precomputed row/column sums, then fold the 2^{8k}
    limb weights back in mod q.  Every step is exact integer arithmetic,
    so the result is bit-identical to the broadcast path (asserted by the
    cross-path test in tests/test_general.py).

    Range proof: |centered limb| <= 128, so each dot entry is at most
    b*128*128; after de-centering a limb-pair product is the true
    A_i @ X_j <= b*255^2, and a weight-class sum over i+j=k of at most
    4 such terms is < 2^31 for b <= 4096 (odd axes are far smaller)."""
    a, b = M.shape
    if b > 4096:
        raise ValueError("matvec_mod_int8: axis too large for int32 accum")
    nl = _limbs_needed(q)  # residues < q, so both operands fit nl limbs
    Mu = jnp.asarray(M, dtype=jnp.uint32)  # jnp throughout: works for plan
    M_limbs = [((Mu >> (8 * i)) & 0xFF).astype(jnp.int32) - 128 for i in range(nl)]
    M_c = [Li.astype(jnp.int8) for Li in M_limbs]  # constants or tracers alike
    M_rowsum = [Li.sum(axis=1) for Li in M_limbs]

    batch = x.shape[:-1]
    X = jnp.moveaxis(x.reshape(-1, b), -1, 0)  # (b, N) uint32
    X_limbs = [((X >> (8 * j)) & 0xFF).astype(jnp.int32) for j in range(nl)]
    X_c = [(Lj - 128).astype(jnp.int8) for Lj in X_limbs]
    X_colsum = [Lj.sum(axis=0) for Lj in X_limbs]  # (N,) int32, of raw limbs

    # weight-class partial sums S_k = sum_{i+j=k} A_i @ X_j, exact in int32
    S = [None] * (2 * nl - 1)
    for i in range(nl):
        for j in range(nl):
            dot = jax.lax.dot_general(
                M_c[i], X_c[j], (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32,
            )  # (a, N)
            # de-center: A_i@X_j = dot + 128*rowsum(A_i^c) + 128*colsum(X_j)
            # (colsum is of the RAW X limb, which absorbs the 128^2*b term)
            p = dot + 128 * X_colsum[j][None, :] + (128 * M_rowsum[i])[:, None]
            k = i + j
            S[k] = p if S[k] is None else S[k] + p

    res = jnp.zeros((a, X.shape[1]), dtype=jnp.uint32)
    for k, Sk in enumerate(S):
        w = pow(2, 8 * k, q)
        term = zq.reduce_mod(Sk.astype(jnp.uint32), q)
        if w != 1:
            term = zq.mul_mod(term, jnp.uint32(w), q)
        res = zq.add_mod(res, term, q)
    return jnp.moveaxis(res, 0, -1).reshape(*batch, a)


# ---------------------------------------------------------------------------
# per-axis plans
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AxisPlan:
    pp: PrimePower
    q: int
    units: np.ndarray  # canonical unit enumeration of Z_{p^e}^*, len phi
    # dense path (odd p); None for the 2-axis
    M: np.ndarray | None  # CRT matrix (phi, phi)
    Minv: np.ndarray | None
    ntt2: ntt.NTTPlan | None  # p=2 fast path

    @property
    def phi(self) -> int:
        return self.pp.phi


@lru_cache(maxsize=1024)
def axis_plan(p: int, e: int, q: int, m: int) -> AxisPlan:
    """Transform plan for the p^e axis of R_m over Z_q.

    The axis root is omega_i = omega^(m / p^e) for the canonical principal
    m-th root omega (derived from the smallest primitive root of q), so
    axes of different rings in a divisibility tower are automatically
    compatible."""
    pp = PrimePower(p, e)
    pe = p**e
    omega = nt.principal_root_of_unity(m, q)
    w = pow(omega, m // pe, q)  # principal p^e-th root
    if p == 2:
        if e == 1:
            # phi(2) = 1: trivial axis (unit 1); treat as dense identity
            units = np.array([1], dtype=np.int64)
            return AxisPlan(pp, q, units, np.array([[1]], np.uint32),
                            np.array([[1]], np.uint32), None)
        n2 = pe // 2
        plan = ntt.ntt_plan(n2, q, psi=w)
        units = (ntt.crt_output_exponents(n2) % pe).astype(np.int64)
        return AxisPlan(pp, q, units, None, None, plan)
    units = np.array([u for u in range(pe) if u % p != 0], dtype=np.int64)
    phi = pp.phi
    M = np.empty((phi, phi), dtype=np.uint32)
    for a, u in enumerate(units):
        wu = pow(int(w), int(u), q)
        row = 1
        for b in range(phi):
            M[a, b] = row
            row = row * wu % q
    return AxisPlan(pp, q, units, M, _mat_inv_mod(M, q), None)


@dataclass(frozen=True)
class GeneralPlan:
    """All per-axis plans for (m, q); the analog of the C++ tensor fuser's
    walk over the factorization (SURVEY §3.3 tensor.cpp)."""

    fm: Factored
    q: int
    axes: tuple[AxisPlan, ...]

    @property
    def phi_shape(self):
        return self.fm.phi_shape


@lru_cache(maxsize=512)
def general_plan(m: int, q: int) -> GeneralPlan:
    f = fact(m)
    if (q - 1) % m != 0:
        raise ValueError(f"general_plan: need m={m} | q-1 (q={q})")
    axes = tuple(axis_plan(pp.p, pp.e, q, m) for pp in f.pps)
    return GeneralPlan(f, q, axes)


# ---------------------------------------------------------------------------
# applying per-axis transforms
# ---------------------------------------------------------------------------


def _apply_axis(plan: GeneralPlan, x, i: int, fn):
    """Apply fn (last-axis transform) along logical axis i of (..., n)."""
    shape = x.shape
    batch = shape[:-1]
    xs = x.reshape(*batch, *plan.phi_shape)
    ax = len(batch) + i
    xs = jnp.moveaxis(xs, ax, -1)
    xs = fn(xs)
    xs = jnp.moveaxis(xs, -1, ax)
    return xs.reshape(*shape)


def crt(plan: GeneralPlan, x):
    """Powerful -> CRT basis (evaluation at the canonical slot order)."""
    for i, ax in enumerate(plan.axes):
        if ax.phi == 1:
            continue
        if ax.ntt2 is not None:
            x = _apply_axis(plan, x, i, lambda v, a=ax: ntt.ntt_forward_stages(v, a.ntt2))
        else:
            x = _apply_axis(
                plan, x, i, lambda v, a=ax: matvec_mod_jnp(jnp.asarray(a.M), v, plan.q)
            )
    return x


def crt_inv(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.phi == 1:
            continue
        if ax.ntt2 is not None:
            x = _apply_axis(plan, x, i, lambda v, a=ax: ntt.ntt_inverse_stages(v, a.ntt2))
        else:
            x = _apply_axis(
                plan, x, i,
                lambda v, a=ax: matvec_mod_jnp(jnp.asarray(a.Minv), v, plan.q),
            )
    return x


# --- coefficient-major (n, B) forms for the batched serving pipeline -------
#
# she_batched keeps ciphertext components coefficient-major ((n, B), batch
# contiguous).  For general m the flat coefficient axis is the row-major
# flattening of phi_shape (primes ascending), so the 2-power axis — where
# the work is — is axis 0 and (n2, rest*B) is a FREE reshape: it rides the
# same negacyclic NTT as the 2-power pipeline (ops.select, including the
# pre_digit_q RNS-digit prologue), while the small odd dense axes ride
# matvec_mod_jnp.  (VERDICT r2 #4.)


def crt_cm(plan: GeneralPlan, x, inverse: bool = False,
           pre_digit_q: int | None = None):
    """(n, B) coefficient-major CRT / CRT^-1 for general m.

    pre_digit_q: fuse the RNS-gadget digit re-expansion (elementwise, so
    it runs before ANY axis transform) — inside the 2-axis transform
    when there is one, as an explicit prologue otherwise.  Forward only."""
    from . import select

    if pre_digit_q is not None and inverse:
        raise ValueError("crt_cm: pre_digit_q is a forward-only prologue")
    n, B = x.shape
    q = plan.q
    shape = plan.phi_shape
    axes = plan.axes
    if axes and axes[0].ntt2 is not None:
        n2 = shape[0]
        x2 = x.reshape(n2, (n // n2) * B)
        x = select.ntt_cm(x2, axes[0].ntt2, inverse, pre_digit_q).reshape(n, B)
    elif pre_digit_q is not None:
        x = ntt.redigit(x, pre_digit_q, q)
    xs = x.reshape(*shape, B)
    for i, ax in enumerate(axes):
        if ax.ntt2 is not None or ax.phi == 1:
            continue
        M = ax.Minv if inverse else ax.M
        xs = jnp.moveaxis(xs, i, -1)
        xs = matvec_mod_jnp(jnp.asarray(M), xs, q)
        xs = jnp.moveaxis(xs, -1, i)
    return xs.reshape(n, B)


def l_cm(plan: GeneralPlan, x, inverse: bool = False):
    """(n, B) coefficient-major L / L^-1 (dec <-> pow basis change)."""
    n, B = x.shape
    xs = x.reshape(*plan.phi_shape, B)
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2 or ax.phi == 1:
            continue
        xs = jnp.moveaxis(xs, i, -1)
        xs = _l_axis(xs, ax.pp, plan.q, inverse)
        xs = jnp.moveaxis(xs, -1, i)
    return xs.reshape(n, B)


# --- exact numpy mirrors (oracle / host keygen) ----------------------------


def _np_apply_axis(plan: GeneralPlan, x: np.ndarray, i: int, fn) -> np.ndarray:
    shape = x.shape
    batch = shape[:-1]
    xs = x.reshape(*batch, *plan.phi_shape)
    ax = len(batch) + i
    xs = np.moveaxis(xs, ax, -1)
    xs = fn(xs)
    xs = np.moveaxis(xs, -1, ax)
    return xs.reshape(*shape)


def _np_l_axis(v: np.ndarray, pp: PrimePower, q: int, inverse: bool) -> np.ndarray:
    """numpy mirror of _l_axis (prefix sums / differences, prime level)."""
    p, e = pp.p, pp.e
    lead = v.shape[:-1]
    vs = v.astype(np.int64).reshape(*lead, p - 1, p ** (e - 1))
    if not inverse:
        out = np.cumsum(vs, axis=-2) % q
    else:
        out = np.diff(vs, axis=-2, prepend=0) % q
    return out.reshape(*lead, pp.phi).astype(np.uint32)


def np_l(plan: GeneralPlan, x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Exact numpy mirror of l/l_inv over (..., n) uint32 arrays."""
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2 or ax.phi == 1:
            continue
        x = _np_apply_axis(
            plan, x, i, lambda v, a=ax: _np_l_axis(v, a.pp, plan.q, inverse)
        )
    return x


def np_crt(plan: GeneralPlan, x: np.ndarray, inverse: bool = False) -> np.ndarray:
    """Exact numpy mirror of crt/crt_inv over (..., n) uint32 arrays."""
    q = plan.q

    def dense(M):
        def f(v):  # (..., b) -> (..., a)
            b = v.shape[-1]
            flat = np.moveaxis(v.reshape(-1, b), -1, 0)  # (b, N)
            out = zq.np_matvec_mod(M, flat, q).astype(np.uint32)  # (a, N)
            return np.moveaxis(out, 0, -1).reshape(*v.shape[:-1], M.shape[0])
        return f

    for i, ax in enumerate(plan.axes):
        if ax.phi == 1:
            continue
        if ax.ntt2 is not None:
            fn = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward
            x = _np_apply_axis(plan, x, i, lambda v, p=ax.ntt2, f=fn: f(v, p))
        else:
            M = ax.Minv if inverse else ax.M
            x = _np_apply_axis(plan, x, i, dense(M))
    return x


# --- L / L^-1 --------------------------------------------------------------


def _l_axis(v, pp: PrimePower, q, inverse: bool):
    """Prefix-sum (or difference) along the prime level of the last axis.

    Axis layout: index j = t * p^(e-1) + r, t < p-1: view (p-1, p^{e-1})."""
    p, e = pp.p, pp.e
    lead = v.shape[:-1]
    vs = v.reshape(*lead, p - 1, p ** (e - 1))
    if not inverse:
        # pow[t] = sum_{t' <= t} dec[t']: sequential fold (p small)
        rows = [vs[..., 0, :]]
        for t in range(1, p - 1):
            rows.append(zq.add_mod(rows[-1], vs[..., t, :], q))
        out = jnp.stack(rows, axis=-2)
    else:
        rows = [vs[..., 0, :]]
        for t in range(1, p - 1):
            rows.append(zq.sub_mod(vs[..., t, :], vs[..., t - 1, :], q))
        out = jnp.stack(rows, axis=-2)
    return out.reshape(*lead, pp.phi)


def l(plan: GeneralPlan, x):
    """Decoding -> powerful (Lol Tensor.l): per-odd-axis prefix sums."""
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2 or ax.phi == 1:
            continue
        x = _apply_axis(plan, x, i, lambda v, a=ax: _l_axis(v, a.pp, plan.q, False))
    return x


def l_inv(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2 or ax.phi == 1:
            continue
        x = _apply_axis(plan, x, i, lambda v, a=ax: _l_axis(v, a.pp, plan.q, True))
    return x


# --- mulG / divG -----------------------------------------------------------


def _mul_g_axis_pow(v, pp: PrimePower, q):
    """(g_p * x) on the p^e axis, powerful basis.  With the axis viewed as
    (t, r), t < p-1, r < p^{e-1}:
      (zeta_p x)[t, r] = x[t-1, r] (t>=1) - x[p-2, r]
      (g x) = x - zeta_p x."""
    p, e = pp.p, pp.e
    lead = v.shape[:-1]
    vs = v.reshape(*lead, p - 1, p ** (e - 1))
    top = vs[..., p - 2, :]
    shifted = jnp.concatenate(
        [jnp.zeros_like(vs[..., :1, :]), vs[..., : p - 2, :]], axis=-2
    )
    zx = zq.sub_mod(shifted, top[..., None, :], q)
    out = zq.sub_mod(vs, zx, q)
    return out.reshape(*lead, pp.phi)


@lru_cache(maxsize=256)
def _g_matrices(p: int, e: int, q: int):
    """Per-axis matrices: G_pow (mult by g_p), its inverse, and the dec
    conjugates L^-1 G L — all (phi, phi) uint32, host-built via the
    stencil applied to basis vectors.

    lru_cached + runs jnp ops: the ExitStack pins compile-time eval so a
    first call from inside an outer jit trace cannot capture tracers."""
    import jax as _jax

    with _jax.ensure_compile_time_eval():
        return _g_matrices_impl(p, e, q)


def _g_matrices_impl(p: int, e: int, q: int):
    pp = PrimePower(p, e)
    phi = pp.phi
    eye = np.eye(phi, dtype=np.uint32)
    cols = []
    for j in range(phi):
        col = np.asarray(
            _mul_g_axis_pow(jnp.asarray(eye[j][None]), pp, q)
        )[0]
        cols.append(col)
    G = np.stack(cols, axis=1).astype(np.uint32)
    Ginv = _mat_inv_mod(G, q)
    # L matrix for the dec conjugation
    Lm = np.zeros((phi, phi), dtype=np.uint32)
    for j in range(phi):
        Lm[:, j] = np.asarray(
            _l_axis(jnp.asarray(eye[j][None]), pp, q, False)
        )[0]
    Linv = _mat_inv_mod(Lm, q)
    Gdec = (Linv.astype(np.int64) @ (G.astype(np.int64) @ Lm % q) % q).astype(
        np.uint32
    )
    Gdec_inv = _mat_inv_mod(Gdec, q)
    return G, Ginv, Gdec, Gdec_inv


def mul_g_pow(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2:
            continue
        x = _apply_axis(plan, x, i, lambda v, a=ax: _mul_g_axis_pow(v, a.pp, plan.q))
    return x


def div_g_pow(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2:
            continue
        Ginv = _g_matrices(ax.pp.p, ax.pp.e, plan.q)[1]
        x = _apply_axis(
            plan, x, i, lambda v, G=Ginv: matvec_mod_jnp(jnp.asarray(G), v, plan.q)
        )
    return x


def mul_g_dec(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2:
            continue
        Gd = _g_matrices(ax.pp.p, ax.pp.e, plan.q)[2]
        x = _apply_axis(
            plan, x, i, lambda v, G=Gd: matvec_mod_jnp(jnp.asarray(G), v, plan.q)
        )
    return x


def div_g_dec(plan: GeneralPlan, x):
    for i, ax in enumerate(plan.axes):
        if ax.pp.p == 2:
            continue
        Gdi = _g_matrices(ax.pp.p, ax.pp.e, plan.q)[3]
        x = _apply_axis(
            plan, x, i, lambda v, G=Gdi: matvec_mod_jnp(jnp.asarray(G), v, plan.q)
        )
    return x


@lru_cache(maxsize=512)
def _g_crt_vec(m: int, q: int) -> np.ndarray:
    """CRT(g) as a flat length-phi(m) vector in canonical slot order."""
    if m == 1:
        return np.ones(1, dtype=np.uint32)
    plan = general_plan(m, q)
    per_axis = []
    for ax in plan.axes:
        if ax.pp.p == 2:
            per_axis.append(np.ones(ax.phi, dtype=np.int64))
            continue
        p, e = ax.pp.p, ax.pp.e
        omega = nt.principal_root_of_unity(m, q)
        w = pow(omega, m // (p**e), q)  # p^e-th root
        wp = pow(w, p ** (e - 1), q)  # p-th root = image of zeta_p
        per_axis.append(
            np.array([(1 - pow(wp, int(u), q)) % q for u in ax.units],
                     dtype=np.int64)
        )
    out = per_axis[0]
    for v in per_axis[1:]:
        out = np.multiply.outer(out, v) % q
    return out.reshape(-1).astype(np.uint32)


def mul_g_crt(plan: GeneralPlan, x):
    v = jnp.asarray(_g_crt_vec(plan.fm.m, plan.q))
    return zq.mul_mod(x, v, plan.q)


def div_g_crt(plan: GeneralPlan, x):
    gv = _g_crt_vec(plan.fm.m, plan.q)
    vinv = np.array([nt.modinv(int(v), plan.q) for v in gv], dtype=np.uint32)
    return zq.mul_mod(x, jnp.asarray(vinv), plan.q)


# ---------------------------------------------------------------------------
# embed / twace index tables (general m' | m)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=512)
def embed_pow_table(m_sub: int, m_sup: int) -> np.ndarray:
    """Flat scatter table: embedded coeff position of each sub coeff.

    Per-axis: for p in both: j = j' * p^(e-e'); p only in sup: j = 0."""
    fs, fS = fact(m_sub), fact(m_sup)
    if m_sup % m_sub != 0:
        raise ValueError("embed: need m_sub | m_sup")
    sub_pp = {pp.p: pp for pp in fs.pps}
    axis_maps = []
    for pp in fS.pps:
        if pp.p in sub_pp:
            e_sub = sub_pp[pp.p].e
            stride = pp.p ** (pp.e - e_sub)
            axis_maps.append(np.arange(sub_pp[pp.p].phi) * stride)
        else:
            axis_maps.append(np.array([0]))
    # flat index of sup tensor for each sub multi-index
    sup_shape = fS.phi_shape
    strides = np.ones(len(sup_shape), dtype=np.int64)
    for a in range(len(sup_shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * sup_shape[a + 1]
    grids = np.meshgrid(*axis_maps, indexing="ij")
    flat = sum(g * s for g, s in zip(grids, strides))
    return flat.reshape(-1).astype(np.int64)


@lru_cache(maxsize=512)
def crt_embed_table(m_sub: int, m_sup: int, q: int) -> np.ndarray:
    """tbl[sup_slot] = sub_slot whose unit is u mod m_sub."""
    ps = general_plan(m_sub, q)
    pS = general_plan(m_sup, q)
    sub_units = _global_units(ps)
    sup_units = _global_units(pS)
    pos = {int(u): i for i, u in enumerate(sub_units)}
    return np.array([pos[int(u) % m_sub] for u in sup_units], dtype=np.int64)


def _global_units(plan: GeneralPlan) -> np.ndarray:
    """Flat slot order -> unit of (Z/m)^* via per-axis CRT combine."""
    m = plan.fm.m
    if m == 1:
        return np.array([0], dtype=np.int64)
    parts = []
    for ax in plan.axes:
        pe = ax.pp.value
        mi = m // pe
        # CRT coefficient: x = sum u_i * M_i * [M_i^-1]_{p^e}
        c = mi * nt.modinv(mi % pe, pe) % m
        parts.append((ax.units % pe) * c % m)
    out = parts[0]
    for v in parts[1:]:
        out = np.add.outer(out, v) % m
    return out.reshape(-1) % m


def embed_pow(m_sub: int, m_sup: int, x):
    tbl = embed_pow_table(m_sub, m_sup)
    n_sup = fact(m_sup).phi
    out = jnp.zeros((*x.shape[:-1], n_sup), dtype=x.dtype)
    return out.at[..., jnp.asarray(tbl)].set(x)


def twace_pow(m_sub: int, m_sup: int, x):
    """Projection onto the embedded coefficient positions."""
    tbl = jnp.asarray(embed_pow_table(m_sub, m_sup))
    return x[..., tbl]


def embed_crt(m_sub: int, m_sup: int, q: int, x):
    tbl = jnp.asarray(crt_embed_table(m_sub, m_sup, q))
    return x[..., tbl]


@lru_cache(maxsize=512)
def twace_crt_twists(m_sub: int, m_sup: int, q: int):
    """(pre, post) uint32 twist vectors for the CRT tweaked trace:
    pre[u] = t(u)^-1 = g(u) * mhat^-1 ; post[u'] = t'(u') = mhat' * g'(u')^-1."""
    g_sup = _g_crt_vec(m_sup, q).astype(np.int64)
    g_sub = _g_crt_vec(m_sub, q).astype(np.int64)
    mh_inv = nt.modinv(fact(m_sup).mhat % q, q)
    pre = (g_sup * mh_inv % q).astype(np.uint32)
    mh_sub = fact(m_sub).mhat % q
    post = np.array(
        [mh_sub * nt.modinv(int(v), q) % q for v in g_sub], dtype=np.uint32
    )
    return pre, post


def twace_crt(m_sub: int, m_sup: int, q: int, x):
    """Tweaked trace in CRT: Tw(x) = t' * Tr(x / t) with twists
    t = mhat/g per ring: pointwise-divide by CRT(t), coset-sum,
    pointwise-multiply by CRT(t').  (Matches the pow-basis projection;
    for 2-power towers it degenerates to the coset mean.)"""
    tbl = crt_embed_table(m_sub, m_sup, q)
    n_sub = fact(m_sub).phi
    k = fact(m_sup).phi // n_sub
    pre, post = twace_crt_twists(m_sub, m_sup, q)
    y = zq.mul_mod(x, jnp.asarray(pre), q)
    order = np.argsort(tbl, kind="stable")
    g = y[..., jnp.asarray(order)].reshape(*x.shape[:-1], n_sub, k)
    s = g[..., 0]
    for j in range(1, k):
        s = zq.add_mod(s, g[..., j], q)
    return zq.mul_mod(s, jnp.asarray(post), q)


# ---------------------------------------------------------------------------
# relative coefficient decomposition (Lol Tensor.coeffs / powBasisPow)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=512)
def rel_coeff_table(m_sub: int, m_sup: int) -> np.ndarray:
    """(d, n_sub) table with T[rel, sub] = sup flat coefficient position:
    x = sum_rel b_rel * embed(a_rel) where a_rel's coefficients are
    gathered from x's at T[rel, :], and b_rel is the rel-th element of the
    relative powerful basis (a monomial; exponents via per-axis split).

    Per-axis: p in both rings: j = j'* p^(e-e') + i, i < p^(e-e');
    p only in sup: j = i over the whole axis.  The same table serves the
    powerful and decoding bases (L acts only on the prime level, which
    lives in the sub part)."""
    fs, fS = fact(m_sub), fact(m_sup)
    if m_sup % m_sub != 0:
        raise ValueError("rel_coeff_table: need m_sub | m_sup")
    sub_pp = {pp.p: pp for pp in fs.pps}
    sup_shape = fS.phi_shape
    strides = np.ones(len(sup_shape), dtype=np.int64)
    for a in range(len(sup_shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * sup_shape[a + 1]
    # per-axis: arrays of (rel_range, sub_range) -> axis index contribution
    rel_ranges, sub_ranges, axis_fn = [], [], []
    for ax, pp in enumerate(fS.pps):
        if pp.p in sub_pp:
            ratio = pp.p ** (pp.e - sub_pp[pp.p].e)
            rel_ranges.append(ratio)
            sub_ranges.append(sub_pp[pp.p].phi)
            axis_fn.append(lambda i, j, r=ratio: j * r + i)
        else:
            rel_ranges.append(pp.phi)
            sub_ranges.append(1)
            axis_fn.append(lambda i, j: i)
    d = int(np.prod(rel_ranges))
    n_sub = int(np.prod(sub_ranges))
    T = np.empty((d, n_sub), dtype=np.int64)
    for rf in range(d):
        ri = np.unravel_index(rf, rel_ranges)
        for sf in range(n_sub):
            si = np.unravel_index(sf, sub_ranges)
            flat = sum(
                int(fn(int(i), int(j))) * int(s)
                for fn, i, j, s in zip(axis_fn, ri, si, strides)
            )
            T[rf, sf] = flat
    return T


@lru_cache(maxsize=512)
def rel_pow_basis_positions(m_sub: int, m_sup: int) -> np.ndarray:
    """Flat sup coefficient position of each relative powerful basis
    monomial b_rel (= T[rel, sub=0]); Lol powBasisPow."""
    return rel_coeff_table(m_sub, m_sup)[:, 0].copy()


def coeffs_rel(m_sub: int, m_sup: int, x):
    """(..., n_sup) -> (d, ..., n_sub) relative coefficients (pow or dec
    coeffs of x, same table for both bases)."""
    T = jnp.asarray(rel_coeff_table(m_sub, m_sup))
    return jnp.moveaxis(x[..., T], -2, 0)


# ---------------------------------------------------------------------------
# real/embedding geometry: decoding-basis Gram matrices (host, f64->int)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
def _dec_basis_complex(m: int) -> np.ndarray:
    """(n, n) complex matrix E with E[u_idx, j] = sigma_u(d_j): the
    canonical embedding of the decoding basis, built from the powerful
    basis embedding and the per-axis L matrices (dec = pow @ L).
    lru_cached + runs jnp ops: pin compile-time eval (see _g_matrices)."""
    import jax as _jax

    with _jax.ensure_compile_time_eval():
        return _dec_basis_complex_impl(m)


def _dec_basis_complex_impl(m: int) -> np.ndarray:
    f = fact(m)
    n = f.phi
    # powerful-basis exponents E(j)
    shape = f.phi_shape
    exps = np.zeros(n, dtype=np.int64)
    for flat in range(n):
        idx = np.unravel_index(flat, shape)
        exps[flat] = sum(int(j) * (m // pp.value) for j, pp in zip(idx, f.pps)) % m
    units = np.array(
        [u for u in range(max(m, 1)) if np.gcd(u, m) == 1] or [0],
        dtype=np.int64,
    )
    mm = max(m, 1)
    P = np.exp(2j * np.pi * (np.outer(units, exps) % mm) / mm)  # (n, n)
    # dec basis: d = sum_j pow_j * Lmat[j, i]? pow coeffs of dec elt i are
    # L applied to the indicator: dec_i = sum_j L[j, i]-ish; reuse the jnp
    # L on identity over a big prime to extract the integer matrix
    # (one batched call: rows of eye are the batch axis).
    q = nt.ntt_primes(max(m, 2) if m % 2 else m, 30, 1)[0] if m > 2 else 7681
    plan = general_plan(m, q) if m > 1 else None
    eye = np.eye(n, dtype=np.uint32)
    if m > 1:
        Lm = np.asarray(l(plan, jnp.asarray(eye))).T
    else:
        Lm = eye
    # entries of Lm are 0/1 integers mod q: safe to cast
    Lint = Lm.astype(np.int64)
    assert Lint.max() <= 1, "L matrix should be 0/1"
    return P @ Lint


@lru_cache(maxsize=256)
def _axis_gram_real(p: int, e: int, with_g: bool) -> np.ndarray:
    """Real Gram of the p^e-axis decoding basis under the canonical
    embedding (= the full Gram of the single-axis ring m = p^e),
    optionally twisted by sigma(1 - zeta_p) — the g factor this axis
    contributes (p = 2 contributes none)."""
    pe = p**e
    E = _dec_basis_complex(pe)
    if with_g and p != 2:
        units = np.array([u for u in range(pe) if u % p != 0], dtype=np.int64)
        gv = 1 - np.exp(2j * np.pi * ((units * (pe // p)) % pe) / pe)
        E = E * gv[:, None]
    return (E.conj().T @ E).real


@lru_cache(maxsize=256)
def gram_g_dec(m: int) -> np.ndarray:
    """Integer Gram matrix G with ||g x||^2 = x^T G x for x in the
    decoding basis (canonical-embedding norm; Lol gSqNormDec's form).

    Built as the exact integer Kronecker product of per-axis Grams:
    the canonical embedding of the decoding basis factors per prime
    power under the CRT unit indexing (row-major over phi_shape), and
    g = prod_{odd p}(1 - zeta_p) contributes one twist per odd axis —
    so Gram_g(m) = kron_i Gram_g(p_i^{e_i}) entry-for-entry.  Same
    matrix as the dense E^H E construction (asserted by
    tests/test_general.py), but integrality is certified per small
    axis and the dense phi(m)^2 complex matrix is never formed."""
    f = fact(m)
    out = np.ones((1, 1), dtype=np.int64)
    for pp in f.pps:
        G = _axis_gram_real(pp.p, pp.e, True)
        Gi = np.rint(G).astype(np.int64)
        tol = max(1e-6, 1e-12 * float(np.max(np.abs(G))) * pp.phi)
        assert np.max(np.abs(G - Gi)) < min(tol, 0.4), "axis Gram not integral"
        out = np.kron(out, Gi)
    return out


@lru_cache(maxsize=256)
def dec_mixing_factors(m: int) -> tuple[np.ndarray, ...]:
    """Per-axis Gaussian mixing factors L_i with kron_i L_i == the dense
    decoding-basis mixing matrix cholesky(Gram_dec(m)^{-1}).

    SURVEY §1's thesis — every linear operation factors as a tensor
    product of per-prime-power transforms — applies to the sampler's
    mixing matrix too: Gram_dec(m) = kron_i Gram_i exactly (per-axis
    embeddings under CRT unit indexing), and both inverse and Cholesky
    distribute over Kronecker products (chol(A (x) B) = chol(A) (x)
    chol(B): both sides are lower-triangular with positive diagonal and
    square to the same matrix, and that factor is unique).  Setup cost
    drops from O(phi(m)^3) — ~104 s of gen_sk at m = 18432 in
    BENCH_r03 — to O(sum_i phi_i^3), microseconds (VERDICT r3 #2)."""
    f = fact(m)
    out = []
    for pp in f.pps:
        if pp.p == 2:
            # 2-power axis: the power basis is orthogonal, Gram = phi*I
            out.append(np.eye(pp.phi) / np.sqrt(pp.phi))
        else:
            gram = _axis_gram_real(pp.p, pp.e, False)
            out.append(np.linalg.cholesky(np.linalg.inv(gram)))
    return tuple(out)

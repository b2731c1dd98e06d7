"""Negacyclic NTT for 2-power cyclotomics — the hot transform.

Replacement for the reference's C++ CRT kernels in the p=2
specialization (`lol-cpp .../crt.cpp`, SURVEY.md §3.3): for m = 2^(k+1),
R_q = Z_q[x]/(x^n + 1) with n = 2^k, and the CRT basis transform is the
negacyclic (psi-twisted) NTT.

Design notes:

- No bit-reversal permutations ever: the forward transform is
  decimation-in-time (natural order in, bit-reversed out) and the inverse
  is decimation-in-frequency (bit-reversed in, natural out), so the CRT
  domain simply *is* bit-reversed-exponent order.  Pointwise ring
  multiplication doesn't care; index tables that do (twace/embed in CRT
  basis) use `crt_output_exponents` below.
- Each butterfly stage is a fully-vectorized elementwise op over the whole
  array — a (m, 2, t) reshape + one Shoup modmul + modadd/sub.  The
  network transforms axis 0 (`ntt_forward_cm`: the batched pipeline's
  coefficient-major (n, B) layout, no transpose); the row-major (..., n)
  form (`ntt_forward_stages`) transposes around it.  The fused GPU
  kernel (ops/pallas/ntt_triton.py) runs the same network.
- Twiddles are precomputed with Shoup companions at plan-build time
  (exact host integers), one plan per (n, q), cached.

Output-order spec (verified by tests against direct evaluation):
forward(a)[i] = a(psi^(2*brv_k(i)+1)) where psi is the principal 2n-th
root used by the plan and brv_k is k-bit reversal.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import numtheory as nt
from .. import zq


def _bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def _pow_table(base: int, exps: np.ndarray, q: int) -> np.ndarray:
    return np.array([pow(base, int(e), q) for e in exps], dtype=np.uint32)


@dataclass(frozen=True, eq=True)
class NTTPlan:
    """Twiddle tables for one (n, q); arrays are host numpy (static)."""

    n: int
    q: int
    psi: int  # principal 2n-th root of unity mod q
    # psi_rev[i] = psi^brv(i); inv tables for psi^-1; all with Shoup words
    psi_rev: np.ndarray
    psi_rev_sh: np.ndarray
    ipsi_rev: np.ndarray
    ipsi_rev_sh: np.ndarray
    n_inv: int
    n_inv_sh: int

    def __hash__(self):
        return hash(("NTTPlan", self.n, self.q))


@lru_cache(maxsize=256)
def ntt_plan(n: int, q: int, psi: int | None = None) -> NTTPlan:
    """Build (and cache) the negacyclic NTT plan for x^n+1 over Z_q.

    Requires q prime with 2n | q-1.  If psi is not given, a canonical
    principal 2n-th root is chosen (deterministic: derived from the
    smallest primitive root), so plans are reproducible across backends.
    """
    if n & (n - 1) or n < 1:
        raise ValueError(f"ntt_plan: n={n} must be a power of 2")
    if (q - 1) % (2 * n) != 0:
        raise ValueError(f"ntt_plan: need 2n={2 * n} | q-1={q - 1}")
    if psi is None:
        psi = nt.principal_root_of_unity(2 * n, q)
    rev = _bit_reverse_perm(n)
    psi_rev = _pow_table(psi, rev, q)
    ipsi = nt.modinv(psi, q)
    ipsi_rev = _pow_table(ipsi, rev, q)
    n_inv = nt.modinv(n, q)
    return NTTPlan(
        n=n,
        q=q,
        psi=psi,
        psi_rev=psi_rev,
        psi_rev_sh=np.array([zq.shoup(int(w), q) for w in psi_rev], dtype=np.uint32),
        ipsi_rev=ipsi_rev,
        ipsi_rev_sh=np.array([zq.shoup(int(w), q) for w in ipsi_rev], dtype=np.uint32),
        n_inv=n_inv,
        n_inv_sh=zq.shoup(n_inv, q),
    )


def crt_output_exponents(n: int) -> np.ndarray:
    """exponent e(i) with forward(a)[i] = a(psi^e(i)): e = 2*brv(i)+1."""
    return 2 * _bit_reverse_perm(n) + 1


def block_twiddles(plan: NTTPlan, inverse: bool, S: int, tS: int) -> np.ndarray:
    """(n // tS, tS) per-block tables for the stages after the first S.

    After S stages the DIT network stays within contiguous tS-row
    blocks.  Block b's table has the standard DIT layout: rows
    [2^sp, 2^(sp+1)) hold the local-stage-sp group twiddles, which for
    global stage s = S+sp and block b are src[2^s + b*2^sp + i']."""
    k = plan.n.bit_length() - 1
    src = plan.ipsi_rev if inverse else plan.psi_rev
    nblk = plan.n // tS
    T = np.zeros((nblk, tS), dtype=np.uint32)
    for sp in range(k - S):
        mp = 1 << sp
        base = 1 << (S + sp)
        for b in range(nblk):
            T[b, mp : 2 * mp] = src[base + b * mp : base + (b + 1) * mp]
    return T


def redigit(x, q_src: int, q: int):
    """RNS-gadget digit re-expansion: x holds residues in [0, q_src);
    emit the centered representative's residue mod q (bit-identical to
    she_batched.decompose_cm's per-channel arithmetic)."""
    if q_src == q:
        return x
    r = zq.reduce_mod(x, q) if q_src > q else x
    hi = x >= jnp.uint32((q_src + 1) // 2)
    return jnp.where(hi, zq.sub_mod(r, jnp.uint32(q_src % q), q), r)


# ---------------------------------------------------------------------------
# staged jnp implementation (the XLA path and the kernel's reference)
# ---------------------------------------------------------------------------


def ntt_forward_cm(x, plan: NTTPlan):
    """Forward negacyclic NTT over axis 0 of a coefficient-major (n, ...)
    array (natural in, brv out)."""
    n, q = plan.n, plan.q
    rest = x.shape[1:]
    pad = (1,) * len(rest)
    for s in range(n.bit_length() - 1):
        m = 1 << s
        t = n >> (s + 1)
        w = jnp.asarray(plan.psi_rev[m : 2 * m]).reshape(m, 1, *pad)
        w_sh = jnp.asarray(plan.psi_rev_sh[m : 2 * m]).reshape(m, 1, *pad)
        x = x.reshape(m, 2, t, *rest)
        u = x[:, 0]
        v = zq.mul_mod_shoup(x[:, 1], w, w_sh, q)
        x = jnp.stack([zq.add_mod(u, v, q), zq.sub_mod(u, v, q)], axis=1)
        x = x.reshape(n, *rest)
    return x


def ntt_inverse_cm(x, plan: NTTPlan):
    """Inverse negacyclic NTT over axis 0 of a coefficient-major array
    (brv in, natural out)."""
    n, q = plan.n, plan.q
    rest = x.shape[1:]
    pad = (1,) * len(rest)
    for s in reversed(range(n.bit_length() - 1)):
        h = 1 << s
        t = n >> (s + 1)
        w = jnp.asarray(plan.ipsi_rev[h : 2 * h]).reshape(h, 1, *pad)
        w_sh = jnp.asarray(plan.ipsi_rev_sh[h : 2 * h]).reshape(h, 1, *pad)
        x = x.reshape(h, 2, t, *rest)
        u = x[:, 0]
        v = x[:, 1]
        x = jnp.stack(
            [zq.add_mod(u, v, q), zq.mul_mod_shoup(zq.sub_mod(u, v, q), w, w_sh, q)],
            axis=1,
        ).reshape(n, *rest)
    return zq.mul_mod_shoup(x, jnp.uint32(plan.n_inv), jnp.uint32(plan.n_inv_sh), q)


def ntt_forward_stages(x, plan: NTTPlan):
    """Forward negacyclic NTT over the last axis (natural in, brv out)."""
    return jnp.moveaxis(ntt_forward_cm(jnp.moveaxis(x, -1, 0), plan), 0, -1)


def ntt_inverse_stages(x, plan: NTTPlan):
    """Inverse negacyclic NTT over the last axis (brv in, natural out)."""
    return jnp.moveaxis(ntt_inverse_cm(jnp.moveaxis(x, -1, 0), plan), 0, -1)


@lru_cache(maxsize=256)
def _jit_fwd(plan: NTTPlan):
    return jax.jit(partial(ntt_forward_stages, plan=plan))


@lru_cache(maxsize=256)
def _jit_inv(plan: NTTPlan):
    return jax.jit(partial(ntt_inverse_stages, plan=plan))


def ntt_forward(x, plan: NTTPlan):
    return _jit_fwd(plan)(x)


def ntt_inverse(x, plan: NTTPlan):
    return _jit_inv(plan)(x)


# ---------------------------------------------------------------------------
# exact numpy mirror (oracle; same algorithm, int64 arithmetic)
# ---------------------------------------------------------------------------


def np_ntt_forward(x: np.ndarray, plan: NTTPlan) -> np.ndarray:
    n, q = plan.n, plan.q
    x = x.astype(np.int64) % q
    k = n.bit_length() - 1
    batch = x.shape[:-1]
    for s in range(k):
        m = 1 << s
        t = n >> (s + 1)
        w = plan.psi_rev[m : 2 * m].astype(np.int64)[:, None]
        x = x.reshape(*batch, m, 2, t)
        u, v = x[..., 0, :], x[..., 1, :] * w % q
        x = np.stack([(u + v) % q, (u - v) % q], axis=-2).reshape(*batch, n)
    return x.astype(np.uint32)


def np_ntt_inverse(x: np.ndarray, plan: NTTPlan) -> np.ndarray:
    n, q = plan.n, plan.q
    x = x.astype(np.int64) % q
    k = n.bit_length() - 1
    batch = x.shape[:-1]
    for s in reversed(range(k)):
        h = 1 << s
        t = n >> (s + 1)
        w = plan.ipsi_rev[h : 2 * h].astype(np.int64)[:, None]
        x = x.reshape(*batch, h, 2, t)
        u, v = x[..., 0, :], x[..., 1, :]
        x = np.stack([(u + v) % q, (u - v) * w % q], axis=-2).reshape(*batch, n)
    return (x * plan.n_inv % q).astype(np.uint32)


def np_negacyclic_mul_schoolbook(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """O(n^2) schoolbook product in Z_q[x]/(x^n+1) — the independent oracle."""
    n = a.shape[-1]
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    out = np.zeros(n, dtype=np.int64)
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] = (out[k] + a[i] * b[j]) % q
            else:
                out[k - n] = (out[k - n] - a[i] * b[j]) % q
    return (out % q).astype(np.uint32)

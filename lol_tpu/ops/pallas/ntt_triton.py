"""Fused negacyclic NTT for the GPU: Pallas through Triton.

The kernel runs the same stage network as ops/ntt.py, with the same
`zq` arithmetic, so its results are bit-exact with the staged XLA path
and the numpy oracle.  The network's log2(n) radix-2 stages are
regrouped into a few radix-2^r passes:

- Data stays coefficient-major, (n, B) with the batch contiguous.  For
  a pass over global stages s .. s+r-1 the free reshape
  (2^s, 2^r, n >> (s+r), B) puts every independent radix-2^r butterfly
  network on one (group, offset) pair: its 2^r rows are strided by
  n >> (s+r), and each row is contiguous along the batch.
- One program loads those 2^r rows of a `slab`-wide batch slice as an
  unrolled list of (slab,) row vectors, runs r butterfly stages in
  registers and stores them back.  There is no reshape inside the
  kernel, and every load and store is a contiguous row.
- The pass's twiddles ride as a compact (2^s, 2^r) table: row g holds
  the group twiddles program g needs, each read as a scalar.  Shoup
  companions arrive pre-split into 16-bit halves (zq.mul_shoup_lazy).
- Values stay in Harvey's lazy ranges between stages and passes
  ([0, 4q) forward, [0, 2q) inverse) and are fully reduced once at the
  end.  The forward's first pass can fuse the RNS-gadget digit
  re-expansion (`pre_digit_q`), and the inverse's last stage carries
  the 1/n scale folded into its butterflies.
- The modulus and the scalar constants are a small runtime operand, not
  compiled in, so every prime of an RNS chain runs the same kernel and
  XLA compiles each pass shape once per program.  Kernel compile time
  grows steeply with the radix (on an H100: about 0.5 s per kernel at
  r=3, 1.8 s at r=4, 5.6 s at r=5, 50 s at r=6), which bounds r.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt
from jax.sharding import PartitionSpec as P

from ... import zq
from ..ntt import NTTPlan, redigit

SLAB = 128  # batch columns per program
RMAX = 4  # largest fused radix log2 (see the module docstring)
NUM_WARPS = 4


def pass_sizes(k: int, rmax: int) -> list[int]:
    """Split k stages into the fewest passes of at most rmax, as even as
    possible (larger passes first)."""
    npass = -(-k // rmax)
    base, extra = divmod(k, npass)
    return [base + (i < extra) for i in range(npass)]


def pass_table(src: np.ndarray, s: int, r: int) -> np.ndarray:
    """(2^s, 2^r) twiddles of a pass over global stages s .. s+r-1:
    row g, column 2^j + c holds src[2^(s+j) + g*2^j + c], the twiddle of
    inner stage j's butterfly group c in program g (column 0 unused)."""
    m = 1 << s
    T = np.zeros((m, 1 << r), dtype=np.uint32)
    g = np.arange(m)[:, None]
    for j in range(r):
        c = np.arange(1 << j)
        T[:, (1 << j) + c] = src[(1 << (s + j)) + g * (1 << j) + c[None, :]]
    return T


def _bf_fwd(u, v, w, q):
    """DIT butterfly, lazy: inputs and outputs in [0, 4q)."""
    q2 = 2 * q
    t = zq.mul_shoup_lazy(v, *w, q)
    uu = jnp.where(u >= q2, u - q2, u)
    return uu + t, uu + (q2 - t)


def _bf_inv(u, v, w, q):
    """GS butterfly, lazy: inputs and outputs in [0, 2q)."""
    q2 = 2 * q
    s = u + v
    s = jnp.where(s >= q2, s - q2, s)
    return s, zq.mul_shoup_lazy(u + (q2 - v), *w, q)


def _bf_inv_scaled(u, v, ninv, w0s, q):
    """Global stage 0 of the GS inverse with the 1/n scale folded in:
    u' = (u+v) / n, v' = (u-v) * w0 / n; outputs in [0, 2q)."""
    return (zq.mul_shoup_lazy(u + v, *ninv, q),
            zq.mul_shoup_lazy(u + (2 * q - v), *w0s, q))


def _fold(x, q, bound):
    """[0, bound*q) -> [0, q) for bound in {2, 4}."""
    if bound == 4:
        x = jnp.where(x >= 2 * q, x - 2 * q, x)
    return jnp.where(x >= q, x - q, x)


# runtime constants operand: slot -> meaning
_Q, _HALF, _SHIFT, _MU, _NINV, _W0S = 0, 1, 2, 3, 4, 7  # _NINV/_W0S: 3 each


def _redigit(x, q, half, shift, mu, k):
    """ops/ntt.redigit with the source modulus's constants as runtime
    scalars; k is q's bit length when the source modulus is larger (a
    Barrett reduction first), else None."""
    r = x if k is None else zq.reduce_mod(x, q, k=k, mu=mu)
    return jnp.where(x >= half, zq.sub_mod(r, shift, q), r)


def _kernel(c_ref, x_ref, w_ref, wh_ref, wl_ref, o_ref, *, r, inverse, pre,
            pre_k, fold, last):
    """One pass: x_ref is the (2^r, slab) block of one butterfly network;
    c_ref holds the modulus and scalar constants (see _consts)."""
    R = 1 << r
    q = c_ref[_Q]
    rows = [x_ref[i, :] for i in range(R)]
    if pre:
        c = (c_ref[_HALF], c_ref[_SHIFT], c_ref[_MU])
        rows = [_redigit(v, q, *c, pre_k) for v in rows]
    if fold:
        ninv = tuple(c_ref[_NINV + i] for i in range(3))
        w0s = tuple(c_ref[_W0S + i] for i in range(3))
    order = range(r - 1, -1, -1) if inverse else range(r)
    for j in order:
        step = 1 << (r - 1 - j)
        for iu in range(R):
            if iu & step:
                continue
            iv = iu | step
            if fold and j == 0:
                rows[iu], rows[iv] = _bf_inv_scaled(rows[iu], rows[iv], ninv,
                                                    w0s, q)
                continue
            idx = (1 << j) + (iu >> (r - j))
            w = (w_ref[idx], wh_ref[idx], wl_ref[idx])
            bf = _bf_inv if inverse else _bf_fwd
            rows[iu], rows[iv] = bf(rows[iu], rows[iv], w, q)
    for i in range(R):
        o_ref[i, :] = _fold(rows[i], q, 2 if inverse else 4) if last else rows[i]


def _shoup_split(w: int, q: int) -> list[int]:
    sh = zq.shoup(w, q)
    return [w, sh >> 16, sh & 0xFFFF]


def _consts(plan: NTTPlan, pre_q: int | None) -> np.ndarray:
    """The kernel's runtime constants: q, the digit prologue's
    ((pre_q+1)//2, pre_q mod q, barrett_mu(q)) and the inverse's folded
    scale (n^-1 and ipsi_rev[1] * n^-1, each with Shoup halves)."""
    q = plan.q
    c = np.zeros(16, dtype=np.uint32)
    c[_Q] = q
    if pre_q is not None:
        c[_HALF:_MU + 1] = [(pre_q + 1) // 2, pre_q % q, zq.barrett_mu(q)]
    w0s = int(plan.ipsi_rev[1]) * plan.n_inv % q
    c[_NINV:_NINV + 3] = _shoup_split(plan.n_inv, q)
    c[_W0S:_W0S + 3] = _shoup_split(w0s, q)
    return c


@lru_cache(maxsize=512)
def _pass_call(n: int, s: int, r: int, slab: int,
               inverse: bool, pre: bool, pre_k: int | None, last: bool,
               interpret: bool):
    """One pass as a jitted (consts, x, w, wh, wl) -> x' over (n, B).

    Nothing plan-specific is compiled in and the kernel is traced once,
    here, so every prime and call site lowers to the identical kernel
    (source locations included) and XLA compiles it once per program."""
    m, R, t = 1 << s, 1 << r, n >> (s + r)
    kern = partial(_kernel, r=r, inverse=inverse, pre=pre, pre_k=pre_k,
                   fold=inverse and last, last=last)
    data = pl.BlockSpec((None, R, None, slab), lambda g, o, j: (g, 0, o, j))
    tab = pl.BlockSpec((None, R), lambda g, o, j: (g, 0))
    cst = pl.BlockSpec((16,), lambda g, o, j: (0,))

    def one_pass(c, x, w, wh, wl):
        # a batch that is not a multiple of the slab gets zero columns,
        # cut off again below
        B = x.shape[1]
        pad = -B % slab
        if pad:
            x = jnp.pad(x, ((0, 0), (0, pad)))
        Bp = B + pad
        call = pl.pallas_call(
            kern,
            out_shape=jax.ShapeDtypeStruct((m, R, t, Bp), jnp.uint32),
            grid=(m, t, Bp // slab),
            in_specs=[cst, data, tab, tab, tab],
            out_specs=data,
            backend="triton",
            compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                               num_stages=1),
            interpret=interpret,
            name=f"ntt_{'inv' if inverse else 'fwd'}_n{n}_s{s}_r{r}",
        )
        y = call(c, x.reshape(m, R, t, Bp), w, wh, wl).reshape(n, Bp)
        return y[:, :B] if pad else y

    return jax.jit(one_pass)


@lru_cache(maxsize=512)
def _plan_tables(plan: NTTPlan, inverse: bool, pre_q: int | None, rmax: int):
    """Per-pass (start stage, radix log2, twiddle tables) and the
    runtime constants of one transform."""
    q = plan.q
    k = plan.n.bit_length() - 1
    sizes = pass_sizes(k, rmax)
    starts = np.cumsum([0] + sizes[:-1]).tolist()
    if inverse:  # GS runs the stages high -> low
        starts = [k - s - r for s, r in zip(starts, sizes)]
    src = plan.ipsi_rev if inverse else plan.psi_rev
    passes = []
    for s, r in zip(starts, sizes):
        w = pass_table(src, s, r)
        sh = zq.shoup_np(w, q)
        passes.append((s, r, (w, sh >> 16, sh & 0xFFFF)))
    return passes, _consts(plan, pre_q)


def ntt_cm(x, plan: NTTPlan, inverse: bool = False,
           pre_digit_q: int | None = None, *, mesh=None, slab: int = SLAB,
           interpret: bool = False):
    """Negacyclic NTT over axis 0 of a coefficient-major (n, B) u32 array.

    pre_digit_q (forward only): the input holds residues mod pre_digit_q;
    transform their centered re-expansion into this plan's modulus.  A
    batch that is not a multiple of the slab is zero-padded.

    mesh: a Mesh with a 'data' axis splits the batch over it (shard_map),
    so each device transforms its own columns; the kernel is opaque to
    the SPMD partitioner, which would otherwise run it on gathered
    operands.  A batch the 'data' axis does not divide runs gathered."""
    n = x.shape[0]
    if n != plan.n:
        raise ValueError(f"ntt_cm: x has n={n}, plan has n={plan.n}")
    if pre_digit_q is not None and inverse:
        raise ValueError("ntt_cm: pre_digit_q is a forward-only prologue")
    if slab & (slab - 1):
        raise ValueError(f"ntt_cm: slab {slab} must be a power of 2")
    if pre_digit_q == plan.q:
        pre_digit_q = None  # the identity re-expansion
    if n == 1:
        return x if pre_digit_q is None else redigit(x, pre_digit_q, plan.q)
    passes, consts = _plan_tables(plan, inverse, pre_digit_q, RMAX)
    pre_k = None
    if pre_digit_q is not None and pre_digit_q > plan.q:
        pre_k = plan.q.bit_length()

    def transform(v):
        c = jnp.asarray(consts)  # converted per trace (no cached tracers)
        for i, (s, r, tabs) in enumerate(passes):
            run = _pass_call(n, s, r, slab, inverse,
                             pre_digit_q is not None and i == 0,
                             pre_k if i == 0 else None,
                             i == len(passes) - 1, interpret)
            v = run(c, v, *(jnp.asarray(a) for a in tabs))
        return v

    D = mesh.shape.get("data", 0) if mesh is not None else 0
    if not D or x.shape[1] % D:
        return transform(x)
    return jax.shard_map(transform, mesh=mesh, in_specs=P(None, "data"),
                         out_specs=P(None, "data"), check_vma=False)(x)

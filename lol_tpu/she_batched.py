"""Batched, device-resident BGV pipeline — the "serving path".

The object-level API (she.py) manipulates single ciphertexts with host
round-trips for lifts; production throughput needs the whole
mul -> relinearize -> rescale step fused under one jit over large
batches.  This module provides that: ciphertext components live as
coefficient-major (nrns, n, B) uint32 arrays (every NTT row is
contiguous along the batch), hints are baked in as compile-time
constants, and one `step()` performs

    ct_mul (CRT Hadamards) -> RNS-gadget key switch -> exact BGV rescale

entirely on device.  Bit-exact vs the she.py path (same arithmetic, same
decomposition and rescale formulas) — tested column-by-column.  The
pipeline covers BOTH encodings (encoding="msd": in-kernel toLSD for the
step, exact Garner-digit scaled-rounding decrypt) and BOTH ring shapes
(2-power and composite m via the per-ring CRT dispatch), with batched
device noise tracking (build_error_term / build_noise_bits).

Also fully device-resident here (reference call stacks SURVEY.md §4):
  - `build_decrypt`:  c(s) eval + Garner mixed-radix centered lift mod p
    (§4.3 decrypt — the reference's C++-speed liftDec),
  - `build_tunnel`:   the batched ring-tunneling step (§4.5) — relative
    coefficient gather (static index table), RNS-gadget digits over the
    common subring E, embed-scatter into S, hint inner products,
  - `build_galois`:   CRT slot permutation + key switch (hom. automorphism).

Sharding: pass `mesh` (axes 'rns' and 'data') to build_step/build_tunnel
to make the digit re-expansion's cross-channel movement an explicit
replicate over 'rns' — one all-gather of the (nrns, n, B) u32 component,
(nrns-1)/nrns * 4*nrns*n*B bytes received per device — instead of the
SPMD partitioner's involuntary full rematerialization of the stacked
(nrns, nrns, n, B) digit tensor (VERDICT r1 #3).

This is the benchmark pipeline for BASELINE's "BGV ct-mult + key-switch
ops/sec" metric and the multi-chip sharding target (batch axis = 'data',
residue axis = 'rns').
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from . import numtheory as nt
from . import she, zq
from .gadget import RnsGad
from .ring import ring_context
from .ops import general as gen
from .ops import select


# ---------------------------------------------------------------------------
# channel-wise helpers over (nrns, n, B) stacks (static per-prime moduli)
# ---------------------------------------------------------------------------


def _jit(mesh):
    """jax.jit for a builder body; under a mesh the body is traced inside
    ops.select.over_mesh, so its NTTs run on each device's share of the
    batch."""
    def deco(fn):
        if mesh is None:
            return jax.jit(fn)

        @functools.wraps(fn)
        def body(*args):
            with select.over_mesh(mesh):
                return fn(*args)

        return jax.jit(body)

    return deco


def _check_encoding(encoding: str) -> str:
    if encoding not in ("lsd", "msd"):
        raise ValueError(f"encoding must be 'lsd' or 'msd', got {encoding!r}")
    return encoding


def _mulmod_ch(qs, a, b):
    return jnp.stack([zq.mul_mod(a[i], b[i], q) for i, q in enumerate(qs)])


def _addmod_ch(qs, a, b):
    return jnp.stack([zq.add_mod(a[i], b[i], q) for i, q in enumerate(qs)])


def _submod_ch(qs, a, b):
    return jnp.stack([zq.sub_mod(a[i], b[i], q) for i, q in enumerate(qs)])


def decompose_cm(qs, x):
    """RNS-gadget digits of (nrns, n, B) coeff-domain values: digit i =
    centered [x]_{q_i} re-expanded into every channel, shape
    (ell=nrns, nrns, n, B) (gadget.decompose_rns_jnp in this layout).

    The hot paths no longer call this — the same arithmetic runs as the
    pre_digit_q prologue inside the forward transforms (ntt.redigit;
    bit-identical, tested in test_ntt_kernel) — but it remains the readable
    reference form and the API for materialized digits."""
    digs = []
    for i, qi in enumerate(qs):
        xi = x[i]
        is_high = xi >= jnp.uint32((qi + 1) // 2)
        chans = []
        for j, qj in enumerate(qs):
            if i == j:
                chans.append(xi)
                continue
            r = zq.reduce_mod(xi, qj) if qi > qj else xi
            r = jnp.where(is_high, zq.sub_mod(r, jnp.uint32(qi % qj), qj), r)
            chans.append(r)
        digs.append(jnp.stack(chans))
    return jnp.stack(digs)


def _crt_const(cyc_val, qs) -> jnp.ndarray:
    """A Cyc baked as an (nrns, n, 1) CRT-domain jit constant.

    Uses the host numpy CRT (no eager per-op device dispatches; the
    numpy transform is milliseconds)."""
    return jnp.asarray(_cyc_crt_np(cyc_val))[..., None]


def _crt_const_sh(cyc_val, qs):
    """A Cyc as ((nrns, n, 1) values, same-shape Shoup companions).

    Constant CRT Hadamards then run 5-multiply Shoup instead of the
    11-multiply variable-variable Barrett (bit-identical results)."""
    w = _cyc_crt_np(cyc_val)  # (nrns, n)
    wsh = np.stack([zq.shoup_np(w[i], q) for i, q in enumerate(qs)])
    return jnp.asarray(w)[..., None], jnp.asarray(wsh)[..., None]


def _hint_const_sh(hs, qs):
    """Hint Cyc list -> ((ell, nrns, n, 1) values, companions)."""
    w = np.stack([_cyc_crt_np(h) for h in hs])  # (ell, nrns, n)
    wsh = np.stack(
        [zq.shoup_np(w[:, i], q) for i, q in enumerate(qs)], axis=1
    )
    return jnp.asarray(w)[..., None], jnp.asarray(wsh)[..., None]


def _mulmod_sh_ch(qs, a, w, wsh):
    """Per-channel constant Hadamard with precomputed Shoup companions."""
    return jnp.stack(
        [zq.mul_mod_shoup(a[i], w[i], wsh[i], q) for i, q in enumerate(qs)]
    )


@dataclass(frozen=True)
class BatchedBGV:
    """Compiled batched pipeline for one SHEParams (RnsGad keyswitch).

    NTTs run the platform's implementation (ops.select); every choice is
    bit-identical (same staged arithmetic)."""

    params: she.SHEParams

    @property
    def ctx(self):
        return self.params.ctx

    @property
    def qs(self):
        return self.params.qs

    def plans(self):
        return self.ctx.ntt_plans()

    # --- layout helpers ---------------------------------------------------
    def pack(self, cts: list[she.CT]) -> tuple[jnp.ndarray, jnp.ndarray]:
        """List of degree-1 cts (CRT rep) -> two (nrns, n, B) arrays."""
        comps = []
        for k in range(2):
            cols = [np.asarray(ct.cs[k].to_crt().data) for ct in cts]  # (nrns, n)
            comps.append(jnp.asarray(np.stack(cols, axis=-1)))
        return tuple(comps)

    def unpack(self, arrs, f: int = 1, encoding: str = "lsd") -> list[she.CT]:
        """(nrns, n, B) component arrays -> list of cts (CRT rep)."""
        from .cyc import Cyc, Rep

        B = arrs[0].shape[-1]
        out = []
        for b in range(B):
            cs = tuple(
                Cyc(self.ctx, Rep.CRT, a[..., b]) for a in arrs
            )
            out.append(she.CT(self.params, self.ctx, cs, f=f, encoding=encoding))
        return out

    # --- per-channel transforms --------------------------------------------
    # 2-power m: the negacyclic NTT of ops.select (the platform's kernel).
    # General m (VERDICT r2 #4): gen.crt_cm — the 2-axis rides the same
    # transform on a free (n2, rest*B) reshape; odd dense axes ride
    # matvec_mod_jnp.

    def _crt_one(self, x2d, ch, inverse=False, ctx=None, pre_digit_q=None):
        """(n, B) single-channel CRT transform of the given ring.

        pre_digit_q: fuse the RNS-gadget digit re-expansion (centered
        [x]_{pre_digit_q} mod q_ch) as a prologue of the forward
        transform (identity when pre_digit_q == q_ch)."""
        ctx = ctx if ctx is not None else self.ctx
        if not ctx.fm.is_pow2():
            return gen.crt_cm(
                ctx.general_plans()[ch], x2d, inverse=inverse,
                pre_digit_q=pre_digit_q,
            )
        return select.ntt_cm(x2d, ctx.ntt_plans()[ch], inverse, pre_digit_q)

    def _ntt(self, x, inverse=False, ctx=None):
        """(nrns, n, B) per-channel CRT transform (name kept from the
        2-power-only pipeline; dispatches per ring)."""
        return jnp.stack(
            [self._crt_one(x[i], i, inverse, ctx=ctx)
             for i in range(x.shape[0])]
        )

    def _l(self, x, inverse=False):
        """(nrns, n, B) per-channel L / L^-1 (dec <-> pow); identity for
        2-power m, where the bases coincide."""
        if self.ctx.fm.is_pow2():
            return x
        gps = self.ctx.general_plans()
        return jnp.stack(
            [gen.l_cm(gps[i], x[i], inverse=inverse)
             for i in range(x.shape[0])]
        )

    def _mesh_gathered(self, x, mesh):
        """Replicate a stack over the 'rns' mesh axis so per-digit
        channel re-expansion / cross-channel reads are local."""
        if mesh is None:
            return x
        spec = (None,) * (x.ndim - 1) + ("data",)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(*spec))
        )

    def _mesh_channel_sharded(self, x, mesh):
        if mesh is None:
            return x
        spec = (None,) * (x.ndim - 3) + ("rns", None, "data")
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P(*spec))
        )

    def _ext_hint_setup(self, hint: she.KSHintExt, mesh=None):
        """Shared validation + constants for the extended-modulus
        builders: the hint's chain must extend the pipeline chain;
        returns (ctx_ext, ext_qs, hint constants, special-prime drops)."""
        if not isinstance(hint.spec, RnsGad):
            raise ValueError("batched pipeline uses the RNS gadget")
        qs = self.qs
        nrns = len(qs)
        ctx_ext = hint.ctx_ext
        ext_qs = ctx_ext.basis.qs
        if ext_qs[:nrns] != qs or nrns + hint.n_special != len(ext_qs):
            raise ValueError(
                "extended-modulus hint's chain does not extend the "
                f"pipeline chain (ext={ext_qs}, base={qs})"
            )
        h0, h0s = _hint_const_sh(hint.h0, ext_qs)
        h1, h1s = _hint_const_sh(hint.h1, ext_qs)
        drops = [
            self._rescale_crt(
                encoding="lsd",
                mesh=mesh,
                qs=ext_qs[: nrns + k],
                ctx=ring_context(self.params.m, ext_qs[: nrns + k]),
            )
            for k in range(hint.n_special, 0, -1)
        ]
        return ctx_ext, ext_qs, (h0, h0s, h1, h1s), drops

    def _digit_crt(self, src_i, i, known_crt, qs, ctx=None):
        """Digit i's CRT stack straight from the coefficient-domain
        channel src_i = iNTT(x)[i]: the re-expansion into channel j
        (decompose_cm's arithmetic) runs as a prologue of channel j's
        forward NTT — the (ell-1) digit arrays per digit are
        never materialized in HBM.  Channel i itself is known_crt[i]
        (free diagonal; exact — iNTT then NTT round-trips bit-exactly,
        so 1/nrns of the keyswitch digit transforms are free)."""
        return jnp.stack([
            known_crt[j] if j == i
            else self._crt_one(src_i, j, ctx=ctx, pre_digit_q=qs[i])
            for j in range(len(qs))
        ])

    # --- batched encryption ------------------------------------------------
    def build_encrypt(self, sk: she.SK, encoding: str = "lsd"):
        """jit-compiled (msgs, key) -> (c0, c1): encrypt a batch.

        msgs: (n, B) int32 decoding-basis coefficients mod p (column-major
        like everything else here); key: jax PRNG key.  Same scheme as
        she.encrypt (c1 uniform in CRT, c0 = NTT(m + p e) - c1 * s) /
        she.encrypt_msd (c0 = NTT(Delta*m + e) - c1 * s, Delta = Q//p,
        entering per channel as the precomputed residue Delta mod q_i)."""
        qs = self.qs
        p = self.params.p
        n = self.ctx.n
        var = self.params.var
        msd = _check_encoding(encoding) == "msd"
        s_crt, s_sh = _crt_const_sh(she.Cyc.from_ints(self.ctx, sk.s_ints), qs)
        delta = self.ctx.basis.modulus // p
        d_res = [(delta % q, zq.shoup(delta % q, q)) for q in qs]

        @jax.jit
        def enc(msgs, key):
            B = msgs.shape[-1]
            k_e, *k_u = jax.random.split(key, 1 + len(qs))
            e = jnp.round(
                jax.random.normal(k_e, (n, B), dtype=jnp.float32)
                * jnp.sqrt(jnp.float32(var))
            ).astype(jnp.int32)
            if msd:
                mm = jnp.mod(msgs, p).astype(jnp.uint32)  # accept centered
                me_res = []
                for i, q in enumerate(qs):
                    dm = zq.mul_mod_shoup(
                        mm, jnp.uint32(d_res[i][0]),
                        jnp.uint32(d_res[i][1]), q,
                    )
                    me_res.append(
                        zq.add_mod(dm, jnp.mod(e, q).astype(jnp.uint32), q)
                    )
                me_res = jnp.stack(me_res)
            else:
                me = msgs.astype(jnp.int32) + p * e
                me_res = jnp.stack(
                    [jnp.mod(me, q).astype(jnp.uint32) for q in qs]
                )
            me_crt = self._ntt(self._l(me_res))
            c1 = jnp.stack(
                [
                    jax.random.randint(k_u[i], (n, B), 0, q, dtype=jnp.uint32)
                    for i, q in enumerate(qs)
                ]
            )
            c0 = _submod_ch(qs, me_crt, _mulmod_sh_ch(qs, c1, s_crt, s_sh))
            return c0, c1

        return enc

    # --- batched decryption (device-side liftDec; SURVEY §4.3) -------------
    def build_decrypt(self, sk: she.SK, f: int = 1, encoding: str = "lsd"):
        """jit-compiled (c0, c1) -> (n, B) int32 messages mod p.

        c(s) = c0 + c1 s as a CRT Hadamard, one inverse NTT, then the
        device lift (VERDICT r1 #4 / r2 #3):

        LSD: Garner mixed-radix centered lift reduced mod p
        (rns.RnsBasis.lift_mod_jnp) — the reference's liftDec.

        MSD: exact round-half-up of (p/Q)*lift WITHOUT big ints: with
        x in [0, Q) the canonical residue representative and Q odd,
          round_hu(p*x/Q) = floor((p*x + (Q-1)/2) / Q)
                          = (u - [u]_Q) / Q      for u = p*x + (Q-1)/2,
        so mod p:  m = ([u]_p - [u mod Q]_p) * Q^{-1}  (mod p), where
        u mod Q's residues are just u's channel residues and [.]_p comes
        from the same Garner-digit Horner as the LSD lift (pos_mod_jnp).
        Centering is free: x -> x - Q shifts the quotient by exactly -p.
        Bit-exact vs she.decrypt's object-int (2*d*p + Q) // (2*Q)."""
        qs = self.qs
        p = self.params.p
        basis = self.ctx.basis
        msd = _check_encoding(encoding) == "msd"
        s_crt, s_sh = _crt_const_sh(she.Cyc.from_ints(self.ctx, sk.s_ints), qs)
        finv = nt.modinv(f % p, p)
        Q = basis.modulus
        if msd and Q % 2 == 0:
            raise ValueError("MSD decrypt's rounding identity needs odd Q "
                             "(every NTT-prime chain is)")
        half = (Q - 1) // 2
        # per-channel constants of u = p*x + half (+ Shoup for the p mult)
        u_consts = [
            (p % q, zq.shoup(p % q, q), half % q) for q in qs
        ]
        qinv_p = nt.modinv(Q % p, p)
        half_p = half % p

        @jax.jit
        def dec(c0, c1):
            cs = _addmod_ch(qs, c0, _mulmod_sh_ch(qs, c1, s_crt, s_sh))
            # decoding-basis coefficients (liftDec; L^-1 is id for 2-power)
            coeff = self._l(self._ntt(cs, inverse=True), inverse=True)
            if not msd:
                # lift_mod_jnp wants rns at axis -2: (n, nrns, B) view
                lifted = basis.lift_mod_jnp(jnp.moveaxis(coeff, 0, 1), p)
                return zq.mul_mod(lifted, jnp.uint32(finv), p).astype(jnp.int32)
            u = jnp.stack([
                zq.add_mod(
                    zq.mul_mod_shoup(
                        coeff[i], jnp.uint32(pc), jnp.uint32(psh), q
                    ),
                    jnp.uint32(hc), q,
                )
                for i, (q, (pc, psh, hc)) in enumerate(zip(qs, u_consts))
            ])
            rem_p = basis.pos_mod_jnp(jnp.moveaxis(u, 0, 1), p)
            m = zq.mul_mod(
                zq.sub_mod(jnp.uint32(half_p), rem_p, p),
                jnp.uint32(qinv_p), p,
            )
            return zq.mul_mod(m, jnp.uint32(finv), p).astype(jnp.int32)

        return dec

    # --- batched noise extraction (SURVEY §4.3/§5; VERDICT r2 #6) ----------
    def build_error_term(self, sk: she.SK):
        """jit-compiled (c0, c1) -> (nrns, n, B) RNS residues of the LSD
        noise e = (lift(c(s)) - centered [c(s)]_p) / p (she.error_term,
        channel-wise: e_i = (d_i - [mu]_{q_i}) * p^{-1} mod q_i with mu
        the device centered lift mod p) — noise-budget tracking at batch
        scale without any host big-int loop."""
        qs = self.qs
        p = self.params.p
        basis = self.ctx.basis
        s_crt, s_sh = _crt_const_sh(she.Cyc.from_ints(self.ctx, sk.s_ints), qs)
        pinvs = [(nt.modinv(p % q, q), zq.shoup(nt.modinv(p % q, q), q))
                 for q in qs]

        @jax.jit
        def err(c0, c1):
            cs = _addmod_ch(qs, c0, _mulmod_sh_ch(qs, c1, s_crt, s_sh))
            d = self._l(self._ntt(cs, inverse=True), inverse=True)  # DEC
            mu = basis.lift_mod_jnp(jnp.moveaxis(d, 0, 1), p)  # [d]_p in [0,p)
            hi = mu >= jnp.uint32((p + 1) // 2)
            chans = []
            for i, q in enumerate(qs):
                mi = zq.reduce_mod(mu, q) if p > q else mu
                mi = jnp.where(hi, zq.sub_mod(mi, jnp.uint32(p % q), q), mi)
                ei = zq.sub_mod(d[i], mi, q)
                chans.append(zq.mul_mod_shoup(
                    ei, jnp.uint32(pinvs[i][0]), jnp.uint32(pinvs[i][1]), q
                ))
            return jnp.stack(chans)

        return err

    def build_noise_bits(self, sk: she.SK):
        """jit-compiled (c0, c1) -> (B,) float32 noise budgets:
        log2(max_coeff |e|) per ciphertext (she.noise_bits, batched).

        |e| = min(x, Q - x) over the canonical representative x of e,
        assembled from the Garner mixed-radix digits (non-negative
        digit-weight sums — no cancellation).  Digit weights are binned
        into 70-bit groups, each group summed at its own float32 scale,
        and the per-coefficient log2 is taken as max over groups of
        log2(mag_g + mag_{g-1}/2^70) + 70g — so arbitrarily long chains
        neither overflow NOR underflow float32 (a single global 2^-shift
        zeroed low digits for chains over ~8 primes); dropped groups
        contribute < 2^-36 relative.  Matches the host noise_bits to
        float32 accuracy (asserted by the cross test)."""
        import math

        qs = self.qs
        basis = self.ctx.basis
        err = self.build_error_term(sk)
        GB = 70  # group span in bits: group sums stay < 2^104 < float32 max
        groups: dict[int, list[tuple[int, float]]] = {}
        W = 1
        for j, q in enumerate(qs):
            g = (W.bit_length() - 1) // GB
            # W / 2^(GB*g) scaled in the integer domain first: float(W)
            # alone would overflow for W > ~2^1024 (ADVICE r3), capping
            # "arbitrarily long chains" at ~34 thirty-bit primes
            sh = max(0, W.bit_length() - 53)
            groups.setdefault(g, []).append(
                (j, math.ldexp(float(W >> sh), sh - GB * g))
            )
            W *= q
        gmax = max(groups)

        def logmag(v):  # (n, nrns, B) digits -> (n, B) log2 magnitude
            mags = {}
            for g, entries in groups.items():
                acc = None
                for j, w in entries:
                    t = v[:, j, :].astype(jnp.float32) * jnp.float32(w)
                    acc = t if acc is None else acc + t
                mags[g] = acc
            best = jnp.full(v.shape[::2], -jnp.inf, dtype=jnp.float32)
            for g in sorted(groups):
                tot = mags[g]
                if g - 1 in mags:
                    tot = tot + mags[g - 1] * jnp.float32(2.0 ** -GB)
                cand = jnp.where(
                    mags[g] > 0,
                    jnp.log2(tot) + jnp.float32(GB * g),
                    jnp.float32(-jnp.inf),
                )
                best = jnp.maximum(best, cand)
            return best

        @jax.jit
        def bits(c0, c1):
            e = err(c0, c1)
            neg = jnp.stack([zq.neg_mod(e[i], q) for i, q in enumerate(qs)])
            m_pos = logmag(basis.to_mixed_radix_jnp(jnp.moveaxis(e, 0, 1)))
            m_neg = logmag(basis.to_mixed_radix_jnp(jnp.moveaxis(neg, 0, 1)))
            mx = jnp.max(jnp.minimum(m_pos, m_neg), axis=0)  # (B,)
            return jnp.where(jnp.isfinite(mx), mx, jnp.float32(0))

        return bits

    # --- batched ct +/- ct (she.ct_add / ct_sub with scale alignment) ------
    def build_add(self, f_a: int = 1, f_b: int = 1, sub: bool = False):
        """jit-compiled (c0, c1, d0, d1) -> (e0, e1): ct_a +/- ct_b for
        degree-1 cts with scale factors f_a, f_b (she._align + ct_add:
        the second operand is scaled by the centered u = f_a * f_b^{-1}
        mod p so both carry scale f_a; output scale is f_a).  Works for
        both encodings (the alignment math is encoding-uniform)."""
        qs = self.qs
        p = self.params.p
        u = f_a * nt.modinv(f_b % p, p) % p
        if u >= (p + 1) // 2:
            u -= p
        u_res = [((u % q), zq.shoup(u % q, q)) for q in qs]
        ident = u == 1

        @jax.jit
        def addf(c0, c1, d0, d1):
            if not ident:
                d0, d1 = (
                    jnp.stack([
                        zq.mul_mod_shoup(
                            x[i], jnp.uint32(uc), jnp.uint32(ush), q
                        )
                        for i, (q, (uc, ush)) in enumerate(zip(qs, u_res))
                    ])
                    for x in (d0, d1)
                )
            op = _submod_ch if sub else _addmod_ch
            return op(qs, c0, d0), op(qs, c1, d1)

        return addf

    # --- batched public-operand ops (she.add_public / she.mul_public) ------
    def build_add_public(self, f: int = 1, encoding: str = "lsd"):
        """jit-compiled (c0, c1, m_pub) -> (c0', c1): ct + public
        plaintext (she.add_public, batched).  m_pub: (n, B) int32
        decoding-basis coefficients mod p (or (n, 1) to broadcast one
        public value over the batch).  The appropriately-scaled encoding
        (f*m_pub for LSD, Delta*[f*m_pub]_p for MSD) is added to c0."""
        qs = self.qs
        p = self.params.p
        msd = _check_encoding(encoding) == "msd"
        delta = self.ctx.basis.modulus // p
        d_res = [(delta % q, zq.shoup(delta % q, q)) for q in qs]
        fc = f % p

        @jax.jit
        def addp(c0, c1, m_pub):
            sc = zq.mul_mod(
                jnp.mod(m_pub, p).astype(jnp.uint32), jnp.uint32(fc), p
            )
            if msd:
                enc = jnp.stack([
                    zq.mul_mod_shoup(sc, jnp.uint32(dc), jnp.uint32(dsh), q)
                    for q, (dc, dsh) in zip(qs, d_res)
                ])
            else:
                enc = jnp.stack([sc.astype(jnp.uint32) for _ in qs])
            enc = self._ntt(self._l(enc))
            enc = jnp.broadcast_to(enc, c0.shape)
            return _addmod_ch(qs, c0, enc), c1

        return addp

    def build_mul_public(self):
        """jit-compiled (c0, c1, m_pub) -> (c0', c1'): ct * public
        plaintext (she.mul_public, batched; encoding-agnostic).  Both
        components are multiplied by the CRT transform of the centered
        lift of m_pub ((n, B) int32 mod p, or (n, 1) broadcast)."""
        qs = self.qs
        p = self.params.p
        half = (p + 1) // 2

        @jax.jit
        def mulp(c0, c1, m_pub):
            m = jnp.mod(m_pub, p).astype(jnp.int32)
            lifted = jnp.where(m >= half, m - p, m)  # centered in (-p/2, p/2]
            res = jnp.stack([
                jnp.mod(lifted, q).astype(jnp.uint32) for q in qs
            ])
            w = self._ntt(self._l(res))
            w = jnp.broadcast_to(w, c0.shape)
            return _mulmod_ch(qs, c0, w), _mulmod_ch(qs, c1, w)

        return mulp

    # --- batched encoding switches (she.to_lsd / she.to_msd) ---------------
    def build_to_lsd(self):
        """jit-compiled (c0, c1) -> (c0', c1'): MSD -> LSD, components
        scaled by p (she.to_lsd); track f with `to_lsd_f`."""
        return self._build_scale_components(self.params.p % self.ctx.basis.modulus)

    def build_to_msd(self):
        """jit-compiled (c0, c1) -> (c0', c1'): LSD -> MSD, components
        scaled by p^{-1} mod Q (she.to_msd); track f with `to_msd_f`."""
        return self._build_scale_components(
            nt.modinv(self.params.p % self.ctx.basis.modulus,
                      self.ctx.basis.modulus)
        )

    def _build_scale_components(self, c: int):
        qs = self.qs
        consts = [(c % q, zq.shoup(c % q, q)) for q in qs]

        @jax.jit
        def scale(c0, c1):
            def one(x):
                return jnp.stack([
                    zq.mul_mod_shoup(
                        x[i], jnp.uint32(cc), jnp.uint32(sh), q
                    )
                    for i, (q, (cc, sh)) in enumerate(zip(qs, consts))
                ])
            return one(c0), one(c1)

        return scale

    def build_div_d(self, d: int):
        """jit-compiled (c0, c1) -> (c0', c1'): batched she.div_d —
        exact homomorphic divide-by-d (components scaled by d^{-1} mod
        Q) for plaintexts guaranteed divisible by d.  The plaintext
        modulus drops to p/d: subsequent builders come from a
        BatchedBGV over SHEParams with p//d; track f with div_d_f."""
        if self.params.p % d:
            raise ValueError("build_div_d: d must divide the pt modulus")
        Q = self.ctx.basis.modulus
        return self._build_scale_components(nt.modinv(d % Q, Q))

    def div_d_f(self, d: int, f: int) -> int:
        """Scale-factor update matching build_div_d (she.div_d)."""
        return f % (self.params.p // d)

    def to_lsd_f(self, f: int) -> int:
        """Scale-factor update matching build_to_lsd (she.to_lsd)."""
        p = self.params.p
        return f * ((-self.ctx.basis.modulus) % p) % p

    def to_msd_f(self, f: int) -> int:
        """Scale-factor update matching build_to_msd (she.to_msd)."""
        p = self.params.p
        return f * ((-nt.modinv(self.ctx.basis.modulus % p, p)) % p) % p

    def step_f(self, fc: int, fd: int, encoding: str = "lsd") -> int:
        """Output scale factor of build_step for input scales fc, fd.

        LSD: the rescale multiplies by q_last^{-1} mod p.  MSD: the
        second operand is toLSD'd inside the step (factor (-Q) mod p)
        and the MSD rescale leaves f unchanged (she.ct_mul/mod_switch)."""
        p = self.params.p
        if _check_encoding(encoding) == "msd":
            return self.to_lsd_f(fc * fd % p)
        return fc * fd * nt.modinv(self.qs[-1] % p, p) % p

    # --- the exact BGV rescale (modSwitch primitive) ------------------------
    def _rescale_crt(self, encoding: str = "lsd", mesh=None, qs=None,
                     ctx=None):
        """One-component exact BGV drop-last rescale computed IN the CRT
        domain: only the dropped channel is inverse-transformed; the
        correction polynomial delta (p * centered [c p^-1]_{ql} for
        LSD, plain centered [c]_{ql} for MSD round-to-nearest) is
        forward-transformed into each surviving channel (every op is
        a ring hom mod q_i, so the result is bit-identical to
        iNTT -> coeff rescale -> NTT, at nrns transforms instead of
        2*nrns - 1).  All scalar constants carry Shoup companions.
        (delta is a single cheap fused XLA pass, kept explicit rather
        than routed through the forward transform's digit prologue.)

        qs/ctx: rescale over a DIFFERENT chain than the pipeline's
        (build_step_ext's special-prime drops run over the shrinking
        extended chains); default is the pipeline chain."""
        qs = self.qs if qs is None else qs
        nrns = len(qs)
        p = self.params.p
        msd = _check_encoding(encoding) == "msd"
        ql = qs[-1]
        pinv_l = nt.modinv(p % ql, ql)

        def rescale(comp):
            last_c = self._crt_one(comp[-1], nrns - 1, inverse=True, ctx=ctx)
            if msd:
                v = last_c
            else:
                v = zq.mul_mod_shoup(
                    last_c, jnp.uint32(pinv_l),
                    jnp.uint32(zq.shoup(pinv_l, ql)), ql,
                )
            v = self._mesh_gathered(v, mesh)
            is_high = v >= jnp.uint32((ql + 1) // 2)
            chans = []
            for i, qi in enumerate(qs[:-1]):
                inv = nt.modinv(ql % qi, qi)
                vi = zq.reduce_mod(v, qi)
                vi = jnp.where(
                    is_high, zq.sub_mod(vi, jnp.uint32(ql % qi), qi), vi
                )
                delta = vi if msd else zq.mul_mod_shoup(
                    vi, jnp.uint32(p % qi),
                    jnp.uint32(zq.shoup(p % qi, qi)), qi,
                )
                nd = self._crt_one(delta, i, ctx=ctx)
                d = zq.sub_mod(comp[i], nd, qi)
                chans.append(zq.mul_mod_shoup(
                    d, jnp.uint32(inv), jnp.uint32(zq.shoup(inv, qi)), qi,
                ))
            return jnp.stack(chans)

        return rescale

    def build_mod_switch(self, encoding: str = "lsd", mesh=None):
        """jit-compiled (c0, c1) -> (e0, e1) over the dropped-prime
        chain: the standalone exact BGV modulus switch (she.mod_switch,
        batched — VERDICT r3 #4; additive-only serving workloads pay
        this instead of the full mul step).  Track the LSD scale with
        `mod_switch_f` (MSD leaves f unchanged)."""
        rescale = self._rescale_crt(encoding=encoding, mesh=mesh)

        @_jit(mesh)
        def ms(c0, c1):
            return rescale(c0), rescale(c1)

        return ms

    def mod_switch_f(self, f: int) -> int:
        """Scale-factor update matching build_mod_switch (LSD: the
        rescale multiplies the message by q_last^{-1} mod p)."""
        p = self.params.p
        return f * nt.modinv(self.qs[-1] % p, p) % p

    # --- standalone batched linear key switch (re-encryption) ---------------
    def build_key_switch_linear(self, hint: she.KSHint, mesh=None):
        """jit-compiled (c0, c1) -> (e0, e1): re-encrypt a degree-1 ct
        from the hint's old key to its new key (she.key_switch_linear,
        batched; encoding-uniform — VERDICT r3 #4).  The digit path is
        build_galois's with the identity permutation:
        e0 = c0 + sum_i d_i h0_i, e1 = sum_i d_i h1_i, with the digit
        re-expansion fused into each channel's forward transform.
        mesh: as in build_step."""
        if not isinstance(hint.spec, RnsGad):
            raise ValueError("batched pipeline uses the RNS gadget")
        qs = self.qs
        nrns = len(qs)
        h0, h0s = _hint_const_sh(hint.h0, qs)
        h1, h1s = _hint_const_sh(hint.h1, qs)

        @_jit(mesh)
        def ksl(c0, c1):
            c1c = self._mesh_gathered(self._ntt(c1, inverse=True), mesh)
            e0, e1 = c0, jnp.zeros_like(c1)
            for i in range(nrns):
                di = self._mesh_channel_sharded(
                    self._digit_crt(c1c[i], i, c1, qs), mesh
                )
                e0 = _addmod_ch(qs, e0, _mulmod_sh_ch(qs, di, h0[i], h0s[i]))
                e1 = _addmod_ch(qs, e1, _mulmod_sh_ch(qs, di, h1[i], h1s[i]))
            return e0, e1

        return ksl

    # --- the fused mul+keyswitch+rescale step -------------------------------
    def build_step(self, hint: she.KSHint, mesh=None, encoding: str = "lsd"):
        """jit-compiled (c0,c1,d0,d1) -> (e0,e1) over the dropped-prime
        chain: ct_mul + keySwitchQuadCirc + modSwitch.

        mesh: optional Mesh with 'rns'/'data' axes — makes the digit
        broadcast an explicit all-gather over 'rns' (module docstring).

        encoding (VERDICT r2 #3): "lsd" keeps the f*m + p*e invariant
        (rescale carries the p-multiple correction and a q_last^{-1}
        scale); "msd" mirrors she.ct_mul's MSD*MSD handling — the second
        operand is toLSD'd in-kernel (components scaled by p) so the
        product is exactly MSD, and the rescale is the plain
        round-to-nearest division by q_last (Delta scales with Q, f
        fixed).  Track scales with `step_f(fc, fd, encoding)`."""
        if not isinstance(hint.spec, RnsGad):
            raise ValueError("batched pipeline uses the RNS gadget")
        qs = self.qs
        nrns = len(qs)
        p = self.params.p
        msd = _check_encoding(encoding) == "msd"
        p_consts = [(p % q, zq.shoup(p % q, q)) for q in qs]
        # hint components as (ell=nrns, nrns, n, 1) constants (+ Shoup)
        h0, h0s = _hint_const_sh(hint.h0, qs)
        h1, h1s = _hint_const_sh(hint.h1, qs)

        rescale_crt = self._rescale_crt(encoding=encoding, mesh=mesh)

        @_jit(mesh)
        def step(c0, c1, d0, d1):
            if msd:  # toLSD the second operand: components scaled by p
                d0, d1 = (
                    jnp.stack([
                        zq.mul_mod_shoup(
                            x[i], jnp.uint32(pc), jnp.uint32(sh), q
                        )
                        for i, (q, (pc, sh)) in enumerate(zip(qs, p_consts))
                    ])
                    for x in (d0, d1)
                )
            # ct_mul: (c0 + c1 s)(d0 + d1 s): e0 = c0 d0, e1 = c0 d1 + c1 d0,
            # e2 = c1 d1 — all CRT Hadamards, fused by XLA.
            e0 = _mulmod_ch(qs, c0, d0)
            e1 = _addmod_ch(qs, _mulmod_ch(qs, c0, d1), _mulmod_ch(qs, c1, d0))
            e2 = _mulmod_ch(qs, c1, d1)
            # key switch e2: coefficient-domain digits, NTT back, inner
            # prod; the digit re-expansion runs as an in-kernel prologue
            # of each channel's forward NTT (no digit arrays in HBM)
            e2c = self._mesh_gathered(self._ntt(e2, inverse=True), mesh)
            for i in range(nrns):
                # digit i's channel i is e2c[i] itself -> its NTT is e2[i]
                di = self._mesh_channel_sharded(
                    self._digit_crt(e2c[i], i, e2, qs), mesh
                )
                e0 = _addmod_ch(qs, e0, _mulmod_sh_ch(qs, di, h0[i], h0s[i]))
                e1 = _addmod_ch(qs, e1, _mulmod_sh_ch(qs, di, h1[i], h1s[i]))
            return rescale_crt(e0), rescale_crt(e1)

        return step

    # --- the fused step with extended-modulus (hybrid) key switching --------
    def build_step_ext(self, hint: she.KSHintExt, encoding: str = "lsd",
                       mesh=None):
        """jit-compiled (c0,c1,d0,d1) -> (e0,e1) over the dropped-prime
        chain: ct_mul + keySwitchQuadCircExt + modSwitch — the hybrid
        variant of build_step (VERDICT r3 #3; SURVEY §3.6 "hints over an
        extended modulus q'').  mesh: as in build_step.

        The e2 digits (base-chain RNS gadget, re-expansion fused into
        each forward transform) inner-product with hints over Q*P; the
        special primes are then dropped by repeated exact rescales (the
        p-corrected form in BOTH encodings, mirroring she._ks_inner_ext
        — the hint term is a p-multiple-plus-message either way), the
        accumulators rejoin c0*d0 / cross terms over Q, and the standard
        encoding-aware rescale drops q_last.  Bit-exact vs
        she.mod_switch(she.key_switch_quad_circ_ext(hint,
        she.ct_mul(a, b))).  KS noise is divided by P ~ prod(special_qs)
        relative to build_step (demonstrated by the build_noise_bits
        comparison in tests).  Scale bookkeeping: step_f (unchanged vs
        the base step — the P-drop re-enters the s^2 term exactly)."""
        qs = self.qs
        nrns = len(qs)
        p = self.params.p
        msd = _check_encoding(encoding) == "msd"
        p_consts = [(p % q, zq.shoup(p % q, q)) for q in qs]
        ctx_ext, ext_qs, (h0, h0s, h1, h1s), drops = self._ext_hint_setup(
            hint, mesh=mesh
        )
        final = self._rescale_crt(encoding=encoding, mesh=mesh)

        @_jit(mesh)
        def step(c0, c1, d0, d1):
            if msd:  # toLSD the second operand (as in build_step)
                d0, d1 = (
                    jnp.stack([
                        zq.mul_mod_shoup(
                            x[i], jnp.uint32(pc), jnp.uint32(sh), q
                        )
                        for i, (q, (pc, sh)) in enumerate(zip(qs, p_consts))
                    ])
                    for x in (d0, d1)
                )
            e0 = _mulmod_ch(qs, c0, d0)
            e1 = _addmod_ch(qs, _mulmod_ch(qs, c0, d1), _mulmod_ch(qs, c1, d0))
            e2 = _mulmod_ch(qs, c1, d1)
            e2c = self._mesh_gathered(self._ntt(e2, inverse=True), mesh)
            acc0 = acc1 = None
            for i in range(nrns):
                # digit i over ALL extended channels; base channel i is
                # the free diagonal (e2[i] itself)
                di = self._mesh_channel_sharded(
                    self._digit_crt(e2c[i], i, e2, ext_qs, ctx=ctx_ext),
                    mesh,
                )
                t0 = _mulmod_sh_ch(ext_qs, di, h0[i], h0s[i])
                t1 = _mulmod_sh_ch(ext_qs, di, h1[i], h1s[i])
                acc0 = t0 if acc0 is None else _addmod_ch(ext_qs, acc0, t0)
                acc1 = t1 if acc1 is None else _addmod_ch(ext_qs, acc1, t1)
            for drop in drops:
                acc0, acc1 = drop(acc0), drop(acc1)
            e0 = _addmod_ch(qs, e0, acc0)
            e1 = _addmod_ch(qs, e1, acc1)
            return final(e0), final(e1)

        return step

    # --- batched Galois automorphism (hom. slot rotation) -------------------
    def build_galois(self, hint: she.KSHint, k: int, mesh=None):
        """jit-compiled (c0, c1) -> (e0, e1): apply sigma_k to both
        components (CRT slot permutation, a static gather) and key-switch
        the permuted c1 back under s with the sigma_k(s) hint
        (she.ks_galois_hint).  mesh: as in build_step."""
        from . import zmstar

        qs = self.qs
        nrns = len(qs)
        perm = jnp.asarray(
            zmstar.automorphism_slot_perm(self.ctx.m, qs[0], k)
        )
        h0, h0s = _hint_const_sh(hint.h0, qs)
        h1, h1s = _hint_const_sh(hint.h1, qs)

        @_jit(mesh)
        def gal(c0, c1):
            c0k = c0[:, perm, :]
            c1k = c1[:, perm, :]
            c1c = self._mesh_gathered(self._ntt(c1k, inverse=True), mesh)
            e0, e1 = c0k, jnp.zeros_like(c1k)
            for i in range(nrns):
                di = self._mesh_channel_sharded(
                    self._digit_crt(c1c[i], i, c1k, qs), mesh
                )
                e0 = _addmod_ch(qs, e0, _mulmod_sh_ch(qs, di, h0[i], h0s[i]))
                e1 = _addmod_ch(qs, e1, _mulmod_sh_ch(qs, di, h1[i], h1s[i]))
            return e0, e1

        return gal

    def build_galois_many(self, hints: dict, mesh=None):
        """jit-compiled (c0, c1) -> {k: (e0_k, e1_k)}: a HOISTED batch
        of homomorphic automorphisms (HElib-style hoisting) — the
        expensive part of build_galois (one inverse transform + one
        digit-NTT set) runs ONCE and is shared by every rotation; each
        sigma_k then costs only slot perms + hint Hadamards.

        hints: {k: sigma_k(s) KSHint} (she.ks_galois_hint per k).

        Exactness: sigma_k commutes with the RNS digit extraction for
        2-power m (the automorphism is a signed permutation of POW
        coefficients, and centered digits satisfy digit(-a) = -digit(a)
        since q is odd), so outputs are bit-identical to per-k
        build_galois there.  For general m, sum_j sigma(d_j) g_j is
        still a valid gadget decomposition of sigma(c1) (sigma is a
        ring hom fixing the gadget scalars, and sigma preserves
        canonical-embedding size, so the noise bound is unchanged) —
        outputs then differ from build_galois's canonical digits by
        keygen-grade randomness but decrypt identically (tested)."""
        from . import zmstar

        qs = self.qs
        nrns = len(qs)
        rots = []
        for k, hint in sorted(hints.items()):
            if not isinstance(hint.spec, RnsGad):
                raise ValueError("batched pipeline uses the RNS gadget")
            perm_np = zmstar.automorphism_slot_perm(self.ctx.m, qs[0], k)
            inv_np = np.argsort(perm_np)
            # pre-permute the HINT tables by sigma^{-1} (host numpy) so
            # the per-rotation body is pure Hadamards on the SHARED
            # digit stacks: e_k = sigma(c + sum_i d_i * sigma^{-1}(h_i))
            # — pointwise modular ops commute with slot permutation, so
            # this is bit-identical while needing only ONE slot gather
            # per output component (vs nrns+1 per rotation)
            hp = []
            for hs in (hint.h0, hint.h1):
                w = np.stack([_cyc_crt_np(h) for h in hs])[:, :, inv_np]
                wsh = np.stack(
                    [zq.shoup_np(w[:, i], q) for i, q in enumerate(qs)],
                    axis=1,
                )
                hp.append((jnp.asarray(w)[..., None],
                           jnp.asarray(wsh)[..., None]))
            rots.append((k, jnp.asarray(perm_np), hp[0], hp[1]))

        @_jit(mesh)
        def gals(c0, c1):
            c1c = self._mesh_gathered(self._ntt(c1, inverse=True), mesh)
            digits = [
                self._mesh_channel_sharded(
                    self._digit_crt(c1c[i], i, c1, qs), mesh
                )
                for i in range(nrns)
            ]
            outs = {}
            for k, perm, (h0, h0s), (h1, h1s) in rots:
                acc0, acc1 = c0, None
                for i in range(nrns):
                    acc0 = _addmod_ch(
                        qs, acc0, _mulmod_sh_ch(qs, digits[i], h0[i], h0s[i])
                    )
                    t1 = _mulmod_sh_ch(qs, digits[i], h1[i], h1s[i])
                    acc1 = t1 if acc1 is None else _addmod_ch(qs, acc1, t1)
                outs[k] = (acc0[:, perm, :], acc1[:, perm, :])
            return outs

        return gals

    # --- batched ring tunneling (SURVEY §4.5; VERDICT r1 #2) ----------------
    def build_tunnel(self, th: she.TunnelHint, mesh=None):
        """jit-compiled (c0, c1) over R -> (e0, e1) over S: the fused
        device tunnel.  All cross-ring index tables are static constants:

          out0 = evalLin(c0)   = sum_i NTT_S(embed(gather_i(iNTT_R(c0)))) * ys_i
          ct'  = out0, 0  +  sum_{i,j} NTT_S(embed(digit_j(a_i))) * hint_{i,j}

        where a_i = gather_i(iNTT_R(c1)) is the relative coefficient
        decomposition over the common subring E (gen.rel_coeff_table) and
        digit_j is the RNS gadget over E (= over the same chain).  Works
        for general-m towers too (VERDICT r2 #4): the S-transforms route
        through the per-ring CRT dispatch (_ntt with ctx=s_ctx)."""
        lin = th.lin
        if not isinstance(th.spec, RnsGad):
            raise ValueError("batched tunnel uses the RNS gadget")
        r_ctx, s_ctx, e_ctx = lin.r_ctx, lin.s_ctx, lin.e_ctx
        if r_ctx != self.ctx:
            raise ValueError("tunnel: pipeline ring != map source ring")
        qs = self.qs
        nrns = len(qs)
        d = r_ctx.n // e_ctx.n
        n_s = s_ctx.n
        coeff_tbl = jnp.asarray(gen.rel_coeff_table(e_ctx.m, r_ctx.m))  # (d, n_e)
        embed_tbl = jnp.asarray(gen.embed_pow_table(e_ctx.m, s_ctx.m))  # (n_e,)
        ys = [_crt_const_sh(y, qs) for y in lin.ys]  # images f(b_i), CRT over S
        hints0 = [_hint_const_sh(hh.h0, qs) for hh in th.hints]
        hints1 = [_hint_const_sh(hh.h1, qs) for hh in th.hints]

        def _ntt_s(x, inverse=False):
            return self._ntt(x, inverse=inverse, ctx=s_ctx)

        def _embed_s(a):
            """(..., n_e, B) POW coefficients of E -> (..., n_s, B)."""
            B = a.shape[-1]
            out = jnp.zeros((*a.shape[:-2], n_s, B), dtype=a.dtype)
            return out.at[..., embed_tbl, :].set(a)

        @_jit(mesh)
        def tun(c0, c1):
            B = c0.shape[-1]
            c0p = self._mesh_gathered(self._ntt(c0, inverse=True), mesh)
            c1p = self._mesh_gathered(self._ntt(c1, inverse=True), mesh)
            e0 = jnp.zeros((nrns, n_s, B), dtype=jnp.uint32)
            e1 = jnp.zeros((nrns, n_s, B), dtype=jnp.uint32)
            for i in range(d):
                a0 = c0p[:, coeff_tbl[i], :]  # (nrns, n_e, B)
                e0 = _addmod_ch(
                    qs, e0,
                    _mulmod_sh_ch(qs, _ntt_s(_embed_s(a0)), *ys[i]),
                )
                a1 = c1p[:, coeff_tbl[i], :]
                for j in range(nrns):
                    # digit j's re-expansion (decompose_cm's arithmetic)
                    # runs as the prologue of each channel's forward
                    # S-transform; redigit commutes with the zero-
                    # preserving embed scatter, so this is bit-identical
                    # to decompose-then-embed-then-NTT with no digit
                    # arrays materialized in HBM
                    src = _embed_s(a1[j])  # (n_s, B)
                    dj = jnp.stack([
                        self._crt_one(src, ch, ctx=s_ctx, pre_digit_q=qs[j])
                        for ch in range(nrns)
                    ])
                    h0v, h0s = hints0[i]
                    h1v, h1s = hints1[i]
                    e0 = _addmod_ch(
                        qs, e0, _mulmod_sh_ch(qs, dj, h0v[j], h0s[j])
                    )
                    e1 = _addmod_ch(
                        qs, e1, _mulmod_sh_ch(qs, dj, h1v[j], h1s[j])
                    )
            return e0, e1

        return tun

    def target_pipeline(self, th: she.TunnelHint) -> "BatchedBGV":
        """The BatchedBGV over the tunnel's target ring S (for unpacking
        / further steps)."""
        new_params = type(self.params)(
            m=th.lin.s_ctx.m, p=self.params.p, qs=self.qs, var=self.params.var
        )
        return BatchedBGV(new_params)

    # --- device-side hint generation ----------------------------------------
    # The object path (she._ks_hint / she.tunnel_hint) runs one eager
    # device op per Cyc operation.  These wrappers compute
    # the (cheap, exact) targets in host numpy and produce all gadget
    # hints in ONE jitted device call; output distribution matches the
    # object path (threefry gaussians/uniforms), results are interchangeable
    # KSHint/TunnelHint objects (hints are keygen randomness — equality
    # with the host path is not required, decryption correctness is).

    def _check_sk(self, sk: she.SK, what: str) -> None:
        """Reject an SK from a different ring/chain (ADVICE r2: a
        mismatched SK would silently produce hints over the wrong ring
        context, mirroring gen_tunnel_hint's r_ctx guard)."""
        if sk.params.ctx != self.ctx or sk.params.qs != self.params.qs:
            raise ValueError(
                f"{what}: SK params (m={sk.params.m}, qs={sk.params.qs}) "
                f"!= pipeline params (m={self.params.m}, qs={self.params.qs})"
            )

    def gen_ks_quad_hint(self, sk: she.SK, key) -> she.KSHint:
        """Device-generated relinearization hint (she.ks_quad_circ_hint)."""
        self._check_sk(sk, "gen_ks_quad_hint")
        s_crt = _s_crt_np(self.ctx, sk.s_ints)
        qs = self.qs
        s2 = np.stack(
            [zq.np_mul_mod(s_crt[i], s_crt[i], q) for i, q in enumerate(qs)]
        )
        h0, h1 = _gen_gadget_hints(
            self.params, self.ctx, sk.s_ints, s2[None], key
        )
        return _mk_ks_hint(self.params, self.ctx, h0[0], h1[0])

    def gen_ks_linear_hint(self, s_new: she.SK, s_old: she.SK, key) -> she.KSHint:
        """Device-generated re-encryption hint (she.ks_linear_hint)."""
        self._check_sk(s_new, "gen_ks_linear_hint")
        self._check_sk(s_old, "gen_ks_linear_hint")
        tgt = _s_crt_np(self.ctx, s_old.s_ints)
        h0, h1 = _gen_gadget_hints(
            self.params, self.ctx, s_new.s_ints, tgt[None], key
        )
        return _mk_ks_hint(self.params, self.ctx, h0[0], h1[0])

    def gen_galois_hint(self, k: int, sk: she.SK, key) -> she.KSHint:
        """Device-generated sigma_k hint (she.ks_galois_hint)."""
        self._check_sk(sk, "gen_galois_hint")
        from . import zmstar

        perm = zmstar.automorphism_slot_perm(self.ctx.m, self.qs[0], k)
        tgt = _s_crt_np(self.ctx, sk.s_ints)[:, perm]
        h0, h1 = _gen_gadget_hints(
            self.params, self.ctx, sk.s_ints, tgt[None], key
        )
        return _mk_ks_hint(self.params, self.ctx, h0[0], h1[0])

    def _gen_hint_ext(self, sk_enc: she.SK, tgt_crt_ext: np.ndarray,
                      special_qs: tuple[int, ...], key) -> she.KSHintExt:
        """Shared extended-modulus hint generator: gadget encryptions of
        P * target over Q*P under sk_enc, with the BASE chain's RNS
        gadget.  Exactness note: P*t mod Q*P is determined by t mod Q
        alone (P*t = 0 mod every special prime), so targets need only
        their residues over the extended chain — no integer lift."""
        from . import gadget as gd_mod

        ext_qs = self.qs + tuple(special_qs)
        ctx_ext = ring_context(self.params.m, ext_qs)
        P = 1
        for qq in special_qs:
            P *= qq
        base_g = gd_mod.gadget_ints(RnsGad(), self.ctx.basis)
        params_ext = type(self.params)(
            m=self.params.m, p=self.params.p, qs=ext_qs, var=self.params.var
        )
        h0, h1 = _gen_gadget_hints(
            params_ext, ctx_ext, sk_enc.s_ints, tgt_crt_ext[None], key,
            gadget_ints=tuple(P * int(g) for g in base_g),
        )
        from .cyc import Cyc, Rep

        ell = len(base_g)
        return she.KSHintExt(
            self.params, ctx_ext, len(special_qs), RnsGad(),
            tuple(Cyc(ctx_ext, Rep.CRT, h0[0][j]) for j in range(ell)),
            tuple(Cyc(ctx_ext, Rep.CRT, h1[0][j]) for j in range(ell)),
        )

    def gen_ks_quad_hint_ext(self, sk: she.SK, special_qs: tuple[int, ...],
                             key) -> she.KSHintExt:
        """Device-generated extended-modulus relinearization hint
        (she.ks_quad_circ_hint_ext): gadget encryptions of P * s^2 over
        the chain Q*P (P = prod special_qs), with the BASE chain's RNS
        gadget — the digit inner product then runs over Q*P and the
        P-drop divides the keyswitch noise by P (SURVEY §3.6, the
        reference's q'' construction; VERDICT r3 #3)."""
        self._check_sk(sk, "gen_ks_quad_hint_ext")
        ext_qs = self.qs + tuple(special_qs)
        ctx_ext = ring_context(self.params.m, ext_qs)
        s_crt_ext = _s_crt_np(ctx_ext, sk.s_ints)  # (nrns_ext, n)
        s2 = np.stack([
            zq.np_mul_mod(s_crt_ext[i], s_crt_ext[i], q)
            for i, q in enumerate(ext_qs)
        ])
        return self._gen_hint_ext(sk, s2, tuple(special_qs), key)

    def gen_ks_linear_hint_ext(self, s_new: she.SK, s_old: she.SK,
                               special_qs: tuple[int, ...],
                               key) -> she.KSHintExt:
        """Device-generated extended-modulus re-encryption hint
        (she.ks_linear_hint_ext): gadget encryptions of P * s_old over
        Q*P under s_new, base-chain RNS gadget (see
        gen_ks_quad_hint_ext for the exactness argument)."""
        self._check_sk(s_new, "gen_ks_linear_hint_ext")
        self._check_sk(s_old, "gen_ks_linear_hint_ext")
        ext_qs = self.qs + tuple(special_qs)
        ctx_ext = ring_context(self.params.m, ext_qs)
        tgt = _s_crt_np(ctx_ext, s_old.s_ints)  # (nrns_ext, n)
        return self._gen_hint_ext(s_new, tgt, tuple(special_qs), key)

    def build_key_switch_linear_ext(self, hint: she.KSHintExt, mesh=None):
        """jit-compiled (c0, c1) -> (e0, e1): batched re-encryption with
        an extended-modulus hint — c1's base-chain digits inner-product
        with hints over Q*P, the special primes are dropped by repeated
        exact rescales, and the result rejoins c0 over Q (bit-exact vs
        she.key_switch_linear_ext; KS noise divided by P)."""
        qs = self.qs
        nrns = len(qs)
        ctx_ext, ext_qs, (h0, h0s, h1, h1s), drops = self._ext_hint_setup(
            hint, mesh=mesh
        )

        @_jit(mesh)
        def ksl(c0, c1):
            c1c = self._mesh_gathered(self._ntt(c1, inverse=True), mesh)
            acc0 = acc1 = None
            for i in range(nrns):
                di = self._mesh_channel_sharded(
                    self._digit_crt(c1c[i], i, c1, ext_qs, ctx=ctx_ext),
                    mesh,
                )
                t0 = _mulmod_sh_ch(ext_qs, di, h0[i], h0s[i])
                t1 = _mulmod_sh_ch(ext_qs, di, h1[i], h1s[i])
                acc0 = t0 if acc0 is None else _addmod_ch(ext_qs, acc0, t0)
                acc1 = t1 if acc1 is None else _addmod_ch(ext_qs, acc1, t1)
            for drop in drops:
                acc0, acc1 = drop(acc0), drop(acc1)
            return _addmod_ch(qs, c0, acc0), acc1

        return ksl

    def gen_tunnel_hint(self, lin, sk_s: she.SK, sk_r: she.SK,
                        key) -> she.TunnelHint:
        """Device-generated ring-tunneling hint set (she.tunnel_hint).

        Targets f(b_i * s_R) are exact host numpy; all d*ell gadget
        hints then come from one device call.  2-power towers: b_i * s_R
        is a negacyclic monomial shift of the secret's integer
        coefficients, and evalLin is gather + embed-scatter + np NTT +
        Hadamard per relative basis element.  General-m towers
        (VERDICT r3 #1): every step is a ring hom mod q, so the targets
        are computed per channel — b_i * s_R as a CRT Hadamard with the
        monomial's np CRT over R, inverse-CRT to POW, then the same
        gather / embed-scatter / np CRT over S / Hadamard with ys."""
        r_ctx, s_ctx, e_ctx = lin.r_ctx, lin.s_ctx, lin.e_ctx
        if r_ctx != self.ctx:
            raise ValueError("gen_tunnel_hint: pipeline ring != source ring")
        qs = self.qs
        nrns = len(qs)
        n_r, n_s = r_ctx.n, s_ctx.n
        coeff_tbl = gen.rel_coeff_table(e_ctx.m, r_ctx.m)  # (d, n_e)
        embed_tbl = gen.embed_pow_table(e_ctx.m, s_ctx.m)  # (n_e,)
        pos = gen.rel_pow_basis_positions(e_ctx.m, r_ctx.m)  # (d,)
        d = coeff_tbl.shape[0]
        ys_crt = [_cyc_crt_np(y) for y in lin.ys]
        s_ints = np.asarray(sk_r.s_ints, dtype=np.int64)

        from .ops import ntt as ntt_mod

        if r_ctx.fm.is_pow2() and s_ctx.fm.is_pow2():
            s_plans = s_ctx.ntt_plans()
            targets = []
            for i in range(d):
                sh = _monomial_mul_np(s_ints, int(pos[i]), n_r)  # b_i * s_R
                tgt = np.zeros((nrns, n_s), dtype=np.uint32)
                for k_rel in range(d):
                    a_k = sh[coeff_tbl[k_rel]]  # (n_e,) rel coeff over E
                    emb = np.zeros(n_s, dtype=np.int64)
                    emb[embed_tbl] = a_k
                    for ch, q in enumerate(qs):
                        crt = ntt_mod.np_ntt_forward(
                            np.mod(emb, q).astype(np.uint32)[None], s_plans[ch]
                        )[0]
                        prod = zq.np_mul_mod(crt, ys_crt[k_rel][ch], q)
                        tgt[ch] = (
                            (tgt[ch].astype(np.int64) + prod) % q
                        ).astype(np.uint32)
                targets.append(tgt)
        else:
            r_gps = r_ctx.general_plans()
            s_gps = s_ctx.general_plans()
            s_crt = _s_crt_np(r_ctx, s_ints)  # (nrns, n_r)
            mono = np.zeros((d, n_r), dtype=np.uint32)
            mono[np.arange(d), np.asarray(pos)] = 1
            targets_arr = np.zeros((d, nrns, n_s), dtype=np.uint32)
            for ch, q in enumerate(qs):
                bc = gen.np_crt(r_gps[ch], mono)  # (d, n_r) CRT of b_i
                prod_crt = (
                    bc.astype(np.int64) * s_crt[ch][None].astype(np.int64)
                ) % q
                prods = gen.np_crt(
                    r_gps[ch], prod_crt.astype(np.uint32), inverse=True
                )  # (d, n_r) POW coefficients of b_i * s_R mod q
                a = prods[:, coeff_tbl]  # (d, d_rel, n_e)
                emb = np.zeros((d, d, n_s), dtype=np.uint32)
                emb[..., embed_tbl] = a
                crt_s = gen.np_crt(
                    s_gps[ch], emb.reshape(d * d, n_s)
                ).reshape(d, d, n_s)
                ys_ch = np.stack([ys_crt[k][ch] for k in range(d)])  # (d, n_s)
                term = (
                    crt_s.astype(np.int64) * ys_ch[None].astype(np.int64)
                ) % q  # per-term mod: the d-term sum stays far below 2^63
                targets_arr[:, ch, :] = (term.sum(axis=1) % q).astype(
                    np.uint32
                )
            targets = list(targets_arr)

        params_s = type(self.params)(
            m=s_ctx.m, p=self.params.p, qs=qs, var=self.params.var
        )
        h0, h1 = _gen_gadget_hints(
            params_s, s_ctx, sk_s.s_ints, np.stack(targets), key
        )
        hints = tuple(
            _mk_ks_hint(params_s, s_ctx, h0[i], h1[i]) for i in range(d)
        )
        return she.TunnelHint(lin, RnsGad(), hints)


# ---------------------------------------------------------------------------
# hint-generation internals (host-exact targets + one-call device sampling)
# ---------------------------------------------------------------------------


def _s_crt_np(ctx, s_ints) -> np.ndarray:
    """(nrns, n) CRT residues of integer (powerful-basis) coefficients —
    host numpy transforms, no device dispatch (2-power: the numpy NTT;
    general m: gen.np_crt per-axis mirror)."""
    from .ops import ntt as ntt_mod

    s = np.asarray(s_ints, dtype=np.int64)
    if not ctx.fm.is_pow2():
        gps = ctx.general_plans()
        return np.stack([
            gen.np_crt(gp, np.mod(s, gp.q).astype(np.uint32)[None])[0]
            for gp in gps
        ])
    plans = ctx.ntt_plans()
    return np.stack([
        ntt_mod.np_ntt_forward(np.mod(s, p.q).astype(np.uint32)[None], p)[0]
        for p in plans
    ])


def _cyc_crt_np(cyc) -> np.ndarray:
    """Host CRT residues of a Cyc without eager device NTTs (POW feeds
    the numpy transform directly; 2-power DEC == POW; general-m DEC
    falls back to the device path — rare: constants are POW or CRT)."""
    from .cyc import Rep

    ctx = cyc.ctx
    if cyc.rep is Rep.CRT:
        return np.asarray(cyc.data)
    coeffs = np.asarray(cyc.data)  # (nrns, n) residues
    if not ctx.fm.is_pow2():
        if cyc.rep is Rep.DEC:
            return np.asarray(cyc.to_crt().data)
        gps = ctx.general_plans()
        return np.stack([
            gen.np_crt(gps[i], coeffs[i][None])[0] for i in range(len(gps))
        ])
    from .ops import ntt as ntt_mod

    plans = ctx.ntt_plans()
    return np.stack([
        ntt_mod.np_ntt_forward(coeffs[i][None], plans[i])[0]
        for i in range(len(plans))
    ])


def _monomial_mul_np(s: np.ndarray, p: int, n: int) -> np.ndarray:
    """x^p * s(x) in Z[x]/(x^n + 1): negacyclic coefficient shift."""
    out = np.empty(n, dtype=np.int64)
    out[p:] = s[: n - p]
    out[:p] = -s[n - p :]
    return out


def _mk_ks_hint(params, ctx, h0: np.ndarray, h1: np.ndarray) -> she.KSHint:
    """(ell, nrns, n) component arrays -> she.KSHint of CRT Cycs."""
    from .cyc import Cyc, Rep

    ell = h0.shape[0]
    return she.KSHint(
        params, ctx, RnsGad(),
        tuple(Cyc(ctx, Rep.CRT, h0[j]) for j in range(ell)),
        tuple(Cyc(ctx, Rep.CRT, h1[j]) for j in range(ell)),
    )


def _gen_gadget_hints(params, ctx, s_ints, targets: np.ndarray, key,
                      gadget_ints=None):
    """All RNS-gadget hints for a batch of targets in ONE jitted call.

    targets: (T, nrns, n) u32, CRT domain.  For target t, digit j:
      h0[t,j] = p*e_{t,j} + g_j*target_t - a_{t,j}*s,   h1[t,j] = a_{t,j}
    with e fresh rounded gaussians (var) and a fresh uniforms, all in the
    CRT domain over ctx.  Returns two (T, ell, nrns, n) numpy arrays.

    gadget_ints: override the gadget values (python ints, reduced per
    channel here) — the extended-modulus hints encode P*g_j of the BASE
    chain's gadget over the Q*P ctx (ell = len(gadget_ints) digits);
    default is ctx's own RNS gadget (ell = nrns).

    The 2-power e-NTTs run the staged XLA network (keygen is off the
    hot path)."""
    from .ops import ntt as ntt_mod

    qs = ctx.basis.qs
    nrns = len(qs)
    n = ctx.n
    T = targets.shape[0]
    p = params.p
    var = params.var
    pow2 = ctx.fm.is_pow2()
    plans = ctx.ntt_plans() if pow2 else None
    gplans = None if pow2 else ctx.general_plans()
    if gadget_ints is None:
        g_rns = gd_gadget_rns(ctx.basis)  # (ell, nrns)
    else:
        g_rns = np.array(
            [[int(g) % q for q in qs] for g in gadget_ints], dtype=np.int64
        ).astype(np.uint32)
    ell = g_rns.shape[0]
    L = T * ell
    cols = np.arange(L)
    jcol = cols % ell
    tcol = cols // ell
    # per-column gadget residue rows (1, L) per channel, + Shoup
    gcol = np.stack([g_rns[jcol, i] for i in range(nrns)])  # (nrns, L)
    gcol_sh = np.stack(
        [zq.shoup_np(gcol[i], q) for i, q in enumerate(qs)]
    )
    s_crt = _s_crt_np(ctx, s_ints)  # (nrns, n)
    s_sh = np.stack([zq.shoup_np(s_crt[i], q) for i, q in enumerate(qs)])

    @jax.jit
    def gen_hints(targets_dev, key):
        ke, *kas = jax.random.split(key, 1 + nrns)
        e = jnp.round(
            jax.random.normal(ke, (n, L), dtype=jnp.float32)
            * np.sqrt(var)
        ).astype(jnp.int32)
        pe = p * e
        # (T, nrns, n)[tcol] -> (L, nrns, n) -> (nrns, n, L)
        tg = jnp.transpose(targets_dev[jnp.asarray(tcol)], (1, 2, 0))
        h0, h1 = [], []
        for i, q in enumerate(qs):
            pe_res = jnp.mod(pe, q).astype(jnp.uint32)
            if pow2:
                pe_crt = ntt_mod.ntt_forward_cm(pe_res, plans[i])
            else:
                pe_crt = gen.crt_cm(gplans[i], pe_res)
            a = jax.random.randint(kas[i], (n, L), 0, q, dtype=jnp.uint32)
            gt = zq.mul_mod_shoup(
                tg[i], jnp.asarray(gcol[i])[None, :],
                jnp.asarray(gcol_sh[i])[None, :], q,
            )
            a_s = zq.mul_mod_shoup(
                a, jnp.asarray(s_crt[i])[:, None],
                jnp.asarray(s_sh[i])[:, None], q,
            )
            h0.append(zq.add_mod(pe_crt, zq.sub_mod(gt, a_s, q), q))
            h1.append(a)
        return jnp.stack(h0), jnp.stack(h1)  # (nrns, n, L)

    h0, h1 = gen_hints(jnp.asarray(targets), key)
    h0 = np.asarray(h0)
    h1 = np.asarray(h1)
    # columns l = t*ell + j -> (T, ell, nrns, n)
    out0 = np.transpose(h0.reshape(nrns, n, T, ell), (2, 3, 0, 1))
    out1 = np.transpose(h1.reshape(nrns, n, T, ell), (2, 3, 0, 1))
    return np.ascontiguousarray(out0), np.ascontiguousarray(out1)


def gd_gadget_rns(basis) -> np.ndarray:
    from . import gadget as gd

    return gd.gadget_rns(RnsGad(), basis)

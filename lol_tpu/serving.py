"""Serving-scale orchestration: homomorphic rounding and HomomPRF over
ciphertext BATCHES.

The object-level pipelines (`she.pt_round`, `prf.homom_prf`) manipulate
one ciphertext at a time with host round trips; this module assembles
the SAME op sequences from `she_batched.BatchedBGV`'s fused builders, so
entire batches ride each device execution:

  - `batched_pt_round`: the homomorphic plaintext rounding chain
    (Z_{2^k} -> Z_2 LSB stripping / Z_{3^k} -> Z_3 balanced-ternary
    stripping — she.pt_round's exact schedule) with every multiply a
    fused build_step, every chain alignment a build_mod_switch, the
    subtraction a build_add, and the exact divide a build_div_d.
  - `batched_homom_prf_component`: the reference HomomPRF call stack
    (SURVEY §3.6: mulPublic -> tunnel chain -> PTRound) at batch scale:
    build_mul_public -> build_tunnel per tower hop -> batched_pt_round.

Every constituent builder is individually bit-exact vs its `she` op, and
the schedules mirror she.pt_round / prf.homom_prf_component statement
for statement, so end-to-end outputs are bit-exact vs the object path
column by column (asserted in tests/test_serving.py).  LSD encoding
(the object rounding chain's convention).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from . import she
from .cyc import Rep
from .she_batched import BatchedBGV, _check_encoding


def _mk(bb: BatchedBGV, p_cur: int, L: int) -> BatchedBGV:
    """The pipeline over chain prefix qs[:L] at plaintext modulus p_cur."""
    base = bb.params
    return BatchedBGV(
        type(base)(m=base.m, p=p_cur, qs=base.qs[:L], var=base.var)
    )


def build_pt_round(bb: BatchedBGV, rh: she.PTRoundHints, f: int = 1,
                   encoding: str = "lsd", mesh=None):
    """Builder-style she.pt_round over batches: constructs every stage's
    jitted builder ONCE and returns (run, bb_out, f_out), where
    run: (c0, c1) -> (c0', c1') over bb_out's chain — reuse `run`
    across serving calls (the stage program and all scale bookkeeping
    are data-independent, so they are laid out at build time).

    The schedule is she.pt_round's, statement for statement (hint i is
    consumed at chain prefix L0 - i, exactly as pt_round_hints lays the
    hints out); plaintexts must be scalar (constant polynomials), as in
    the object path.

    encoding: "lsd" (the chain's native convention) or "msd".  The
    exact-divide schedule is intrinsically LSD (see she.pt_round's
    derivation / DESIGN §12: div_d's unit multiplication exactly
    divides the LSD noise scale but destroys MSD raw noise), so MSD
    inputs ride the exact encoding switches at the boundary — batched
    toLSD in front, the LSD program, batched toMSD on the output
    pipeline — mirroring she.pt_round's MSD route bit for bit.

    mesh: optional Mesh (as in BatchedBGV.build_step) — every step and
    mod-switch stage compiles mesh-aware; batch ('data') sharding is
    the serving axis for the chain (the modulus chain SHRINKS stage by
    stage, so an 'rns' axis only divides the early prefixes)."""
    if _check_encoding(encoding) == "msd":
        run_l, bb_out, f_out = build_pt_round(
            bb, rh, f=bb.to_lsd_f(f), encoding="lsd", mesh=mesh
        )
        to_lsd = bb.build_to_lsd()
        to_msd = bb_out.build_to_msd()

        def run_m(c0, c1):
            return to_msd(*run_l(*to_lsd(c0, c1)))

        return run_m, bb_out, bb_out.to_msd_f(f_out)
    p = bb.params.p
    pr, k = she._pt_round_base(p)
    if k == 1:
        return (lambda c0, c1: (c0, c1)), bb, f
    it = iter(rh.hints)
    L = len(bb.params.qs)
    py, fy, Ly = p, f, L
    prog = []  # closures over state {"y": pair, "b": pair}

    if pr == 2:
        shift = np.zeros((bb.ctx.n, 1), dtype=np.int32)
        shift[0, 0] = 1 << (k - 2)
        addp = bb.build_add_public(f=f)
        sa = jnp.asarray(shift)
        prog.append(lambda st: {**st, "y": addp(*st["y"], sa)})

    def emit_square(reg, pcur, Lcur, hint):
        step = _mk(bb, pcur, Lcur).build_step(hint, mesh=mesh)
        prog.append(
            lambda st: {**st, reg: step(*st[reg], *st[reg])}
        )

    def emit_align(reg, pcur, Lfrom, Lto):
        for Lc in range(Lfrom, Lto, -1):
            ms = _mk(bb, pcur, Lc).build_mod_switch(mesh=mesh)
            prog.append(lambda st, ms=ms: {**st, reg: ms(*st[reg])})

    for j in range(k, 1, -1):
        if pr == 2:
            fb, Lb = fy, Ly
            prog.append(lambda st: {**st, "b": st["y"]})
            for _ in range(she._lsb_squarings(j)):
                cur = _mk(bb, py, Lb)
                emit_square("b", py, Lb, next(it))
                fb = cur.step_f(fb, fb)
                Lb -= 1
        else:
            ft, Lt = fy, Ly
            prog.append(lambda st: {**st, "b": st["y"]})
            for _ in range(j - 1):  # b <- b^3 (square, align, times b)
                cur = _mk(bb, py, Lt)
                sq_step = cur.build_step(next(it), mesh=mesh)
                prog.append(
                    lambda st, s=sq_step: {**st, "sq": s(*st["b"], *st["b"])}
                )
                fsq = cur.step_f(ft, ft)
                emit_align("b", py, Lt, Lt - 1)
                ft = _mk(bb, py, Lt).mod_switch_f(ft)
                Lt -= 1
                cur = _mk(bb, py, Lt)
                mul_step = cur.build_step(next(it), mesh=mesh)
                prog.append(
                    lambda st, s=mul_step: {
                        **st, "b": s(*st["sq"], *st["b"])
                    }
                )
                ft = cur.step_f(fsq, ft)
                Lt -= 1
            fb, Lb = ft, Lt
        emit_align("y", py, Ly, Lb)
        while Ly > Lb:
            fy = _mk(bb, py, Ly).mod_switch_f(fy)
            Ly -= 1
        cur = _mk(bb, py, Ly)
        sub = cur.build_add(f_a=fy, f_b=fb, sub=True)
        div = cur.build_div_d(pr)
        prog.append(
            lambda st, sub=sub, div=div: {
                **st, "y": div(*sub(*st["y"], *st["b"]))
            }
        )
        fy = cur.div_d_f(pr, fy)
        py //= pr

    def run(c0, c1):
        st = {"y": (c0, c1)}
        for op in prog:
            st = op(st)
        return st["y"]

    return run, _mk(bb, py, Ly), fy


def batched_pt_round(bb: BatchedBGV, rh: she.PTRoundHints, c0, c1,
                     f: int = 1, encoding: str = "lsd", mesh=None):
    """One-shot form of build_pt_round: (bb_out, f_out, (c0', c1'))."""
    run, bb_out, f_out = build_pt_round(bb, rh, f=f, encoding=encoding,
                                        mesh=mesh)
    return bb_out, f_out, run(c0, c1)


def batched_homom_prf_component(fam, hints, bb: BatchedBGV, c0, c1,
                                bits, i: int, f: int = 1,
                                encoding: str = "lsd", mesh=None):
    """prf.homom_prf_component over a batch of key ciphertexts:
    component i of s * A_T(x) via build_mul_public, the tunnel-tower
    walk via build_tunnel per hop (both encoding-agnostic), then the
    TRUE homomorphic rounding (batched_pt_round, encoding-aware) when
    hints.rounds is present — else the plaintext-modulus
    reinterpretation (she.mod_switch_pt: pure p/f bookkeeping in LSD;
    MSD rides the exact encoding switches, since Delta = Q//p is
    p-dependent).  Returns (bb_out, f_out, (c0', c1'))."""
    at = fam.a_t(bits)
    a_pt = np.array(
        [int(v) % bb.params.p for v in at[i].lift_ints(rep=Rep.DEC)],
        dtype=np.int32,
    )
    c0, c1 = bb.build_mul_public()(c0, c1, jnp.asarray(a_pt[:, None]))
    cur = bb
    for th in hints.tunnels:
        c0, c1 = cur.build_tunnel(th, mesh=mesh)(c0, c1)
        cur = cur.target_pipeline(th)
    if hints.rounds is not None:
        return batched_pt_round(cur, hints.rounds, c0, c1, f=f,
                                encoding=encoding, mesh=mesh)
    if hints.p_final != cur.params.p:
        base = cur.params
        msd = _check_encoding(encoding) == "msd"
        if msd:  # exact switch to LSD, where reinterpretation is free
            c0, c1 = cur.build_to_lsd()(c0, c1)
            f = cur.to_lsd_f(f)
        cur = BatchedBGV(
            type(base)(m=base.m, p=hints.p_final, qs=base.qs, var=base.var)
        )
        f = f % hints.p_final
        if msd:
            c0, c1 = cur.build_to_msd()(c0, c1)
            f = cur.to_msd_f(f)
    return cur, f, (c0, c1)

"""Smoke test of the main path on an NVIDIA GPU, at deployment size.

One process drives the system through the entry points a user calls
(`BatchedBGV` builders and `serving`) at BGV m=32768 (n=2^14), three
30-bit NTT primes, p=257, batch 1024, plus the n=4096 ring, the general
ring m=18432 and the rounding chain.  Every check is exact integer
equality against a numpy oracle or the object path (`she`), on values
fetched back from the card.  For each builder it prints the compile
time, one steady call and the compiled program's memory, beside the
card's name and power limit.  The last line of stdout is one JSON
object; the script exits non-zero, and prints no such line, when JAX
finds no GPU or a check fails.

    python chip_smoke.py           # one card
    python chip_smoke.py --four    # the mesh phase only, on four cards
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

CARD = "not read"


def log(msg):
    print(msg, flush=True)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def timed(name, fn, *args, iters=5):
    """Compile fn ahead of time, run it, time `iters` steady calls and
    print the compiled program's memory; returns the first output."""
    import jax

    t0 = time.perf_counter()
    if hasattr(fn, "lower"):
        compiled = fn.lower(*args).compile()
        compile_s = time.perf_counter() - t0
        out = jax.block_until_ready(compiled(*args))
        m = compiled.memory_analysis()
        mem = (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, out "
               f"{m.output_size_in_bytes / 2**20:.1f} MiB, temp "
               f"{m.temp_size_in_bytes / 2**20:.1f} MiB")
    else:  # a chain of jitted stages: compile time includes one call
        compiled = fn
        out = jax.block_until_ready(fn(*args))
        compile_s = time.perf_counter() - t0
        mem = "chain of jitted stages"
    t0 = time.perf_counter()
    for _ in range(iters):
        res = compiled(*args)
    jax.block_until_ready(res)
    call_ms = (time.perf_counter() - t0) / iters * 1e3
    log(f"  {name}: compile {compile_s:.2f} s, call {call_ms:.3f} ms, "
        f"memory {mem} [{CARD}]")
    return out


def _eq(got, want, what):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError(f"{what}: mismatch")


def _rand_stack(key, qs, n, B):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(key, len(qs))
    return jnp.stack([
        jax.random.randint(k, (n, B), 0, q, dtype=jnp.uint32)
        for k, q in zip(ks, qs)
    ])


# --- phases -----------------------------------------------------------------


def phase_ntt(n, nrns, B):
    """Forward and inverse through ops.select, 16 columns vs numpy, and
    inverse(forward(x)) == x on the whole array.  All primes run in one
    program per direction, as in the pipeline."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from lol_tpu import numtheory as nt
    from lol_tpu.ops import ntt, select

    log(f"NTT n={n}, {nrns} primes, B={B} ({select.ntt_backend()})")
    rng = np.random.default_rng(n)
    cols = np.sort(rng.choice(B, 16, replace=False))
    plans = [ntt.ntt_plan(n, q) for q in nt.ntt_primes(2 * n, 30, nrns)]
    x = _rand_stack(jax.random.PRNGKey(n), [p.q for p in plans], n, B)

    def run(v, inverse):
        return jnp.stack([select.ntt_cm(v[i], p, inverse)
                          for i, p in enumerate(plans)])

    fwd = jax.jit(lambda v: run(v, False))
    inv = jax.jit(lambda v: run(v, True))
    y = timed("forward", fwd, x)
    z = timed("inverse", inv, x)
    xs = np.asarray(x[:, :, cols])
    for i, plan in enumerate(plans):
        _eq(np.asarray(y[i][:, cols]).T, ntt.np_ntt_forward(xs[i].T, plan),
            f"forward q={plan.q}")
        _eq(np.asarray(z[i][:, cols]).T, ntt.np_ntt_inverse(xs[i].T, plan),
            f"inverse q={plan.q}")
    if not bool(jax.jit(lambda a, b: (a == b).all())(inv(y), x)):
        raise AssertionError("inverse(forward(x)) != x")


def _bgv(m, nrns, p, seed=0):
    import jax

    from lol_tpu import numtheory as nt, she
    from lol_tpu.she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=p, qs=qs, var=2.0)
    ks, kh = jax.random.split(jax.random.PRNGKey(seed))
    sk = she.gen_sk(params, ks)
    bb = BatchedBGV(params)
    t0 = time.perf_counter()
    hint = jax.block_until_ready(bb.gen_ks_quad_hint(sk, kh))
    log(f"  keygen (gen_ks_quad_hint): {time.perf_counter() - t0:.2f} s "
        f"[{CARD}]")
    return bb, sk, hint


def _dropped(bb, sk):
    """The pipeline one prime down (the step's output chain) and its key."""
    from lol_tpu import she
    from lol_tpu.she_batched import BatchedBGV

    pr = bb.params
    params2 = she.SHEParams(m=pr.m, p=pr.p, qs=pr.qs[:-1], var=pr.var)
    return BatchedBGV(params2), she.SK(params2, sk.s_ints, sk.var)


def _messages(bb, B, seed):
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    n, p = bb.ctx.n, bb.params.p
    return [jax.random.randint(k, (n, B), 0, p, dtype=jnp.int32) for k in ks]


def _check_products(bb, got, m1, m2, what, ncols=8):
    import numpy as np

    from lol_tpu import she

    got = np.asarray(got[:, :ncols])
    a, b = np.asarray(m1[:, :ncols]), np.asarray(m2[:, :ncols])
    for c in range(ncols):
        _eq(got[:, c], she.pt_mul(bb.params, a[:, c], b[:, c]),
            f"{what} column {c}")


def phase_bgv(m, nrns, p, B, extras=False, msd=True):
    import jax
    import numpy as np

    from lol_tpu import numtheory as nt, she

    log(f"BGV m={m} (n={m // 2 if m & (m - 1) == 0 else 'general'}), "
        f"{nrns} primes, p={p}, B={B}")
    bb, sk, hint = _bgv(m, nrns, p)
    bb2, sk2 = _dropped(bb, sk)
    m1, m2 = _messages(bb, B, 1)
    encodings = ("lsd", "msd") if msd else ("lsd",)
    for enc_name in encodings:
        enc = bb.build_encrypt(sk, encoding=enc_name)
        c0, c1 = timed(f"build_encrypt {enc_name}", enc, m1,
                       jax.random.PRNGKey(2))
        d0, d1 = enc(m2, jax.random.PRNGKey(3))
        step = bb.build_step(hint, encoding=enc_name)
        e0, e1 = timed(f"build_step {enc_name}", step, c0, c1, d0, d1)
        f2 = bb.step_f(1, 1, encoding=enc_name)
        dec = bb2.build_decrypt(sk2, f=f2, encoding=enc_name)
        got = timed(f"build_decrypt {enc_name}", dec, e0, e1)
        _check_products(bb, got, m1, m2, f"step {enc_name}")
    if not extras:
        return
    enc = bb.build_encrypt(sk)
    c0, c1 = enc(m1, jax.random.PRNGKey(2))
    d0, d1 = enc(m2, jax.random.PRNGKey(3))
    want1 = np.asarray(m1[:, :8])
    s0, s1 = timed("build_mod_switch", bb.build_mod_switch(), c0, c1)
    dec_ms = bb2.build_decrypt(sk2, f=bb.mod_switch_f(1))
    _eq(np.asarray(dec_ms(s0, s1)[:, :8]), want1, "mod_switch")
    sk_new = she.gen_sk(bb.params, jax.random.PRNGKey(4))
    lh = bb.gen_ks_linear_hint(sk_new, sk, jax.random.PRNGKey(5))
    k0, k1 = timed("build_key_switch_linear", bb.build_key_switch_linear(lh),
                   c0, c1)
    _eq(np.asarray(bb.build_decrypt(sk_new)(k0, k1)[:, :8]), want1,
        "key_switch_linear")
    specials = tuple(nt.ntt_primes(m, 30, nrns + 2))[nrns:]
    hx = bb.gen_ks_quad_hint_ext(sk, specials, jax.random.PRNGKey(6))
    x0, x1 = timed("build_step_ext", bb.build_step_ext(hx), c0, c1, d0, d1)
    dec2 = bb2.build_decrypt(sk2, f=bb.step_f(1, 1))
    _check_products(bb, dec2(x0, x1), m1, m2, "step_ext")


def phase_tunnel(m_r, m_s, nrns, p, B):
    """build_tunnel R -> S, decrypted with the target key and compared
    with the object path (she.tunnel) on the same columns."""
    import jax
    import numpy as np

    from lol_tpu import linear as lin, numtheory as nt, she
    from lol_tpu.cyc import Cyc
    from lol_tpu.ring import ring_context
    from lol_tpu.she_batched import BatchedBGV

    log(f"tunnel m={m_r} -> m={m_s}, {nrns} primes, B={B}")
    qs = tuple(nt.ntt_primes(m_r, 30, nrns))
    pr = she.SHEParams(m=m_r, p=p, qs=qs, var=2.0)
    ps = she.SHEParams(m=m_s, p=p, qs=qs, var=2.0)
    kr, ks_, kh = jax.random.split(jax.random.PRNGKey(5), 3)
    sk_r, sk_s = she.gen_sk(pr, kr), she.gen_sk(ps, ks_)
    E = S = ring_context(m_s, qs)
    R = ring_context(m_r, qs)
    ys = [Cyc.zero(S) for _ in range(R.n // E.n)]
    ys[0] = Cyc.scalar(S, 1)  # the tower-descent projection
    f = lin.linear_pow(E, R, S, ys)
    bb = BatchedBGV(pr)
    th = bb.gen_tunnel_hint(f, sk_s, sk_r, kh)
    m1, _ = _messages(bb, B, 7)
    c0, c1 = bb.build_encrypt(sk_r)(m1, jax.random.PRNGKey(6))
    e0, e1 = timed("build_tunnel", bb.build_tunnel(th), c0, c1)
    bb_s = bb.target_pipeline(th)
    got = np.asarray(bb_s.build_decrypt(sk_s)(e0, e1)[:, :2])
    outs = bb_s.unpack((e0[:, :, :2], e1[:, :, :2]))
    cts = bb.unpack((c0[:, :, :2], c1[:, :, :2]))
    for b in range(2):
        ref = she.tunnel(th, cts[b])
        for k in range(2):
            _eq(outs[b].cs[k].data, ref.cs[k].to_crt().data,
                f"tunnel column {b} component {k}")
        _eq(got[:, b], she.decrypt(sk_s, ref), f"tunnel decrypt column {b}")


def _pt_round_setup(m, p_round, B, seed=0):
    """Hints for serving.build_pt_round Z_{p_round} -> Z_2 (device keygen
    per chain prefix) and one encrypted batch of scalar plaintexts."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace

    from lol_tpu import numtheory as nt, she
    from lol_tpu.she_batched import BatchedBGV

    M = she.pt_round_mults(p_round)
    qs = tuple(nt.ntt_primes(m, 30, M + 2))
    params = she.SHEParams(m=m, p=p_round, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(seed))
    hints = []
    for i in range(M):
        params_i = replace(params, qs=qs[: len(qs) - i])
        hints.append(BatchedBGV(params_i).gen_ks_quad_hint(
            she.SK(params_i, sk.s_ints, sk.var),
            jax.random.fold_in(jax.random.PRNGKey(1), i),
        ))
    bb = BatchedBGV(params)
    vals = jax.random.randint(jax.random.PRNGKey(11), (B,), 0, p_round,
                              dtype=jnp.int32)
    msgs = jnp.zeros((params.ctx.n, B), dtype=jnp.int32).at[0].set(vals)
    c0, c1 = bb.build_encrypt(sk)(msgs, jax.random.PRNGKey(2))
    return bb, sk, she.PTRoundHints(tuple(hints)), vals, (c0, c1)


def _check_rounded(bb_out, sk, f_out, y, vals, p_round, ncols=8):
    import numpy as np

    from lol_tpu import she

    sk_out = she.SK(bb_out.params, sk.s_ints, sk.var)
    got = np.asarray(bb_out.build_decrypt(sk_out, f=f_out)(*y)[:, :ncols])
    v = np.asarray(vals[:ncols])
    pr = bb_out.params.p
    _eq(got[0], ((2 * v * pr + p_round) // (2 * p_round)) % pr, "pt_round")
    if got[1:].any():
        raise AssertionError("pt_round: non-constant output")


def phase_pt_round(m, p_round, B):
    from lol_tpu import serving

    log(f"rounding chain Z_{p_round} -> Z_2, m={m}, B={B}")
    bb, sk, rh, vals, c = _pt_round_setup(m, p_round, B)
    run, bb_out, f_out = serving.build_pt_round(bb, rh)
    y = timed("serving.build_pt_round", run, *c)
    _check_rounded(bb_out, sk, f_out, y, vals, p_round)


def _shards(name, x):
    log(f"  {name} shards: " + ", ".join(
        f"dev{s.device.id}{tuple(s.data.shape)}" for s in x.addressable_shards
    ))


def phase_four_step(m=32768, B=1024):
    """build_step over four cards, meshes {'data': 4} and {'rns': 2,
    'data': 2}, each compared bit-exactly with the unsharded run on
    card 0."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lol_tpu.parallel import sharding as sh

    log(f"BGV step m={m}, 4 primes, B={B} over 4 cards")
    bb, sk, hint = _bgv(m, 4, 257)
    args = [_rand_stack(jax.random.PRNGKey(20 + i), bb.qs, bb.ctx.n, B)
            for i in range(4)]
    ref = timed("build_step (card 0)", bb.build_step(hint),
                *(jax.device_put(a, jax.devices()[0]) for a in args))
    for shape in ({"rns": 1, "data": 4}, {"rns": 2, "data": 2}):
        mesh = sh.make_mesh(shape)
        spec = NamedSharding(mesh, P("rns", None, "data"))
        out = timed(f"build_step mesh {shape}", bb.build_step(hint, mesh=mesh),
                    *(jax.device_put(a, spec) for a in args))
        for k in range(2):
            _shards(f"component {k}", out[k])
            _eq(out[k], ref[k], f"sharded step {shape} component {k}")


def phase_four_round(m=32768, p_round=4, B=1024):
    """serving.build_pt_round(mesh=) over four cards, checked by
    decryption against the exact rounding.  Z_4 -> Z_2 runs every stage
    kind of the chain (add, step, mod switch, sub, exact divide) once;
    Z_8 repeats them at more chain prefixes."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    import jax

    from lol_tpu import serving
    from lol_tpu.parallel import sharding as sh

    log(f"rounding chain Z_{p_round} -> Z_2, m={m}, B={B} over 4 cards")
    bb, sk, rh, vals, c = _pt_round_setup(m, p_round, B)
    mesh = sh.make_mesh({"rns": 1, "data": 4})
    spec = NamedSharding(mesh, P("rns", None, "data"))
    run, bb_out, f_out = serving.build_pt_round(bb, rh, mesh=mesh)
    out = timed("serving.build_pt_round mesh", run,
                *(jax.device_put(a, spec) for a in c))
    for k in range(2):
        _shards(f"component {k}", out[k])
    _check_rounded(bb_out, sk, f_out, out, vals, p_round)


def phase_four_ring(n=16384, rows=64):
    """ntt_ring_sharded over a 4-card 'ring' axis vs numpy."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lol_tpu import numtheory as nt
    from lol_tpu.ops import ntt
    from lol_tpu.parallel import sharding as sh

    log(f"ring-sharded NTT n={n} over a 4-card 'ring' axis")
    plan = ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, 1)[0])
    x = jax.random.randint(jax.random.PRNGKey(30), (rows, n), 0, plan.q,
                           dtype=jnp.uint32)
    mesh = sh.make_mesh({"ring": 4})
    xs = jax.device_put(x, NamedSharding(mesh, P(None, "ring")))
    y = timed("ntt_ring_sharded",
              jax.jit(lambda v: sh.ntt_ring_sharded(mesh, v, plan)), xs)
    _shards("output", y)
    _eq(y, ntt.np_ntt_forward(np.asarray(x), plan), "ring-sharded NTT")


def phase_four():
    """The mesh-aware paths over four cards."""
    import jax

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    phase_four_step()
    phase_four_round()
    phase_four_ring()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 1
    global CARD
    CARD = _card()
    log(f"card: {CARD}")
    log(f"devices: {len(devices)} x {devices[0].device_kind}, "
        f"jax {jax.__version__}")
    t0 = time.perf_counter()
    if args.four:
        phase_four()
    else:
        phase_ntt(4096, 2, 32768)
        phase_ntt(16384, 3, 1024)
        phase_bgv(32768, 3, 257, 1024)
        phase_bgv(8192, 3, 257, 1024, extras=True, msd=False)
        phase_bgv(18432, 3, 7, 1024, msd=False)
        phase_tunnel(32768, 16384, 3, 257, 1024)
        phase_pt_round(32768, 8, 1024)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s [{CARD}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

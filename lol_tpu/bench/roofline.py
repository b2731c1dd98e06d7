"""Per-kernel roofline table + profiler hook (SURVEY.md §6 tracing row).

The reference's only instruments are criterion wall-times; on the
device the useful per-kernel numbers are achieved integer-op throughput and HBM
bandwidth, next to the op's arithmetic intensity — that tells you which
side of the roofline a kernel sits on.  Device peaks vary per chip and
are not hardcoded; pass them (GOPS/GBps) to get utilization columns.

Run: python -m lol_tpu.bench.roofline [--n 4096] [--batch 8192]
Profiler traces: `with trace("/tmp/lol_trace"): ...` then load the
directory in TensorBoard / xprof.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace around a block (device + host timelines)."""
    import jax

    with jax.profiler.trace(log_dir):
        yield


def _time(fn, iters=30):
    import jax

    jax.block_until_ready(fn())
    t0 = time.time()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.time() - t0) / iters


def run(n: int = 4096, batch: int = 8192, peak_gops: float | None = None,
        peak_gbps: float | None = None):
    """Roofline rows for the hot kernels: the pipeline's NTT, pointwise modmul,
    L (prefix sum).  u32-op counts: Shoup modmul = 5 ops (2 mul via
    4x16-bit partials amortized + hi/lo + correction), add/sub_mod = 2."""
    import jax
    import jax.numpy as jnp

    from .. import numtheory as nt, zq
    from ..ops import ntt
    from ..ops import select

    q = nt.ntt_primes(2 * n, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, q, (n, batch), dtype=np.uint64).astype(np.uint32))
    y = jnp.asarray(rng.integers(0, q, (n, batch), dtype=np.uint64).astype(np.uint32))
    k = n.bit_length() - 1

    rows = []

    def add(op, secs, u32_ops, bytes_moved):
        gops = u32_ops / secs / 1e9
        gbps = bytes_moved / secs / 1e9
        rows.append((op, secs * 1e3, gops, gbps, u32_ops / bytes_moved))

    if select.ntt_backend() == "triton":
        # fused kernel: k/2 * n butterflies * (5+2+2) ops; one HBM read
        # and write per radix pass
        from ..ops.pallas import ntt_triton

        npass = len(ntt_triton.pass_sizes(k, ntt_triton.RMAX))
        cm = jax.jit(lambda v: select.ntt_cm(v, plan))
        add("ntt fused (triton)", _time(lambda: cm(x)),
            (k * n // 2) * batch * 9, 8 * n * batch * npass)
    xt = x.T
    fwd = ntt._jit_fwd(plan)
    add("ntt staged (xla)", _time(lambda: fwd(xt)),
        (k * n // 2) * batch * 9, 8 * n * batch * k)  # one pass per stage

    mul = jax.jit(lambda a, b: zq.mul_mod(a, b, q))
    add("pointwise modmul", _time(lambda: mul(x, y)),
        9 * n * batch, 12 * n * batch)
    addm = jax.jit(lambda a, b: zq.add_mod(a, b, q))
    add("pointwise modadd", _time(lambda: addm(x, y)),
        2 * n * batch, 12 * n * batch)

    dev = jax.devices()[0].device_kind
    print(f"# roofline @ {dev}, n={n}, batch={batch}, q={q}")
    hdr = f"{'op':24} {'ms':>8} {'u32 GOPS':>10} {'GB/s':>8} {'ops/byte':>9}"
    if peak_gops:
        hdr += f" {'%peak-ops':>10}"
    if peak_gbps:
        hdr += f" {'%peak-bw':>9}"
    print(hdr)
    for op, ms, gops, gbps, inten in rows:
        line = f"{op:24} {ms:8.3f} {gops:10.1f} {gbps:8.1f} {inten:9.2f}"
        if peak_gops:
            line += f" {100 * gops / peak_gops:9.1f}%"
        if peak_gbps:
            line += f" {100 * gbps / peak_gbps:8.1f}%"
        print(line)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--peak-gops", type=float, default=None)
    ap.add_argument("--peak-gbps", type=float, default=None)
    args = ap.parse_args()
    run(args.n, args.batch, args.peak_gops, args.peak_gbps)


if __name__ == "__main__":
    main()

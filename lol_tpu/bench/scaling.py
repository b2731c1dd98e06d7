"""Multi-device scaling report: NTT ops/s at 1 chip vs N chips.

BASELINE.md asks for NTT ops/s scaling efficiency at 1 chip / 1 host /
N>=2 hosts.  On a multi-GPU host this script reports true scaling (same
code: the mesh just gets bigger); on the virtual CPU mesh
(--platform cpu --devices 8) it only exercises the machinery, and its
"efficiency" reflects the simulator, not the interconnect.

Run: python -m lol_tpu.bench.scaling [--devices 8] [--platform cpu]
Prints one JSON line per mesh size.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np



def run(n=2048, nrns=4, batch_per_dev=64, platform=None, max_devices=None):
    import os

    if platform:
        os.environ.setdefault("JAX_PLATFORMS", platform)
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp

    from .. import numtheory as nt
    from ..ops import ntt
    from ..parallel import sharding as sh

    qs = nt.ntt_primes(2 * n, 30, nrns)
    plans = [ntt.ntt_plan(n, q) for q in qs]
    devs = jax.devices()
    if max_devices:
        devs = devs[:max_devices]
    rng = np.random.default_rng(0)
    results = []
    sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devs)]
    base_rate = None
    for nd in sizes:
        ddp = nd  # pure data-parallel scaling of the batched NTT
        mesh = sh.make_mesh({"data": ddp, "rns": 1}, devices=devs)
        B = batch_per_dev * ddp
        x = np.stack([
            rng.integers(0, q, (B, n), dtype=np.uint64).astype(np.uint32)
            for q in qs
        ])
        xs = sh.shard_batch_rns(mesh, jnp.asarray(x))
        out = sh.batched_ntt_sharded(mesh, xs, plans)
        jax.block_until_ready(out)
        iters = 10
        t0 = time.time()
        for _ in range(iters):
            out = sh.batched_ntt_sharded(mesh, out, plans)
        jax.block_until_ready(out)
        dt = time.time() - t0
        rate = B * iters / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        results.append((nd, rate, eff))
        print(json.dumps({
            "metric": f"batched NTT polys/sec, n={n}, {nrns}-prime RNS, {nd} devices",
            "value": round(rate),
            "unit": "poly/s",
            "vs_baseline": round(eff, 3),
        }))
    return results


def run_bgv(m=4096, nrns=3, batch_per_dev=64, platform=None, max_devices=None):
    """BGV ct-mult+keyswitch+rescale step sharded over the data axis —
    the BASELINE "BGV ... ops/sec at N hosts" report (same code scales
    the mesh on real slices; here the 8-device CPU mesh demonstrates
    the sharding)."""
    import os

    if platform:
        os.environ.setdefault("JAX_PLATFORMS", platform)
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .. import gadget as gd, numtheory as nt, she
    from ..parallel import sharding as sh
    from ..she_batched import BatchedBGV

    qs = tuple(nt.ntt_primes(m, 30, nrns))
    params = she.SHEParams(m=m, p=257, qs=qs, var=2.0)
    sk = she.gen_sk(params, jax.random.PRNGKey(0))
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), jax.random.PRNGKey(1))
    bb = BatchedBGV(params)
    step = bb.build_step(hint)
    n = params.ctx.n
    devs = jax.devices()
    if max_devices:
        devs = devs[:max_devices]
    rng = np.random.default_rng(0)
    results, base_rate = [], None
    for nd in [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devs)]:
        mesh = sh.make_mesh({"data": nd, "rns": 1}, devices=devs)
        B = batch_per_dev * nd
        spec = NamedSharding(mesh, P(None, None, "data"))
        arrs = [
            jax.device_put(
                jnp.asarray(np.stack([
                    rng.integers(0, q, (n, B), dtype=np.uint64).astype(np.uint32)
                    for q in qs
                ])), spec)
            for _ in range(4)
        ]
        out = step(*arrs)
        jax.block_until_ready(out)
        iters = 5
        t0 = time.time()
        for _ in range(iters):
            out = step(*arrs)
        jax.block_until_ready(out)
        rate = B * iters / (time.time() - t0)
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        results.append((nd, rate, eff))
        print(json.dumps({
            "metric": f"BGV mul+keyswitch+rescale ct-ops/sec, n={n}, "
                      f"{nrns}x30-bit RNS, {nd} devices",
            "value": round(rate),
            "unit": "ct-op/s",
            "vs_baseline": round(eff, 3),
        }))
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--bgv", action="store_true",
                    help="report the BGV pipeline scaling instead of NTT")
    args = ap.parse_args()
    if args.bgv:
        run_bgv(platform=args.platform, max_devices=args.devices)
    else:
        run(n=args.n, platform=args.platform, max_devices=args.devices)


if __name__ == "__main__":
    main()

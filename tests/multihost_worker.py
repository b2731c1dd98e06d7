"""Worker script for the 2-process multihost test (run as a subprocess).

Exercises the real `multihost.initialize` bring-up (VERDICT r2 #5): two
OS processes, each with 2 virtual CPU devices, form one jax.distributed
job over localhost; the host-spanning mesh runs a data-sharded NTT and a
cross-process reduction, checked against the numpy oracle per shard.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
Prints "MULTIHOST_OK <pid>" on success (the parent test asserts it).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


def main(pid: int, nproc: int, port: int) -> None:
    from lol_tpu import numtheory as nt
    from lol_tpu.ops import ntt
    from lol_tpu.parallel import multihost

    multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.device_count() == 2 * nproc, jax.device_count()
    mesh = multihost.global_mesh({"data": -1})
    assert mesh.shape["data"] == 2 * nproc

    n, q = 64, nt.ntt_primes(128, 30, 1)[0]
    plan = ntt.ntt_plan(n, q)
    B = 4 * nproc
    rng = np.random.default_rng(0)  # same seed both processes: shared view
    full = rng.integers(0, q, (B, n)).astype(np.uint32)
    per = B // nproc
    local = full[pid * per : (pid + 1) * per]
    sh = NamedSharding(mesh, P("data", None))
    g = jax.make_array_from_process_local_data(sh, local, full.shape)

    # data-sharded NTT: embarrassingly parallel over the host-spanning mesh
    y = jax.jit(lambda x: ntt.ntt_forward_stages(x, plan), out_shardings=sh)(g)
    want = ntt.np_ntt_forward(full, plan)
    for shard in y.addressable_shards:
        np.testing.assert_array_equal(np.asarray(shard.data), want[shard.index])

    # one cross-process (DCN-analog) collective: replicated global sum
    tot = jax.jit(
        lambda x: jnp.sum(x), out_shardings=NamedSharding(mesh, P())
    )(g)
    assert int(np.asarray(tot)) == int(full.sum(dtype=np.uint32)), "psum"

    # the real thing: a (rns x data) mesh SPANNING the two processes,
    # running the fused BGV step — "same code, bigger mesh", executed.
    # Deterministic threefry keygen gives both processes identical
    # keys/hints/ciphertexts; each contributes its local batch shard.
    from lol_tpu import gadget as gd, she
    from lol_tpu.parallel.multihost import global_mesh
    from lol_tpu.she_batched import BatchedBGV

    # DCN-crossing axis FIRST (global_mesh docstring): 'data' spans the
    # two processes, 'rns' stays within each process's devices
    mesh2 = global_mesh({"data": -1, "rns": 2})
    m_she = 32
    qs2 = tuple(nt.ntt_primes(m_she, 30, 2))
    params = she.SHEParams(m=m_she, p=257, qs=qs2, var=2.0)
    key = jax.random.PRNGKey(7)
    ks, kh, k1, k2 = jax.random.split(key, 4)
    sk = she.gen_sk(params, ks)
    hint = she.ks_quad_circ_hint(sk, gd.RnsGad(), kh)
    bb = BatchedBGV(params)
    rng2 = np.random.default_rng(1)
    Bs = 2 * mesh2.shape["data"]
    cts_a = [she.encrypt(sk, she.pt_random(params, rng2), k)
             for k in jax.random.split(k1, Bs)]
    cts_b = [she.encrypt(sk, she.pt_random(params, rng2), k)
             for k in jax.random.split(k2, Bs)]
    comps = [np.asarray(x) for x in (*bb.pack(cts_a), *bb.pack(cts_b))]
    sh2 = NamedSharding(mesh2, P("rns", None, "data"))
    dd = mesh2.shape["data"]
    per_d = Bs // nproc  # data axis is contiguous over processes

    def to_global(a):
        loc = a[:, :, pid * per_d : (pid + 1) * per_d]
        return jax.make_array_from_process_local_data(sh2, loc, a.shape)

    gargs = [to_global(a) for a in comps]
    e0, e1 = bb.build_step(hint, mesh=mesh2)(*gargs)
    ref0, ref1 = bb.build_step(hint)(*comps)  # local unsharded oracle
    for got, ref in ((e0, ref0), (e1, ref1)):
        refn = np.asarray(ref)
        for shard in got.addressable_shards:
            np.testing.assert_array_equal(
                np.asarray(shard.data), refn[shard.index]
            )

    # round-4: the extended-modulus (hybrid) keyswitch step over the
    # same host-spanning mesh (deterministic device keygen gives both
    # processes the same Q*P hints), vs the local unsharded oracle
    specials = tuple(nt.ntt_primes(m_she, 30, 4))[2:]
    hx = bb.gen_ks_quad_hint_ext(sk, specials, jax.random.PRNGKey(8))
    x0, x1 = bb.build_step_ext(hx)(*gargs)
    rx0, rx1 = bb.build_step_ext(hx)(*comps)
    for got, ref in ((x0, rx0), (x1, rx1)):
        refn = np.asarray(ref)
        for shard in got.addressable_shards:
            np.testing.assert_array_equal(
                np.asarray(shard.data), refn[shard.index]
            )

    print(f"MULTIHOST_OK {pid}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))

"""Debug assert-reduced kernel variant + multi-host mesh helper."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lol_tpu import numtheory as nt
from lol_tpu.ops import debug as dbg
from lol_tpu.ops import ntt

Q = nt.ntt_primes(128, 30, 1)[0]


def test_assert_reduced_concrete():
    x = jnp.asarray(np.array([0, Q - 1], dtype=np.uint32))
    dbg.assert_reduced(x, Q)
    with pytest.raises(dbg.ReductionError, match="residue"):
        dbg.assert_reduced(jnp.asarray(np.array([Q], dtype=np.uint32)), Q)


def test_assert_reduced_under_jit():
    @jax.jit
    def f(x):
        return dbg.assert_reduced(x, Q, where="jit-test")

    good = f(jnp.asarray(np.array([1, 2], dtype=np.uint32)))
    jax.block_until_ready(good)
    with pytest.raises(Exception):  # callback errors surface wrapped
        jax.block_until_ready(
            f(jnp.asarray(np.array([Q + 5], dtype=np.uint32)))
        )


def test_ntt_cm_checked(rng):
    plan = ntt.ntt_plan(64, Q)
    x = jnp.asarray(
        rng.integers(0, Q, (64, 128), dtype=np.uint64).astype(np.uint32)
    )
    y = dbg.ntt_cm_checked(x, plan)
    np.testing.assert_array_equal(
        np.asarray(y).T, ntt.np_ntt_forward(np.asarray(x).T, plan)
    )
    bad = x.at[0, 0].set(np.uint32(Q))
    with pytest.raises(Exception):
        jax.block_until_ready(dbg.ntt_cm_checked(bad, plan))


def test_global_mesh_shapes():
    from lol_tpu.parallel import multihost

    n = len(jax.devices())
    if n < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = multihost.global_mesh({"data": -1, "rns": 2})
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": n // 2, "rns": 2
    }
    with pytest.raises(ValueError, match="divisible"):
        multihost.global_mesh({"data": -1, "rns": 3})
    with pytest.raises(ValueError, match="at most one"):
        multihost.global_mesh({"a": -1, "b": -1})

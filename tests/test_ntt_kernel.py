"""The fused GPU NTT (ops/pallas/ntt_triton.py) against the numpy oracle.

Here the kernel runs in Pallas interpret mode, so the tests check its
stage network, twiddle tables, lazy ranges, digit prologue and padding;
small fused radices keep the interpreter fast.  `gpu`-marked tests run
the compiled kernel on the card and skip elsewhere.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lol_tpu import numtheory as nt
from lol_tpu.ops import ntt
from lol_tpu.ops.pallas import ntt_triton as nk


def _plan(n, idx=0):
    return ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, idx + 1)[idx])


def _rand(rng, q, shape):
    return rng.integers(0, q, shape, dtype=np.uint64).astype(np.uint32)


@pytest.fixture
def radix(monkeypatch):
    """Set the kernel's largest fused radix (small ones keep the
    interpreter fast)."""
    return lambda r: monkeypatch.setattr(nk, "RMAX", r)


def _oracle(x, plan, inverse):
    f = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward
    return f(x.T, plan).T


@pytest.mark.parametrize("slab", [8, 16])
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [256, 1024, 2048])
def test_kernel_matches_oracle(n, inverse, slab, rng, radix):
    radix(3)
    plan = _plan(n)
    x = _rand(rng, plan.q, (n, 2 * slab))
    got = nk.ntt_cm(jnp.asarray(x), plan, inverse, slab=slab,
                    interpret=True)
    np.testing.assert_array_equal(np.asarray(got), _oracle(x, plan, inverse))


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("src_idx", [0, 2], ids=["q_src<q", "q_src>q"])
def test_kernel_digit_prologue(n, src_idx, rng, radix):
    """pre_digit_q fuses the centered re-expansion from another prime."""
    radix(3)
    plan = _plan(n, 1)
    q_src = nt.ntt_primes(2 * n, 30, 3)[src_idx]
    x = _rand(rng, q_src, (n, 16))
    got = nk.ntt_cm(jnp.asarray(x), plan, pre_digit_q=q_src,
                    slab=8, interpret=True)
    want = np.asarray(ntt.redigit(jnp.asarray(x), q_src, plan.q))
    np.testing.assert_array_equal(np.asarray(got), _oracle(want, plan, False))


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_kernel_lazy_ranges_near_2_30(inverse, rng, radix):
    """Harvey's lazy [0, 4q) / [0, 2q) ranges stay inside u32 at the
    largest NTT prime below 2^30, on inputs pinned to the extremes."""
    radix(4)
    n = 256
    q = max(p for p in nt.ntt_primes(2 * n, 30, 8))
    assert q > (1 << 29) + (1 << 28)
    plan = ntt.ntt_plan(n, q)
    x = _rand(rng, q, (n, 16))
    x[:, :4] = q - 1
    x[::2, 4:8] = 0
    got = nk.ntt_cm(jnp.asarray(x), plan, inverse, slab=8,
                    interpret=True)
    np.testing.assert_array_equal(np.asarray(got), _oracle(x, plan, inverse))


@pytest.mark.parametrize("B", [5, 21])
def test_kernel_pads_ragged_batch(B, rng, radix):
    """A batch that is not a multiple of the slab is padded and cut back;
    forward then inverse returns the input."""
    radix(4)
    plan = _plan(256)
    x = _rand(rng, plan.q, (256, B))
    y = nk.ntt_cm(jnp.asarray(x), plan, slab=8, interpret=True)
    assert y.shape == (256, B)
    np.testing.assert_array_equal(np.asarray(y), _oracle(x, plan, False))
    back = nk.ntt_cm(y, plan, inverse=True, slab=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(back), x)


def test_kernel_default_radix(rng):
    """The radix the card runs (passes of up to 2^RMAX rows) at n = 64."""
    plan = _plan(64)
    x = _rand(rng, plan.q, (64, 8))
    assert nk.pass_sizes(6, nk.RMAX) == [3, 3]
    y = nk.ntt_cm(jnp.asarray(x), plan, slab=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(y), _oracle(x, plan, False))
    back = nk.ntt_cm(y, plan, inverse=True, slab=8, interpret=True)
    np.testing.assert_array_equal(np.asarray(back), x)


@pytest.mark.parametrize(
    "k,rmax,want",
    [(12, 6, [6, 6]), (14, 7, [7, 7]), (11, 6, [6, 5]), (13, 4, [4, 3, 3, 3]),
     (3, 6, [3]), (1, 7, [1])],
)
def test_pass_sizes(k, rmax, want):
    assert nk.pass_sizes(k, rmax) == want


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("s,r", [(0, 3), (3, 2), (5, 3)])
def test_pass_table_layout(s, r, inverse):
    """Row g, column 2^j + c is the twiddle of inner stage j's group c of
    program g — the global group (g * 2^j + c) of stage s + j."""
    plan = _plan(256)
    src = plan.ipsi_rev if inverse else plan.psi_rev
    T = nk.pass_table(src, s, r)
    assert T.shape == (1 << s, 1 << r)
    for g in range(1 << s):
        for j in range(r):
            for c in range(1 << j):
                assert T[g, (1 << j) + c] == src[(1 << (s + j)) + g * (1 << j) + c]


def test_kernel_rejects_bad_arguments():
    plan = _plan(64)
    x = jnp.zeros((64, 8), jnp.uint32)
    with pytest.raises(ValueError, match="forward-only"):
        nk.ntt_cm(x, plan, inverse=True, pre_digit_q=plan.q)
    with pytest.raises(ValueError, match="n=32"):
        nk.ntt_cm(x[:32], plan)
    with pytest.raises(ValueError, match="power of 2"):
        nk.ntt_cm(x, plan, slab=12)


@pytest.mark.parametrize(
    "spec,B", [(("rns", "data"), 64), ((None, "data"), 64), (("data", None), 64),
               ((None, "data"), 16), ((None, None), 21)],
    ids=["rns-data", "data", "coeff", "data-below-slab", "batch-not-split"],
)
def test_kernel_under_mesh(spec, B, rng, radix):
    """Under a mesh each device transforms its own share of the batch
    over 'data' (a share below the slab is padded there), bit-exactly;
    other layouts are resharded to that first, and a batch 'data' does
    not divide runs unsplit."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lol_tpu.parallel import sharding as sh

    radix(4)
    mesh = sh.make_mesh({"rns": 2, "data": 2})
    plan = _plan(256)
    x = _rand(rng, plan.q, (256, B))
    pspec = P(None, spec) if spec[0] == "rns" else P(*spec)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, pspec))
    slab = 8 if B != 16 else 16
    y = jax.jit(lambda v: nk.ntt_cm(v, plan, mesh=mesh, slab=slab,
                                    interpret=True))(xs)
    np.testing.assert_array_equal(np.asarray(y), _oracle(x, plan, False))
    share = B // 2 if B % 2 == 0 else B
    assert {s.data.shape for s in y.addressable_shards} == {(256, share)}


@pytest.mark.gpu
@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n,B", [(4096, 1024), (16384, 256)])
def test_kernel_compiled_on_gpu(n, B, inverse, gpu, rng):
    plan = _plan(n)
    x = _rand(rng, plan.q, (n, B))
    got = np.asarray(jax.jit(lambda v: nk.ntt_cm(v, plan, inverse))(x))
    cols = np.arange(0, B, B // 16)
    np.testing.assert_array_equal(got[:, cols],
                                  _oracle(x[:, cols], plan, inverse))

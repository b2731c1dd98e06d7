"""The NTT selection point, the shared helpers of ops/ntt.py, the compile
cache rules and chip_smoke.py's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from lol_tpu import numtheory as nt
from lol_tpu.ops import ntt, select
from lol_tpu.she_batched import decompose_cm

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "platform,want", [("cpu", "xla"), ("gpu", "triton"), (None, "xla")]
)
def test_ntt_backend(platform, want):
    """CPU runs the XLA stages, the GPU the Triton-route kernel; the
    default is the platform JAX compiles for (the CPU here)."""
    assert select.ntt_backend(platform) == want


@pytest.mark.parametrize("platform", ["neuron", "rocm", "METAL"])
def test_ntt_backend_unknown_platform_raises(platform):
    with pytest.raises(NotImplementedError, match=platform):
        select.ntt_backend(platform)


def _plan(n, idx=0):
    return ntt.ntt_plan(n, nt.ntt_primes(2 * n, 30, idx + 1)[idx])


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("n", [2, 64, 2048])
def test_select_ntt_cm_matches_oracle(n, inverse, rng):
    """ops.select.ntt_cm (the XLA axis-0 network here) == numpy oracle."""
    plan = _plan(n)
    x = rng.integers(0, plan.q, (n, 6), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(select.ntt_cm(jnp.asarray(x), plan, inverse))
    f = ntt.np_ntt_inverse if inverse else ntt.np_ntt_forward
    np.testing.assert_array_equal(got, f(x.T, plan).T)


def test_select_ntt_cm_digit_prologue(rng):
    n = 256
    plan = _plan(n, 0)
    q_src = nt.ntt_primes(2 * n, 30, 2)[1]
    x = rng.integers(0, q_src, (n, 4), dtype=np.uint64).astype(np.uint32)
    got = np.asarray(select.ntt_cm(jnp.asarray(x), plan, pre_digit_q=q_src))
    want = ntt.np_ntt_forward(
        np.asarray(ntt.redigit(jnp.asarray(x), q_src, plan.q)).T, plan
    ).T
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="forward-only"):
        select.ntt_cm(jnp.asarray(x), plan, inverse=True, pre_digit_q=q_src)


@pytest.mark.parametrize("nrns", [2, 3])
def test_redigit_matches_decompose_cm(nrns, rng):
    """ntt.redigit is decompose_cm's per-channel arithmetic, and equals
    the centered lift reduced mod each prime."""
    qs = tuple(nt.ntt_primes(512, 30, nrns))
    x = np.stack([rng.integers(0, q, (16, 3), dtype=np.uint64) for q in qs])
    x = x.astype(np.uint32)
    digs = np.asarray(decompose_cm(qs, jnp.asarray(x)))
    for i, qi in enumerate(qs):
        centered = np.where(x[i] >= (qi + 1) // 2, x[i].astype(np.int64) - qi,
                            x[i].astype(np.int64))
        for j, qj in enumerate(qs):
            got = np.asarray(ntt.redigit(jnp.asarray(x[i]), qi, qj))
            np.testing.assert_array_equal(got, digs[i, j])
            np.testing.assert_array_equal(got, (centered % qj).astype(np.uint32))


@pytest.mark.parametrize("n,S", [(256, 2), (1024, 3)])
def test_block_twiddles_finish_the_network(n, S, rng):
    """The first S DIT stages on the strided view, then each tS-row block
    with its block_twiddles table, is the whole forward transform."""
    plan = _plan(n)
    q = plan.q
    tS = n >> S
    x0 = rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32)
    x = x0.astype(np.int64)
    for s in range(S):  # stages 0..S-1 (global tables)
        m, t = 1 << s, n >> (s + 1)
        w = plan.psi_rev[m : 2 * m].astype(np.int64)[:, None]
        xs = x.reshape(m, 2, t)
        u, v = xs[:, 0], xs[:, 1] * w % q
        x = np.stack([(u + v) % q, (u - v) % q], axis=1).reshape(n)
    TB = ntt.block_twiddles(plan, False, S, tS)
    assert TB.shape == (n // tS, tS)
    blocks = x.reshape(n // tS, tS)
    for b in range(n // tS):
        y = blocks[b]
        for sp in range(tS.bit_length() - 1):
            mp, t = 1 << sp, tS >> (sp + 1)
            w = TB[b, mp : 2 * mp].astype(np.int64)[:, None]
            ys = y.reshape(mp, 2, t)
            u, v = ys[:, 0], ys[:, 1] * w % q
            y = np.stack([(u + v) % q, (u - v) % q], axis=1).reshape(tS)
        blocks[b] = y
    np.testing.assert_array_equal(blocks.reshape(n).astype(np.uint32),
                                  ntt.np_ntt_forward(x0, plan))


def _run(code, env_extra=None, cwd=None):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *code], capture_output=True,
                          text=True, env=env, cwd=cwd or ROOT, timeout=120)


@pytest.mark.parametrize("set_env", [True, False], ids=["env", "default"])
def test_compile_cache_dir(set_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set (and nothing else is set
    in code); otherwise the cache lives at a fixed path in the checkout."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_env else {}
    r = _run(["-c", "import jax, lol_tpu; "
              "print(jax.config.jax_compilation_cache_dir); "
              "print(lol_tpu.CACHE_DIR)"], env)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if set_env else str(ROOT / ".jax_cache")
    assert r.stdout.split() == [want, want]


@pytest.mark.parametrize("isolated", [False, True], ids=["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(isolated, tmp_path):
    """On the CPU, and alone in a directory without the package,
    chip_smoke.py exits non-zero and prints no ok line."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if isolated:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {"PYTHONPATH": ""} if isolated else {}
    r = _run([str(script)], env, cwd=cwd)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

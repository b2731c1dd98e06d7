"""Debug guards for the modular-arithmetic kernels.

SURVEY.md §6 "race detection / sanitizers" row: the analog of memory
sanitizers here is an overflow tripwire — every residue must sit in
[0, q) after reduction; a lazy-reduction bug shows up as a value in
[q, 2q) (or garbage after u32 wraparound).  `assert_reduced` is that
check: free on concrete arrays, and under jit it rides a host callback
so it works inside traced pipelines (enable for debugging only — the
callback forces a device->host sync).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


class ReductionError(AssertionError):
    pass


def _host_check(maxval, q, where):
    if int(maxval) >= int(q):
        raise ReductionError(
            f"assert_reduced{f' [{where}]' if where else ''}: residue "
            f"{int(maxval)} >= modulus {int(q)} (lazy-reduction overflow?)"
        )


def assert_reduced(x, q: int, where: str = ""):
    """Check every element of x is < q; returns x unchanged.

    Concrete inputs: immediate Python assert.  Traced inputs: a
    jax.debug.callback on the max — keeps the op jit-compatible at the
    cost of a sync, the debug-kernel-variant contract of SURVEY §6."""
    mx = jnp.max(x)
    if isinstance(mx, jax.core.Tracer):
        jax.debug.callback(_host_check, mx, np.uint32(q), where)
    else:
        _host_check(mx, q, where)
    return x


def ntt_cm_checked(x, plan, inverse: bool = False):
    """ops.select.ntt_cm (the platform's NTT) with the post-reduction
    assert — the 'debug kernel variant' for the fused NTT (checks both
    the input and the output channel against the plan's modulus)."""
    from . import select

    assert_reduced(x, plan.q, where=f"ntt_cm input n={plan.n}")
    y = select.ntt_cm(x, plan, inverse=inverse)
    return assert_reduced(y, plan.q, where=f"ntt_cm output n={plan.n}")

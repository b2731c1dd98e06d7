"""Which NTT implementation runs on which platform.

This is the one place that decides for the batched pipeline: every
coefficient-major transform of she_batched's builders, serving and the
general-m 2-axis goes through `ntt_cm`; the choice is made when the
caller is traced, from the platform JAX compiles for:

- "cpu": the staged XLA network (ops/ntt.py);
- "gpu": the fused Triton-route kernel (ops/pallas/ntt_triton.py);
- anything else: an error.  There is no fallback: a kernel that does
  not compile raises.

Three paths always run the XLA stages, on every platform: device keygen
(she_batched._gen_gadget_hints: one transform per hint, off the serving
path), the object path (she/cyc, row-major single polynomials) and the
ring-sharded NTT (parallel/sharding.py, whose stages are split across
devices by coefficient, which the kernel's batch-split layout cannot do).

Builders compiled for a mesh trace their bodies inside `over_mesh`, so
the kernel splits the batch over the mesh's 'data' axis.
"""

from __future__ import annotations

import contextlib
import contextvars

import jax

from . import ntt
from .pallas import ntt_triton

_BACKENDS = {"cpu": "xla", "gpu": "triton"}
_MESH = contextvars.ContextVar("ntt_mesh", default=None)


def ntt_backend(platform: str | None = None) -> str:
    """The NTT implementation ("xla" or "triton") for a JAX platform
    (default: the platform JAX compiles for)."""
    platform = platform or jax.default_backend()
    try:
        return _BACKENDS[platform]
    except KeyError:
        raise NotImplementedError(
            f"no NTT implementation for platform {platform!r}"
        ) from None


@contextlib.contextmanager
def over_mesh(mesh):
    """Transforms traced inside run per device on its share of the batch
    (the mesh's 'data' axis); mesh None leaves them unsplit."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def ntt_cm(x, plan: ntt.NTTPlan, inverse: bool = False,
           pre_digit_q: int | None = None):
    """(n, B) coefficient-major negacyclic NTT / inverse with the
    optional fused digit re-expansion prologue (forward only)."""
    if pre_digit_q is not None and inverse:
        raise ValueError("ntt_cm: pre_digit_q is a forward-only prologue")
    if ntt_backend() == "triton":
        return ntt_triton.ntt_cm(x, plan, inverse, pre_digit_q,
                                 mesh=_MESH.get())
    if inverse:
        return ntt.ntt_inverse_cm(x, plan)
    if pre_digit_q is not None:
        x = ntt.redigit(x, pre_digit_q, plan.q)
    return ntt.ntt_forward_cm(x, plan)

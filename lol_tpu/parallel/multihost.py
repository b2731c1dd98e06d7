"""Multi-host (DCN) initialization helpers.

SURVEY.md §3.9 / §6: the single-host code in parallel/sharding.py is
mesh-shape agnostic — "same code, bigger mesh".  This module provides
the missing glue for actually getting that bigger mesh: the
jax.distributed runtime bring-up and a host-spanning mesh constructor.
Not exercisable in a single-host sandbox (no second host to talk to);
the sharded pipelines themselves are tested on the 8-virtual-device CPU
mesh (tests/test_sharding.py), which compiles the identical collectives.

Typical usage (same script on every host, one process per host):

    from lol_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_mesh({"data": -1, "rns": 4})
"""

from __future__ import annotations

import numpy as np

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up the jax.distributed runtime (idempotent).

    Pass all three arguments (coordinator 'host:port', world size,
    rank) unless the cluster environment lets JAX detect them.

    Must run before anything initializes the XLA backend (jax.devices()
    etc.) — the idempotence check deliberately avoids jax.process_count,
    which would itself initialize the backend."""
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(shape: dict[str, int]) -> "jax.sharding.Mesh":
    """Mesh over ALL devices of the (multi-host) job.

    shape maps axis name -> size; exactly one axis may be -1 to absorb
    the remaining device count.  Axis order follows dict order with the
    first axis outermost — put the host-crossing axis ('data' for the
    batch-parallel BGV pipeline) FIRST so jax's device order keeps each
    host's devices contiguous in the inner axes."""
    from jax.sharding import Mesh

    devices = np.array(jax.devices())
    total = devices.size
    dims = list(shape.values())
    if dims.count(-1) > 1:
        raise ValueError("global_mesh: at most one -1 axis")
    known = int(np.prod([d for d in dims if d != -1]))
    if -1 in dims:
        if total % known:
            raise ValueError(
                f"global_mesh: {total} devices not divisible by {known}"
            )
        dims[dims.index(-1)] = total // known
    if int(np.prod(dims)) != total:
        raise ValueError(
            f"global_mesh: shape {dims} != device count {total}"
        )
    return Mesh(devices.reshape(dims), axis_names=tuple(shape.keys()))

"""lol_tpu — a ring-LWE lattice-cryptography framework in JAX.

Brand-new implementation of the reference library Lol's capability set
(cyclotomic rings, CRT/NTT tensor transforms, BGV SHE, ring tunneling,
KH-PRF, RLWE challenges): JAX/XLA plus a fused Pallas NTT for the GPU,
RNS residue channels, jax.sharding meshes.  See SURVEY.md for the layer
map and DESIGN.md for the architecture.
"""

import os as _os

import jax as _jax

# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set (JAX
# reads it itself), else a fixed directory inside the checkout — the
# path is part of the cache key, so it must not move between runs.
CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)

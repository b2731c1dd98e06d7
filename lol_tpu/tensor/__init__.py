"""Tensor backends.

The reference runs one generic Tensor interface over two backends (C++
`CT` and pure-Haskell `RT`) and uses their agreement as the oracle
(SURVEY.md §5.1).  Here:

- the XLA path (ops/ntt.py staged jnp) and the GPU kernel
  (ops/pallas/ntt_triton.py) share one arithmetic implementation;
- `cpp_backend` is the native C++ CPU backend (lol-cpp's role);
- the numpy mirrors in ops/ntt.py are the pure reference (RT's role).

Cross-backend bit-exactness is enforced by tests/test_cpp_backend.py and
tests/test_ntt_kernel.py.
"""

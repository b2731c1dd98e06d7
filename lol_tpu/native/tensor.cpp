// Native CPU tensor kernels — the analog of the reference's lol-cpp C++
// backend (SURVEY.md §3.3: zq.cpp / crt.cpp / l.cpp / g.cpp / tensor.cpp).
//
// Role in this framework: a fast host-side oracle for the device
// kernels — the "CT backend" to the numpy reference's "RT".
// Exposed via a C ABI consumed with ctypes (tensor/cpp_backend.py).
//
// All arrays are uint32 residues < q < 2^30; arithmetic uses native u64
// products (the device path synthesizes them from 16-bit limbs).
//
// Build: g++ -O3 -march=native -shared -fPIC -o liblol_tensor.so tensor.cpp

#include <cstdint>
#include <cstring>

using u32 = uint32_t;
using u64 = uint64_t;

extern "C" {

// ---------------------------------------------------------------------------
// Z_q scalar kernels (zq.cpp analog)
// ---------------------------------------------------------------------------

void zq_mul(const u32* a, const u32* b, u32* out, long n, u32 q) {
  for (long i = 0; i < n; ++i) out[i] = (u32)((u64)a[i] * b[i] % q);
}

void zq_add(const u32* a, const u32* b, u32* out, long n, u32 q) {
  for (long i = 0; i < n; ++i) {
    u32 s = a[i] + b[i];
    out[i] = s >= q ? s - q : s;
  }
}

void zq_sub(const u32* a, const u32* b, u32* out, long n, u32 q) {
  for (long i = 0; i < n; ++i)
    out[i] = a[i] >= b[i] ? a[i] - b[i] : a[i] + (q - b[i]);
}

// ---------------------------------------------------------------------------
// negacyclic NTT (crt.cpp analog, p = 2 path)
// Same network as ops/ntt.py: DIT natural->bit-reversed forward, GS
// bit-reversed->natural inverse; twiddle tables supplied by the caller
// (psi_rev layout), so results are bit-identical to the Python/device paths.
// ---------------------------------------------------------------------------

void ntt_fwd(u32* x, long batch, long n, u32 q, const u32* psi_rev) {
  for (long b = 0; b < batch; ++b) {
    u32* a = x + b * n;
    long t = n;
    for (long m = 1; m < n; m <<= 1) {
      t >>= 1;
      for (long i = 0; i < m; ++i) {
        u64 w = psi_rev[m + i];
        long j1 = 2 * i * t;
        for (long j = j1; j < j1 + t; ++j) {
          u32 u = a[j];
          u32 v = (u32)(w * a[j + t] % q);
          u32 s = u + v;
          a[j] = s >= q ? s - q : s;
          a[j + t] = u >= v ? u - v : u + (q - v);
        }
      }
    }
  }
}

void ntt_inv(u32* x, long batch, long n, u32 q, const u32* ipsi_rev,
             u32 n_inv) {
  for (long b = 0; b < batch; ++b) {
    u32* a = x + b * n;
    long t = 1;
    for (long m = n; m > 1; m >>= 1) {
      long h = m >> 1;
      long j1 = 0;
      for (long i = 0; i < h; ++i) {
        u64 w = ipsi_rev[h + i];
        for (long j = j1; j < j1 + t; ++j) {
          u32 u = a[j];
          u32 v = a[j + t];
          u32 s = u + v;
          a[j] = s >= q ? s - q : s;
          u32 d = u >= v ? u - v : u + (q - v);
          a[j + t] = (u32)(w * d % q);
        }
        j1 += 2 * t;
      }
      t <<= 1;
    }
    for (long j = 0; j < n; ++j) a[j] = (u32)((u64)a[j] * n_inv % q);
  }
}

// ---------------------------------------------------------------------------
// dense per-axis transform (crt.cpp general-p path): out = M @ x per batch
// column along the last axis; used for odd prime-power axes.
// ---------------------------------------------------------------------------

void axis_matvec(const u32* M, const u32* x, u32* out, long batch, long phi,
                 u32 q) {
  for (long b = 0; b < batch; ++b) {
    const u32* col = x + b * phi;
    u32* oc = out + b * phi;
    for (long i = 0; i < phi; ++i) {
      u64 acc = 0;
      const u32* row = M + i * phi;
      for (long j = 0; j < phi; ++j) {
        acc += (u64)row[j] * col[j];
        // lazy reduction: fits u64 for phi <= 2^18 at q < 2^30... not
        // quite (phi * q^2 can pass 2^64 for phi > 16); reduce every 16
        if ((j & 15) == 15) acc %= q;
      }
      oc[i] = (u32)(acc % q);
    }
  }
}

// ---------------------------------------------------------------------------
// L / L^-1 (l.cpp analog): prefix sums / differences along the prime level
// of one axis, axis viewed as (p-1, inner) blocks over contiguous memory.
// ---------------------------------------------------------------------------

void l_fwd(u32* x, long batch, long p, long inner, u32 q) {
  // pow[t] = sum_{t' <= t} dec[t'] along the (p-1)-level
  for (long b = 0; b < batch; ++b) {
    u32* blk = x + b * (p - 1) * inner;
    for (long t = 1; t < p - 1; ++t)
      for (long r = 0; r < inner; ++r) {
        u32 s = blk[t * inner + r] + blk[(t - 1) * inner + r];
        blk[t * inner + r] = s >= q ? s - q : s;
      }
  }
}

void l_inv(u32* x, long batch, long p, long inner, u32 q) {
  for (long b = 0; b < batch; ++b) {
    u32* blk = x + b * (p - 1) * inner;
    for (long t = p - 2; t >= 1; --t)
      for (long r = 0; r < inner; ++r) {
        u32 hi = blk[t * inner + r], lo = blk[(t - 1) * inner + r];
        blk[t * inner + r] = hi >= lo ? hi - lo : hi + (q - lo);
      }
  }
}

// ---------------------------------------------------------------------------
// mulG powerful basis (g.cpp analog): banded stencil per odd-prime axis.
//   (zeta x)[t,r] = x[t-1,r] (t>=1) - x[p-2,r];  (g x) = x - zeta x.
// ---------------------------------------------------------------------------

void mul_g_pow(const u32* x, u32* out, long batch, long p, long inner, u32 q) {
  for (long b = 0; b < batch; ++b) {
    const u32* blk = x + b * (p - 1) * inner;
    u32* ob = out + b * (p - 1) * inner;
    for (long t = 0; t < p - 1; ++t)
      for (long r = 0; r < inner; ++r) {
        u64 zx = (t >= 1 ? blk[(t - 1) * inner + r] : 0);
        zx = (zx + q - blk[(p - 2) * inner + r]) % q;
        u32 v = blk[t * inner + r];
        ob[t * inner + r] = (u32)((v + q - (u32)zx) % q);
      }
  }
}

// divG powerful basis (g.cpp analog): exact inverse of the mul_g_pow
// stencil.  From y = g*x with (zeta x)[t] = x[t-1] (t>=1) - x[p-2]:
//   sum_t y[t] = p * x[p-2]          => x[p-2] = p^{-1} sum_t y[t]
//   x[0] = y[0] - x[p-2];  x[t] = y[t] + x[t-1] - x[p-2]  (t >= 1).
// Over Z_q with gcd(p, q) = 1 the division always succeeds (the
// reference's Maybe flag concerns the integer-coefficient tensor).
void div_g_pow(const u32* x, u32* out, long batch, long p, long inner, u32 q,
               u32 p_inv) {
  long lvl = p - 1;
  for (long b = 0; b < batch; ++b) {
    const u32* blk = x + b * lvl * inner;
    u32* ob = out + b * lvl * inner;
    for (long r = 0; r < inner; ++r) {
      u64 s = 0;
      for (long t = 0; t < lvl; ++t) s += blk[t * inner + r];
      u32 xl = (u32)(s % q * p_inv % q);  // x[p-2]
      u32 prev = 0;
      for (long t = 0; t < lvl; ++t) {
        u64 v = (u64)blk[t * inner + r] + q - xl;  // y[t] - x[p-2]
        if (t >= 1) v += prev;                     // + x[t-1]
        prev = (u32)(v % q);
        ob[t * inner + r] = prev;
      }
      // prev now holds x[p-2] recomputed; consistency is guaranteed mod q
    }
  }
}

// ---------------------------------------------------------------------------
// cross-ring index ops (tensor.cpp twace/embed/coeffs analog): static
// gather / scatter tables computed by the plan layer (ops/general.py).
// ---------------------------------------------------------------------------

void gather_idx(const u32* x, u32* out, long batch, long n_out,
                const long* tbl, long n_in) {
  for (long b = 0; b < batch; ++b)
    for (long i = 0; i < n_out; ++i) out[b * n_out + i] = x[b * n_in + tbl[i]];
}

void scatter_idx(const u32* x, u32* out, long batch, long n_in,
                 const long* tbl, long n_out) {
  for (long b = 0; b < batch; ++b) {
    u32* ob = out + b * n_out;
    for (long i = 0; i < n_out; ++i) ob[i] = 0;
    for (long i = 0; i < n_in; ++i) ob[tbl[i]] = x[b * n_in + i];
  }
}

// out[b, i] = sum_{j < k} x[b, i*k + j] mod q (the twaceCRT coset sum)
void strided_sum(const u32* x, u32* out, long batch, long n_sub, long k,
                 u32 q) {
  for (long b = 0; b < batch; ++b)
    for (long i = 0; i < n_sub; ++i) {
      u64 acc = 0;
      const u32* grp = x + (b * n_sub + i) * k;
      for (long j = 0; j < k; ++j) acc += grp[j];
      out[b * n_sub + i] = (u32)(acc % q);
    }
}

// ---------------------------------------------------------------------------
// gSqNormDec (norm.cpp analog)
// ---------------------------------------------------------------------------

// 2-power m: n * (sum of squared centered lifts)... callers scale; this
// returns the raw sum of squares (matching the python oracle convention).
void gsq_norm_pow2(const u32* x, double* out, long batch, long n, u32 q) {
  for (long b = 0; b < batch; ++b) {
    double acc = 0;
    for (long j = 0; j < n; ++j) {
      long long v = x[b * n + j];
      if (v >= (long long)((q + 1) / 2)) v -= q;
      acc += (double)v * (double)v;
    }
    out[b] = acc;
  }
}

// general m: exact x^T G x over centered int64 lifts with 128-bit
// accumulation (G = integer Gram of the g-scaled decoding basis).
void gsq_norm_gram(const long long* x, const long long* G, double* out,
                   long batch, long n) {
  for (long b = 0; b < batch; ++b) {
    const long long* v = x + b * n;
    __int128 total = 0;
    for (long i = 0; i < n; ++i) {
      __int128 row = 0;
      const long long* g = G + i * n;
      for (long j = 0; j < n; ++j) row += (__int128)g[j] * v[j];
      total += row * v[i];
    }
    out[b] = (double)total;
  }
}

}  // extern "C"

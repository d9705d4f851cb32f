// The block FFT's tile machinery, shared by block_fft.cu and abft_fft.cu.
//
// A CTA tile holds S whole signals of N points (S * N <= 8192) in shared
// memory under an XOR swizzle of the point index (slot), and N / 16 * S
// threads run the plan's radix-2/4/8/16 stages on it with register
// codelets and compile-time twiddles (stage_first_rows, stage_mid,
// stage_last, which folds the digit reversal into its stores). load_tile
// and store_tile move a tile between global memory and the swizzled tile
// with 16-byte accesses where the layout allows. block_fft.cu's header
// comment gives the design and its reasons.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "stockham.cuh"

namespace turbofft {
namespace blockfft {

constexpr int kStoreUnroll = 2;                // store iterations unrolled
constexpr int kTile = 8192;                    // points per CTA tile
constexpr int kPts = 16;                       // points per thread and stage
constexpr int kMaxThreads = kTile / kPts;      // 512

// The launch's layout, as the host packs it (16 x int64, see block_fft_c64).
struct Desc {
  long long cnt[3], in[3], out[3];   // signal axes, slowest first
  long long pin, pout, total;        // point strides; signals in all
  int sigs, log_sigs;                // signals per CTA (a power of two)
  int vec_in, vec_out;               // complex64: 16-byte pairs allowed
};

template <typename V> struct Traits;
template <> struct Traits<float2> {
  using R = float;
  static constexpr int kMinBlocks = 2;           // 64 registers a thread
  // 16 banks of 8-byte words a half-warp: XOR bits 4-7 and 8-11 into 0-3
  __device__ __forceinline__ static int swz(int e) {
    return e ^ (((e >> 4) ^ (e >> 8)) & 15);
  }
};
template <> struct Traits<double2> {
  using R = double;
  static constexpr int kMinBlocks = 1;           // 128 KiB tiles
  // 8 banks of 16-byte words a quarter-warp: XOR bits 3-5, 6-8, 9-11
  __device__ __forceinline__ static int swz(int e) {
    return e ^ (((e >> 3) ^ (e >> 6) ^ (e >> 9)) & 7);
  }
};

template <typename V, bool SWZ>
__device__ __forceinline__ int slot(int e) {
  if constexpr (SWZ) {
    return Traits<V>::swz(e);
  } else {
    return e;
  }
}

template <typename V>
__device__ __forceinline__ V csub(V a, V b) {
  a.x -= b.x;
  a.y -= b.y;
  return a;
}

// a * (-i) in the forward direction, a * (+i) in the inverse
template <typename V, bool INV>
__device__ __forceinline__ V mul_mi(V a) {
  V r;
  if constexpr (INV) {
    r.x = -a.y;
    r.y = a.x;
  } else {
    r.x = a.y;
    r.y = -a.x;
  }
  return r;
}

// cos(2 pi j / 16); folds to a literal when j is a compile-time constant
__device__ __forceinline__ double cos16(int j) {
  switch (j & 15) {
    case 0: return 1.0;
    case 1: case 15: return 0.92387953251128675613;
    case 2: case 14: return 0.70710678118654752440;
    case 3: case 13: return 0.38268343236508977173;
    case 4: case 12: return 0.0;
    case 5: case 11: return -0.38268343236508977173;
    case 6: case 10: return -0.70710678118654752440;
    case 7: case 9: return -0.92387953251128675613;
    default: return -1.0;
  }
}

// v * w_RAD^e, w_RAD = exp(-2 pi i / RAD) forward, its conjugate inverse
template <typename V, int RAD, bool INV>
__device__ __forceinline__ V rot(V v, int e) {
  using R = typename Traits<V>::R;
  e &= RAD - 1;
  if (e == 0) return v;
  if (4 * e == RAD) return mul_mi<V, INV>(v);
  if (2 * e == RAD) {
    v.x = -v.x;
    v.y = -v.y;
    return v;
  }
  if (4 * e == 3 * RAD) return mul_mi<V, !INV>(v);
  const int j = e * (16 / RAD);
  const R c = (R)cos16(j);
  const R s = INV ? -(R)cos16(j - 4) : (R)cos16(j - 4);   // sin(2 pi j/16)
  V r;
  r.x = v.x * c + v.y * s;
  r.y = v.y * c - v.x * s;
  return r;
}

// In-register DFT of RAD points, in place: input n in z[n], output k in
// z[slot(k)]. RAD = A * B: n = B*n1 + n2, A-point DFTs over n1, twiddle
// w_RAD^(k1*n2), B-point DFTs over n2, output k = k1 + A*k2 (the plan's
// own index convention) left in z[B*k1 + k2]; the caller's compile-time
// indices absorb that transposition, so no temporary array is live.
template <typename V, bool INV, int RAD>
struct Fft {
  static constexpr int A = RAD == 8 ? 2 : 4;
  static constexpr int B = RAD / A;
  __host__ __device__ static constexpr int slot(int k) {
    return B * (k % A) + k / A;
  }
  __device__ __forceinline__ static void run(V* z) {
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
      V a[A];
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) a[n1] = z[B * n1 + n2];
      Fft<V, INV, A>::run(a);
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1)
        z[B * k1 + n2] = rot<V, RAD, INV>(a[Fft<V, INV, A>::slot(k1)],
                                         k1 * n2);
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      V b[B];
#pragma unroll
      for (int n2 = 0; n2 < B; ++n2) b[n2] = z[B * k1 + n2];
      Fft<V, INV, B>::run(b);
#pragma unroll
      for (int k2 = 0; k2 < B; ++k2)
        z[B * k1 + k2] = b[Fft<V, INV, B>::slot(k2)];
    }
  }
};

template <typename V, bool INV>
struct Fft<V, INV, 2> {
  __host__ __device__ static constexpr int slot(int k) { return k; }
  __device__ __forceinline__ static void run(V* z) {
    const V t = z[0];
    z[0] = cadd(t, z[1]);
    z[1] = csub(t, z[1]);
  }
};

template <typename V, bool INV>
struct Fft<V, INV, 4> {
  __host__ __device__ static constexpr int slot(int k) { return k; }
  __device__ __forceinline__ static void run(V* z) {
    const V t0 = cadd(z[0], z[2]), t1 = csub(z[0], z[2]);
    const V t2 = cadd(z[1], z[3]), t3 = mul_mi<V, INV>(csub(z[1], z[3]));
    z[0] = cadd(t0, t2);
    z[2] = csub(t0, t2);
    z[1] = cadd(t1, t3);
    z[3] = csub(t1, t3);
  }
};

template <int RAD> struct Log2;
template <> struct Log2<2> { static constexpr int v = 1; };
template <> struct Log2<4> { static constexpr int v = 2; };
template <> struct Log2<8> { static constexpr int v = 3; };
template <> struct Log2<16> { static constexpr int v = 4; };

// Output point of the value at in-place position `pos` after stages
// 0..nst-1 (log2 of their product: log_n).
__device__ __forceinline__ int natural_index(int pos, int nst,
                                             unsigned long long logr,
                                             int log_n) {
  int k = 0, wbits = log_n;
  for (int st = nst - 1; st >= 0; --st) {
    const int l = stage_log_radix(logr, st);
    wbits -= l;
    k |= (pos & ((1 << l) - 1)) << wbits;
    pos >>= l;
  }
  return k;
}

// A butterfly's outputs back to the tile: row k1 times the stage twiddle
// T[k1, n2] to slot(base + k1*m). T[k1, n2] = T[1, n2]^k1 is formed from
// T at the powers of two k1 = 2^b (log2 RAD table loads), one product per
// further set bit of k1.
template <typename V, bool INV, int RAD>
__device__ __forceinline__ void twiddle_store(V* s, const V* z, int base,
                                              int log_m, int n2,
                                              const V* __restrict__ tw) {
  using F = Fft<V, INV, RAD>;
  constexpr int lr = Log2<RAD>::v;
  s[slot<V, true>(base)] = z[F::slot(0)];
  V w[lr];
#pragma unroll
  for (int b = 0; b < lr; ++b) w[b] = __ldg(&tw[((1 << b) << log_m) + n2]);
#pragma unroll
  for (int k = 1; k < RAD; ++k) {
    V t;
    bool first = true;
#pragma unroll
    for (int b = 0; b < lr; ++b) {
      if (k & (1 << b)) {
        t = first ? w[b] : cmul(t, w[b]);
        first = false;
      }
    }
    s[slot<V, true>(base + (k << log_m))] = cmul(z[F::slot(k)], t);
  }
}

// A stage that is not the last: butterfly i reads points base + j*m of the
// swizzled tile, runs the codelet and writes row k1 times T[k1, n2] back to
// the same places, so the stage is in place.
template <typename V, bool INV, int RAD>
__device__ __forceinline__ void stage_mid(V* s, int nbf, int log_m,
                                          int log_ns,
                                          const V* __restrict__ tw) {
  const int m = 1 << log_m;
  // one butterfly at a time: its RAD points and twiddles are the thread's
  // whole working set (unrolling would spill)
#pragma unroll 1
  for (int i = threadIdx.x; i < nbf; i += blockDim.x) {
    const int n2 = i & (m - 1);
    const int base = ((i >> log_m) << log_ns) + n2;
    V z[RAD];
#pragma unroll
    for (int j = 0; j < RAD; ++j) z[j] = s[slot<V, true>(base + (j << log_m))];
    Fft<V, INV, RAD>::run(z);
    twiddle_store<V, INV, RAD>(s, z, base, log_m, n2, tw);
  }
}

// The first stage straight from global memory, for rows (point stride 1):
// butterfly i of signal j reads x[row j + n1*m + n2], n1 < RAD, every load
// of the thread issued before its first codelet, each load instruction of a
// warp a few contiguous runs. Saves the staging round trip through shared
// memory and its barrier. complex128 points are 16 bytes each. complex64
// threads work in lane pairs (butterflies n2, n2 + 1 of one signal): each
// loads 16-byte pairs of both columns, the even lane rows 0..RAD/2-1, the
// odd lane the rest, and one shuffle per row swaps the halves.
template <typename V, bool INV, int RAD>
__device__ __forceinline__ void stage_first_rows(V* s, const V* x,
                                                 long long base, long long st,
                                                 int nsig, int nbf,
                                                 int log_m, int log_n,
                                                 const V* __restrict__ tw) {
  constexpr int kPer = kPts / RAD;
  const int m = 1 << log_m;
  V z[kPer][RAD];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    const int j = i >> log_m;
    const bool live = i < nbf && j < nsig;
    if constexpr (std::is_same<V, float2>::value) {
      constexpr int kHalf = RAD / 2;
      const bool odd = threadIdx.x & 1;
      const float4* xv = reinterpret_cast<const float4*>(
          x + base + j * st + ((i & (m - 1)) & ~1)
          + (odd ? kHalf << log_m : 0));
      float4 v[kHalf];
#pragma unroll
      for (int r = 0; r < kHalf; ++r)
        v[r] = live ? __ldcs(xv + ((r << log_m) >> 1))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const float rx =
            __shfl_xor_sync(0xffffffffu, odd ? v[r].x : v[r].z, 1);
        const float ry =
            __shfl_xor_sync(0xffffffffu, odd ? v[r].y : v[r].w, 1);
        z[q][r] = odd ? make_float2(rx, ry) : make_float2(v[r].x, v[r].y);
        z[q][kHalf + r] =
            odd ? make_float2(v[r].z, v[r].w) : make_float2(rx, ry);
      }
    } else {
      const V* xs = x + base + j * st + (i & (m - 1));
#pragma unroll
      for (int r = 0; r < RAD; ++r) {
        z[q][r].x = 0;
        z[q][r].y = 0;
        if (live) z[q][r] = __ldcs(xs + (r << log_m));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    if (i < nbf) {
      const int n2 = i & (m - 1);
      Fft<V, INV, RAD>::run(z[q]);
      twiddle_store<V, INV, RAD>(s, z[q], ((i >> log_m) << log_n) + n2,
                                 log_m, n2, tw);
    }
  }
}

// The last stage (m = 1): every thread reads and transforms all its points,
// the CTA syncs, and each output goes straight to its natural position (the
// digit reversal folded into the store addresses). A thread past the
// tile's butterflies (tiny tiles) reads butterfly 0 and stores nothing, so
// the loads need no branch and the points stay in registers.
template <typename V, bool INV, int RAD>
__device__ __forceinline__ void stage_last(V* s, int nbf, int log_n, int nst,
                                           unsigned long long logr) {
  constexpr int kPer = kPts / RAD;
  constexpr int lr = Log2<RAD>::v;
  using F = Fft<V, INV, RAD>;
  V z[kPer][RAD];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    const int b = i < nbf ? i : 0;
#pragma unroll
    for (int j = 0; j < RAD; ++j) z[q][j] = s[slot<V, true>(b * RAD + j)];
    F::run(z[q]);
  }
  __syncthreads();
  const int lp = log_n - lr;            // log2 of butterflies per signal
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    if (i < nbf) {
      const int e0 = ((i >> lp) << log_n)
                     | natural_index(i & ((1 << lp) - 1), nst - 1, logr, lp);
#pragma unroll
      for (int k = 0; k < RAD; ++k)
        s[slot<V, true>(e0 | (k << lp))] = z[q][F::slot(k)];
    }
  }
}

// Tile point of staging index q: rows (point stride 1) put consecutive
// q on consecutive points of a signal, other layouts on consecutive signals.
// With pairs (complex64, 16-byte accesses) q counts pairs: two neighbouring
// points of one signal, or one point of two neighbouring signals.
__device__ __forceinline__ void tile_point(int q, bool rows, bool pairs,
                                           int log_n, int log_sigs, int& j,
                                           int& p, int& dj, int& dp) {
  if (rows) {
    const int e = pairs ? 2 * q : q;
    j = e >> log_n;
    p = e & ((1 << log_n) - 1);
    dj = 0;
    dp = 1;
  } else {
    const int ls = pairs ? log_sigs - 1 : log_sigs;
    p = q >> ls;
    j = (q & ((1 << ls) - 1)) << (pairs ? 1 : 0);
    dj = 1;
    dp = 0;
  }
}

// A global load: rows stream through the caches (evict first); strided
// columns load normally, so the other half of each 128-byte line, which
// the neighbouring CTA reads, can still be in L2.
template <typename T>
__device__ __forceinline__ T load_point(const T* p, bool rows) {
  return rows ? __ldcs(p) : *p;
}

// Global -> tile: tile point (j, p), point p of the CTA's signal j, sits at
// slot(j*N + p). Every load of a thread is issued before its first shared
// store (kPts points a thread at most), so each thread keeps up to 128 bytes
// in flight.
template <typename V, bool SWZ>
__device__ __forceinline__ void load_tile(V* s, const V* x, const Desc& d,
                                          long long base, int nsig,
                                          int log_n) {
  const int tile = d.sigs << log_n;
  const long long st = d.in[2];
  const bool rows = d.pin == 1;
  if constexpr (std::is_same<V, float2>::value) {
    if (d.vec_in) {
      float4 v[kPts / 2];
#pragma unroll
      for (int it = 0; it < kPts / 2; ++it) {
        const int q = threadIdx.x + it * blockDim.x;
        int j, p, dj, dp;
        tile_point(q, rows, true, log_n, d.log_sigs, j, p, dj, dp);
        v[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (q < (tile >> 1) && j < nsig)
          v[it] = load_point(reinterpret_cast<const float4*>(
                                 x + base + j * st + p * d.pin),
                             rows);
      }
#pragma unroll
      for (int it = 0; it < kPts / 2; ++it) {
        const int q = threadIdx.x + it * blockDim.x;
        int j, p, dj, dp;
        tile_point(q, rows, true, log_n, d.log_sigs, j, p, dj, dp);
        if (q < (tile >> 1)) {
          s[slot<V, SWZ>((j << log_n) + p)] = make_float2(v[it].x, v[it].y);
          s[slot<V, SWZ>(((j + dj) << log_n) + p + dp)] =
              make_float2(v[it].z, v[it].w);
        }
      }
      return;
    }
  }
  V v[kPts];
#pragma unroll
  for (int it = 0; it < kPts; ++it) {
    const int q = threadIdx.x + it * blockDim.x;
    int j, p, dj, dp;
    tile_point(q, rows, false, log_n, d.log_sigs, j, p, dj, dp);
    v[it].x = 0;
    v[it].y = 0;
    if (q < tile && j < nsig)
      v[it] = load_point(x + base + j * st + p * d.pin, rows);
  }
#pragma unroll
  for (int it = 0; it < kPts; ++it) {
    const int q = threadIdx.x + it * blockDim.x;
    int j, p, dj, dp;
    tile_point(q, rows, false, log_n, d.log_sigs, j, p, dj, dp);
    if (q < tile) s[slot<V, SWZ>((j << log_n) + p)] = v[it];
  }
}

// Tile point (j, p) times scale and the pass twiddle w_M^(p * (fast0 + j)):
// w = lo[e mod L] * hi[e / L], e = p * (fast0 + j) mod M, L = 2^log_l.
template <typename V, bool SWZ>
__device__ __forceinline__ V out_value(const V* s, int j, int p, int log_n,
                                       typename Traits<V>::R scale,
                                       const V* __restrict__ tw, int log_l,
                                       unsigned mask_m, long long fast0) {
  V v = cscale(s[slot<V, SWZ>((j << log_n) + p)], scale);
  if (tw != nullptr) {
    const unsigned e = ((unsigned)p * (unsigned)(fast0 + j)) & mask_m;
    const V w = cmul(__ldg(&tw[e & ((1u << log_l) - 1)]),
                     __ldg(&tw[(1u << log_l) + (e >> log_l)]));
    v = cmul(v, w);
  }
  return v;
}

// Tile -> global, the mirror of load_tile with the output strides.
template <typename V, bool SWZ>
__device__ __forceinline__ void store_tile(V* y, const V* s, const Desc& d,
                                           long long base, int nsig,
                                           int log_n,
                                           typename Traits<V>::R scale,
                                           const V* __restrict__ tw,
                                           int log_l, unsigned mask_m,
                                           long long fast0) {
  const int tile = d.sigs << log_n;
  const long long st = d.out[2];
  const bool rows = d.pout == 1;
  if constexpr (std::is_same<V, float2>::value) {
    if (d.vec_out) {
#pragma unroll kStoreUnroll
      for (int it = 0; it < kPts / 2; ++it) {
        const int q = threadIdx.x + it * blockDim.x;
        int j, p, dj, dp;
        tile_point(q, rows, true, log_n, d.log_sigs, j, p, dj, dp);
        if (q < (tile >> 1) && j < nsig) {
          const V a = out_value<V, SWZ>(s, j, p, log_n, scale, tw, log_l,
                                        mask_m, fast0);
          const V b = out_value<V, SWZ>(s, j + dj, p + dp, log_n, scale, tw,
                                        log_l, mask_m, fast0);
          __stcs(reinterpret_cast<float4*>(y + base + j * st + p * d.pout),
                 make_float4(a.x, a.y, b.x, b.y));
        }
      }
      return;
    }
  }
#pragma unroll kStoreUnroll
  for (int it = 0; it < kPts; ++it) {
    const int q = threadIdx.x + it * blockDim.x;
    int j, p, dj, dp;
    tile_point(q, rows, false, log_n, d.log_sigs, j, p, dj, dp);
    if (q < tile && j < nsig)
      __stcs(y + base + j * st + p * d.pout,
             out_value<V, SWZ>(s, j, p, log_n, scale, tw, log_l, mask_m,
                               fast0));
  }
}

}  // namespace blockfft
}  // namespace turbofft

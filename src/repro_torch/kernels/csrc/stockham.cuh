// Shared-memory mixed-radix Stockham stages, shared by block_fft.cu and
// abft_fft.cu.
//
// A CTA holds `nsig` whole signals of n = 2^log_n points in shared memory
// (s[q*n + i] is point i of signal q) and runs the plan's stages in place.
// Stage st has radix r = 2^lr and leaves sub-signals of m = ns / r points
// (ns = the current sub-signal length). One thread-level butterfly (p, n2)
// reads the r points s[p*ns + n1*m + n2], n1 < r, into registers, contracts
// them with the r x r DFT matrix W_r, multiplies row k1 by the stage twiddle
// T[k1, n2] (when m > 1) and writes k1 back to s[p*ns + k1*m + n2]: the same
// r locations it read, so the stage is in place with one barrier after it.
// That is the reference's recursion with its transposes deferred: after the
// last stage, output k = d0 + r0*(d1 + r1*(d2 + ...)) sits at position
// ((d0*r1 + d1)*r2 + d2)... (fft_tile.cuh's natural_index inverts it).
//
// W and T come precomputed from the host (repro_torch.core.fft.factors), as
// one flat table per plan: for each stage W_r (r*r, row-major [k1][n1]) and,
// when m > 1, T (r*m, row-major [k1][n2]). No trigonometry on the device.
// The stage radices travel packed as 4-bit log2 fields in one 64-bit word.
#pragma once

#include <cuda_runtime.h>

namespace turbofft {

template <typename R> struct Cplx;
template <> struct Cplx<float> { using T = float2; };
template <> struct Cplx<double> { using T = double2; };

template <typename V>
__device__ __forceinline__ V cmul(V a, V b) {
  V c;
  c.x = a.x * b.x - a.y * b.y;
  c.y = a.x * b.y + a.y * b.x;
  return c;
}

// acc + a * b
template <typename V>
__device__ __forceinline__ V cfma(V a, V b, V acc) {
  acc.x += a.x * b.x - a.y * b.y;
  acc.y += a.x * b.y + a.y * b.x;
  return acc;
}

template <typename V>
__device__ __forceinline__ V cadd(V a, V b) {
  a.x += b.x;
  a.y += b.y;
  return a;
}

template <typename V, typename R>
__device__ __forceinline__ V cscale(V a, R s) {
  a.x *= s;
  a.y *= s;
  return a;
}

__device__ __forceinline__ int stage_log_radix(unsigned long long logr,
                                               int st) {
  return (int)((logr >> (4 * st)) & 15ull);
}

// Radix-RAD butterfly with every point in registers (RAD <= 16).
template <typename V, int RAD>
__device__ __forceinline__ void butterfly_reg(V* s, int base, int m, int n2,
                                              const V* __restrict__ w,
                                              const V* __restrict__ tw) {
  V z[RAD];
#pragma unroll
  for (int j = 0; j < RAD; ++j) z[j] = s[base + j * m];
#pragma unroll
  for (int k = 0; k < RAD; ++k) {
    V acc;
    acc.x = 0;
    acc.y = 0;
#pragma unroll
    for (int j = 0; j < RAD; ++j) acc = cfma(__ldg(&w[k * RAD + j]), z[j], acc);
    if (tw != nullptr) acc = cmul(acc, __ldg(&tw[k * m + n2]));
    s[base + k * m] = acc;
  }
}

// Radix-r butterfly for the large radices (32..128) that reference plans
// use: the points go to a local array, correct but not fast.
template <typename V>
__device__ void butterfly_local(V* s, int base, int m, int n2, int r,
                                const V* __restrict__ w,
                                const V* __restrict__ tw) {
  V z[128];
  for (int j = 0; j < r; ++j) z[j] = s[base + j * m];
  for (int k = 0; k < r; ++k) {
    V acc;
    acc.x = 0;
    acc.y = 0;
    for (int j = 0; j < r; ++j) acc = cfma(__ldg(&w[k * r + j]), z[j], acc);
    if (tw != nullptr) acc = cmul(acc, __ldg(&tw[k * m + n2]));
    s[base + k * m] = acc;
  }
}

// All stages of the plan on nsig signals of 2^log_n points in s. Every
// thread of the CTA must call it; it ends with a barrier.
template <typename V>
__device__ void stockham_stages(V* s, int nsig, int log_n,
                                const V* __restrict__ tables, int nst,
                                unsigned long long logr) {
  const V* tab = tables;
  int log_ns = log_n;
  for (int st = 0; st < nst; ++st) {
    const int lr = stage_log_radix(logr, st);
    const int r = 1 << lr;
    const int log_m = log_ns - lr;
    const int m = 1 << log_m;
    const V* w = tab;
    tab += r * r;
    const V* tw = nullptr;
    if (m > 1) {
      tw = tab;
      tab += r * m;
    }
    const int nbf = nsig << (log_n - lr);  // butterflies in the tile
    for (int i = threadIdx.x; i < nbf; i += blockDim.x) {
      const int n2 = i & (m - 1);
      const int base = ((i >> log_m) << log_ns) + n2;
      switch (lr) {
        case 1: butterfly_reg<V, 2>(s, base, m, n2, w, tw); break;
        case 2: butterfly_reg<V, 4>(s, base, m, n2, w, tw); break;
        case 3: butterfly_reg<V, 8>(s, base, m, n2, w, tw); break;
        case 4: butterfly_reg<V, 16>(s, base, m, n2, w, tw); break;
        default: butterfly_local<V>(s, base, m, n2, r, w, tw); break;
      }
    }
    __syncthreads();
    log_ns = log_m;
  }
}

}  // namespace turbofft

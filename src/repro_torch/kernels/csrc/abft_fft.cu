// abft_fft: the block FFT with the paper's two-sided ABFT fused into it.
//
// Replaces the TPU kernel abft_fft_pallas (src/repro/kernels/stockham_abft.py,
// body _abft_kernel). Its (G, T) Pallas grid runs the T transactions of a
// checksum group one after another and carries the (8, N) right-side
// checksum scratch from grid step to grid step. CUDA blocks run in parallel
// and in no order, so here ONE CTA owns one checksum group and loops over its
// T*bs signals itself (the paper's multi-transaction threadblock), in tiles
// of whole signals that fit shared memory. Per tile it
//
//   * loads x and adds the tile's column sums X.e2 and X.e3 (e3 = the 1-based
//     global signal id tile*bs + row + 1) to the group's accumulators,
//   * takes the per-signal left input checksum (e1^T W) x_b (one warp per
//     signal) when per_signal is set,
//   * runs the Stockham stages of stockham.cuh,
//   * adds the simulated SEU [tile, row, col, enabled, eps_r, eps_i] to y
//     (before any output checksum, as the reference does),
//   * adds Y.e2 and Y.e3, writes delta_b = |s_in - e1^T y_b| / (|s_in| + EPS)
//     (zeros without per_signal) and writes y in natural order.
//
// Each thread owns a fixed set of columns for the whole loop, so the
// accumulation is race-free without atomics and the sum order is fixed:
// results are deterministic. Where a thread's 4 complex accumulators per
// column fit in registers (N <= 2048 at complex64, N <= 1024 at complex128)
// they live there and cs[:, g] is written once at the end; otherwise each
// thread accumulates into its own columns of the group's cs slice in global
// memory (the 4*N points of one group stay L2-resident).
//
// cs is (4, G, N) complex: [X.e2, X.e3, Y.e2, Y.e3], so cs[0] and cs[1] are
// the contiguous (G, N) inputs of the checksum FFT that follows.
//
// Bound on an H100: bytes. The function reads x once and writes y, cs and
// delta once: (2*B*N + 4*G*N)*sizeof(complex) + B*sizeof(real) at 3.35 TB/s.
// The checksum sums add about 8 flops per point, far below the peaks. The
// costs beyond the block FFT's are the per-tile read-modify-write of the
// accumulators where they do not fit in registers (L2 traffic, not device
// memory), and G = B / (bs*T) CTAs, which the Hopper plan sizes to fill the
// 132 SMs where the batch allows.
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace turbofft {

// Column sums of one tile: a2 = sum_q v_q, a3 = sum_q gid_q * v_q over the
// tile's nsig signals at shared-memory column `pos` (gid_q = sig0 + q + 1).
template <typename V, typename R>
__device__ __forceinline__ void tile_column_sums(const V* s, int n, int nsig,
                                                 long long sig0, int pos,
                                                 V& a2, V& a3) {
  a2.x = 0;
  a2.y = 0;
  a3.x = 0;
  a3.y = 0;
  for (int q = 0; q < nsig; ++q) {
    const V v = s[q * n + pos];
    const R gid = (R)(sig0 + q + 1);
    a2 = cadd(a2, v);
    a3.x += gid * v.x;
    a3.y += gid * v.y;
  }
}

template <typename R>
__device__ __forceinline__ R warp_sum(R v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// C = columns per thread held in registers; 0 = accumulate in cs itself.
template <typename R, int C>
__global__ void __launch_bounds__(kThreads)
abft_fft_kernel(const typename Cplx<R>::T* __restrict__ x,
                typename Cplx<R>::T* __restrict__ y, R* __restrict__ delta,
                typename Cplx<R>::T* __restrict__ cs,
                const typename Cplx<R>::T* __restrict__ tables,
                const typename Cplx<R>::T* __restrict__ ew,
                const typename Cplx<R>::T* __restrict__ e1,
                const R* __restrict__ inj, int log_n, int bs,
                int transactions, int groups, int sigs, int nst,
                unsigned long long logr, int per_signal) {
  using V = typename Cplx<R>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* s = reinterpret_cast<V*>(smem_raw);
  V* s_in = s + sigs * (1 << log_n);  // per-signal left input checksums

  const int n = 1 << log_n;
  const int g = blockIdx.x;
  const int rows = transactions * bs;
  const long long g0 = (long long)g * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  V* cs_x2 = cs + ((long long)0 * groups + g) * n;
  V* cs_x3 = cs + ((long long)1 * groups + g) * n;
  V* cs_y2 = cs + ((long long)2 * groups + g) * n;
  V* cs_y3 = cs + ((long long)3 * groups + g) * n;

  // The SEU descriptor: integer fields truncate toward zero, as the
  // reference's astype(int32); a row or column out of range never hits.
  bool inj_on = false;
  long long inj_sig = -1;
  int inj_col = 0;
  V inj_eps;
  inj_eps.x = 0;
  inj_eps.y = 0;
  if (inj != nullptr && inj[3] > (R)0) {
    const int tile = (int)inj[0];
    const int row = (int)inj[1];
    inj_col = (int)inj[2];
    if (row >= 0 && row < bs && inj_col >= 0 && inj_col < n) {
      inj_on = true;
      inj_sig = (long long)tile * bs + row;
      inj_eps.x = inj[4];
      inj_eps.y = inj[5];
    }
  }

  V acc[C > 0 ? C : 1][4];
  if constexpr (C > 0) {
#pragma unroll
    for (int ci = 0; ci < C; ++ci)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[ci][j].x = 0;
        acc[ci][j].y = 0;
      }
  } else {
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      V z;
      z.x = 0;
      z.y = 0;
      cs_x2[c] = z;
      cs_x3[c] = z;
      cs_y2[c] = z;
      cs_y3[c] = z;
    }
  }

  for (int r0 = 0; r0 < rows; r0 += sigs) {
    const int nsig = rows - r0 < sigs ? rows - r0 : sigs;
    const long long sig0 = g0 + r0;  // 0-based global id of the tile's first
    const int tot = nsig << log_n;
    const V* xb = x + sig0 * n;
    V* yb = y + sig0 * n;

    for (int i = threadIdx.x; i < tot; i += blockDim.x) s[i] = xb[i];
    __syncthreads();

    // right-side input checksums X.e2, X.e3
    if constexpr (C > 0) {
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const int c = threadIdx.x + ci * kThreads;
        if (c < n) {
          V a2, a3;
          tile_column_sums<V, R>(s, n, nsig, sig0, c, a2, a3);
          acc[ci][0] = cadd(acc[ci][0], a2);
          acc[ci][1] = cadd(acc[ci][1], a3);
        }
      }
    } else {
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        V a2, a3;
        tile_column_sums<V, R>(s, n, nsig, sig0, c, a2, a3);
        cs_x2[c] = cadd(cs_x2[c], a2);
        cs_x3[c] = cadd(cs_x3[c], a3);
      }
    }
    // left-side input checksum s_in[q] = sum_k (e1^T W)[k] x_q[k]
    if (per_signal) {
      for (int q = warp; q < nsig; q += nwarps) {
        V a;
        a.x = 0;
        a.y = 0;
        for (int k = lane; k < n; k += 32) a = cfma(__ldg(&ew[k]), s[q * n + k], a);
        a.x = warp_sum(a.x);
        a.y = warp_sum(a.y);
        if (lane == 0) s_in[q] = a;
      }
    }
    __syncthreads();

    stockham_stages<V>(s, nsig, log_n, tables, nst, logr);

    if (inj_on && threadIdx.x == 0 && inj_sig >= sig0 &&
        inj_sig < sig0 + nsig) {
      const int pos = (int)(inj_sig - sig0) * n + digit_rev(inj_col, nst, logr);
      s[pos] = cadd(s[pos], inj_eps);
    }
    __syncthreads();

    // right-side output checksums Y.e2, Y.e3 (y[q][c] sits at digit_rev(c))
    if constexpr (C > 0) {
#pragma unroll
      for (int ci = 0; ci < C; ++ci) {
        const int c = threadIdx.x + ci * kThreads;
        if (c < n) {
          V a2, a3;
          tile_column_sums<V, R>(s, n, nsig, sig0, digit_rev(c, nst, logr),
                                 a2, a3);
          acc[ci][2] = cadd(acc[ci][2], a2);
          acc[ci][3] = cadd(acc[ci][3], a3);
        }
      }
    } else {
      for (int c = threadIdx.x; c < n; c += blockDim.x) {
        V a2, a3;
        tile_column_sums<V, R>(s, n, nsig, sig0, digit_rev(c, nst, logr), a2,
                               a3);
        cs_y2[c] = cadd(cs_y2[c], a2);
        cs_y3[c] = cadd(cs_y3[c], a3);
      }
    }
    // left-side output checksum and the per-signal divergence
    if (per_signal) {
      for (int q = warp; q < nsig; q += nwarps) {
        V a;
        a.x = 0;
        a.y = 0;
        for (int k = lane; k < n; k += 32)
          a = cfma(__ldg(&e1[k]), s[q * n + digit_rev(k, nst, logr)], a);
        a.x = warp_sum(a.x);
        a.y = warp_sum(a.y);
        if (lane == 0) {
          const V si = s_in[q];
          const R dr = si.x - a.x;
          const R di = si.y - a.y;
          const R mag = sqrt(si.x * si.x + si.y * si.y) + (R)1e-30;
          delta[sig0 + q] = sqrt(dr * dr + di * di) / mag;
        }
      }
    } else {
      for (int q = threadIdx.x; q < nsig; q += blockDim.x) delta[sig0 + q] = 0;
    }
    for (int i = threadIdx.x; i < tot; i += blockDim.x) {
      const int k = i & (n - 1);
      yb[i] = s[(i - k) + digit_rev(k, nst, logr)];
    }
    __syncthreads();  // the next tile overwrites s
  }

  if constexpr (C > 0) {
#pragma unroll
    for (int ci = 0; ci < C; ++ci) {
      const int c = threadIdx.x + ci * kThreads;
      if (c < n) {
        cs_x2[c] = acc[ci][0];
        cs_x3[c] = acc[ci][1];
        cs_y2[c] = acc[ci][2];
        cs_y3[c] = acc[ci][3];
      }
    }
  }
}

template <typename R, int C>
int launch_abft(const void* x, void* y, void* delta, void* cs,
                const void* tables, const void* ew, const void* e1,
                const void* inj, int log_n, int bs, int transactions,
                int groups, int nst, unsigned long long logr, int per_signal,
                void* stream) {
  using V = typename Cplx<R>::T;
  const int n = 1 << log_n;
  const int rows = transactions * bs;
  int sigs = n >= kTileElems ? 1 : kTileElems / n;
  if (sigs > rows) sigs = rows;
  const size_t smem = ((size_t)sigs * n + sigs) * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      abft_fft_kernel<R, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  abft_fft_kernel<R, C><<<groups, kThreads, smem, (cudaStream_t)stream>>>(
      (const V*)x, (V*)y, (R*)delta, (V*)cs, (const V*)tables, (const V*)ew,
      (const V*)e1, (const R*)inj, log_n, bs, transactions, groups, sigs, nst,
      logr, per_signal);
  return (int)cudaGetLastError();
}

// Picks the register-accumulator width: 4 complex accumulators per column
// must fit in 64 registers a thread.
template <typename R>
int dispatch_abft(const void* x, void* y, void* delta, void* cs,
                  const void* tables, const void* ew, const void* e1,
                  const void* inj, long long batch, int log_n, int bs,
                  int transactions, int nst, unsigned long long logr,
                  int per_signal, void* stream) {
  if (bs <= 0 || transactions <= 0 || batch % ((long long)bs * transactions))
    return (int)cudaErrorInvalidValue;
  const long long groups = batch / ((long long)bs * transactions);
  if (groups == 0) return (int)cudaSuccess;
  if (groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n = 1 << log_n;
  const int cols = (n + kThreads - 1) / kThreads;
  const int max_cols = sizeof(R) == 4 ? 8 : 4;
#define TURBOFFT_ABFT(CC)                                                    \
  return launch_abft<R, CC>(x, y, delta, cs, tables, ew, e1, inj, log_n, bs, \
                            transactions, (int)groups, nst, logr,           \
                            per_signal, stream)
  if (cols > max_cols) TURBOFFT_ABFT(0);
  if (cols == 1) TURBOFFT_ABFT(1);
  if (cols == 2) TURBOFFT_ABFT(2);
  if (cols <= 4) TURBOFFT_ABFT(4);
  TURBOFFT_ABFT(8);
#undef TURBOFFT_ABFT
}

}  // namespace turbofft

extern "C" {

// x, y: (batch, 2^log_n) complex64, contiguous, batch = G * transactions * bs;
// delta: (batch,) float32; cs: (4, G, 2^log_n) complex64; ew, e1: (2^log_n,)
// complex64 encoding vectors; inj: 6 float32 on the device or NULL. Returns
// the CUDA error code of the launch (0 on success).
int abft_fft_c64(const void* x, void* y, void* delta, void* cs,
                 const void* tables, const void* ew, const void* e1,
                 const void* inj, long long batch, int log_n, int bs,
                 int transactions, int nst, unsigned long long logr,
                 int per_signal, void* stream) {
  return turbofft::dispatch_abft<float>(x, y, delta, cs, tables, ew, e1, inj,
                                        batch, log_n, bs, transactions, nst,
                                        logr, per_signal, stream);
}

// As abft_fft_c64 for complex128 (delta and inj in float64).
int abft_fft_c128(const void* x, void* y, void* delta, void* cs,
                  const void* tables, const void* ew, const void* e1,
                  const void* inj, long long batch, int log_n, int bs,
                  int transactions, int nst, unsigned long long logr,
                  int per_signal, void* stream) {
  return turbofft::dispatch_abft<double>(x, y, delta, cs, tables, ew, e1, inj,
                                         batch, log_n, bs, transactions, nst,
                                         logr, per_signal, stream);
}

}  // extern "C"

// block_fft: batched C2C FFT of power-of-two length N <= 8192, one launch per
// pass of a (multi-pass) transform.
//
// Replaces the TPU kernel block_fft_pallas (src/repro/kernels/stockham.py,
// body _fft_kernel), which runs the plan's stages on a VMEM-resident (bs, N)
// tile with 4 real MXU matmuls per stage on split re/im arrays, and which the
// JAX level wraps in materialised transposes and a twiddle multiply for
// N > 8192.
//
// What a launch computes. Signal q of the launch is addressed through a
// layout descriptor: up to three signal axes (count, input stride, output
// stride; the last axis is the fastest) and a point stride on each side.
// Each signal is read once, transformed through the plan's stages, times
// `scale`, times the optional pass twiddle w_M^(k * i) (k the output point,
// i = offset + the signal's index along the fastest axis + mid_step * its
// index along the axis before it; M = 2^tw_log_m, by default N * the
// fastest axis's count with offset = mid_step = 0), and written once. The
// offset and mid_step let one pass of a pencil-sharded transform apply the
// twiddle of its global columns: w_Ntotal^(k1 * (shard offset + column)). A P-pass transform is P such launches with no other
// work between them (repro_torch.core.fft.plan.pass_layouts gives the
// layouts); a single pass is one signal axis of contiguous rows.
//
// Bound on an H100: bytes. The function reads x once and writes y once,
// 2 * B * N * sizeof(complex) at 3.35 TB/s; 5 N log2 N flops per signal are
// far below the fp32/fp64 peaks at N <= 8192. The design, the paper's
// template (a thread-level FFT in registers, a threadblock-level exchange
// through shared memory):
//
// * One CTA holds a tile of S whole signals, S * N <= 8192 points (64 KiB at
//   complex64, 128 KiB at complex128), and runs N / 16 * S threads, each
//   holding 16 points of every stage in registers.
// * Each stage of radix r <= 16 is 16 / r register codelets per thread with
//   compile-time twiddles (+-i, sqrt(1/2), cos and sin of pi/8), in place in
//   the thread's registers: no DFT matrix, no table loads inside a
//   butterfly. The stage twiddles T[k1, n2] of a butterfly come from
//   log2(r) reads of the plan's flat stage table (T at k1 = 1, 2, 4, 8; its
//   W_r parts are skipped) and one product per further bit of k1.
// * The exchange between stages goes through shared memory in place, under
//   an XOR swizzle of the point index that keeps every stage's reads and
//   writes, the staging copies and the final reorder at most 2-way bank
//   conflicted. The digit reversal is folded into the last stage's stores.
// * Global loads and stores are 16 bytes a thread, coalesced. Rows (point
//   stride 1) go straight into the first stage's registers (complex64 lane
//   pairs load two columns and swap halves with one shuffle per row);
//   strided columns and every output go through a staging copy in shared
//   memory, complex64 as pairs of points (two of a row, or one point of two
//   neighbouring signals). A CTA takes consecutive signals along the
//   fastest axis, so every point row of a strided pass is one contiguous
//   run (S * 8 bytes or more). Row loads and all stores stream (evict
//   first); strided column loads are cached, so the rest of each line is
//   still in L2 when the neighbouring CTA reads it.
// * The pass twiddle is two table loads (the exponent split into high and
//   low halves, both tables built in float64 on the host) and two complex
//   multiplies on the way out.
// * No spills: 64 registers a thread at complex64 (two 512-thread CTAs an
//   SM), 128 at complex128 (one 128 KiB CTA an SM).
//
// Plans with a radix above 16 (the reference's radix-128 plans) take the
// generic stages of stockham.cuh (a direct DFT against the table) on an
// unswizzled tile, then a register reorder: correct, not fast.
#include <cuda_runtime.h>

#include "fft_tile.cuh"
#include "smem_limit.cuh"

namespace turbofft {
namespace blockfft {

// x and y may be the same buffer (a pass in place): a CTA reads its whole
// tile before it writes, and the CTAs' tiles are disjoint. DIRECT: the first
// stage reads the rows itself (stage_first_rows); a separate instance, so
// the staged instance's code is not reshaped by it.
template <typename V, bool INV, bool FAST, bool DIRECT>
__global__ void __launch_bounds__(kMaxThreads, Traits<V>::kMinBlocks)
block_fft_kernel(const V* x, V* y, const V* __restrict__ tables,
                 const V* __restrict__ tw, Desc d, int log_n, int nst,
                 unsigned long long logr, int log_l, unsigned mask_m,
                 long long tw_off, long long tw_mid,
                 typename Traits<V>::R scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* s = reinterpret_cast<V*>(smem_raw);

  const long long s0 = (long long)blockIdx.x * d.sigs;
  const long long left = d.total - s0;
  const int nsig = left < d.sigs ? (int)left : d.sigs;
  const long long i2 = s0 % d.cnt[2];
  const long long rest = s0 / d.cnt[2];
  const long long i1 = rest % d.cnt[1];
  const long long i0 = rest / d.cnt[1];
  const long long ibase = i0 * d.in[0] + i1 * d.in[1] + i2 * d.in[2];
  const long long obase = i0 * d.out[0] + i1 * d.out[1] + i2 * d.out[2];
  const long long fast0 = i2 + tw_off + i1 * tw_mid;   // the twiddle's index
  const int tile = d.sigs << log_n;

  // complex128 rows: the first stage reads them itself
  if constexpr (!DIRECT) {
    load_tile<V, FAST>(s, x, d, ibase, nsig, log_n);
    __syncthreads();
  }
  if constexpr (FAST) {
    const V* tab = tables;
    int log_ns = log_n;
    for (int st = 0; st < nst; ++st) {
      const int lr = stage_log_radix(logr, st);
      const int log_m = log_ns - lr;
      const V* tw_st = tab + (1 << (2 * lr));      // skip W_r
      tab = tw_st + (log_m > 0 ? (1 << log_ns) : 0);
      const int nbf = tile >> lr;
      if (DIRECT && st == 0) {
        switch (lr) {
          case 1: stage_first_rows<V, INV, 2>(s, x, ibase, d.in[2], nsig, nbf,
                                              log_m, log_n, tw_st); break;
          case 2: stage_first_rows<V, INV, 4>(s, x, ibase, d.in[2], nsig, nbf,
                                              log_m, log_n, tw_st); break;
          case 3: stage_first_rows<V, INV, 8>(s, x, ibase, d.in[2], nsig, nbf,
                                              log_m, log_n, tw_st); break;
          default: stage_first_rows<V, INV, 16>(s, x, ibase, d.in[2], nsig,
                                                nbf, log_m, log_n, tw_st);
                   break;
        }
      } else if (st + 1 < nst) {
        switch (lr) {
          case 1: stage_mid<V, INV, 2>(s, nbf, log_m, log_ns, tw_st); break;
          case 2: stage_mid<V, INV, 4>(s, nbf, log_m, log_ns, tw_st); break;
          case 3: stage_mid<V, INV, 8>(s, nbf, log_m, log_ns, tw_st); break;
          default: stage_mid<V, INV, 16>(s, nbf, log_m, log_ns, tw_st); break;
        }
      } else {
        switch (lr) {
          case 1: stage_last<V, INV, 2>(s, nbf, log_n, nst, logr); break;
          case 2: stage_last<V, INV, 4>(s, nbf, log_n, nst, logr); break;
          case 3: stage_last<V, INV, 8>(s, nbf, log_n, nst, logr); break;
          default: stage_last<V, INV, 16>(s, nbf, log_n, nst, logr); break;
        }
      }
      __syncthreads();
      log_ns = log_m;
    }
  } else if constexpr (!FAST) {
    stockham_stages<V>(s, d.sigs, log_n, tables, nst, logr);
    V v[kPts];
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      if (e < tile) v[q] = s[e];
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPts; ++q) {
      const int e = threadIdx.x + q * blockDim.x;
      if (e < tile) {
        const int lo = e & ((1 << log_n) - 1);
        s[(e - lo) | natural_index(lo, nst, logr, log_n)] = v[q];
      }
    }
    __syncthreads();
  }
  store_tile<V, FAST>(y, s, d, obase, nsig, log_n, scale, tw, log_l, mask_m,
                      fast0);
}

template <typename V, bool INV, bool FAST, bool DIRECT>
int launch(const void* x, void* y, const void* tables, const void* tw,
           const long long* packed, int log_n, int nst,
           unsigned long long logr, int tw_log_m, long long tw_off,
           long long tw_mid, double scale, void* stream) {
  Desc d;
  for (int a = 0; a < 3; ++a) {
    d.cnt[a] = packed[a];
    d.in[a] = packed[3 + a];
    d.out[a] = packed[6 + a];
  }
  d.pin = packed[9];
  d.pout = packed[10];
  d.total = packed[11];
  d.sigs = (int)packed[12];
  d.log_sigs = (int)packed[13];
  d.vec_in = (int)packed[14];
  d.vec_out = (int)packed[15];
  if (d.total <= 0) return (int)cudaSuccess;
  const int tile = d.sigs << log_n;
  if (tile > kTile || d.sigs != (1 << d.log_sigs))
    return (int)cudaErrorInvalidValue;
  const int threads = tile / kPts > 32 ? tile / kPts : 32;
  const size_t smem = (size_t)tile * sizeof(V);
  auto kernel = block_fft_kernel<V, INV, FAST, DIRECT>;
  cudaError_t err = allow_smem((const void*)kernel, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (d.total + d.sigs - 1) / d.sigs;
  const int log_l = (tw_log_m + 1) / 2;
  const unsigned mask_m =
      tw_log_m >= 32 ? 0xffffffffu : (unsigned)((1ull << tw_log_m) - 1);
  kernel<<<(unsigned)grid, threads, smem, (cudaStream_t)stream>>>(
      (const V*)x, (V*)y, (const V*)tables, (const V*)tw, d, log_n, nst, logr,
      log_l, mask_m, tw_off, tw_mid, (typename Traits<V>::R)scale);
  return (int)cudaGetLastError();
}

template <typename V, bool INV>
int launch_fast(const void* x, void* y, const void* tables, const void* tw,
                const long long* desc, int log_n, int nst,
                unsigned long long logr, int tw_log_m, long long tw_off,
                long long tw_mid, double scale, void* stream) {
  // Rows in (point stride 1) and more than one stage: the first stage
  // reads them itself; complex64 needs its 16-byte pairs aligned.
  const bool direct = desc[9] == 1 && nst >= 2
                      && (std::is_same<V, double2>::value || desc[14]);
  return direct ? launch<V, INV, true, true>(x, y, tables, tw, desc, log_n,
                                             nst, logr, tw_log_m, tw_off,
                                             tw_mid, scale, stream)
                : launch<V, INV, true, false>(x, y, tables, tw, desc, log_n,
                                              nst, logr, tw_log_m, tw_off,
                                              tw_mid, scale, stream);
}

template <typename V>
int dispatch(const void* x, void* y, const void* tables, const void* tw,
             const long long* desc, int log_n, int nst,
             unsigned long long logr, int inverse, int fast, int tw_log_m,
             long long tw_off, long long tw_mid, double scale, void* stream) {
  if (fast) {
    return inverse ? launch_fast<V, true>(x, y, tables, tw, desc, log_n, nst,
                                          logr, tw_log_m, tw_off, tw_mid,
                                          scale, stream)
                   : launch_fast<V, false>(x, y, tables, tw, desc, log_n,
                                           nst, logr, tw_log_m, tw_off,
                                           tw_mid, scale, stream);
  }
  // the generic stages take the direction from the tables
  return launch<V, false, false, false>(x, y, tables, tw, desc, log_n, nst,
                                        logr, tw_log_m, tw_off, tw_mid, scale,
                                        stream);
}

}  // namespace blockfft
}  // namespace turbofft

extern "C" {

// One pass over complex64 data. desc: 16 x int64, [count, in stride, out
// stride] of three signal axes (slowest first, unused axes count 1), point
// strides in and out, signals in all, signals per CTA and its log2, and the
// 16-byte-access flags for input and output. tables: the plan's flat stage
// table in this direction; tw: the pass twiddle table (lo then hi) of
// M = 2^tw_log_m, or null; tw_off and tw_mid: the twiddle index of a signal
// is tw_off + its fastest-axis index + tw_mid * its middle-axis index.
// fast: every radix <= 16. Returns the CUDA error code of the launch (0 on
// success).
int block_fft_c64(const void* x, void* y, const void* tables, const void* tw,
                  const long long* desc, int log_n, int nst,
                  unsigned long long logr, int inverse, int fast,
                  int tw_log_m, long long tw_off, long long tw_mid,
                  double scale, void* stream) {
  return turbofft::blockfft::dispatch<float2>(x, y, tables, tw, desc, log_n,
                                              nst, logr, inverse, fast,
                                              tw_log_m, tw_off, tw_mid, scale,
                                              stream);
}

// As block_fft_c64 for complex128 (the 16-byte flags are ignored).
int block_fft_c128(const void* x, void* y, const void* tables, const void* tw,
                   const long long* desc, int log_n, int nst,
                   unsigned long long logr, int inverse, int fast,
                   int tw_log_m, long long tw_off, long long tw_mid,
                   double scale, void* stream) {
  return turbofft::blockfft::dispatch<double2>(x, y, tables, tw, desc, log_n,
                                               nst, logr, inverse, fast,
                                               tw_log_m, tw_off, tw_mid,
                                               scale, stream);
}

}  // extern "C"

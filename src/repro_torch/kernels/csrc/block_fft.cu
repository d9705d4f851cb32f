// block_fft: batched single-pass C2C FFT over the last axis, (B, N) -> (B, N).
//
// Replaces the TPU kernel block_fft_pallas (src/repro/kernels/stockham.py,
// body _fft_kernel), which runs the plan's stages on a VMEM-resident (bs, N)
// tile with 4 real MXU matmuls per stage on split re/im arrays.
//
// Here one CTA loads a tile of whole signals (up to kTileElems interleaved
// complex points: 64 KiB at complex64, 128 KiB at complex128) into dynamic
// shared memory, runs the radix <= 16 register butterflies of
// stockham.cuh in place, and writes the points back in natural order. The
// grid covers the batch; the last CTA masks the ragged end, so there is no
// B % bs restriction. The inverse uses the conjugate tables and multiplies
// by `scale` on the way out: the caller passes 1/N of the whole transform to
// exactly one launch of it.
//
// Bound on an H100: bytes. The function reads x once and writes y once,
// 2*B*N*sizeof(complex) at 3.35 TB/s; 5*N*log2(N) flops per signal are far
// below the fp32/fp64 peaks at N <= 8192. The design touches device memory
// once per point each way, with consecutive threads on consecutive points
// (coalesced loads and stores); the stage tables (about 2N points) are read
// through the read-only cache and stay in L2 across CTAs. The direct r-point
// DFTs and the shared-memory round trip per stage are the costs a later
// optimisation removes.
#include <cuda_runtime.h>

#include "stockham.cuh"

namespace turbofft {

template <typename R>
__global__ void __launch_bounds__(kThreads)
block_fft_kernel(const typename Cplx<R>::T* __restrict__ x,
                 typename Cplx<R>::T* __restrict__ y,
                 const typename Cplx<R>::T* __restrict__ tables,
                 long long batch, int log_n, int sigs, int nst,
                 unsigned long long logr, R scale) {
  using V = typename Cplx<R>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* s = reinterpret_cast<V*>(smem_raw);

  const int n = 1 << log_n;
  const long long b0 = (long long)blockIdx.x * sigs;
  const long long left = batch - b0;
  const int nsig = left < sigs ? (int)left : sigs;
  const int tot = nsig << log_n;
  const V* xb = x + b0 * n;
  V* yb = y + b0 * n;

  for (int i = threadIdx.x; i < tot; i += blockDim.x) s[i] = xb[i];
  __syncthreads();
  stockham_stages<V>(s, nsig, log_n, tables, nst, logr);
  for (int i = threadIdx.x; i < tot; i += blockDim.x) {
    const int k = i & (n - 1);
    yb[i] = cscale(s[(i - k) + digit_rev(k, nst, logr)], scale);
  }
}

template <typename R>
int launch_block_fft(const void* x, void* y, const void* tables,
                     long long batch, int log_n, int nst,
                     unsigned long long logr, double scale, void* stream) {
  using V = typename Cplx<R>::T;
  if (batch <= 0) return (int)cudaSuccess;
  const int n = 1 << log_n;
  long long sigs = n >= kTileElems ? 1 : kTileElems / n;
  if (sigs > batch) sigs = batch;
  const size_t smem = (size_t)sigs * n * sizeof(V);
  cudaError_t err = cudaFuncSetAttribute(
      block_fft_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (batch + sigs - 1) / sigs;
  block_fft_kernel<R><<<(unsigned)grid, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const V*)x, (V*)y, (const V*)tables, batch, log_n, (int)sigs, nst,
      logr, (R)scale);
  return (int)cudaGetLastError();
}

}  // namespace turbofft

extern "C" {

// x, y: (batch, 2^log_n) complex64, contiguous; tables: the plan's flat
// stage table. Returns the CUDA error code of the launch (0 on success).
int block_fft_c64(const void* x, void* y, const void* tables, long long batch,
                  int log_n, int nst, unsigned long long logr, double scale,
                  void* stream) {
  return turbofft::launch_block_fft<float>(x, y, tables, batch, log_n, nst,
                                           logr, scale, stream);
}

// As block_fft_c64 for complex128.
int block_fft_c128(const void* x, void* y, const void* tables,
                   long long batch, int log_n, int nst,
                   unsigned long long logr, double scale, void* stream) {
  return turbofft::launch_block_fft<double>(x, y, tables, batch, log_n, nst,
                                            logr, scale, stream);
}

}  // extern "C"

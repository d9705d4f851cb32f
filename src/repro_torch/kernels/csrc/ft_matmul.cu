// ft_matmul: C = X @ W, (M, K) @ (K, N), with the two-side ABFT checksum
// strips of the product, each (N,) float32:
//
//   out2 = e2^T C,  out3 = e3^T C (e3 = [1..M]),  taken over the float32
//                   accumulator after the injected SEUs, before the cast;
//   pred2 = xsum @ W, pred3 = xloc @ W, from xsum = e2^T X and
//                   xloc = e3^T X, which the caller computes.
//
// Replaces the TPU kernel ft_matmul_pallas (src/repro/kernels/ft_matmul.py,
// body _kernel), whose grid (N/bn, M/bm, K/bk) runs in order and carries the
// column strips across the M tiles in VMEM scratch.
//
// Here one CTA of 256 threads owns one (BM, BN) output tile (BM, BN in
// {64, 128}) and loops over K in stages of 32: X's (BM, 32) and W's
// (32, BN) slices are converted to float32 as they are loaded into shared
// memory, and each thread keeps a (BM/16, BN/16) micro-tile of the
// accumulator in registers (rows ty + 16i, columns tx + 16j), updated by
// float32 FMAs. No tensor cores: TF32 would change C by about 1e-3
// relative against the reference. The CTAs of the first M tile also take
// pred2/pred3 for their columns in the same K loop, from the W slice
// already in shared memory, so the predicted strips need no cross-CTA sum.
//
// The M-axis carry: CTAs run in no order, so instead of carrying the
// strips, each CTA writes its tile's partial out2/out3 (summed over its BM
// rows in a fixed order) to an (M/BM, N) float32 scratch, and a second small
// kernel sums the M tiles of each column in order. No float atomics: two
// calls on the same input give bitwise-equal outputs.
//
// Injection: each (F, 4) [row, col, enable, eps] row adds enable * eps to
// the accumulator element whose global (row, col), as floats, equal the
// row's, before the store and the strips, as the reference does.
//
// Bound on an H100: operations. (2048, 3072) @ (3072, 8192) float32 is
// 103 GFLOP, 1.54 ms at the 67 TFLOP/s of fp32 outside the tensor cores,
// while its 193 MB take 0.058 ms at 3.35 TB/s. The design keeps every
// operand load in shared memory and every FMA's inputs in registers
// (4 FMAs per shared-memory load at 128 x 128 tiles); it has no
// double-buffered loads, vectorised shared-memory reads or wgmma, which are
// the work of a later optimisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ftmm {

constexpr int kThreads = 256;   // 16 x 16 threads over each output tile
constexpr int kStage = 32;      // depth of one shared-memory stage of K

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename TX, typename TW, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
ft_matmul_tile(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ xsum,
               const float* __restrict__ xloc,
               const float* __restrict__ inj, int nf, TX* __restrict__ c,
               float* __restrict__ part2, float* __restrict__ part3,
               float* __restrict__ pred2, float* __restrict__ pred3, int k,
               int n) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int kAStride = BM + 1;   // padded: conflict-free transposed store
  __shared__ float smem[kStage * kAStride + kStage * BN + 2 * kStage];
  float* as = smem;                        // as[kk][r] = X[m0 + r][k0 + kk]
  float* bs = smem + kStage * kAStride;    // bs[kk][j] = W[k0 + kk][n0 + j]
  float* xs = bs + kStage * BN;            // xsum, then xloc, of the stage
  static_assert(2 * 16 * BN <= kStage * kAStride + kStage * BN,
                "the strip reduction reuses the operand tiles");

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int mt = blockIdx.y;
  const long long m0 = (long long)mt * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const bool first = mt == 0;              // this CTA also takes pred2/3
  const int pcol = tid < BN ? tid : tid - BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float pred = 0.f;   // pred2 (tid < BN) or pred3 (tid < 2 BN), first only

  for (int k0 = 0; k0 < k; k0 += kStage) {
#pragma unroll
    for (int i = 0; i < BM * kStage / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / kStage, kk = idx % kStage;
      as[kk * kAStride + r] = to_f32(x[(m0 + r) * k + k0 + kk]);
    }
#pragma unroll
    for (int i = 0; i < kStage * BN / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kk = idx / BN, j = idx % BN;
      bs[kk * BN + j] = to_f32(w[(long long)(k0 + kk) * n + n0 + j]);
    }
    if (first && tid < 2 * kStage)
      xs[tid] = tid < kStage ? xsum[k0 + tid] : xloc[k0 + tid - kStage];
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStage; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = as[kk * kAStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = bs[kk * BN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (first && tid < 2 * BN) {
      const float* v = tid < BN ? xs : xs + kStage;
#pragma unroll 8
      for (int kk = 0; kk < kStage; ++kk)
        pred = fmaf(v[kk], bs[kk * BN + pcol], pred);
    }
    __syncthreads();
  }

  // in-kernel SEU injection: into the product before the store and strips
  for (int f = 0; f < nf; ++f) {
    const float fr = inj[4 * f], fc = inj[4 * f + 1];
    const float e = inj[4 * f + 2] * inj[4 * f + 3];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if ((float)(m0 + ty + 16 * i) == fr &&
            (float)(n0 + tx + 16 * j) == fc)
          acc[i][j] += e;
  }

  // store C in x's type; this thread's column partials of out2 and out3
  float* red2 = smem;             // [16][BN]: one row per ty
  float* red3 = smem + 16 * BN;   // (the K loop ended with a barrier)
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    float s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = m0 + ty + 16 * i;
      store(&c[row * n + n0 + tx + 16 * j], acc[i][j]);
      s2 += acc[i][j];
      s3 = fmaf((float)(row + 1), acc[i][j], s3);
    }
    red2[ty * BN + tx + 16 * j] = s2;
    red3[ty * BN + tx + 16 * j] = s3;
  }
  __syncthreads();
  if (tid < 2 * BN) {
    const float* red = tid < BN ? red2 : red3;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) s += red[t * BN + pcol];
    (tid < BN ? part2 : part3)[(long long)mt * n + n0 + pcol] = s;
    if (first) (tid < BN ? pred2 : pred3)[n0 + pcol] = pred;
  }
}

// out2/out3 of each column: its M tiles' partials summed in tile order.
__global__ void strip_reduce(const float* __restrict__ part2,
                             const float* __restrict__ part3, int tiles,
                             int n, float* __restrict__ out2,
                             float* __restrict__ out3) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float s2 = 0.f, s3 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    s2 += part2[(long long)t * n + col];
    s3 += part3[(long long)t * n + col];
  }
  out2[col] = s2;
  out3[col] = s3;
}

struct Args {
  const void* x;
  const void* w;
  const float* xsum;
  const float* xloc;
  const float* inj;
  int nf;
  void* c;
  float* part2;
  float* part3;
  float* out2;
  float* pred2;
  float* out3;
  float* pred3;
  int m, k, n;
  cudaStream_t stream;
};

template <typename TX, typename TW, int BM, int BN>
cudaError_t launch(const Args& a) {
  const dim3 grid(a.n / BN, a.m / BM);
  ft_matmul_tile<TX, TW, BM, BN><<<grid, kThreads, 0, a.stream>>>(
      (const TX*)a.x, (const TW*)a.w, a.xsum, a.xloc, a.inj, a.nf,
      (TX*)a.c, a.part2, a.part3, a.pred2, a.pred3, a.k, a.n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  strip_reduce<<<(a.n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
      a.part2, a.part3, a.m / BM, a.n, a.out2, a.out3);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_tiles(const Args& a, int bm, int bn) {
  if (bm == 128 && bn == 128) return launch<TX, TW, 128, 128>(a);
  if (bm == 128 && bn == 64) return launch<TX, TW, 128, 64>(a);
  if (bm == 64 && bn == 128) return launch<TX, TW, 64, 128>(a);
  if (bm == 64 && bn == 64) return launch<TX, TW, 64, 64>(a);
  return cudaErrorInvalidValue;
}

}  // namespace ftmm

extern "C" {

// x: (m, k), w: (k, n), row-major, each float32 or (flag set) bfloat16;
// c: (m, n) in x's type. xsum, xloc: (k,) float32; inj: (nf, 4) float32
// [row, col, enable, eps]. part2, part3: (m / bm, n) float32 scratch;
// out2, pred2, out3, pred3: (n,) float32. m % bm, n % bn and k % 32 must
// be 0, with bm, bn in {64, 128}. Returns the CUDA error code of the
// launches (0 on success).
int ft_matmul_launch(const void* x, const void* w, int x_bf16, int w_bf16,
                     const float* xsum, const float* xloc, const float* inj,
                     int nf, void* c, float* part2, float* part3,
                     float* out2, float* pred2, float* out3, float* pred3,
                     int m, int k, int n, int bm, int bn, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || bm <= 0 || bn <= 0 || m % bm ||
      n % bn || k % ftmm::kStage)
    return (int)cudaErrorInvalidValue;
  const ftmm::Args a{x,    w,     xsum, xloc,  inj,   nf, c, part2, part3,
                     out2, pred2, out3, pred3, m,     k,  n,
                     (cudaStream_t)stream};
  cudaError_t err;
  if (x_bf16 && w_bf16)
    err = ftmm::launch_tiles<__nv_bfloat16, __nv_bfloat16>(a, bm, bn);
  else if (x_bf16)
    err = ftmm::launch_tiles<__nv_bfloat16, float>(a, bm, bn);
  else if (w_bf16)
    err = ftmm::launch_tiles<float, __nv_bfloat16>(a, bm, bn);
  else
    err = ftmm::launch_tiles<float, float>(a, bm, bn);
  return (int)err;
}

}  // extern "C"

// ft_matmul: C = X @ W, (M, K) @ (K, N), with the two-side ABFT checksum
// strips of the product, each (N,) float32:
//
//   out2 = e2^T C,  out3 = e3^T C (e3 = [1..M]),  taken over the float32
//                   accumulator after the injected SEUs, before the cast;
//   pred2 = xsum @ W, pred3 = xloc @ W, from the input checksums
//                   xsum = e2^T X and xloc = e3^T X.
//
// Replaces the TPU kernel ft_matmul_pallas (src/repro/kernels/ft_matmul.py,
// body _kernel), whose grid (N/bn, M/bm, K/bk) runs in order and carries the
// column strips across the M tiles in VMEM scratch.
//
// Bound on an H100: operations. (2048, 3072) @ (3072, 8192) float32 is
// 103 GFLOP, 1.54 ms at the 67 TFLOP/s of fp32 outside the tensor cores,
// while its 193 MB take 0.058 ms at 3.35 TB/s. No tensor cores: TF32 would
// change C by about 1e-3 relative against the reference. So the design is
// about keeping the FMA pipe fed:
//
// * One CTA of 256 threads owns one (BM, BN) output tile (BM, BN in
//   {64, 128}); each thread keeps a (BM/16, BN/16) accumulator made of
//   blocks of 4 x 4: rows 4 rg + {0..3} (+ 64), columns 4 cg + {0..3}
//   (+ 64). A warp's lanes are 4 row groups by 8 column groups, so every
//   fragment read is a float4 that 8 (A) or 4 (B) lanes share: at 128 x 128
//   a k step is 4 16-byte shared loads for 64 FMAs, double-buffered in
//   registers so step k+1's loads are in flight during step k's FMAs.
// * K runs in stages of kStage = 16 through a ring of kStages = 3 stages in
//   dynamic shared memory, the loop unrolled over the ring so that no slot
//   offset is computed at run time. W (f32) goes straight to shared memory
//   by 16-byte cp.async, kStages - 1 stages ahead. X (needed as [k][m]) and
//   a bf16 W are loaded as 16-byte vectors into registers one stage ahead,
//   and stored converted to float32 (X transposed) after the current
//   stage's FMAs. The A rows are padded by 4 floats: the transposed stores
//   are at most 2-way bank-conflicted and every float4 read stays aligned.
// * __launch_bounds__(256, 2): at most 128 registers a thread, so two CTAs
//   (16 warps) share an SM and one CTA's barrier or loads hide behind the
//   other's FMAs. ft_matmul_occupancy reports the blocks per SM.
//
// The caller's (bm, bn, bk) only constrain alignment. bk never reaches the
// kernel: the K stage is the kernel's own. The CTA tile (BM, BN) is chosen
// per launch from the grid's wave count (kernels/ft_matmul.py, cta_tile).
// The outputs do not depend on that choice, bit for bit: every C element
// is one fmaf chain over k in order, and the strips are summed per 64-row
// group in a fixed order whatever BM is.
//
// The M-axis carry: CTAs run in no order, so instead of carrying the
// strips, each CTA writes its 64-row groups' partial out2/out3 (each summed
// over its rows in a fixed order) to an (M/64, N) float32 scratch, and a
// second small kernel sums the groups of each column in order. No float
// atomics: two calls on the same input give bitwise-equal outputs. The CTAs
// of the first M tile also take pred2/pred3 for their columns from the W
// stage already in shared memory, so the predicted strips need no
// cross-CTA sum.
//
// The input checksums come first, in one pass over X (x_checksums, 64-row
// partials in order, then strip_reduce): the reference computes them
// outside its pallas_call, and two torch reductions over X would read it
// twice and launch four kernels.
//
// Injection: each (F, 4) [row, col, enable, eps] row adds enable * eps to
// the accumulator element whose global (row, col), as floats, equal the
// row's, before the store and the strips, as the reference does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "smem_limit.cuh"

namespace ftmm {

constexpr int kThreads = 256;   // 8 warps: 4 x 2 warps of 4 x 8 lanes
constexpr int kStage = 16;      // K depth of one ring stage
constexpr int kStages = 3;      // stages in the shared-memory ring
constexpr int kAPad = 4;        // floats of padding after each A row
constexpr int kStrip = 64;      // rows of one out2/out3 partial
constexpr int kGroups = 16;     // row groups: threads that share a column

// Shared-memory layout of one (BM, BN) instance, in floats. Stage s starts
// at s * kStageFloats: as[kk][r] = X[m0 + r][k0 + kk] (row stride kAStride),
// then bs[kk][j] = W[k0 + kk][n0 + j], then xsum and xloc of the stage.
// After the K loop the ring holds the strip reduction red[2][BM/64][16][BN].
template <int BM, int BN>
struct Tile {
  static constexpr int kTM = BM / kGroups, kTN = BN / kGroups;
  static constexpr int kAStride = BM + kAPad;
  static constexpr int kA = kStage * kAStride;
  static constexpr int kB = kStage * BN;
  static constexpr int kStageFloats = kA + kB + 2 * kStage;
  static constexpr int kHalves = BM / kStrip;
  static constexpr int kRed = 2 * kHalves * kGroups * BN;
  static constexpr int kRing = kStages * kStageFloats;
  static constexpr int kBytes = 4 * (kRing > kRed ? kRing : kRed);
};

// 16 bytes of global memory as float32: 4 floats or 8 bfloat16s.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void unpack(uint4 r, float* v) {
    const unsigned u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// 4 consecutive elements (16 or 8 bytes) as float32.
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void cp_async16(float* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// The operand copies of one stage. X, and W when it is bf16, go through
// registers (load() one stage ahead, store() after the FMAs); a float32 W,
// and xsum/xloc for the first M tile, go by cp.async (issue()). A thread's
// 16-byte chunks lie kXRows rows of X (kWRows rows of W) apart, so its
// global pointers and shared offsets are set once and stepped by uniform
// amounts.
template <typename TX, typename TW, int BM, int BN>
struct Stager {
  using L = Tile<BM, BN>;
  static constexpr int kXV = Vec<TX>::kN;
  static constexpr int kXRow = kStage / kXV;          // 16-byte chunks a row
  static constexpr int kXChunks = BM * kXRow;
  static constexpr int kXIters = (kXChunks + kThreads - 1) / kThreads;
  static constexpr int kXRows = kThreads / kXRow;     // rows between chunks
  static constexpr bool kWAsync = std::is_same<TW, float>::value;
  static constexpr int kWV = Vec<TW>::kN;
  static constexpr int kWRow = BN / kWV;
  static constexpr int kWChunks = kStage * kWRow;
  static constexpr int kWIters = (kWChunks + kThreads - 1) / kThreads;
  static constexpr int kWRows = kThreads / kWRow;

  const TX* xp;   // X[m0 + tid / kXRow][tid % kXRow * kXV]
  const TW* wp;   // W[tid / kWRow][n0 + tid % kWRow * kWV]
  int xo, wo;     // the thread's first X store and W copy in a stage
  int tid;
  uint4 xr[kXIters];
  uint4 wr[kWAsync ? 1 : kWIters];

  __device__ __forceinline__ Stager(const TX* x, const TW* w, int k, int n,
                                    long long m0, long long n0, int t)
      : xp(x + (m0 + t / kXRow) * k + t % kXRow * kXV),
        wp(w + (long long)(t / kWRow) * n + n0 + t % kWRow * kWV),
        xo(t % kXRow * kXV * L::kAStride + t / kXRow),
        wo(L::kA + t / kWRow * BN + t % kWRow * kWV),
        tid(t) {}

  static __device__ __forceinline__ bool live(int tid, int i, int chunks) {
    return chunks % kThreads == 0 || tid + i * kThreads < chunks;
  }

  __device__ __forceinline__ void load(int k, int n, int k0) {
#pragma unroll
    for (int i = 0; i < kXIters; ++i)
      if (live(tid, i, kXChunks))
        xr[i] = ldg16(xp + (long long)i * kXRows * k + k0);
    if constexpr (!kWAsync) {
#pragma unroll
      for (int i = 0; i < kWIters; ++i)
        if (live(tid, i, kWChunks))
          wr[i] = ldg16(wp + ((long long)i * kWRows + k0) * n);
    }
  }

  __device__ __forceinline__ void store(float* st) const {
#pragma unroll
    for (int i = 0; i < kXIters; ++i) {
      if (live(tid, i, kXChunks)) {
        float v[kXV];
        Vec<TX>::unpack(xr[i], v);
#pragma unroll
        for (int j = 0; j < kXV; ++j)
          st[xo + i * kXRows + j * L::kAStride] = v[j];
      }
    }
    if constexpr (!kWAsync) {
#pragma unroll
      for (int i = 0; i < kWIters; ++i) {
        if (live(tid, i, kWChunks)) {
          float v[kWV];
          Vec<TW>::unpack(wr[i], v);
          float* p = st + wo + i * kWRows * BN;
#pragma unroll
          for (int j = 0; j < kWV; j += 4)
            store4(p + j, v[j], v[j + 1], v[j + 2], v[j + 3]);
        }
      }
    }
  }

  __device__ __forceinline__ void issue(float* st, const float* xsum,
                                        const float* xloc, bool first, int n,
                                        int k0) const {
    if constexpr (kWAsync) {
#pragma unroll
      for (int i = 0; i < kWIters; ++i)
        if (live(tid, i, kWChunks))
          cp_async16(st + wo + i * kWRows * BN,
                     wp + ((long long)i * kWRows + k0) * n);
    }
    if (first && tid < 2 * kStage / 4)   // xsum, then xloc: 4 chunks each
      cp_async16(st + L::kA + L::kB + 4 * tid,
                 (tid < 4 ? xsum : xloc) + k0 + 4 * (tid & 3));
  }
};

template <int T>
__device__ __forceinline__ void fragment(const float* p, float (&v)[T]) {
#pragma unroll
  for (int h = 0; h < T / 4; ++h) {
    const float4 q = *reinterpret_cast<const float4*>(p + 64 * h);
    v[4 * h] = q.x;
    v[4 * h + 1] = q.y;
    v[4 * h + 2] = q.z;
    v[4 * h + 3] = q.w;
  }
}

// One stage's FMAs: acc[i][j] += as[kk][row i] * bs[kk][col j], kk in order.
template <int BM, int BN>
__device__ __forceinline__ void fma_stage(const float* st, int rg, int cg,
                                          float (&acc)[BM / 16][BN / 16]) {
  using L = Tile<BM, BN>;
  constexpr int TM = L::kTM, TN = L::kTN;
  const float* as = st + 4 * rg;
  const float* bs = st + L::kA + 4 * cg;
  float a[2][TM], b[2][TN];
  fragment(as, a[0]);
  fragment(bs, b[0]);
#pragma unroll
  for (int kk = 0; kk < kStage; ++kk) {
    if (kk + 1 < kStage) {
      fragment(as + (kk + 1) * L::kAStride, a[(kk + 1) & 1]);
      fragment(bs + (kk + 1) * BN, b[(kk + 1) & 1]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = fmaf(a[kk & 1][i], b[kk & 1][j], acc[i][j]);
  }
}

template <typename TX, typename TW, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2)
ft_matmul_tile(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ xsum,
               const float* __restrict__ xloc,
               const float* __restrict__ inj, int nf, TX* __restrict__ c,
               float* __restrict__ part2, float* __restrict__ part3,
               float* __restrict__ pred2, float* __restrict__ pred3, int k,
               int n) {
  using L = Tile<BM, BN>;
  using S = Stager<TX, TW, BM, BN>;
  constexpr int TM = L::kTM, TN = L::kTN;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rg = (warp >> 1) * 4 + (lane >> 3);   // rows 4 rg + {0..3} (+64)
  const int cg = (warp & 1) * 8 + (lane & 7);     // cols 4 cg + {0..3} (+64)
  const int mt = blockIdx.y;
  const long long m0 = (long long)mt * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const bool first = mt == 0;              // this CTA also takes pred2/3
  const int pcol = tid < BN ? tid : tid - BN;
  const int nk = k / kStage;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float pred = 0.f;   // pred2 (tid < BN) or pred3 (tid < 2 BN), first only

  S stager(x, w, k, n, m0, n0, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      stager.issue(smem + s * L::kStageFloats, xsum, xloc, first, n,
                   s * kStage);
    cp_async_commit();
  }
  stager.load(k, n, 0);
  stager.store(smem);
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // stage t of the K loop, in ring slot c = t % kStages. The loop is
  // unrolled over the ring, so every slot's offsets are constants.
  static_assert(kStages == 3, "the K loop is unrolled over a 3-stage ring");
  auto step = [&](int t, auto slot) {
    constexpr int c = decltype(slot)::value;
    constexpr int nx = (c + 1) % kStages, ah = (c + kStages - 1) % kStages;
    if (t + 1 < nk) stager.load(k, n, (t + 1) * kStage);
    if (t + kStages - 1 < nk)
      stager.issue(smem + ah * L::kStageFloats, xsum, xloc, first, n,
                   (t + kStages - 1) * kStage);
    cp_async_commit();
    const float* st = smem + c * L::kStageFloats;
    fma_stage<BM, BN>(st, rg, cg, acc);
    if (first && tid < 2 * BN) {
      const float* v = st + L::kA + L::kB + (tid < BN ? 0 : kStage);
      const float* b = st + L::kA + pcol;
#pragma unroll
      for (int kk = 0; kk < kStage; ++kk) pred = fmaf(v[kk], b[kk * BN], pred);
    }
    if (t + 1 < nk) stager.store(smem + nx * L::kStageFloats);
    cp_async_wait<kStages - 2>();
    __syncthreads();
  };
  int t = 0;
  for (; t + 3 <= nk; t += 3) {
    step(t, std::integral_constant<int, 0>{});
    step(t + 1, std::integral_constant<int, 1>{});
    step(t + 2, std::integral_constant<int, 2>{});
  }
  if (t < nk) step(t, std::integral_constant<int, 0>{});
  if (t + 1 < nk) step(t + 1, std::integral_constant<int, 1>{});
  cp_async_wait<0>();          // only empty groups are left

  // in-kernel SEU injection: into the product before the store and strips
  for (int f = 0; f < nf; ++f) {
    const float fr = inj[4 * f], fc = inj[4 * f + 1];
    const float e = inj[4 * f + 2] * inj[4 * f + 3];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if ((float)(m0 + 4 * rg + 64 * (i / 4) + i % 4) == fr &&
            (float)(n0 + 4 * cg + 64 * (j / 4) + j % 4) == fc)
          acc[i][j] += e;
  }

  // store C in x's type, 4 columns at a time
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    TX* crow = c + (m0 + 4 * rg + 64 * (i / 4) + i % 4) * n + n0 + 4 * cg;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      store4(crow + 64 * h, acc[i][4 * h], acc[i][4 * h + 1],
             acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }

  // this thread's partials of out2 and out3 over its 4 rows of each 64-row
  // group, then the 16 row groups of each column summed in order
  float* red = smem;   // red[strip][half][rg][col]; the loop ended on a barrier
#pragma unroll
  for (int hm = 0; hm < TM / 4; ++hm) {
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      float s2[4], s3[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s2[jj] = 0.f;
        s3[jj] = 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const float v = acc[4 * hm + ii][4 * h + jj];
          s2[jj] += v;
          s3[jj] = fmaf((float)(m0 + 64 * hm + 4 * rg + ii + 1), v, s3[jj]);
        }
      }
      const int at = (hm * kGroups + rg) * BN + 4 * cg + 64 * h;
      store4(red + at, s2[0], s2[1], s2[2], s2[3]);
      store4(red + L::kHalves * kGroups * BN + at, s3[0], s3[1], s3[2],
             s3[3]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 2 * L::kHalves * BN; idx += kThreads) {
    const int col = idx % BN, sh = idx / BN;   // sh = strip * halves + half
    const float* r = red + sh * kGroups * BN + col;
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) s += r[g * BN];
    const int strip = sh / L::kHalves, half = sh % L::kHalves;
    (strip ? part3 : part2)[(mt * L::kHalves + half) * (long long)n + n0 +
                            col] = s;
  }
  if (first && tid < 2 * BN) (tid < BN ? pred2 : pred3)[n0 + pcol] = pred;
}

// The input checksums' 64-row partials: part2[g][col] sums rows 64 g ..
// 64 g + 63 of X's column col in order, part3[g][col] the same rows
// weighted by their 1-based index. Each thread takes 4 columns.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
x_checksums(const TX* __restrict__ x, int k, float* __restrict__ part2,
            float* __restrict__ part3) {
  const int col = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (col >= k) return;
  const long long r0 = (long long)blockIdx.y * kStrip;
  float s2[4] = {0.f, 0.f, 0.f, 0.f}, s3[4] = {0.f, 0.f, 0.f, 0.f};
  const TX* p = x + r0 * k + col;
#pragma unroll 8
  for (int r = 0; r < kStrip; ++r, p += k) {
    float v[4];
    load4(p, v);
    const float loc = (float)(r0 + r + 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s2[j] += v[j];
      s3[j] = fmaf(loc, v[j], s3[j]);
    }
  }
  const long long at = blockIdx.y * (long long)k + col;
  store4(part2 + at, s2[0], s2[1], s2[2], s2[3]);
  store4(part3 + at, s3[0], s3[1], s3[2], s3[3]);
}

// out2/out3 of each column: its 64-row groups' partials summed in order.
__global__ void strip_reduce(const float* __restrict__ part2,
                             const float* __restrict__ part3, int groups,
                             int n, float* __restrict__ out2,
                             float* __restrict__ out3) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float s2 = 0.f, s3 = 0.f;
  for (int g = 0; g < groups; ++g) {
    s2 += part2[(long long)g * n + col];
    s3 += part3[(long long)g * n + col];
  }
  out2[col] = s2;
  out3[col] = s3;
}

struct Args {
  const void* x;
  const void* w;
  float* xsum;
  float* xloc;
  float* xpart;
  const float* inj;
  int nf;
  void* c;
  float* part2;
  float* part3;
  float* out2;
  float* pred2;
  float* out3;
  float* pred3;
  int m, k, n, smem;
  cudaStream_t stream;
};

// Opt the instance into `smem` bytes of dynamic shared memory (above the
// default 48 KB; allow_smem) with the carveout that fits the most of them
// on an SM.
template <typename Kernel>
cudaError_t configure(Kernel kernel, int smem) {
  cudaError_t err = turbofft::allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct LaunchOp {
  const Args& a;
  template <typename TX, typename TW, int BM, int BN>
  cudaError_t run() const {
    if (a.m % BM || a.n % BN || a.smem < Tile<BM, BN>::kBytes)
      return cudaErrorInvalidValue;
    const auto kernel = ft_matmul_tile<TX, TW, BM, BN>;
    cudaError_t err = configure(kernel, a.smem);
    if (err != cudaSuccess) return err;
    const int groups = a.m / kStrip;
    float* xpart3 = a.xpart + (long long)groups * a.k;
    x_checksums<TX><<<dim3((a.k / 4 + kThreads - 1) / kThreads, groups),
                      kThreads, 0, a.stream>>>((const TX*)a.x, a.k, a.xpart,
                                               xpart3);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    strip_reduce<<<(a.k + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
        a.xpart, xpart3, groups, a.k, a.xsum, a.xloc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid(a.n / BN, a.m / BM);
    kernel<<<grid, kThreads, a.smem, a.stream>>>(
        (const TX*)a.x, (const TW*)a.w, a.xsum, a.xloc, a.inj, a.nf,
        (TX*)a.c, a.part2, a.part3, a.pred2, a.pred3, a.k, a.n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    strip_reduce<<<(a.n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
        a.part2, a.part3, groups, a.n, a.out2, a.out3);
    return cudaGetLastError();
  }
};

struct OccupancyOp {
  int smem;
  int* blocks;
  template <typename TX, typename TW, int BM, int BN>
  cudaError_t run() const {
    const auto kernel = ft_matmul_tile<TX, TW, BM, BN>;
    cudaError_t err = configure(kernel, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kThreads, smem);
  }
};

template <typename TX, typename TW, typename Op>
cudaError_t tiles(int bm, int bn, const Op& op) {
  if (bm == 128 && bn == 128) return op.template run<TX, TW, 128, 128>();
  if (bm == 128 && bn == 64) return op.template run<TX, TW, 128, 64>();
  if (bm == 64 && bn == 128) return op.template run<TX, TW, 64, 128>();
  if (bm == 64 && bn == 64) return op.template run<TX, TW, 64, 64>();
  return cudaErrorInvalidValue;
}

template <typename Op>
cudaError_t dispatch(int x_bf16, int w_bf16, int bm, int bn, const Op& op) {
  using bf16 = __nv_bfloat16;
  if (x_bf16 && w_bf16) return tiles<bf16, bf16>(bm, bn, op);
  if (x_bf16) return tiles<bf16, float>(bm, bn, op);
  if (w_bf16) return tiles<float, bf16>(bm, bn, op);
  return tiles<float, float>(bm, bn, op);
}

}  // namespace ftmm

extern "C" {

// x: (m, k), w: (k, n), row-major, each float32 or (flag set) bfloat16,
// 16-byte aligned; c: (m, n) in x's type. xsum, xloc: (k,) float32, the
// input checksums it computes; xpart: (2, m / 64, k) float32 scratch; inj:
// (nf, 4) float32 [row, col, enable, eps]. part2, part3: (m / 64, n)
// float32 scratch; out2, pred2, out3, pred3: (n,) float32. (bm, bn) is the
// CTA tile, each 64 or 128, dividing m and n; k % 16 == 0; smem: the
// dynamic shared memory of one CTA, at least the instance's layout. Returns
// the CUDA error code of the launches (0 on success).
int ft_matmul_launch(const void* x, const void* w, int x_bf16, int w_bf16,
                     float* xsum, float* xloc, float* xpart,
                     const float* inj, int nf, void* c, float* part2,
                     float* part3, float* out2, float* pred2, float* out3,
                     float* pred3, int m, int k, int n, int bm, int bn,
                     int smem, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % ftmm::kStage)
    return (int)cudaErrorInvalidValue;
  const ftmm::Args a{x,     w,     xsum,  xloc,  xpart, inj, nf, c,
                     part2, part3, out2,  pred2, out3,  pred3, m, k,
                     n,     smem,  (cudaStream_t)stream};
  return (int)ftmm::dispatch(x_bf16, w_bf16, bm, bn, ftmm::LaunchOp{a});
}

// Blocks of the (bm, bn) instance that fit on one SM of the current device
// with `smem` bytes of dynamic shared memory each, into *blocks.
int ft_matmul_occupancy(int x_bf16, int w_bf16, int bm, int bn, int smem,
                        int* blocks) {
  return (int)ftmm::dispatch(x_bf16, w_bf16, bm, bn,
                             ftmm::OccupancyOp{smem, blocks});
}

}  // extern "C"

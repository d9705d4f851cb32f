// abft_fft: the block FFT with the paper's two-sided ABFT fused into it.
//
// Replaces the TPU kernel abft_fft_pallas (src/repro/kernels/stockham_abft.py,
// body _abft_kernel). Its (G, T) Pallas grid runs the T transactions of a
// checksum group one after another and carries the (8, N) right-side
// checksum scratch from grid step to grid step. A launch here computes the
// same function: for a batch of B = G * T * bs signals of N points,
//
//   * y, the forward FFT, plus the simulated SEU [tile, row, col, enabled,
//     eps_r, eps_i] at y[tile * bs + row, col] (before any output checksum);
//   * cs, (4, G, N) complex: [X.e2, X.e3, Y.e2, Y.e3] per group, e2 = ones,
//     e3 the 1-based global signal id, so cs[0] and cs[1] are the contiguous
//     (2G, N) input of the checksum FFT that follows;
//   * delta_b = |(e1^T W) x_b - e1^T y_b| / (|(e1^T W) x_b| + EPS) with
//     per_signal, else zeros.
//
// Bound on an H100: bytes. The function reads x once and writes y, cs and
// delta once: (2 B N + 4 G N) * sizeof(complex) + B * sizeof(real) at
// 3.35 TB/s; the FFT's 5 N log2 N flops and the sums' 8 per point are far
// below the fp32/fp64 peaks. So the design keeps every intermediate on chip:
//
// * The FFT is block_fft's (fft_tile.cuh): a CTA tile of S whole signals,
//   S * N <= 8192 points, N / 16 * S threads of 16 points, radix-2/4/8/16
//   register codelets with compile-time twiddles, XOR-swizzled in-place
//   exchanges, the digit reversal folded into the last stage's stores, and
//   16-byte loads and streaming stores of x and y. The tile is loaded
//   through shared memory (block_fft's staged instance), not straight into
//   the first stage's registers, because the X-side sums below read the
//   raw tile.
// * Each checksum group runs on one thread-block cluster of C <= 8 CTAs
//   (C a power of two, at most the group's tile count rounded up, at most
//   N). The group's bs * T signals form tiles 0, 1, ... of S signals; CTA c
//   takes tiles c, c + C, ... in steps (a CTA with no tile in a step joins
//   the barriers and contributes nothing).
// * Each CTA owns N / C columns of the group's four sums. After a step's
//   load the cluster synchronises and each owner adds its columns of every
//   CTA's tile, CTA by CTA in rank order, signal by signal, weighted by the
//   1-based global ids, reading the other tiles over distributed shared
//   memory (cluster.map_shared_rank). The cluster synchronises again before
//   the stages overwrite x. The Y side is the same after the last stage and
//   the SEU, and a last barrier keeps every tile alive until all owners
//   have read it. The fixed order makes the result bitwise deterministic.
// * With one step per CTA (the timed shape: G = 256, T = 4, bs = 1 gives
//   C = 4, one signal per CTA, block_fft's own grid) each owner writes its
//   columns of cs straight from registers. With more steps the owner keeps
//   its running sums in shared memory (4 N / C points) and writes cs at the
//   last step. No element of cs is read back from device memory, and each
//   is written once.
// * The per-signal left checksums are block-level dot products over the
//   tile: N / 16 lanes a signal, a shuffle tree inside each warp and a
//   fixed-order sum of the warps' partials.
// * The host (repro_torch.kernels.stockham_abft.launch_geometry) picks S,
//   C, the steps and the shared memory; the launch checks them, sets the
//   cluster dimension with cudaLaunchKernelEx and returns the CUDA error of
//   a launch the card refuses. abft_fft_clusters_* reports how many such
//   clusters the card can hold at once (0: it cannot schedule one).
// * No spills: complex64 at 64 registers a thread (two 512-thread CTAs an
//   SM, at most 96 KiB of shared memory each), complex128 at 128 (one CTA
//   an SM). For that, nothing but loop counters stays live across the
//   stages (the cluster rank and id are re-read, the SEU decoded after
//   them); complex64 rows always move as 16-byte pairs (the host requires
//   N >= 2 and 16-byte alignment), so load_tile's scalar path is not
//   compiled; complex128 rows load 4 deep (load_rows) instead of
//   load_tile's 16, and a radix-16 middle stage forms its twiddles as a
//   running product (stage_mid16_c128): block_fft's radix-16 stage_mid
//   spills at complex128.
//
// Plans with a radix above 16 (the reference's radix-128 plans) take the
// generic stages of stockham.cuh on an unswizzled tile, then a register
// reorder into natural order, in a separate instance with the same
// checksum machinery: correct, not fast.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_tile.cuh"
#include "smem_limit.cuh"

namespace turbofft {
namespace abft {

namespace cg = cooperative_groups;
using blockfft::Desc;
using blockfft::kMaxThreads;
using blockfft::kPts;
using blockfft::kTile;
using blockfft::slot;
using blockfft::Traits;

constexpr int kMaxCluster = 8;   // the portable cluster size

// Columns an owner thread sums at once: 4 complex64, 2 complex128 (the same
// registers).
template <typename V>
constexpr int kOwnCols = sizeof(V) == 8 ? 4 : 2;

// The launch geometry, as the host packs it (see abft_fft_c64).
struct Geo {
  long long groups;
  int log_n, nst;
  unsigned long long logr;
  int bs, rows;                  // signals a transaction, a group
  int sigs, log_sigs;            // signals a tile (a power of two)
  int cluster, steps;            // CTAs a group; tiles a CTA, at most
  int per_signal;
};

// Signals in tile k of a group (0 past the group's last tile).
__device__ __forceinline__ int tile_sigs(const Geo& geo, int k) {
  const int left = geo.rows - k * geo.sigs;
  return left <= 0 ? 0 : (left < geo.sigs ? left : geo.sigs);
}

// The CTA's rank in its cluster and the cluster's index (= the group), read
// afresh at each use (volatile), so that nothing derived from them stays in
// a register across the stages, where the codelets need all 64.
__device__ __forceinline__ int cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ long long group_id() {
  unsigned g;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(g));
  return (long long)g;
}

// Where the per-signal input (0) and output (1) checksums, the warps'
// partials (2) and the running sums (3) start after the tile, in points;
// opaque, so it is recomputed at each use and held nowhere across the
// stages.
__device__ __forceinline__ int after_tile(const Geo& geo, int which) {
  int off = geo.sigs << geo.log_n;
  asm volatile("" : "+r"(off));
  return off + (which >= 1 ? geo.sigs : 0) + (which >= 2 ? geo.sigs : 0)
         + (which >= 3 ? (int)(blockDim.x >> 5) : 0);
}

// The CTA's tile in a step: its signals and its first global signal.
struct TilePos {
  int nsig;
  long long sig0;
};
__device__ __forceinline__ TilePos tile_pos(const Geo& geo, int step) {
  const int k = step * geo.cluster + cta_rank();
  return {tile_sigs(geo, k), group_id() * geo.rows + (long long)k * geo.sigs};
}

// The owner's sums over one step of the cluster's tiles, side 0 (x) or 1
// (y): for each of its columns, sum_v and sum gid * v over every CTA's
// tile in rank order, each tile's signals in order; then the running sums
// of earlier steps (shared memory, 2 x N / C points a side) or, at the last
// step, one store of each to cs.
template <typename V, bool SWZ>
__device__ __forceinline__ void owner_sums(cg::cluster_group& cluster,
                                           V* s, V* acc, V* cs,
                                           const Geo& geo, int step,
                                           int side) {
  using R = typename Traits<V>::R;
  const int n = 1 << geo.log_n;
  const int cols = n / geo.cluster;
  const int col0 = cta_rank() * cols;
  const long long g = group_id();
  const long long g0 = g * geo.rows;
  V* out2 = cs + ((2 * side) * geo.groups + g) * n;
  V* out3 = cs + ((2 * side + 1) * geo.groups + g) * n;
  for (int c0 = threadIdx.x; c0 < cols; c0 += kOwnCols<V> * blockDim.x) {
    V a2[kOwnCols<V>], a3[kOwnCols<V>];
#pragma unroll
    for (int i = 0; i < kOwnCols<V>; ++i) {
      a2[i].x = a2[i].y = 0;
      a3[i].x = a3[i].y = 0;
    }
    for (int r = 0; r < geo.cluster; ++r) {
      const int k = step * geo.cluster + r;
      const int nsig = tile_sigs(geo, k);
      const V* sr = cluster.map_shared_rank(s, r);
      const long long gid0 = g0 + (long long)k * geo.sigs + 1;
      for (int q = 0; q < nsig; ++q) {
        const R gid = (R)(gid0 + q);
        V v[kOwnCols<V>];
#pragma unroll
        for (int i = 0; i < kOwnCols<V>; ++i) {
          const int c = c0 + i * blockDim.x;
          v[i].x = v[i].y = 0;
          if (c < cols) v[i] = sr[slot<V, SWZ>((q << geo.log_n) + col0 + c)];
        }
#pragma unroll
        for (int i = 0; i < kOwnCols<V>; ++i) {
          a2[i] = cadd(a2[i], v[i]);
          a3[i].x += gid * v[i].x;
          a3[i].y += gid * v[i].y;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kOwnCols<V>; ++i) {
      const int c = c0 + i * blockDim.x;
      if (c < cols) {
        V* ac = acc + 2 * side * cols + c;
        if (step > 0) {
          a2[i] = cadd(ac[0], a2[i]);
          a3[i] = cadd(ac[cols], a3[i]);
        }
        if (step + 1 < geo.steps) {
          ac[0] = a2[i];
          ac[cols] = a3[i];
        } else {
          __stcs(out2 + col0 + c, a2[i]);
          __stcs(out3 + col0 + c, a3[i]);
        }
      }
    }
  }
}

// out[q] = sum_k a[k] * (point k of signal q of the tile), q < nsig: P =
// max(1, N / 16) lanes a signal, lane j taking points j, j + P, ... (16
// points, as in the stages). Below 32 lanes a signal, a warp holds 32 / P
// signals, lane = j * 32 / P + (signal within the warp), so a half-warp
// reads neighbouring signals (at most 2-way bank conflicted under the
// swizzle). A shuffle tree over each signal's lanes, then, above 32 lanes,
// the warps' partials in order. Every thread of the CTA calls it; it ends
// with a barrier.
template <typename V, bool SWZ>
__device__ __forceinline__ void signal_dots(const V* s, const V* __restrict__ a, V* out,
                            V* part, int nsig, int log_n) {
  const int n = 1 << log_n;
  const int lane = threadIdx.x & 31;
  const int log_p = log_n > 4 ? log_n - 4 : 0;
  const int p = 1 << log_p;
  const int per_pass = blockDim.x >> log_p;
  // the lowest shuffle distance between two lanes of one signal
  const int low = p < 32 ? 32 >> log_p : 1;
  for (int q0 = 0; q0 < nsig; q0 += per_pass) {
    int q, j;
    if (p < 32) {
      q = q0 + (threadIdx.x >> 5) * low + (lane & (low - 1));
      j = lane / low;
    } else {
      q = q0 + (threadIdx.x >> log_p);
      j = threadIdx.x & (p - 1);
    }
    V acc;
    acc.x = acc.y = 0;
    if (q < nsig)
      for (int k = j; k < n; k += p)
        acc = cfma(__ldg(&a[k]), s[slot<V, SWZ>((q << log_n) + k)], acc);
    for (int off = 16; off >= low; off >>= 1) {
      acc.x += __shfl_xor_sync(0xffffffffu, acc.x, off);
      acc.y += __shfl_xor_sync(0xffffffffu, acc.y, off);
    }
    if (p <= 32) {
      if (j == 0 && q < nsig) out[q] = acc;
    } else {
      if (lane == 0) part[threadIdx.x >> 5] = acc;
      __syncthreads();
      const int warps = p >> 5;          // warps a signal
      if ((int)threadIdx.x < per_pass && q0 + (int)threadIdx.x < nsig) {
        V t = part[threadIdx.x * warps];
        for (int w = 1; w < warps; ++w) t = cadd(t, part[threadIdx.x * warps + w]);
        out[q0 + threadIdx.x] = t;
      }
      __syncthreads();                   // part is reused by the next pass
    }
  }
  __syncthreads();
}

// complex128 rows into the tile: the tile's first `pts` points from x, the
// rest of its `tile` points zero, kIn loads in flight a thread. (load_tile
// keeps 16 in flight, 64 of the 128 registers a complex128 thread has,
// which spills here.)
template <typename V, bool SWZ>
__device__ __forceinline__ void load_rows(V* s, const V* x, int pts,
                                          int tile) {
  constexpr int kIn = 4;
  for (int e0 = threadIdx.x; e0 < tile; e0 += kIn * blockDim.x) {
    V v[kIn];
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const int e = e0 + i * blockDim.x;
      v[i].x = v[i].y = 0;
      if (e < pts) v[i] = __ldcs(x + e);
    }
#pragma unroll
    for (int i = 0; i < kIn; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < tile) s[slot<V, SWZ>(e)] = v[i];
    }
  }
}

// A radix-16 stage that is not the last, at complex128: block_fft's
// stage_mid, except that row k1's twiddle T[k1, n2] = T[1, n2]^k1 is a
// running product, one table load and one product a row (twiddle_store
// holds 4 loaded powers). That keeps the 16 double2 points and their
// twiddles within the 128 registers of a 512-thread CTA without spilling;
// 14 products cost about 14 ulps, far inside the complex128 tolerance.
template <typename V>
__device__ __forceinline__ void stage_mid16_c128(V* s, int nbf, int log_m,
                                                 int log_ns,
                                                 const V* __restrict__ tw) {
  using F = blockfft::Fft<V, false, 16>;
  const int m = 1 << log_m;
#pragma unroll 1
  for (int i = threadIdx.x; i < nbf; i += blockDim.x) {
    const int n2 = i & (m - 1);
    const int base = ((i >> log_m) << log_ns) + n2;
    V z[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) z[j] = s[slot<V, true>(base + (j << log_m))];
    F::run(z);
    s[slot<V, true>(base)] = z[F::slot(0)];
    const V w = __ldg(&tw[m + n2]);
    V t = w;
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      s[slot<V, true>(base + (k << log_m))] = cmul(z[F::slot(k)], t);
      t = cmul(t, w);
    }
  }
}

// The plan's stages on the tile; y in natural order at slot(j * N + k)
// after it. Every thread of the CTA calls it; it ends with a barrier.
template <typename V, bool FAST>
__device__ __forceinline__ void run_stages(V* s, const V* __restrict__ tables,
                                           const Geo& geo) {
  const int log_n = geo.log_n;
  const int tile = geo.sigs << log_n;
  if constexpr (FAST) {
    for (int st = 0; st < geo.nst; ++st) {
      // the stage's offset in the table and its sub-signal length, from
      // st alone: only st stays live across a stage (complex128 needs all
      // 128 registers in the radix-16 codelet)
      int tab = 0, log_ns = log_n;
      for (int u = 0; u < st; ++u) {
        const int lu = stage_log_radix(geo.logr, u);
        tab += (1 << (2 * lu)) + (log_ns > lu ? (1 << log_ns) : 0);
        log_ns -= lu;
      }
      const int lr = stage_log_radix(geo.logr, st);
      const int log_m = log_ns - lr;
      const V* tw_st = tables + tab + (1 << (2 * lr));      // skip W_r
      const int nbf = tile >> lr;
      if (st + 1 < geo.nst) {
        switch (lr) {
          case 1: blockfft::stage_mid<V, false, 2>(s, nbf, log_m, log_ns, tw_st); break;
          case 2: blockfft::stage_mid<V, false, 4>(s, nbf, log_m, log_ns, tw_st); break;
          case 3: blockfft::stage_mid<V, false, 8>(s, nbf, log_m, log_ns, tw_st); break;
          default:
            if constexpr (sizeof(V) == 16)
              stage_mid16_c128<V>(s, nbf, log_m, log_ns, tw_st);
            else
              blockfft::stage_mid<V, false, 16>(s, nbf, log_m, log_ns, tw_st);
            break;
        }
      } else {
        switch (lr) {
          case 1: blockfft::stage_last<V, false, 2>(s, nbf, log_n, geo.nst, geo.logr); break;
          case 2: blockfft::stage_last<V, false, 4>(s, nbf, log_n, geo.nst, geo.logr); break;
          case 3: blockfft::stage_last<V, false, 8>(s, nbf, log_n, geo.nst, geo.logr); break;
          default: blockfft::stage_last<V, false, 16>(s, nbf, log_n, geo.nst, geo.logr); break;
        }
      }
      __syncthreads();
    }
  } else {
    stockham_stages<V>(s, geo.sigs, log_n, tables, geo.nst, geo.logr);
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
        s[(e - lo) | blockfft::natural_index(lo, geo.nst, geo.logr, log_n)] = v[q];
      }
    }
    __syncthreads();
  }
}

// One cluster a group; see the header. Shared memory: the tile (S N), the
// per-signal input and output checksums (2 S), the warps' partials
// (threads / 32) and, with more than one step, the owner's running sums
// (4 N / C).
template <typename V, bool FAST>
__global__ void __launch_bounds__(kMaxThreads, Traits<V>::kMinBlocks)
abft_fft_kernel(const V* __restrict__ x, V* __restrict__ y,
                typename Traits<V>::R* __restrict__ delta,
                V* __restrict__ cs, const V* __restrict__ tables,
                const V* __restrict__ ew, const V* __restrict__ e1,
                const typename Traits<V>::R* __restrict__ inj, Geo geo) {
  using R = typename Traits<V>::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* s = reinterpret_cast<V*>(smem_raw);
  const int log_n = geo.log_n;
  cg::cluster_group cluster = cg::this_cluster();
  // contiguous rows in and out, 16-byte pairs at complex64 (the host checks
  // the alignment): known here, so load_tile and store_tile keep only that
  // path
  Desc d;
  for (int a = 0; a < 3; ++a) {
    d.cnt[a] = 1;
    d.in[a] = d.out[a] = 0;
  }
  d.cnt[2] = d.total = geo.groups * geo.rows;
  d.in[2] = d.out[2] = 1 << log_n;
  d.pin = d.pout = 1;
  d.sigs = geo.sigs;
  d.log_sigs = geo.log_sigs;
  d.vec_in = d.vec_out = 1;

  for (int step = 0; step < geo.steps; ++step) {
    {
      const TilePos t = tile_pos(geo, step);
      if (t.nsig > 0) {
        if constexpr (sizeof(V) == 8)
          blockfft::load_tile<V, FAST>(s, x, d, t.sig0 << log_n, t.nsig,
                                       log_n);
        else
          load_rows<V, FAST>(s, x + (t.sig0 << log_n), t.nsig << log_n,
                             geo.sigs << log_n);
      }
      __syncthreads();
      if (geo.per_signal)        // left input checksums (e1^T W) x_q
        signal_dots<V, FAST>(s, ew, s + after_tile(geo, 0),
                             s + after_tile(geo, 2), t.nsig, log_n);
    }
    cluster.sync();              // every tile of the step is loaded
    owner_sums<V, FAST>(cluster, s, s + after_tile(geo, 3), cs, geo, step, 0);
    cluster.sync();              // every owner has read x

    if (tile_pos(geo, step).nsig > 0) run_stages<V, FAST>(s, tables, geo);

    const TilePos t = tile_pos(geo, step);
    // The SEU [tile, row, col, enabled, eps_r, eps_i]: integer fields
    // truncate toward zero, as the reference's astype(int32); a row or
    // column out of range never hits.
    if (inj != nullptr && threadIdx.x == 0 && inj[3] > (R)0) {
      const int row = (int)inj[1], col = (int)inj[2];
      const long long sig = (long long)(int)inj[0] * geo.bs + row;
      if (row >= 0 && row < geo.bs && col >= 0 && col < (1 << log_n)
          && sig >= t.sig0 && sig < t.sig0 + t.nsig) {
        const int e = slot<V, FAST>(((int)(sig - t.sig0) << log_n) + col);
        s[e].x += inj[4];
        s[e].y += inj[5];
      }
    }
    cluster.sync();              // every y of the step is final

    if (geo.per_signal)          // left output checksums e1^T y_q
      signal_dots<V, FAST>(s, e1, s + after_tile(geo, 1),
                           s + after_tile(geo, 2), t.nsig, log_n);
    for (int q = threadIdx.x; q < t.nsig; q += blockDim.x) {
      R dq = 0;
      if (geo.per_signal) {
        const V si = s[after_tile(geo, 0) + q], so = s[after_tile(geo, 1) + q];
        const R dr = si.x - so.x, di = si.y - so.y;
        dq = sqrt(dr * dr + di * di) / (sqrt(si.x * si.x + si.y * si.y) + (R)1e-30);
      }
      delta[t.sig0 + q] = dq;
    }
    if (t.nsig > 0)
      blockfft::store_tile<V, FAST>(y, s, d, t.sig0 << log_n, t.nsig, log_n,
                                    (R)1, nullptr, 0, 0u, 0);
    owner_sums<V, FAST>(cluster, s, s + after_tile(geo, 3), cs, geo, step, 1);
    cluster.sync();              // no tile is overwritten or left while read
  }
}

// Shared memory of a launch, in points (the host's launch_geometry agrees).
__host__ __forceinline__ long long smem_points(const Geo& geo, int threads) {
  const long long n = 1ll << geo.log_n;
  return ((long long)geo.sigs << geo.log_n) + 2 * geo.sigs + threads / 32
         + (geo.steps > 1 ? 4 * n / geo.cluster : 0);
}

// geo: 13 x int64, see abft_fft_c64. query: report the clusters the card
// holds at once instead of launching.
template <typename V>
int launch(const void* x, void* y, void* delta, void* cs, const void* tables,
           const void* ew, const void* e1, const void* inj,
           const long long* p, void* stream, bool query) {
  using R = typename Traits<V>::R;
  const long long batch = p[0];
  Geo geo;
  geo.log_n = (int)p[1];
  geo.nst = (int)p[2];
  geo.logr = (unsigned long long)p[3];
  geo.bs = (int)p[4];
  geo.rows = (int)(p[4] * p[5]);
  geo.sigs = (int)p[6];
  geo.cluster = (int)p[7];
  geo.steps = (int)p[8];
  geo.per_signal = (int)p[9];
  const bool fast = p[10] != 0;
  const long long smem = p[11];
  const int threads = (int)p[12];
  if (geo.log_n < 0 || geo.log_n > 13 || geo.sigs <= 0 || geo.sigs > kTile)
    return (int)cudaErrorInvalidValue;
  geo.log_sigs = 31 - __builtin_clz(geo.sigs);
  const int n = 1 << geo.log_n;
  const int tile = geo.sigs << geo.log_n;
  if (p[4] <= 0 || p[5] <= 0 || geo.rows <= 0 || batch % geo.rows
      || geo.sigs != (1 << geo.log_sigs) || tile > kTile
      || geo.cluster < 1 || geo.cluster > kMaxCluster
      || (geo.cluster & (geo.cluster - 1)) || geo.cluster > n
      || geo.steps < 1
      || (long long)geo.steps * geo.cluster * geo.sigs < geo.rows
      || threads != (tile / kPts > 32 ? tile / kPts : 32)
      || smem != smem_points(geo, threads) * (long long)sizeof(V))
    return (int)cudaErrorInvalidValue;
  // complex64 moves 16-byte pairs of points
  if (sizeof(V) == 8 && (geo.log_n < 1 || (size_t)x % 16 || (size_t)y % 16))
    return (int)cudaErrorInvalidValue;
  geo.groups = batch / geo.rows;
  if (geo.groups == 0 && !query) return (int)cudaSuccess;
  if (geo.groups * geo.cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  auto kernel = fast ? &abft_fft_kernel<V, true> : &abft_fft_kernel<V, false>;
  {
    cudaError_t err = allow_smem((const void*)kernel, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((geo.groups > 0 ? geo.groups : 1) * geo.cluster));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (query) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    return err != cudaSuccess ? -(int)err : clusters;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const V*)x, (V*)y, (R*)delta, (V*)cs, (const V*)tables,
      (const V*)ew, (const V*)e1, (const R*)inj, geo);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace abft
}  // namespace turbofft

extern "C" {

// x, y: (batch, 2^log_n) complex64, contiguous, 16-byte aligned, N >= 2,
// batch = G * transactions * bs; delta: (batch,) float32; cs: (4, G,
// 2^log_n) complex64; tables: the plan's flat forward stage table; ew, e1:
// (2^log_n,) complex64 encoding vectors; inj: 6 float32 on the device or
// NULL. geo: 13 x int64, [batch, log2 N, stages, packed log2 radices, bs,
// transactions, signals a tile, cluster size, steps, per_signal, every
// radix <= 16, shared memory bytes, threads] (launch_geometry in
// stockham_abft.py). Returns the CUDA error code of the launch (0 on
// success).
int abft_fft_c64(const void* x, void* y, void* delta, void* cs,
                 const void* tables, const void* ew, const void* e1,
                 const void* inj, const long long* geo, void* stream) {
  return turbofft::abft::launch<float2>(x, y, delta, cs, tables, ew, e1, inj,
                                        geo, stream, false);
}

// As abft_fft_c64 for complex128 (delta and inj in float64; any N).
int abft_fft_c128(const void* x, void* y, void* delta, void* cs,
                  const void* tables, const void* ew, const void* e1,
                  const void* inj, const long long* geo, void* stream) {
  return turbofft::abft::launch<double2>(x, y, delta, cs, tables, ew, e1,
                                         inj, geo, stream, false);
}

// The clusters of geo's launch the current device holds at once (0: it
// cannot schedule one), or minus the CUDA error code of the query.
int abft_fft_clusters_c64(const long long* geo) {
  return turbofft::abft::launch<float2>(nullptr, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, nullptr, nullptr,
                                        geo, nullptr, true);
}

int abft_fft_clusters_c128(const long long* geo) {
  return turbofft::abft::launch<double2>(nullptr, nullptr, nullptr, nullptr,
                                         nullptr, nullptr, nullptr, nullptr,
                                         geo, nullptr, true);
}

}  // extern "C"

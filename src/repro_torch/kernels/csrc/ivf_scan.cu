// K13 and K14: the IVF scan on Hopper, exact and PQ/ADC.
//
// K13 replaces src/repro/kernels/ivf_scan.py::ivf_scan_pallas (line 122),
// K14 replaces ivf_scan.py::ivf_adc_scan_pallas (line 249). For one query
// q the scan walks the query's compacted probed tiles ids[q, 0 .. n_active)
// in order. Before each tile it evaluates the kth-distance ball gate
//   lo = max(dc - r_t, 0),  dc = sqrt(sum_j (c_t,j - q_j)^2),
//   skip = lo*lo >= tau*(1 + REL) + ABS*((|c_t| + r_t + sqrt(|q|^2))^2),
// with tau the carried k-th D² (+inf while fewer than k are held), counts
// the skip, and otherwise scores every row x of the tile,
//   exact (K13): D² = max((|x|^2 - 2 x.q) + |q|^2, 0),
//   ADC   (K14): D² = max((|q|^2 - 2 (q.r + qdots[label])) + u, 0),
//                q.r = sum_s lut[s, code_s],
// and merges the rows into the carried top-k by the key (D², row),
// lexicographic. Rows >= n are not candidates (the reference's sentinel).
//
// Arithmetic, one order for kernel, plain version and oracle:
// |q|^2, |c_t|^2 and dc^2 add the columns in ascending order with one
// rounded product and one rounded add each (bounds.point_norms); x.q is an
// ascending chain of fused multiply-adds after one rounded product
// (bounds._dots' addcmul chain); sum_s lut adds the gathered values in
// ascending s. Every step is an explicit round-to-nearest intrinsic, so
// nvcc contracts nothing the plain version does not.
//
// K13, tile-major in two parts. What bounds it: operations. Each query
// scores every row of the tiles it probes (2d flops a row; 1.16e9 rows at
// IVF_SIFT1M, Q = 10,000, nprobe 32: 4.4 ms at fp32's rate), while the
// rows themselves, 512 MB there, are shared: a list is probed by about
// Q * nprobe / nlist = 1,250 queries. So the rows must be read once per
// group of queries, not once per query.
//  (a) tile_topk_kernel: the wrapper inverts the probe maps into (query,
//      step) pairs sorted by tile (a stable sort) and cuts each tile's
//      pairs into chunks of 64. One block of 256 threads takes a chunk: it
//      stages the 64 queries and, 64 rows at a time, the tile's rows in
//      shared memory with coalesced loads; warp w scores its 8 pairs
//      against the sub-tile (lane l rows l and l + 32: 16 chains a thread,
//      float4 reads, conflict-free row stride), in the chain above, and
//      keeps each pair's top-k of the tile in registers (position l + 32r
//      in lane l: a sorted list, filled by a bitonic sort of the first 64
//      rows; a later row that beats the k-th key is inserted by a ballot
//      for its rank and a one-place shift). Skipped tiles are
//      scored too (the gate is only known in part (b)); the gate's terms
//      that do not depend on tau (lo*lo and the margin) are computed here,
//      with the same operations. For k > 128 (or staging past shared
//      memory) tile_sort_kernel takes one block per pair and ranks the
//      tile's rows by the key instead.
//  (b) replay_kernel: one warp per query walks its steps in ids order,
//      evaluates the gate against the carried k-th key, counts a skip, and
//      otherwise merges the step's tile top-k (read from part (a)'s output
//      in device memory, so shared memory holds 16 bytes a k) into the
//      carried top-k by rank (binary search on the other sorted list; the
//      carried side first on equal keys, which only the (+inf, INT32_MAX)
//      pads share).
//      A tile's top-k merged gives the same top-k as all its rows, so
//      dists, rows and gate_skipped are the one-block-per-query walk's
//      bits.
// No float atomics: a pair's list does not depend on its chunk.
//
// K14 in the same two parts, part (b) K13's replay_kernel. What bounds it:
// its LUT gathers. Each scored row gathers n_sub LUT values (1.16e9 rows of
// the probed tiles at IVF_SIFT1M, nprobe 32: 5.8e8 warp-wide shared-memory
// loads, about 2 ms at one an SM a clock if no bank conflicts); the
// operations (n_sub + 4 a row) and the bytes (the codes, 16 MB, shared by
// about 1,250 queries a list) are below that.
//  (a) adc_pair_topk_kernel: one block a query stages the query's LUT
//      (16 KB at n_sub 16, n_codes 256), routing dots and vector once; its
//      warps take the query's (query, step) pairs in turn, each on its own:
//      a lane scores rows of the step's tile with the walk's arithmetic
//      (the codes read from device memory as 16-byte rows, L2 serving the
//      tiles the queries share) and the warp keeps the tile's top-k in
//      registers (K13's offer and sort64). A ninth warp computes the gate's
//      tau-free terms. Small blocks, several an SM, hide the gathers' and
//      the offers' latency. (A tile-major form, the pairs sorted by tile
//      and 8 queries' LUTs staged in a block along runs of tiles, was
//      slower than the walk it replaced: its 128 KB of LUTs left one block
//      an SM, whose barriers and serial phases the latency then set.)
//      Past k = 128 adc_tile_sort_kernel takes one block per pair and
//      ranks the tile's rows.
//  (b) replay_kernel, as K13's, with the gate over the balls of the
//      reconstructed rows: dists, rows and gate_skipped are the walk's
//      bits.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

// how many of the sorted (v, i)[0 .. k) lie below (x, xi); `or_equal`
// counts equal keys too
__device__ __forceinline__ int count_below(const float* v, const int* i,
                                           int k, float x, int xi,
                                           bool or_equal) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool below = or_equal ? !lex_less(x, xi, v[mid], i[mid])
                                : lex_less(v[mid], i[mid], x, xi);
    if (below) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// asynchronous copies global -> shared (16 and 4 bytes), their groups
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// sum_j x_j^2 in ascending order, every operation rounded
__device__ __forceinline__ float sq_sum(const float* x, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j)
    s = j == 0 ? __fmul_rn(x[j], x[j]) : __fadd_rn(s, __fmul_rn(x[j], x[j]));
  return s;
}

// the gate's terms that do not depend on tau: lo*lo and the margin
__device__ void gate_terms(const float* q, float qn, const float* c, float r,
                           int d, float abs_, float* lo2, float* margin) {
  float dc2 = 0.f;
  for (int j = 0; j < d; ++j) {
    const float t = __fsub_rn(c[j], q[j]);
    dc2 = j == 0 ? __fmul_rn(t, t) : __fadd_rn(dc2, __fmul_rn(t, t));
  }
  const float dc = __fsqrt_rn(dc2);
  const float cn = __fsqrt_rn(sq_sum(c, d));
  const float lo = clamp0(__fsub_rn(dc, r));
  const float mag = __fadd_rn(__fadd_rn(cn, r), __fsqrt_rn(qn));
  *margin = __fmul_rn(abs_, __fmul_rn(mag, mag));
  *lo2 = __fmul_rn(lo, lo);
}

__device__ __forceinline__ bool gate_says_skip(float lo2, float margin,
                                               float tau, float rel1) {
  return lo2 >= __fadd_rn(__fmul_rn(tau, rel1), margin);
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// ---------------------------------------------------------------------------
// K13 part (a): each (query, step) pair's top-k of its tile
// ---------------------------------------------------------------------------

constexpr int kPairs = 64;      // pairs a block
constexpr int kPairsWarp = 8;   // pairs a warp
constexpr int kLaneRows = 2;    // rows a lane scores per sub-tile
constexpr int kRows = 32 * kLaneRows;   // rows of a sub-tile
constexpr int kListMax = 128;   // the largest k of the register lists
constexpr unsigned kAll = 0xffffffffu;

struct TopkArgs {
  const float* queries;    // (Q, d)
  const float* points;     // (n, d) label-sorted rows
  const float* norms;      // (n,) cached |x|^2
  const float* centers;    // (n_tiles, d)
  const float* radii;      // (n_tiles,)
  const int* pair_query;   // (P,) pair -> query
  const int* pair_tile;    // (P,) pair -> tile
  const int* order;        // (P,) the pairs, sorted by tile (stable)
  const int* chunk_start;  // (C,) a chunk's first entry of order
  const int* chunk_count;  // (C,) its pairs, at most kPairs, one tile
  float* cand_d;           // (P, k) each pair's top-k D², ascending
  int* cand_r;             // (P, k) and rows
  float* gate_lo2;         // (P,)
  float* gate_margin;      // (P,)
  int n, d, block_n, k, stride, gate;
  float abs_;
};

// the key at position k - 1 of a warp's list (lane l holds l + 32r)
template <int kR>
__device__ __forceinline__ void kth_key(const float (&lv)[kR],
                                        const int (&li)[kR], int k, float& tv,
                                        int& ti) {
  float v = 0.f;
  int i = 0;
#pragma unroll
  for (int r = 0; r < kR; ++r)
    if (r == (k - 1) >> 5) {
      v = lv[r];
      i = li[r];
    }
  tv = __shfl_sync(kAll, v, (k - 1) & 31);
  ti = __shfl_sync(kAll, i, (k - 1) & 31);
}

// offer every lane's (v, row) (where ok) to the warp's sorted list: each
// that beats the k-th key goes in at its rank, the tail one place up
template <int kR>
__device__ __forceinline__ void offer(float (&lv)[kR], int (&li)[kR], float v,
                                      int row, bool ok, int k, int lane) {
  float tv;
  int ti;
  kth_key(lv, li, k, tv, ti);
  unsigned want = __ballot_sync(kAll, ok && lex_less(v, row, tv, ti));
  while (want) {
    const int src = __ffs(want) - 1;
    want &= want - 1;
    const float x = __shfl_sync(kAll, v, src);
    const int xr = __shfl_sync(kAll, row, src);
    if (!lex_less(x, xr, tv, ti)) continue;
    int pos = 0;
#pragma unroll
    for (int r = 0; r < kR; ++r)
      pos += __popc(__ballot_sync(kAll, lex_less(lv[r], li[r], x, xr)));
#pragma unroll
    for (int r = kR - 1; r >= 0; --r) {
      float up = __shfl_up_sync(kAll, lv[r], 1);
      int upi = __shfl_up_sync(kAll, li[r], 1);
      if (r > 0) {
        const float w = __shfl_sync(kAll, lv[r > 0 ? r - 1 : 0], 31);
        const int wi = __shfl_sync(kAll, li[r > 0 ? r - 1 : 0], 31);
        if (lane == 0) {
          up = w;
          upi = wi;
        }
      }
      const int p = 32 * r + lane;
      if (p == pos) {
        lv[r] = x;
        li[r] = xr;
      } else if (p > pos) {
        lv[r] = up;
        li[r] = upi;
      }
    }
    kth_key(lv, li, k, tv, ti);
  }
}

// the warp's 64 keys, element h * 32 + lane in (v[h], i[h]), sorted
// ascending by a bitonic network (21 compare-exchange steps)
__device__ __forceinline__ void sort64(float (&v)[2], int (&i)[2], int lane) {
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j == 32) {   // within the lane; the whole 64 ascend
        if (lex_less(v[1], i[1], v[0], i[0])) {
          const float tv = v[0];
          const int ti = i[0];
          v[0] = v[1];
          i[0] = i[1];
          v[1] = tv;
          i[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 32 * h + lane;
        const float pv = __shfl_xor_sync(kAll, v[h], j);
        const int pi = __shfl_xor_sync(kAll, i[h], j);
        // the lower element of a pair keeps the smaller key in an
        // ascending block, the larger in a descending one
        const bool low = (e & j) == 0, up = (e & size) == 0;
        if (low == up ? lex_less(pv, pi, v[h], i[h])
                      : lex_less(v[h], i[h], pv, pi)) {
          v[h] = pv;
          i[h] = pi;
        }
      }
    }
}

template <int kR>
__global__ void __launch_bounds__(kThreads) tile_topk_kernel(TopkArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = a.d, st = a.stride;
  float* qs = smem;                 // (kPairs, st) the chunk's queries
  float* xs = qs + kPairs * st;     // (kRows, st) a sub-tile of rows
  float* xn = xs + kRows * st;      // (kRows,) their norms
  __shared__ float qn_s[kPairs];
  __shared__ int pid_s[kPairs];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cnt = a.chunk_count[blockIdx.x];
  const int p0 = a.order[a.chunk_start[blockIdx.x]];
  const int t = a.pair_tile[p0];
  if (tid < kPairs)
    pid_s[tid] = tid < cnt ? a.order[a.chunk_start[blockIdx.x] + tid] : -1;
  __syncthreads();
  for (int r = warp; r < kPairs; r += kThreads / 32) {
    const int p = pid_s[r];
    const float* q = a.queries + (size_t)(p >= 0 ? a.pair_query[p] : 0) * d;
    for (int j = lane; j < d; j += 32) qs[r * st + j] = p >= 0 ? q[j] : 0.f;
  }
  __syncthreads();
  if (tid < kPairs) {
    const float* q = qs + tid * st;
    const float qn = sq_sum(q, d);
    qn_s[tid] = qn;
    const int p = pid_s[tid];
    if (p >= 0 && a.gate)
      gate_terms(q, qn, a.centers + (size_t)t * d, a.radii[t], d, a.abs_,
                 a.gate_lo2 + p, a.gate_margin + p);
  }
  float lv[kPairsWarp][kR];
  int li[kPairsWarp][kR];
#pragma unroll
  for (int i = 0; i < kPairsWarp; ++i)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      lv[i][r] = CUDART_INF_F;
      li[i][r] = kSentinel;
    }
  const int row0 = t * a.block_n;
  const int nrows = min(a.block_n, a.n - row0);
  const float* qw = qs + warp * kPairsWarp * st;
  const float* xl = xs + lane * st;   // row lane + 32h at xl + 32h st
  for (int s0 = 0; s0 < nrows; s0 += kRows) {
    __syncthreads();   // the queries staged, the previous sub-tile read
    const int m = min(kRows, nrows - s0);
    const float* src = a.points + (size_t)(row0 + s0) * d;
    for (int r = warp; r < m; r += kThreads / 32)
      for (int j = lane; j < d; j += 32) xs[r * st + j] = src[(size_t)r * d + j];
    for (int r = tid; r < kRows; r += kThreads)
      xn[r] = r < m ? a.norms[row0 + s0 + r] : 0.f;
    __syncthreads();
    // 16 chains a lane: pairs 8w .. 8w + 7 x rows lane, lane + 32; x.q
    // starts with a rounded product and goes on in fused multiply-adds
    // (4 rows a lane measured slower on the H100: fewer blocks an SM)
    float acc[kPairsWarp][kLaneRows];
    int j;
    if (d >= 4) {
      float4 x[kLaneRows];
#pragma unroll
      for (int h = 0; h < kLaneRows; ++h)
        x[h] = *reinterpret_cast<const float4*>(xl + 32 * h * st);
#pragma unroll
      for (int i = 0; i < kPairsWarp; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(qw + i * st);
#pragma unroll
        for (int h = 0; h < kLaneRows; ++h) {
          float u = __fmul_rn(x[h].x, q.x);
          u = __fmaf_rn(x[h].y, q.y, u);
          u = __fmaf_rn(x[h].z, q.z, u);
          acc[i][h] = __fmaf_rn(x[h].w, q.w, u);
        }
      }
      j = 4;
    } else {
#pragma unroll
      for (int i = 0; i < kPairsWarp; ++i)
#pragma unroll
        for (int h = 0; h < kLaneRows; ++h)
          acc[i][h] = __fmul_rn(xl[32 * h * st], qw[i * st]);
      j = 1;
    }
    for (; j + 4 <= d; j += 4) {
      float4 x[kLaneRows];
#pragma unroll
      for (int h = 0; h < kLaneRows; ++h)
        x[h] = *reinterpret_cast<const float4*>(xl + 32 * h * st + j);
#pragma unroll
      for (int i = 0; i < kPairsWarp; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(qw + i * st + j);
#pragma unroll
        for (int h = 0; h < kLaneRows; ++h) {
          float u = __fmaf_rn(x[h].x, q.x, acc[i][h]);
          u = __fmaf_rn(x[h].y, q.y, u);
          u = __fmaf_rn(x[h].z, q.z, u);
          acc[i][h] = __fmaf_rn(x[h].w, q.w, u);
        }
      }
    }
    for (; j < d; ++j) {
#pragma unroll
      for (int i = 0; i < kPairsWarp; ++i)
#pragma unroll
        for (int h = 0; h < kLaneRows; ++h)
          acc[i][h] = __fmaf_rn(xl[32 * h * st + j], qw[i * st + j], acc[i][h]);
    }
#pragma unroll
    for (int i = 0; i < kPairsWarp; ++i) {
      const float qn = qn_s[warp * kPairsWarp + i];
      float v[kLaneRows];
      int id[kLaneRows];
#pragma unroll
      for (int h = 0; h < kLaneRows; ++h) {
        const int r = lane + 32 * h;
        v[h] = clamp0(__fadd_rn(__fsub_rn(xn[r], __fmul_rn(2.f, acc[i][h])),
                                qn));
        id[h] = row0 + s0 + r;
        if (r >= m) {   // not a candidate: a pad, which sorts last
          v[h] = CUDART_INF_F;
          id[h] = kSentinel;
        }
      }
      if (s0 == 0) {
        // the first sub-tile fills the empty list at once: its 64 keys
        // sorted are its first 64 positions
        sort64(v, id, lane);
#pragma unroll
        for (int r = 0; r < kR && r < kLaneRows; ++r) {
          lv[i][r] = v[r];
          li[i][r] = id[r];
        }
      } else {
#pragma unroll
        for (int h = 0; h < kLaneRows; ++h)
          offer(lv[i], li[i], v[h], id[h], id[h] != kSentinel, a.k, lane);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPairsWarp; ++i) {
    const int p = pid_s[warp * kPairsWarp + i];
    if (p < 0) continue;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int pos = 32 * r + lane;
      if (pos < a.k) {
        a.cand_d[(size_t)p * a.k + pos] = lv[i][r];
        a.cand_r[(size_t)p * a.k + pos] = li[i][r];
      }
    }
  }
}

// one block per pair: every row of the tile scored (thread r rows r, r +
// 256, ...), then ranked by the key; positions past the tile's rows are
// (+inf, INT32_MAX)
__global__ void __launch_bounds__(kThreads) tile_sort_kernel(TopkArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k;
  float* qs = smem;                                  // (d,)
  float* sv = qs + d;                                // (block_n,)
  int* si = reinterpret_cast<int*>(sv + a.block_n);  // (block_n,)
  __shared__ float qn_s;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int t = a.pair_tile[p];
  for (int j = tid; j < d; j += kThreads)
    qs[j] = a.queries[(size_t)a.pair_query[p] * d + j];
  __syncthreads();
  if (tid == 0) {
    qn_s = sq_sum(qs, d);
    if (a.gate)
      gate_terms(qs, qn_s, a.centers + (size_t)t * d, a.radii[t], d, a.abs_,
                 a.gate_lo2 + p, a.gate_margin + p);
  }
  __syncthreads();
  const int row0 = t * a.block_n;
  const int nrows = min(a.block_n, a.n - row0);
  for (int r = tid; r < nrows; r += kThreads) {
    const float* x = a.points + (size_t)(row0 + r) * d;
    float dot = __fmul_rn(__ldg(x), qs[0]);
    for (int j = 1; j < d; ++j) dot = __fmaf_rn(__ldg(x + j), qs[j], dot);
    sv[r] = clamp0(__fadd_rn(
        __fsub_rn(__ldg(a.norms + row0 + r), __fmul_rn(2.f, dot)), qn_s));
    si[r] = row0 + r;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += kThreads) {
    int rank = 0;
    for (int j = 0; j < nrows && rank < k; ++j)
      rank += lex_less(sv[j], si[j], sv[r], si[r]);
    if (rank < k) {
      a.cand_d[(size_t)p * k + rank] = sv[r];
      a.cand_r[(size_t)p * k + rank] = si[r];
    }
  }
  for (int pos = nrows + tid; pos < k; pos += kThreads) {
    a.cand_d[(size_t)p * k + pos] = CUDART_INF_F;
    a.cand_r[(size_t)p * k + pos] = kSentinel;
  }
}

// ---------------------------------------------------------------------------
// K14 part (a): each (query, step) pair's ADC top-k of its tile
// ---------------------------------------------------------------------------

constexpr int kAdcWarps = 8;     // scoring warps a block
// the scoring warps, and one that computes the gate's terms
constexpr int kAdcThreads = 32 * (kAdcWarps + 1);

struct AdcTopkArgs {
  const float* queries;    // (Q, d)
  const float* lut;        // (Q, n_sub, n_codes)
  const float* qdots;      // (Q, nlist)
  const uint8_t* codes;    // (n, n_sub)
  const int* labels;       // (n,)
  const float* u;          // (n,) |x_hat|^2
  const float* centers;    // (n_tiles, d) tile balls over the x_hat
  const float* radii;      // (n_tiles,)
  const int* ids;          // (Q, n_tiles) compacted probed tiles
  const int* n_active;     // (Q,)
  const int* pair_start;   // (Q,) the query's first pair
  const int* pair_query;   // (P,) pair -> query (the rank path)
  const int* pair_tile;    // (P,) pair -> tile (the rank path)
  float* cand_d;           // (P, k) each pair's top-k D², ascending
  int* cand_r;             // (P, k) and rows
  float* gate_lo2;         // (P,)
  float* gate_margin;      // (P,)
  int n, d, n_tiles, block_n, k, gate, n_sub, n_codes, nlist;
  float abs_;
};

// One block of 288 threads takes one query's pairs (its steps, in the
// query-major order of part (b)): it stages the query's LUT (as (s, code)),
// routing dots and vector in shared memory by cp.async, once. Warp w then
// takes steps w, w + 8, ... on its own, with no block barrier: it reads the
// step's tile from device memory (each lane a row's 16 code bytes as one
// 16-byte load, its label and u; L2 holds the codes, which about 1,250
// queries a list share), scores every row with the walk's arithmetic (two
// rows a lane on interleaved chains, the LUT values gathered from shared
// memory), keeps the tile's top-k in registers (K13's sort64 and offer,
// the offers of 64 rows skipped when none beats the k-th key) and writes
// it. A ninth warp computes the gate's tau-free terms of the
// query's pairs meanwhile, a lane a pair. Small blocks (about 18 KB of
// shared memory; registers for three an SM) keep many warps an SM, which
// hide the latency of the gathers, loads and offers.
template <int kR>
__global__ void __launch_bounds__(kAdcThreads, 3)
adc_pair_topk_kernel(AdcTopkArgs a) {
  extern __shared__ float4 smem4[];
  const int d = a.d, nl = a.n_sub * a.n_codes, n_codes = a.n_codes;
  float* lut_s = reinterpret_cast<float*>(smem4);          // (nl,)
  float* qd_s = lut_s + (nl + 3) / 4 * 4;                  // (nlist,)
  float* qv_s = qd_s + (a.nlist + 3) / 4 * 4;              // (d,)
  __shared__ float qn_s;
  const int q = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  const int nact = a.n_active[q];
  const size_t p0 = a.pair_start[q];
  const auto sh = [](const void* ptr) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  };
  for (int i = tid; i < nl / 4; i += kAdcThreads)
    cp_async16(sh(lut_s + 4 * i), a.lut + (size_t)q * nl + 4 * i);
  for (int i = tid; i < a.nlist; i += kAdcThreads)
    cp_async4(sh(qd_s + i), a.qdots + (size_t)q * a.nlist + i);
  for (int j = tid; j < d; j += kAdcThreads)
    cp_async4(sh(qv_s + j), a.queries + (size_t)q * d + j);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  if (tid == 0) qn_s = sq_sum(qv_s, d);
  __syncthreads();
  const int* qids = a.ids + (size_t)q * a.n_tiles;
  if (warp == kAdcWarps) {
    // the gate's tau-free terms, a lane a pair, while the others score:
    // gate_terms' two rounded chains (|c - q|^2 and |c|^2) side by side,
    // the ball's columns loaded eight ahead
    if (a.gate)
      for (int st = lane; st < nact; st += 32) {
        const int t = qids[st];
        const float* c = a.centers + (size_t)t * d;
        float dc2 = 0.f, cs = 0.f;
        for (int j0 = 0; j0 < d; j0 += 8) {
          float cv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            cv[e] = j0 + e < d ? __ldg(c + j0 + e) : 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = j0 + e;
            if (j < d) {
              const float tq = __fsub_rn(cv[e], qv_s[j]);
              dc2 = j == 0 ? __fmul_rn(tq, tq)
                           : __fadd_rn(dc2, __fmul_rn(tq, tq));
              cs = j == 0 ? __fmul_rn(cv[e], cv[e])
                          : __fadd_rn(cs, __fmul_rn(cv[e], cv[e]));
            }
          }
        }
        const float r = a.radii[t];
        const float lo = clamp0(__fsub_rn(__fsqrt_rn(dc2), r));
        const float mag = __fadd_rn(__fadd_rn(__fsqrt_rn(cs), r),
                                    __fsqrt_rn(qn_s));
        a.gate_margin[p0 + st] = __fmul_rn(a.abs_, __fmul_rn(mag, mag));
        a.gate_lo2[p0 + st] = __fmul_rn(lo, lo);
      }
    return;
  }
  const float qn = qn_s;
  // rows row[0], row[1]: their D², the LUT values added in ascending s on
  // two interleaved chains, then qn - 2 (qr + qc) + u, clamped
  constexpr int kL = 2;   // rows a lane a sub-tile
  const auto score = [&](const int (&row)[kL], float (&out)[kL]) {
    float qr[kL];
    if (a.n_sub == 16 && n_codes == 256) {
      // IVF_SIFT1M's: one 16-byte load a row, each sub-space's table at a
      // constant offset
      unsigned wd[kL][4];
#pragma unroll
      for (int r = 0; r < kL; ++r) {
        const uint4 w =
            __ldg(reinterpret_cast<const uint4*>(a.codes) + row[r]);
        wd[r][0] = w.x, wd[r][1] = w.y, wd[r][2] = w.z, wd[r][3] = w.w;
      }
#pragma unroll
      for (int s = 0; s < 16; ++s)
#pragma unroll
        for (int r = 0; r < kL; ++r) {
          const float v =
              lut_s[s * 256 + ((wd[r][s >> 2] >> (8 * (s & 3))) & 255)];
          qr[r] = s == 0 ? v : __fadd_rn(qr[r], v);
        }
    } else {
      for (int s = 0; s < a.n_sub; ++s)
#pragma unroll
        for (int r = 0; r < kL; ++r) {
          const float v = lut_s[s * n_codes
                                + __ldg(a.codes + (size_t)row[r] * a.n_sub
                                        + s)];
          qr[r] = s == 0 ? v : __fadd_rn(qr[r], v);
        }
    }
#pragma unroll
    for (int r = 0; r < kL; ++r) {
      const float qc = qd_s[__ldg(a.labels + row[r])];
      out[r] = clamp0(__fadd_rn(
          __fsub_rn(qn, __fmul_rn(2.f, __fadd_rn(qr[r], qc))),
          __ldg(a.u + row[r])));
    }
  };
  float lv[kR];
  int li[kR];
  for (int st = warp; st < nact; st += kAdcWarps) {
    const int row0 = qids[st] * a.block_n;
    const int nrows = min(a.block_n, a.n - row0);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      lv[r] = CUDART_INF_F;
      li[r] = kSentinel;
    }
    for (int sb = 0; sb < nrows; sb += 32 * kL) {
      int row[kL];
      float v[kL];
      int id[kL];
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        const int r = sb + lane + 32 * i;
        row[i] = row0 + (r < nrows ? r : 0);
      }
      score(row, v);
#pragma unroll
      for (int i = 0; i < kL; ++i) {
        id[i] = row0 + sb + lane + 32 * i;
        if (sb + lane + 32 * i >= nrows) {   // a pad, which sorts last
          v[i] = CUDART_INF_F;
          id[i] = kSentinel;
        }
      }
      if (sb == 0) {
        // the first 64 rows fill the empty list at once: sorted, they are
        // its first 64 positions
        sort64(v, id, lane);
#pragma unroll
        for (int r = 0; r < kR && r < 2; ++r) {
          lv[r] = v[r];
          li[r] = id[r];
        }
        continue;
      }
      // the rows offered, once any of them beats the k-th key
      float tv;
      int ti;
      kth_key(lv, li, a.k, tv, ti);
      bool any = false;
#pragma unroll
      for (int i = 0; i < kL; ++i)
        any |= id[i] != kSentinel && lex_less(v[i], id[i], tv, ti);
      if (__any_sync(kAll, any)) {
        offer(lv, li, v[0], id[0], id[0] != kSentinel, a.k, lane);
        offer(lv, li, v[1], id[1], id[1] != kSentinel, a.k, lane);
      }
    }
    const size_t p = p0 + st;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int pos = 32 * r + lane;
      if (pos < a.k) {
        a.cand_d[p * a.k + pos] = lv[r];
        a.cand_r[p * a.k + pos] = li[r];
      }
    }
  }
}

// one block per pair: the query's LUT (as (s, code)), routing dots and
// vector staged, every row of the tile scored (thread r rows r, r + 256,
// ...), then ranked by the key; positions past the tile's rows are (+inf,
// INT32_MAX). For k past the register lists, or a chunk's staging past
// shared memory.
__global__ void __launch_bounds__(kThreads)
adc_tile_sort_kernel(AdcTopkArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k, nl = a.n_sub * a.n_codes;
  float* lut_s = smem;                               // (nl,)
  float* qd_s = lut_s + nl;                          // (nlist,)
  float* qv_s = qd_s + a.nlist;                      // (d,)
  float* sv = qv_s + d;                              // (block_n,)
  int* si = reinterpret_cast<int*>(sv + a.block_n);  // (block_n,)
  __shared__ float qn_s;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int qq = a.pair_query[p], t = a.pair_tile[p];
  for (int i = tid; i < nl; i += kThreads)
    lut_s[i] = a.lut[(size_t)qq * nl + i];
  for (int i = tid; i < a.nlist; i += kThreads)
    qd_s[i] = a.qdots[(size_t)qq * a.nlist + i];
  for (int j = tid; j < d; j += kThreads)
    qv_s[j] = a.queries[(size_t)qq * d + j];
  __syncthreads();
  if (tid == 0) {
    qn_s = sq_sum(qv_s, d);
    if (a.gate)
      gate_terms(qv_s, qn_s, a.centers + (size_t)t * d, a.radii[t], d, a.abs_,
                 a.gate_lo2 + p, a.gate_margin + p);
  }
  __syncthreads();
  const int row0 = t * a.block_n;
  const int nrows = min(a.block_n, a.n - row0);
  for (int r = tid; r < nrows; r += kThreads) {
    const int row = row0 + r;
    const uint8_t* code = a.codes + (size_t)row * a.n_sub;
    float qr = lut_s[code[0]];
    for (int s = 1; s < a.n_sub; ++s)
      qr = __fadd_rn(qr, lut_s[s * a.n_codes + code[s]]);
    const float qc = qd_s[a.labels[row]];
    sv[r] = clamp0(__fadd_rn(__fsub_rn(qn_s, __fmul_rn(2.f, __fadd_rn(qr, qc))),
                             a.u[row]));
    si[r] = row;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += kThreads) {
    int rank = 0;
    for (int j = 0; j < nrows && rank < k; ++j)
      rank += lex_less(sv[j], si[j], sv[r], si[r]);
    if (rank < k) {
      a.cand_d[(size_t)p * k + rank] = sv[r];
      a.cand_r[(size_t)p * k + rank] = si[r];
    }
  }
  for (int pos = nrows + tid; pos < k; pos += kThreads) {
    a.cand_d[(size_t)p * k + pos] = CUDART_INF_F;
    a.cand_r[(size_t)p * k + pos] = kSentinel;
  }
}

// ---------------------------------------------------------------------------
// K13 part (b): each query's walk over its steps' top-k lists
// ---------------------------------------------------------------------------

struct ReplayArgs {
  const float* cand_d;       // (P, k)
  const int* cand_r;         // (P, k)
  const float* gate_lo2;     // (P,)
  const float* gate_margin;  // (P,)
  const int* pair_start;     // (Q,) the query's first pair
  const int* n_active;       // (Q,)
  float* dists;              // (Q, k)
  int* rows;                 // (Q, k)
  int* skipped;              // (Q,)
  int k, gate;
  float rel1;
};

// one warp (a block of 32) per query; shared memory: the carried and the
// merged lists, k each; the step's list is read where part (a) wrote it
__global__ void __launch_bounds__(32) replay_kernel(ReplayArgs a) {
  extern __shared__ float smem[];
  const int k = a.k, lane = threadIdx.x, q = blockIdx.x;
  float* tv = smem;
  int* ti = reinterpret_cast<int*>(tv + k);
  float* nv = reinterpret_cast<float*>(ti + k);
  int* ni = reinterpret_cast<int*>(nv + k);
  for (int e = lane; e < k; e += 32) {
    tv[e] = CUDART_INF_F;
    ti[e] = kSentinel;
  }
  const int p0 = a.pair_start[q], nact = a.n_active[q];
  int nskip = 0;
  for (int s = 0; s < nact; ++s) {
    __syncwarp();
    const size_t p = (size_t)p0 + s;
    if (a.gate && gate_says_skip(a.gate_lo2[p], a.gate_margin[p], tv[k - 1],
                                 a.rel1)) {
      ++nskip;
      continue;
    }
    const float* cv = a.cand_d + p * k;
    const int* ci = a.cand_r + p * k;
    for (int e = lane; e < k; e += 32) {
      const int rc = e + count_below(cv, ci, k, tv[e], ti[e], false);
      if (rc < k) {
        nv[rc] = tv[e];
        ni[rc] = ti[e];
      }
      const int rn = e + count_below(tv, ti, k, cv[e], ci[e], true);
      if (rn < k) {
        nv[rn] = cv[e];
        ni[rn] = ci[e];
      }
    }
    __syncwarp();
    for (int e = lane; e < k; e += 32) {
      tv[e] = nv[e];
      ti[e] = ni[e];
    }
  }
  __syncwarp();
  for (int e = lane; e < k; e += 32) {
    a.dists[(size_t)q * k + e] = tv[e];
    a.rows[(size_t)q * k + e] = ti[e];
  }
  if (lane == 0) a.skipped[q] = nskip;
}

}  // namespace

// Launches K13's part (a) on `stream`: tile_topk_kernel, one block per
// chunk, for k <= 128 when its staging fits `smem_limit` bytes; else
// tile_sort_kernel, one block per pair. Returns cudaGetLastError().
extern "C" int ivf_tile_topk_launch(
    const float* queries, const float* points, const float* norms,
    const float* centers, const float* radii, const int* pair_query,
    const int* pair_tile, const int* order, const int* chunk_start,
    const int* chunk_count, float* cand_d, int* cand_r, float* gate_lo2,
    float* gate_margin, int n_pairs, int n_chunks, int n, int d, int block_n,
    int k, int gate, float abs_, int smem_limit, void* stream) {
  if (n_pairs == 0) return 0;
  const int d4 = (d + 3) / 4 * 4;
  const int stride = d4 % 8 ? d4 : d4 + 4;   // float4 rows, no bank conflict
  TopkArgs a{queries, points, norms, centers, radii, pair_query, pair_tile,
             order, chunk_start, chunk_count, cand_d, cand_r, gate_lo2,
             gate_margin, n, d, block_n, k, stride, gate, abs_};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((size_t)(kPairs + kRows) * stride
                                       + kRows);
  if (k <= kListMax && smem + 512 <= (size_t)smem_limit) {
    const void* fn = k <= 32   ? (const void*)tile_topk_kernel<1>
                     : k <= 64 ? (const void*)tile_topk_kernel<2>
                               : (const void*)tile_topk_kernel<4>;
    const int err = set_smem(fn, smem);
    if (err) return err;
    if (k <= 32) tile_topk_kernel<1><<<n_chunks, kThreads, smem, st>>>(a);
    else if (k <= 64) tile_topk_kernel<2><<<n_chunks, kThreads, smem, st>>>(a);
    else tile_topk_kernel<4><<<n_chunks, kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t smem2 = sizeof(float) * ((size_t)d + 2 * (size_t)block_n);
  const int err = set_smem((const void*)tile_sort_kernel, smem2);
  if (err) return err;
  tile_sort_kernel<<<n_pairs, kThreads, smem2, st>>>(a);
  return (int)cudaGetLastError();
}

// Launches K13's part (b) on `stream`: one warp per query. Returns
// cudaGetLastError().
extern "C" int ivf_replay_launch(const float* cand_d, const int* cand_r,
                                 const float* gate_lo2,
                                 const float* gate_margin,
                                 const int* pair_start, const int* n_active,
                                 float* dists, int* rows, int* skipped,
                                 int n_queries, int k, int gate, float rel1,
                                 void* stream) {
  if (n_queries == 0) return 0;
  ReplayArgs a{cand_d, cand_r, gate_lo2, gate_margin, pair_start, n_active,
               dists, rows, skipped, k, gate, rel1};
  const size_t smem = 4 * sizeof(float) * (size_t)k;
  const int err = set_smem((const void*)replay_kernel, smem);
  if (err) return err;
  replay_kernel<<<n_queries, 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Launches K14's part (a) on `stream`: adc_pair_topk_kernel, one block per
// query, for k <= 128 when the LUT rows are whole 16-byte units and its
// staging fits `smem_limit` bytes; else adc_tile_sort_kernel, one block per
// pair (pair_query / pair_tile required). Returns cudaGetLastError().
extern "C" int ivf_adc_tile_topk_launch(
    const float* queries, const float* lut, const float* qdots,
    const uint8_t* codes, const int* labels, const float* u,
    const float* centers, const float* radii, const int* ids,
    const int* n_active, const int* pair_start, const int* pair_query,
    const int* pair_tile, float* cand_d, int* cand_r, float* gate_lo2,
    float* gate_margin, int n_queries, int n_pairs, int n, int d,
    int n_tiles, int block_n, int k, int gate, int n_sub, int n_codes,
    int nlist, float abs_, int smem_limit, void* stream) {
  if (n_pairs == 0) return 0;
  AdcTopkArgs a{queries,   lut,        qdots,      codes,    labels,
                u,         centers,    radii,      ids,      n_active,
                pair_start, pair_query, pair_tile, cand_d,   cand_r,
                gate_lo2,  gate_margin, n,         d,        n_tiles,
                block_n,   k,          gate,       n_sub,    n_codes,
                nlist,     abs_};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nl = n_sub * n_codes;
  const size_t smem = sizeof(float) * ((size_t)(nl + 3) / 4 * 4
                                       + (nlist + 3) / 4 * 4 + d);
  const bool aligned = reinterpret_cast<uintptr_t>(lut) % 16 == 0
                       && (n_sub != 16
                           || reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  if (k <= kListMax && nl % 4 == 0 && aligned
      && smem + 512 <= (size_t)smem_limit) {
    const auto run = [&](auto kernel) -> int {
      const int err = set_smem((const void*)kernel, smem);
      if (err) return err;
      kernel<<<n_queries, kAdcThreads, smem, st>>>(a);
      return (int)cudaGetLastError();
    };
    return k <= 32   ? run(adc_pair_topk_kernel<1>)
           : k <= 64 ? run(adc_pair_topk_kernel<2>)
                     : run(adc_pair_topk_kernel<4>);
  }
  if (pair_query == nullptr || pair_tile == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem2 = sizeof(float) * ((size_t)nl + nlist + d
                                        + 2 * (size_t)block_n);
  const int err = set_smem((const void*)adc_tile_sort_kernel, smem2);
  if (err) return err;
  adc_tile_sort_kernel<<<n_pairs, kThreads, smem2, st>>>(a);
  return (int)cudaGetLastError();
}

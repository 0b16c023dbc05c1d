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
// K14 (ivf_adc_scan_kernel): one thread block per query walks that
// query's tiles in the order of ids. Thread 0 evaluates the gate; each
// thread scores rows tid, tid + 256, ... of the tile; rows that beat the
// carried k-th key go to a shared-memory buffer, a slot taken with a
// shared-memory integer atomic. The buffer and the carried (sorted) top-k
// are merged by rank: an element's rank is the number of elements whose
// key is smaller (binary search in the carried list, a scan over the
// buffer that stops at k). The key is a total order (rows are unique), so
// the ranks are a permutation and the merged top-k does not depend on the
// slot order. No float atomics. It stages the query's LUT (n_sub x n_codes
// floats) and its routing dots (nlist floats) in shared memory and gathers
// from them. What bounds it: bytes, n_sub + 8 bytes a row and the LUT.
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

// bounds.ivf_gate_skip for tile ball (c, r) against query q
__device__ bool gate_skip(const float* q, float qn, const float* c, float r,
                          int d, float tau, float rel1, float abs_) {
  float lo2, margin;
  gate_terms(q, qn, c, r, d, abs_, &lo2, &margin);
  return gate_says_skip(lo2, margin, tau, rel1);
}

// ---------------------------------------------------------------------------
// K14
// ---------------------------------------------------------------------------

struct AdcArgs {
  const float* queries;   // (Q, d)
  const float* lut;       // (Q, n_sub, n_codes)
  const float* qdots;     // (Q, nlist)
  const uint8_t* codes;   // (n, n_sub)
  const int* labels;      // (n,)
  const float* u;         // (n,) |x_hat|^2
  const float* centers;   // (n_tiles, d) tile balls
  const float* radii;     // (n_tiles,)
  const int* ids;         // (Q, n_tiles) compacted probed tiles
  const int* n_active;    // (Q,)
  float* dists;           // (Q, k)
  int* rows;              // (Q, k)
  int* skipped;           // (Q,)
  int n, d, n_tiles, block_n, k, gate, n_sub, n_codes, nlist;
  float rel1, abs_;
};

__global__ void __launch_bounds__(kThreads) ivf_adc_scan_kernel(AdcArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k, bn = a.block_n;
  float* qs = smem;                        // (d,) the query
  float* tv = qs + d;                      // (k,) carried D²
  int* ti = reinterpret_cast<int*>(tv + k);        // (k,) carried rows
  float* nv = reinterpret_cast<float*>(ti + k);    // (k,) merged D²
  int* ni = reinterpret_cast<int*>(nv + k);        // (k,) merged rows
  float* cv = reinterpret_cast<float*>(ni + k);    // (block_n,) candidates
  int* ci = reinterpret_cast<int*>(cv + bn);       // (block_n,)
  float* lut = reinterpret_cast<float*>(ci + bn);  // (n_sub, n_codes)
  float* qd = lut + a.n_sub * a.n_codes;           // (nlist,)
  __shared__ int n_cand;
  __shared__ int skip_flag;
  __shared__ float qn_s;

  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < d; j += kThreads) qs[j] = a.queries[(size_t)qi * d + j];
  for (int i = tid; i < k; i += kThreads) {
    tv[i] = CUDART_INF_F;
    ti[i] = kSentinel;
  }
  {
    const int nl = a.n_sub * a.n_codes;
    for (int i = tid; i < nl; i += kThreads) lut[i] = a.lut[(size_t)qi * nl + i];
    for (int i = tid; i < a.nlist; i += kThreads)
      qd[i] = a.qdots[(size_t)qi * a.nlist + i];
  }
  __syncthreads();
  if (tid == 0) qn_s = sq_sum(qs, d);
  const int nact = a.n_active[qi];
  int nskip = 0;  // thread 0's count
  for (int step = 0; step < nact; ++step) {
    __syncthreads();  // the previous step's shared state is settled
    const int t = a.ids[(size_t)qi * a.n_tiles + step];
    if (tid == 0) {
      const bool s = a.gate && gate_skip(qs, qn_s, a.centers + (size_t)t * d,
                                         a.radii[t], d, tv[k - 1], a.rel1,
                                         a.abs_);
      skip_flag = s;
      nskip += s;
      n_cand = 0;
    }
    __syncthreads();
    if (skip_flag) continue;
    const float qn = qn_s;
    const float tau_v = tv[k - 1];
    const int tau_i = ti[k - 1];
    for (int r = tid; r < bn; r += kThreads) {
      const int row = t * bn + r;
      if (row >= a.n) break;
      float d2;
      {
        const uint8_t* code = a.codes + (size_t)row * a.n_sub;
        float qr = lut[code[0]];
        for (int s = 1; s < a.n_sub; ++s)
          qr = __fadd_rn(qr, lut[s * a.n_codes + code[s]]);
        const float qc = qd[a.labels[row]];
        d2 = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, __fadd_rn(qr, qc))),
                       a.u[row]);
      }
      d2 = clamp0(d2);
      if (lex_less(d2, row, tau_v, tau_i)) {
        const int slot = atomicAdd(&n_cand, 1);
        cv[slot] = d2;
        ci[slot] = row;
      }
    }
    __syncthreads();
    const int m = n_cand;
    if (m == 0) continue;
    // rank of every carried entry and candidate among all k + m keys
    for (int e = tid; e < k + m; e += kThreads) {
      float v;
      int id, rank;
      if (e < k) {
        v = tv[e];
        id = ti[e];
        rank = e;
      } else {
        v = cv[e - k];
        id = ci[e - k];
        int lo = 0, hi = k;  // carried keys below (v, id): binary search
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (lex_less(tv[mid], ti[mid], v, id)) lo = mid + 1;
          else hi = mid;
        }
        rank = lo;
      }
      for (int j = 0; j < m && rank < k; ++j)
        rank += lex_less(cv[j], ci[j], v, id);
      if (rank < k) {
        nv[rank] = v;
        ni[rank] = id;
      }
    }
    __syncthreads();
    for (int i = tid; i < k; i += kThreads) {
      tv[i] = nv[i];
      ti[i] = ni[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < k; i += kThreads) {
    a.dists[(size_t)qi * k + i] = tv[i];
    a.rows[(size_t)qi * k + i] = ti[i];
  }
  if (tid == 0) a.skipped[qi] = nskip;
}

size_t adc_smem_bytes(const AdcArgs& a) {
  return sizeof(float) * ((size_t)a.d + 4 * (size_t)a.k
                          + 2 * (size_t)a.block_n
                          + (size_t)a.n_sub * a.n_codes + a.nlist);
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

// Launches K14 on `stream`: one block per query. Returns cudaGetLastError().
extern "C" int ivf_adc_scan_launch(const float* queries, const float* lut,
                                   const float* qdots, const uint8_t* codes,
                                   const int* labels, const float* u,
                                   const float* centers, const float* radii,
                                   const int* ids, const int* n_active,
                                   float* dists, int* rows, int* skipped,
                                   int n_queries, int n, int d, int n_tiles,
                                   int block_n, int k, int gate, int n_sub,
                                   int n_codes, int nlist, float rel1,
                                   float abs_, void* stream) {
  AdcArgs a{queries, lut,     qdots,   codes, labels,   u,       centers,
            radii,   ids,     n_active, dists, rows,    skipped, n,
            d,       n_tiles, block_n, k,     gate,     n_sub,   n_codes,
            nlist,   rel1,    abs_};
  if (n_queries == 0) return 0;
  const size_t smem = adc_smem_bytes(a);
  const int err = set_smem((const void*)ivf_adc_scan_kernel, smem);
  if (err) return err;
  ivf_adc_scan_kernel<<<n_queries, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

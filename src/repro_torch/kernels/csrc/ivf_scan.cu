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
// Design. One thread block per query walks that query's tiles in the order
// of ids: the gate reads the k-th D² carried after every tile, so splitting
// one query over blocks would change gate_skipped. Thread 0 evaluates the
// gate; each thread scores rows tid, tid + 256, ... of the tile (its own
// ascending chain over d, reading the row from device memory); rows that
// beat the carried k-th key go to a shared-memory buffer, a slot taken with
// a shared-memory integer atomic. The buffer and the carried (sorted) top-k
// are merged by rank: an element's rank is the number of elements whose
// key is smaller (binary search in the carried list, a scan over the
// buffer that stops at k). The key is a total order (rows are unique), so
// the ranks are a permutation and the merged top-k does not depend on the
// slot order. No float atomics. K14 stages the query's LUT (n_sub x n_codes
// floats) and its routing dots (nlist floats) in shared memory and gathers
// from them.
//
// What bounds it: bytes. Each query reads every row of its probed tiles
// once (K13: 4d + 4 bytes a row; K14: n_sub + 8 bytes a row, plus its LUT)
// and does d multiply-adds (K13) or n_sub adds (K14) per row. Rows are
// read one per thread, not staged through shared memory: a simple first
// kernel; coalesced staging is later work.
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

// bounds.ivf_gate_skip for tile ball (c, r) against query q
__device__ bool gate_skip(const float* q, float qn, const float* c, float r,
                          int d, float tau, float rel1, float abs_) {
  float dc2 = 0.f;
  for (int j = 0; j < d; ++j) {
    const float t = __fsub_rn(c[j], q[j]);
    dc2 = j == 0 ? __fmul_rn(t, t) : __fadd_rn(dc2, __fmul_rn(t, t));
  }
  const float dc = __fsqrt_rn(dc2);
  const float cn = __fsqrt_rn(sq_sum(c, d));
  const float lo = clamp0(__fsub_rn(dc, r));
  const float mag = __fadd_rn(__fadd_rn(cn, r), __fsqrt_rn(qn));
  const float margin = __fmul_rn(abs_, __fmul_rn(mag, mag));
  return __fmul_rn(lo, lo) >= __fadd_rn(__fmul_rn(tau, rel1), margin);
}

struct ScanArgs {
  const float* queries;   // (Q, d)
  const float* points;    // K13: (n, d) label-sorted rows
  const float* norms;     // K13: (n,) cached |x|^2
  const float* lut;       // K14: (Q, n_sub, n_codes)
  const float* qdots;     // K14: (Q, nlist)
  const uint8_t* codes;   // K14: (n, n_sub)
  const int* labels;      // K14: (n,)
  const float* u;         // K14: (n,) |x_hat|^2
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

template <bool kAdc>
__global__ void __launch_bounds__(kThreads) ivf_scan_kernel(ScanArgs a) {
  extern __shared__ float smem[];
  const int d = a.d, k = a.k, bn = a.block_n;
  float* qs = smem;                        // (d,) the query
  float* tv = qs + d;                      // (k,) carried D²
  int* ti = reinterpret_cast<int*>(tv + k);        // (k,) carried rows
  float* nv = reinterpret_cast<float*>(ti + k);    // (k,) merged D²
  int* ni = reinterpret_cast<int*>(nv + k);        // (k,) merged rows
  float* cv = reinterpret_cast<float*>(ni + k);    // (block_n,) candidates
  int* ci = reinterpret_cast<int*>(cv + bn);       // (block_n,)
  float* lut = reinterpret_cast<float*>(ci + bn);  // K14 (n_sub, n_codes)
  float* qd = lut + (kAdc ? a.n_sub * a.n_codes : 0);  // K14 (nlist,)
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
  if (kAdc) {
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
      if (kAdc) {
        const uint8_t* code = a.codes + (size_t)row * a.n_sub;
        float qr = lut[code[0]];
        for (int s = 1; s < a.n_sub; ++s)
          qr = __fadd_rn(qr, lut[s * a.n_codes + code[s]]);
        const float qc = qd[a.labels[row]];
        d2 = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, __fadd_rn(qr, qc))),
                       a.u[row]);
      } else {
        const float* x = a.points + (size_t)row * d;
        float dot = __fmul_rn(__ldg(x), qs[0]);
        for (int j = 1; j < d; ++j) dot = __fmaf_rn(__ldg(x + j), qs[j], dot);
        d2 = __fadd_rn(__fsub_rn(__ldg(a.norms + row), __fmul_rn(2.f, dot)),
                       qn);
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

size_t smem_bytes(const ScanArgs& a, bool adc) {
  size_t words = (size_t)a.d + 4 * (size_t)a.k + 2 * (size_t)a.block_n;
  if (adc) words += (size_t)a.n_sub * a.n_codes + a.nlist;
  return sizeof(float) * words;
}

template <bool kAdc>
int launch(const ScanArgs& a, int n_queries, void* stream) {
  if (n_queries == 0) return 0;
  const size_t smem = smem_bytes(a, kAdc);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        ivf_scan_kernel<kAdc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  ivf_scan_kernel<kAdc><<<n_queries, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches K13 on `stream`: one block per query. Returns cudaGetLastError().
extern "C" int ivf_scan_launch(const float* queries, const float* points,
                               const float* norms, const float* centers,
                               const float* radii, const int* ids,
                               const int* n_active, float* dists, int* rows,
                               int* skipped, int n_queries, int n, int d,
                               int n_tiles, int block_n, int k, int gate,
                               float rel1, float abs_, void* stream) {
  ScanArgs a{queries, points, norms,  nullptr, nullptr, nullptr, nullptr,
             nullptr, centers, radii, ids,     n_active, dists,  rows,
             skipped, n,       d,     n_tiles, block_n, k,       gate,
             0,       0,       0,     rel1,    abs_};
  return launch<false>(a, n_queries, stream);
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
  ScanArgs a{queries, nullptr, nullptr, lut,   qdots,    codes,   labels,
             u,       centers, radii,   ids,   n_active, dists,   rows,
             skipped, n,       d,       n_tiles, block_n, k,      gate,
             n_sub,   n_codes, nlist,   rel1,  abs_};
  return launch<true>(a, n_queries, stream);
}

// K2, K5, K7 and K8: one k-means++ seeding round on Hopper, ungated,
// bound-gated, and each over a batch of independent problems.
//
// K2 replaces src/repro/kernels/kmeans_distance.py::distance_min_update_pallas
// (the TPU kernel's pallas_call at line 125). It computes, for every row x
//   new_md[x] = min(md[x], min_c max(||x||^2 - 2 x.c + ||c||^2, 0))
// with the cached fp32 norm ||x||^2, and one partial sum of new_md per
// block_n-row tile (tail rows past n enter no partial). The partials are the
// tiles the two-level `tiled` sampler draws from, so their boundaries are
// exactly those of repro_torch.core.sampling.tile_partials.
//
// K5 replaces kmeans_distance.py::distance_min_update_gated_pallas (its
// pallas_call at line 250). It is K2 restricted to the tiles the seeding
// gate (repro_torch.core.bounds.seed_gate) marks active, plus the per-point
// prune (bounds.seed_point_prune): a row of an active tile with
//   max(dc_t - center_d[x], 0)^2 >= md[x] * (1 + 1e-6) + margin_t
// provably cannot improve, keeps its md and skips the distance arithmetic.
// It also writes each active tile's max of new_md (the next round's bound)
// and its count of pruned rows. The TPU kernel visited a compacted list of
// active tiles; here the full grid is launched and a block whose tile is
// inactive writes its carries (partial, tile max, a pruned count of 0, and
// its rows' md unless the output is the input, the TPU kernel's
// input_output_aliases) and exits. K5 has its own kernel (below); the
// template's gated instance, K5 before, stays reachable through
// distance_min_update_gated_template_launch (the outputs made copies of the
// carries by its caller, a skipped tile leaving them untouched), which the
// card tests and the smoke script hold K5 to, bit for bit.
//
// K7 replaces kmeans_distance.py::distance_min_update_batched_pallas (its
// pallas_call at line 486): K2 over B independent problems in one launch.
// The grid is B * n_tiles blocks along x (no 65,535 limit on the problem
// count), block i taking tile i % n_tiles of problem i / n_tiles; its
// pointers are offset by the problem's b*n*d points, b*n norms and D², b*m*d
// centroids and b*n_tiles partials, and then it runs K2's code unchanged, so
// row b of a K7 launch is bitwise K2 on problem b.
//
// K8 replaces kmeans_distance.py::distance_min_update_gated_batched_pallas
// (its pallas_call at line 587): K5 over B independent problems in one
// launch, each with its own gate. It is K7's grid on K5's code: block i
// takes tile i % n_tiles of problem i / n_tiles, and besides K7's pointers
// the gate's are offset too, center_d by b*n and dc, margin, the active
// mask, the carried and new partials and tile maxima and pruned by
// b*n_tiles. The TPU kernel visited each problem's compacted list of active
// tiles (a (B, n_tiles) id map and a (B,) count); here the full
// B * n_tiles grid is launched and reads the (B, n_tiles) mask. Row b of a
// K8 launch is K5 on problem b, bitwise.
//
// K7 and K8 also run over a list of the batch's problems (rejection
// seeding refreshes only the problems whose pending block has filled): the
// grid covers the listed problems' tiles, block i taking tile i % n_tiles of
// problem problems[i / n_tiles], and the rest is K7's or K8's code, so a
// listed problem's outputs are bitwise the full launch's. The listed forms
// write in place into the caller's carries (md, partials, tile maxima; the
// TPU kernels' aliasing), so a problem off the list is not touched and no
// listed problem's points are copied. In place, the template body's running
// minimum over centroid chunks folds the carried md in at every chunk (min
// is exact, so the bits are the separate output's).
//
// K2, K7 and the template entries are one template (distance_min_update_
// kernel); K5 and K8 are gated_round_kernel, whose every output is the
// template's gated instance's bits: an active tile's unpruned rows go
// through the same arithmetic in the same order, and a pruned row holds the
// value K2 would write (min(md, d2) = md when d2 >= md), so an all-active
// fp32 K5 is bitwise K2. K2 and K5 are the launches with B = 1. At
// d >= 8, K2 and K7 take K5's row loop ungated (every tile active, no
// prune, no tile max: the same bits; at d = 128, m = 8 30x faster than the
// template body, which at d = 2 stays faster); their template body at every
// width stays reachable through distance_min_update_template_launch.
//
// Each of the four also takes a bf16 point stream (the engine's
// precision="bf16", the TPU kernels' bf16 tiles into the MXU): the template
// is instantiated on the stream type T of `points` and `cents`, float or
// __nv_bfloat16. A bf16 value converts to float exactly, and every operation
// after the conversion is the fp32 instance's, in the same order: the cached
// norms, md, the partials and the gate stay fp32. So a bf16 launch is
// bitwise the fp32 launch on the points and centroids rounded to bf16 and
// widened back. Resident, the (m, d) centroid block is widened into the
// fp32 staging (the same shared memory as fp32's); non-resident, every read
// of a centroid converts. The stream halves only x's bytes: a K2 row at
// d = 2 moves 16 B instead of 20, a K7 row at the sweep's d = 16 44 B
// instead of 76, a K8 row 48 B instead of 80.
//
// What bounds them on the H100: bytes. At the paper's d = 2 a row moves 20 B
// (x 8, norm 4, md in 4, md out 4) and costs 2d + 3 flops per centroid, so
// one K2 round at n = 4M is 80 MB against 3.35 TB/s, about 24 us, and the
// arithmetic is far below the fp32 rate. K5 moves only the active tiles'
// rows (plus center_d, 4 B a row), and a pruned row needs no x or norm. At
// d = 2 there is no product to put on tensor cores, so fp32 FMA only. K7 at
// the PQ codebook sweep (B = 1664 problems of n = 16384, d = 16, m = 1)
// moves 76 B a row, 2.07 GB a round: 0.62 ms at 3.35 TB/s. K8 there, all
// tiles active, also reads center_d: 80 B a row, 2.18 GB, 0.65 ms; a pruned
// row reads no x or norm, so it moves 12 B.
//
// Design of the template. One thread block owns one tile and loops over its
// rows, 256 rows at a time, so reads of x, norms and md are coalesced and
// each is read once. Every thread keeps its own running sum in ascending
// row order, and the block reduces the 256 sums in a fixed tree: the
// partials are the same bits on every run. Resident = true stages the
// centroid block and its norms in shared memory (the paper's constant
// memory), in chunks of as many centroids as fit, ascending, a row's running
// minimum carried from chunk to chunk in md_out: one chunk where the whole
// (m, d) block fits, as before, and any m otherwise (the guard heal's fold
// of all k centroids); Resident = false reads the centroids from global
// memory on every use and recomputes their norms there (Fig. 2's
// global-memory variant). Both give the same bits. The prune test is
// written with explicit round-to-nearest operations, so it is the same four
// roundings as the plain PyTorch version's. min and max propagate NaN like
// torch.minimum / torch.maximum.
//
// K5 on the H100 (gated_round_kernel). What held the template back: the
// wrapper cloned md, the partials and tile maxima before every launch (32 MB
// for md alone at n = 4M); each thread walked its 16 rows one after another,
// each behind dependent loads; three shared-memory trees cost 8 barriers;
// and at d >= 8 each thread read its own row element by element, so a warp's
// load touched 32 rows' lines. The redesign, every output bitwise the
// template's (the thread that adds a row, the order it adds in, the trees'
// pairings, each row's ascending fmaf chain and the prune's roundings are
// all the template's):
//   - the kernel writes every output (a skipped tile its carries), so the
//     outputs are allocated empty and the mask is read as the bool tensor's
//     bytes; with md_out == md_in (the caller's in-place round) a skipped
//     tile and a pruned row write nothing;
//   - below d = 8 (the paper's d = 2) a thread issues the md and center_d
//     loads of six of its rows together (four at other d < 8), prunes,
//     then issues x (one 8-byte load at fp32 d = 2, one 4-byte bf16x2 at
//     bf16) and the norm of the rows it keeps together, and folds those
//     rows' centroids in registers, the carried md waiting in shared
//     memory (at d = 2 four blocks an SM fit its 64 registers);
//   - at d >= 8, rows of at most 128 bytes in whole 16-byte vectors (the
//     codebook sweep's d = 16) are loaded by their thread as 16-byte vectors
//     after the batch's md, center_d and norm loads, a kept row at a time;
//   - wider rows (the IVF build's d = 128) take two passes. Pass 1
//     (wide_rows_kernel) gives each 512-row segment of a tile its own block,
//     so a few tiles still fill the card: the rows the prune keeps are listed
//     in shared memory in row order, staged kB at a time by 16-byte cp.async
//     copies (coalesced; three stages in flight) at a padded stride, so that
//     a quarter-warp's 16-byte reads of 8 rows hit distinct banks (rows
//     too wide for 32 a stage, fp32 d above about 590, are read by their
//     thread from device memory instead: measured faster than staging
//     fewer), and each listed row's D² (the same ascending chain, read as
//     16-byte vectors) goes to md_out; pass 2 (wide_tile_kernel) reads each
//     tile's new md
//     back, thread tid its rows tid, tid + 256, ..., and reduces them in the
//     template's order (4 bytes a row against the row's 512). With m <= 8
//     centroids a round this is a matrix-vector product bounded by bytes:
//     tensor cores add nothing here (their rate bounds nothing a round
//     does);
//   - the sum, max and count trees read their top three levels from shared
//     memory in warp 0 and do the last five by __shfl_down_sync at 16 .. 1,
//     the same pairs as red[tid] op= red[tid + s]: one barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kRelScale = 1.0f + 1e-6f;  // 1 + bounds._REL in fp32
constexpr int kSmem = 232448;  // shared memory one Hopper block can use

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// a stream value as fp32 (exact for bf16)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename C>
__device__ __forceinline__ float sq_norm(const C* c, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = widen(c[j]);
    s = fmaf(v, v, s);
  }
  return s;
}

template <typename X, typename C>
__device__ __forceinline__ float dot(const X* x, const C* c, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(widen(x[j]), widen(c[j]), s);
  return s;
}

// the round's D² from a row's dot product with a centroid (every kernel's
// expression: one rounding of xn - 2 dt, exact since 2 dt is, then + cn)
__device__ __forceinline__ float round_d2(float xn, float dt, float cn) {
  return nan_max(xn - 2.f * dt + cn, 0.f);
}

// bounds.seed_point_prune for one row
__device__ __forceinline__ bool seed_point_prune(float md, float cd, float dc,
                                                 float margin) {
  const float lo = fmaxf(__fsub_rn(dc, cd), 0.f);
  return __fmul_rn(lo, lo) >= __fadd_rn(__fmul_rn(md, kRelScale), margin);
}

// Centroids c0 .. c0 + nc - 1 widened into c_sh (nc, d) and their norms
// (sq_norm, the non-resident arithmetic) into cn_sh, then a barrier.
template <typename T>
__device__ __forceinline__ void stage_centroids(const T* __restrict__ cents,
                                                float* c_sh, float* cn_sh,
                                                int c0, int nc, int d) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nc * d; i += kThreads)
    c_sh[i] = widen(cents[(size_t)c0 * d + i]);
  __syncthreads();
  for (int c = tid; c < nc; c += kThreads)
    cn_sh[c] = sq_norm(c_sh + (size_t)c * d, d);
  __syncthreads();
}

// Gated = false is K2 / K7 (the gate pointers are null); Gated = true is the
// template entry (K5 before gated_round_kernel). T is the stream type of
// points and cents (float or bf16). Resident stages mc centroids at a time
// (mc >= m: all, once); a row's running minimum over a chunk that is not the
// last waits in md_out.
template <typename T, bool Resident, bool Gated>
__global__ void __launch_bounds__(kThreads)
distance_min_update_kernel(const T* __restrict__ points,
                           const float* __restrict__ norms,
                           const T* __restrict__ cents,
                           const float* __restrict__ md_in,
                           float* __restrict__ md_out,
                           float* __restrict__ partials,
                           const float* __restrict__ center_d,
                           const float* __restrict__ dc,
                           const float* __restrict__ margin,
                           const unsigned char* __restrict__ active,
                           float* __restrict__ tile_max,
                           int* __restrict__ pruned,
                           const int* __restrict__ problems,
                           int n, int d, int m, int block_n, int mc) {
  // problem b (the list's r-th where there is a list), tile t of it; its
  // arrays are offset to problem b
  const int n_tiles = (n + block_n - 1) / block_n;
  const int r = blockIdx.x / n_tiles;
  const int b = problems ? problems[r] : r;
  const int t = blockIdx.x - r * n_tiles;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * m * d;
  md_in += (size_t)b * n;
  md_out += (size_t)b * n;
  partials += (size_t)b * n_tiles;
  if (Gated) {
    center_d += (size_t)b * n;
    dc += (size_t)b * n_tiles;
    margin += (size_t)b * n_tiles;
    active += (size_t)b * n_tiles;
    tile_max += (size_t)b * n_tiles;
    pruned += (size_t)b * n_tiles;
    if (!active[t]) return;  // skipped: outputs keep carries
  }
  extern __shared__ float smem[];
  float* red = smem;                        // (kThreads,) sum tree
  float* red_max = red + kThreads;          // (kThreads,) max tree (K5)
  int* red_cnt = reinterpret_cast<int*>(red_max + kThreads);  // (kThreads,)
  float* c_sh = smem + (Gated ? 3 : 1) * kThreads;  // (mc, d) staged chunk
  float* cn_sh = c_sh + (size_t)mc * d;    // (mc,) their norms
  const int tid = threadIdx.x;

  const long long tile0 = (long long)t * block_n;
  const float dc_t = Gated ? dc[t] : 0.f;
  const float margin_t = Gated ? margin[t] : 0.f;
  float local = 0.f;
  float lmax = 0.f;
  int lcnt = 0;
  for (int c0 = 0; c0 < m; c0 += mc) {
    const int nc = min(mc, m - c0);
    const bool last = c0 + nc >= m;
    if (Resident) {
      if (c0 > 0) __syncthreads();   // the last chunk's reads are done
      stage_centroids(cents, c_sh, cn_sh, c0, nc, d);
    }
    for (int r = tid; r < block_n; r += kThreads) {
      const long long row = tile0 + r;
      if (row >= n) break;
      const float md = md_in[row];
      float v;
      if (Gated && seed_point_prune(md, center_d[row], dc_t, margin_t)) {
        if (!last) continue;
        v = md;
        ++lcnt;
      } else {
        const T* x = points + row * d;
        const float xn = norms[row];
        float best = c0 == 0 ? CUDART_INF_F : md_out[row];
        for (int c = 0; c < nc; ++c) {
          float d2;
          if (Resident) {
            const float* cc = c_sh + (size_t)c * d;
            d2 = round_d2(xn, dot(x, cc, d), cn_sh[c]);
          } else {
            const T* cc = cents + (size_t)(c0 + c) * d;
            d2 = round_d2(xn, dot(x, cc, d), sq_norm(cc, d));
          }
          best = nan_min(best, d2);
        }
        if (!last) {
          // in place, the carried md is folded in: a later chunk may read
          // either this value or the one it replaced, and gets the bits
          // the separate output gives
          md_out[row] = md_out == md_in ? nan_min(md, best) : best;
          continue;
        }
        v = nan_min(md, best);
      }
      md_out[row] = v;
      local += v;
      if (Gated) lmax = nan_max(lmax, v);
    }
  }

  red[tid] = local;
  if (Gated) {
    red_max[tid] = lmax;
    red_cnt[tid] = lcnt;
  }
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      if (Gated) {
        red_max[tid] = nan_max(red_max[tid], red_max[tid + s]);
        red_cnt[tid] += red_cnt[tid + s];
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    partials[t] = red[0];
    if (Gated) {
      tile_max[t] = red_max[0];
      pruned[t] = red_cnt[0];
    }
  }
}

// the template's centroids a chunk: all m where the block and the trees
// fit the block's shared memory, else the most that do
inline int template_chunk(int d, int m, bool gated) {
  const int room = kSmem / 4 - (gated ? 3 : 1) * kThreads;
  return m < room / (d + 1) ? m : room / (d + 1);
}

template <typename T, bool Gated>
int launch(const T* points, const float* norms, const T* cents,
           const float* md_in, float* md_out, float* partials,
           const float* center_d, const float* dc, const float* margin,
           const unsigned char* active, float* tile_max, int* pruned, int batch,
           int n, int d, int m, int block_n, int resident,
           const int* problems, cudaStream_t s) {
  const long long blocks = (long long)batch * ((n + block_n - 1) / block_n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)blocks;
  const int mc = resident ? template_chunk(d, m, Gated) : m;
  if (mc < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((Gated ? 3 : 1) * kThreads +
                                       (resident ? (size_t)mc * (d + 1) : 0));
  if (resident) {
    auto kern = distance_min_update_kernel<T, true, Gated>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, s>>>(points, norms, cents, md_in, md_out,
                                      partials, center_d, dc, margin, active,
                                      tile_max, pruned, problems, n, d, m,
                                      block_n, mc);
  } else {
    distance_min_update_kernel<T, false, Gated><<<grid, kThreads, smem, s>>>(
        points, norms, cents, md_in, md_out, partials, center_d, dc, margin,
        active, tile_max, pruned, problems, n, d, m, block_n, mc);
  }
  return (int)cudaGetLastError();
}

// The stream type is the caller's: bf16 != 0 reads points and cents as
// __nv_bfloat16, else as float.
template <bool Gated>
int dispatch(const void* points, const float* norms, const void* cents,
             const float* md_in, float* md_out, float* partials,
             const float* center_d, const float* dc, const float* margin,
             const unsigned char* active, float* tile_max, int* pruned,
             int batch, int n, int d, int m, int block_n, int resident,
             int bf16, void* stream, const int* problems = nullptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, Gated>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), md_in, md_out, partials,
        center_d, dc, margin, active, tile_max, pruned, batch, n, d, m,
        block_n, resident, problems, s);
  return launch<float, Gated>(
      static_cast<const float*>(points), norms,
      static_cast<const float*>(cents), md_in, md_out, partials, center_d, dc,
      margin, active, tile_max, pruned, batch, n, d, m, block_n, resident,
      problems, s);
}

// ---------------------------------------------------------------------------
// K5 and K8: gated_round_kernel (see the header)

// the rows a thread loads together below d = 8
constexpr int kU = 8;
// the wide path (wide_rows_kernel): a block's segment of its tile, the rows
// it lists and stages, so that a tile spreads over several SMs
constexpr int kSeg = 512;
constexpr int kSegU = kSeg / kThreads;
// the wide path's row stages in flight
constexpr int kStages = 3;
// the wide path's centroid staging: at most this many floats a chunk
constexpr int kWideCents = 8192;
// the wide path's shared memory where two blocks share an SM
constexpr size_t kWideHalf = 110 * 1024;

// The row loops of gated_round_kernel: kRegs2 (d = 2: the row in registers
// from one vector load), kRegs (d < 8: the row in registers, value by
// value), kVec4 and kVec8 (d >= 8, rows of at most 64 or 128 bytes in whole
// 16-byte vectors: a kept row's vectors loaded together into registers).
// Every other row at d >= 8 takes the wide path, kWide (wide_rows_kernel,
// then wide_tile_kernel).
enum Path { kRegs2 = 0, kRegs = 1, kVec4 = 2, kVec8 = 3, kWide = 4 };
constexpr int kNarrow = 7;   // the widest row kRegs holds

// the blocks an SM each path's registers are sized for
constexpr int path_blocks(int p) {
  return p == kRegs2 ? 4 : p == kVec4 ? 3 : 2;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The tile's partial (sum), tile max and pruned count from every thread's
// share, in the template's tree pairings (red[tid] op= red[tid + s], the
// lower index first, s = 128 .. 1): warp 0 reads the levels s = 128, 64, 32
// from shared memory and takes s = 16 .. 1 by __shfl_down_sync. One barrier.
// A null `pruned` is not written (the wide path counts with atomics).
__device__ __forceinline__ void reduce_tile(float* red, float local,
                                            float lmax, int lcnt,
                                            float* partial, float* tmax,
                                            int* pruned) {
  const int tid = threadIdx.x, lane = tid & 31;
  float* rs = red;
  float* rm = red + kThreads;
  int* rc = reinterpret_cast<int*>(rm + kThreads);
  rs[tid] = local;
  rm[tid] = lmax;
  rc[tid] = lcnt;
  __syncthreads();
  if (tid >= 32) return;
  // a_i = op(v_i, v_{i+128}), then b_i = op(a_i, a_{i+64}), then
  // c_l = op(b_l, b_{l+32})
  const float s = (((rs[lane] + rs[lane + 128]) +
                    (rs[lane + 64] + rs[lane + 192])) +
                   ((rs[lane + 32] + rs[lane + 160]) +
                    (rs[lane + 96] + rs[lane + 224])));
  const float mx = nan_max(nan_max(nan_max(rm[lane], rm[lane + 128]),
                                   nan_max(rm[lane + 64], rm[lane + 192])),
                           nan_max(nan_max(rm[lane + 32], rm[lane + 160]),
                                   nan_max(rm[lane + 96], rm[lane + 224])));
  const int c = (((rc[lane] + rc[lane + 128]) +
                  (rc[lane + 64] + rc[lane + 192])) +
                 ((rc[lane + 32] + rc[lane + 160]) +
                  (rc[lane + 96] + rc[lane + 224])));
  float sv = s, mv = mx;
  int cv = c;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sv = sv + __shfl_down_sync(kFull, sv, o);
    mv = nan_max(mv, __shfl_down_sync(kFull, mv, o));
    cv = cv + __shfl_down_sync(kFull, cv, o);
  }
  if (lane == 0) {
    *partial = sv;
    if (tmax != nullptr) *tmax = mv;
    if (pruned != nullptr) *pruned = cv;
  }
}

// A skipped tile's (or segment's) carried md rows [0, rows) from src into
// dst by the block: 16-byte vectors where both are aligned, four a thread
// loaded before any is stored (src and dst may not overlap).
__device__ __forceinline__ void copy_md_rows(const float* src, float* dst,
                                             int rows) {
  const int tid = threadIdx.x;
  int r0 = 0;
  if (((reinterpret_cast<uintptr_t>(src) |
        reinterpret_cast<uintptr_t>(dst)) & 15) == 0) {
    const int nq = rows / 4;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q0 = 0; q0 < nq; q0 += 4 * kThreads) {
      float4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i * kThreads + tid;
        if (q < nq) v[i] = s4[q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i * kThreads + tid;
        if (q < nq) d4[q] = v[i];
      }
    }
    r0 = nq * 4;
  }
  for (int r = r0 + tid; r < rows; r += kThreads) dst[r] = src[r];
}

// A row's dot product with a staged (fp32) or global centroid c, the
// ascending fmaf chain from 0 over the row's first d values held in x[DX].
template <int DX, typename C>
__device__ __forceinline__ float dot_regs(const float (&x)[DX],
                                          const C* __restrict__ c, int d) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < DX; ++j)
    if (j < d) s = fmaf(x[j], widen(c[j]), s);
  return s;
}

// A row held as nv (<= NV) 16-byte vectors of the stream type, dotted with
// centroid c (staged fp32 or the stream's): the ascending fmaf chain from 0.
template <typename T, int NV, typename C>
__device__ __forceinline__ float dot_vec(const uint4 (&xv)[NV], int nv,
                                         const C* __restrict__ c) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (v >= nv) break;
    const unsigned h[4] = {xv[v].x, xv[v].y, xv[v].z, xv[v].w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s = fmaf(__uint_as_float(h[e]), widen(c[4 * v + e]), s);
    } else {   // a bf16 value widens as its bits << 16
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s = fmaf(__uint_as_float(h[e] << 16), widen(c[8 * v + 2 * e]), s);
        s = fmaf(__uint_as_float(h[e] & 0xffff0000u),
                 widen(c[8 * v + 2 * e + 1]), s);
      }
    }
  }
  return s;
}

// Batch i of a segment's listed rows (list[i * kB ..], at most kB) into
// stage i % kStages at `stride` bytes a row: 16-byte cp.async copies where
// `vec`, else value by value (then visible after the caller's barrier).
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ seg_x,
                                           const int* list, int i, int nb,
                                           int total, int kB, int stride,
                                           int d, bool vec,
                                           unsigned char* stage,
                                           uint32_t stage_s) {
  if (i >= nb) return;
  const int tid = threadIdx.x;
  const int rn = min(kB, total - i * kB);
  const size_t at = (size_t)(i % kStages) * kB * stride;
  if (vec) {
    const int cpr = d * (int)sizeof(T) / 16;
    for (int e = tid; e < rn * cpr; e += kThreads) {
      const int q = e / cpr, h = e - q * cpr;
      cp_async16(stage_s + (uint32_t)(at + (size_t)q * stride + 16 * h),
                 reinterpret_cast<const unsigned char*>(
                     seg_x + (size_t)list[i * kB + q] * d) + 16 * h);
    }
  } else {
    for (int e = tid; e < rn * d; e += kThreads) {
      const int q = e / d, j = e - q * d;
      reinterpret_cast<T*>(stage + at + (size_t)q * stride)[j] =
          seg_x[(size_t)list[i * kB + q] * d + j];
    }
  }
}

// A staged row's dot product with a staged centroid: the same chain, the
// row (in shared or device memory) read as 16-byte vectors where `vec`
// (d * bytes a multiple of 16), else value by value.
template <typename T>
__device__ __forceinline__ float dot_staged(const unsigned char* xs,
                                            const float* cc, int d,
                                            bool vec) {
  float s = 0.f;
  if (vec) {
    const uint4* x4 = reinterpret_cast<const uint4*>(xs);
    constexpr int kPer = 16 / sizeof(T);
    for (int q = 0; q < d / kPer; ++q) {
      const uint4 w = x4[q];
      const float* c = cc + q * kPer;
      if constexpr (sizeof(T) == 4) {
        s = fmaf(__uint_as_float(w.x), c[0], s);
        s = fmaf(__uint_as_float(w.y), c[1], s);
        s = fmaf(__uint_as_float(w.z), c[2], s);
        s = fmaf(__uint_as_float(w.w), c[3], s);
      } else {   // a bf16 value widens as its bits << 16
        const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s = fmaf(__uint_as_float(h[e] << 16), c[2 * e], s);
          s = fmaf(__uint_as_float(h[e] & 0xffff0000u), c[2 * e + 1], s);
        }
      }
    }
    return s;
  }
  const T* x = reinterpret_cast<const T*>(xs);
  for (int j = 0; j < d; ++j) s = fmaf(widen(x[j]), cc[j], s);
  return s;
}

// K5 (batch 1) and K8 on the register paths (P: kRegs2, kRegs, kVec4,
// kVec8): one gated seeding round, every output written. The
// arguments are the template's, plus the carried partials and tile maxima
// (prev_*) a skipped tile copies; md_out may be md_in (then a skipped tile
// and a pruned row write nothing). mc: the centroids staged a chunk where
// Resident (all m, once, where mc >= m). !Gated is K2 / K7 at d >= 8: every
// tile active, no row pruned, only md_out and partials written (the gate's
// pointers null).
template <typename T, bool Resident, int P, bool Gated>
__global__ void __launch_bounds__(kThreads, path_blocks(P))
gated_round_kernel(const T* __restrict__ points,
                   const float* __restrict__ norms,
                   const T* __restrict__ cents, const float* md_in,
                   float* md_out, float* partials,
                   const float* __restrict__ center_d,
                   const float* __restrict__ dc,
                   const float* __restrict__ margin,
                   const unsigned char* __restrict__ active,
                   const float* prev_partials, const float* prev_tile_max,
                   float* tile_max, int* __restrict__ pruned,
                   const int* __restrict__ problems,
                   int n, int d, int m, int block_n, int mc) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const int r = blockIdx.x / n_tiles;
  const int b = problems ? problems[r] : r;
  const int t = blockIdx.x - r * n_tiles;
  const size_t tb = (size_t)b * n_tiles + t;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * m * d;
  md_in += (size_t)b * n;
  md_out += (size_t)b * n;
  if (Gated) center_d += (size_t)b * n;
  const int tid = threadIdx.x;
  const long long tile0 = (long long)t * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  const bool inplace = md_out == md_in;
  if (Gated && !active[tb]) {   // skipped: the carries
    if (!inplace) copy_md_rows(md_in + tile0, md_out + tile0, rows);
    if (tid == 0) {
      partials[tb] = prev_partials[tb];
      tile_max[tb] = prev_tile_max[tb];
      pruned[tb] = 0;
    }
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                              // (3, kThreads) trees
  float* md_sh = red + 3 * kThreads;              // (kU, kThreads) carried md
  float* c_sh = md_sh + kU * kThreads;            // (mc, d) staged chunk
  float* cn_sh = c_sh + (Resident ? (size_t)mc * d : 0);  // (mc,) norms
  const float dc_t = Gated ? dc[tb] : 0.f, margin_t = Gated ? margin[tb] : 0.f;
  float local = 0.f, lmax = 0.f;
  int lcnt = 0;
  const bool once = !Resident || mc >= m;
  if (Resident && once) stage_centroids(cents, c_sh, cn_sh, 0, m, d);

  {
    constexpr int DX = P == kRegs2 ? 2 : P == kRegs ? kNarrow : 1;
    constexpr bool kV = P == kVec4 || P == kVec8;
    constexpr int NV = P == kVec8 ? 8 : 4;       // a kVec row's vectors
    const int nv = kV ? d * (int)sizeof(T) / 16 : 0;
    // rows loaded together: at d = 2, six (eight spill at four blocks' 64
    // registers; six measured faster than four and eight at three blocks)
    constexpr int U = P == kRegs2 ? 6 : kV ? kU : kU / 2;
    for (int base = 0; base < block_n; base += U * kThreads) {
      float mdv[U], cdv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {   // every md and center_d load first
        const int r = base + u * kThreads + tid;
        const bool ok = r < rows;
        mdv[u] = ok ? md_in[tile0 + r] : 0.f;
        cdv[u] = ok && Gated ? center_d[tile0 + r] : 0.f;
      }
      unsigned keep = 0;   // bit u: row u is not pruned
      float x[U][DX], xn[U], best[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {   // the prune, then the kept rows' loads
        const int r = base + u * kThreads + tid;
        const bool k1 = r < rows &&
                        !(Gated &&
                          seed_point_prune(mdv[u], cdv[u], dc_t, margin_t));
        keep |= (unsigned)k1 << u;
        md_sh[u * kThreads + tid] = mdv[u];   // read back after the fold
        const long long row = tile0 + r;
        if constexpr (P == kRegs2) {
          x[u][0] = x[u][1] = 0.f;
          if (k1) {
            if constexpr (sizeof(T) == 4) {
              const float2 v =
                  reinterpret_cast<const float2*>(points)[row];
              x[u][0] = v.x;
              x[u][1] = v.y;
            } else {
              const unsigned v =
                  reinterpret_cast<const unsigned*>(points)[row];
              x[u][0] = __uint_as_float(v << 16);
              x[u][1] = __uint_as_float(v & 0xffff0000u);
            }
          }
        } else if constexpr (P == kRegs) {
#pragma unroll
          for (int j = 0; j < DX; ++j)
            x[u][j] = k1 && j < d ? widen(points[row * d + j]) : 0.f;
        }
        xn[u] = k1 ? norms[row] : 0.f;
        best[u] = CUDART_INF_F;
      }
      for (int c0 = 0; c0 < m; c0 += mc) {
        const int nc = min(mc, m - c0);
        if (!once) {
          __syncthreads();   // the last chunk's reads are done
          stage_centroids(cents, c_sh, cn_sh, c0, nc, d);
        }
        if constexpr (kV) {   // a kept row at a time, its vectors together
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!((keep >> u) & 1u)) continue;
            const uint4* xr = reinterpret_cast<const uint4*>(
                points + (tile0 + base + u * kThreads + tid) * d);
            uint4 xv[NV];
#pragma unroll
            for (int v = 0; v < NV; ++v)
              if (v < nv) xv[v] = xr[v];
            for (int c = 0; c < nc; ++c) {
              const float* cs = c_sh + (size_t)c * d;
              const T* cg = cents + (size_t)(c0 + c) * d;
              const float dt = Resident ? dot_vec<T>(xv, nv, cs)
                                        : dot_vec<T>(xv, nv, cg);
              best[u] = nan_min(best[u], round_d2(
                  xn[u], dt, Resident ? cn_sh[c] : sq_norm(cg, d)));
            }
          }
          continue;
        }
        for (int c = 0; c < nc; ++c) {
          // centroid c0 + c: staged (fp32) or read from device memory
          const float* cs = c_sh + (size_t)c * d;
          const T* cg = cents + (size_t)(c0 + c) * d;
          const float cn = Resident ? cn_sh[c] : sq_norm(cg, d);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (!((keep >> u) & 1u)) continue;
            const float dt = Resident ? dot_regs<DX>(x[u], cs, d)
                                      : dot_regs<DX>(x[u], cg, d);
            best[u] = nan_min(best[u], round_d2(xn[u], dt, cn));
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {   // in the template's row order
        const int r = base + u * kThreads + tid;
        if (r >= rows) continue;
        const bool k1 = (keep >> u) & 1u;
        const float md = md_sh[u * kThreads + tid];
        const float v = k1 ? nan_min(md, best[u]) : md;
        if (k1 || !inplace) md_out[tile0 + r] = v;
        local += v;
        lmax = nan_max(lmax, v);
        lcnt += k1 ? 0 : 1;
      }
    }
  }
  reduce_tile(red, local, lmax, lcnt, partials + tb,
              Gated ? tile_max + tb : nullptr, Gated ? pruned + tb : nullptr);
}

// The wide path, pass 1 (K5 and K8 at d >= 8 where gated_round_kernel's
// register paths do not take the row): block i takes segment i % segs of
// tile i / segs (kSeg rows; tile i / segs counts problem by problem, as the
// other kernels' blocks do), so a tile spreads over several SMs. A skipped
// tile's segment copies its md rows (unless in place). Otherwise the
// segment's rows are pruned, the kept ones listed in shared memory in row
// order, staged kB at a time by 16-byte cp.async copies (three stages in
// flight) at `stride` bytes a row (an odd count of 16-byte units, so a
// quarter-warp's 16-byte reads of 8 rows hit distinct banks; !Staged: no
// stage, kB = kThreads rows a batch read from device memory), and each
// listed row's D² formed from the stage by one thread: the template's
// ascending chain, its centroids' running minimum carried over chunks in
// shared memory. Every row's new md goes to md_out (a pruned row's only
// where not in place), and the segment's pruned rows are added into
// pruned[tile] (zeroed by the launch) with one integer atomic. Pass 2
// (wide_tile_kernel) then adds each tile's rows in the template's order.
// !Gated: K2 / K7 (every tile active, no row pruned, the gate's pointers
// null).
template <typename T, bool Resident, bool Staged, bool Gated>
__global__ void __launch_bounds__(kThreads, 2)
wide_rows_kernel(const T* __restrict__ points,
                 const float* __restrict__ norms,
                 const T* __restrict__ cents, const float* md_in,
                 float* md_out, const float* __restrict__ center_d,
                 const float* __restrict__ dc,
                 const float* __restrict__ margin,
                 const unsigned char* __restrict__ active,
                 int* __restrict__ pruned,
                 const int* __restrict__ problems, int n, int d, int m,
                 int block_n, int mc, int kB, int stride) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const int segs = (block_n + kSeg - 1) / kSeg;
  const int tg = blockIdx.x / segs;              // r * n_tiles + t
  const int seg0 = (blockIdx.x - tg * segs) * kSeg;
  const int r = tg / n_tiles;
  const int b = problems ? problems[r] : r;
  const int t = tg - r * n_tiles;
  const int tb = b * n_tiles + t;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * m * d;
  md_in += (size_t)b * n;
  md_out += (size_t)b * n;
  if (Gated) center_d += (size_t)b * n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const long long tile0 = (long long)t * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  if (seg0 >= rows) return;
  const bool inplace = md_out == md_in;
  if (Gated && !active[tb]) {   // skipped: the segment's md rows
    if (!inplace)
      copy_md_rows(md_in + tile0 + seg0, md_out + tile0 + seg0,
                   min(kSeg, rows - seg0));
    return;
  }
  extern __shared__ __align__(16) float smem[];
  float* c_sh = smem;                                     // (mc, d)
  float* cn_sh = c_sh + (Resident ? (size_t)mc * d : 0);  // (mc,)
  float* vals = cn_sh + (Resident ? mc : 0);              // (kSeg,)
  int* list = reinterpret_cast<int*>(vals + kSeg);        // (kSeg,)
  int* cnt_sh = list + kSeg;              // (kSegU * kWarps,), total, pruned
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(cnt_sh + kSegU * kWarps + 2) + 15) &
      ~uintptr_t(15));                    // (kStages, kB, stride)
  const uint32_t stage_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(stage));
  const bool vec = d * sizeof(T) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(points) % 16 == 0;
  const bool once = !Resident || mc >= m;
  if (tid == 0) cnt_sh[kSegU * kWarps + 1] = 0;
  if (Resident && once) stage_centroids(cents, c_sh, cn_sh, 0, m, d);
  const float dc_t = Gated ? dc[tb] : 0.f, margin_t = Gated ? margin[tb] : 0.f;
  float mdv[kSegU], cdv[kSegU];
#pragma unroll
  for (int u = 0; u < kSegU; ++u) {
    const int r = seg0 + u * kThreads + tid;
    const bool ok = r < rows;
    mdv[u] = ok ? md_in[tile0 + r] : 0.f;
    cdv[u] = ok && Gated ? center_d[tile0 + r] : 0.f;
  }
  unsigned keep = 0;
  int npruned = 0;
#pragma unroll
  for (int u = 0; u < kSegU; ++u) {
    const int r = seg0 + u * kThreads + tid;
    const bool k1 = r < rows &&
                    !(Gated &&
                      seed_point_prune(mdv[u], cdv[u], dc_t, margin_t));
    keep |= (unsigned)k1 << u;
    npruned += r < rows && !k1 ? 1 : 0;
    const unsigned bal = __ballot_sync(kFull, k1);
    if (lane == 0) cnt_sh[u * kWarps + warp] = __popc(bal);
  }
  for (int o = 16; o > 0; o >>= 1)
    npruned += __shfl_down_sync(kFull, npruned, o);
  __syncthreads();
  if (lane == 0 && npruned) atomicAdd(&cnt_sh[kSegU * kWarps + 1], npruned);
  if (warp == 0) {   // exclusive scan of the counts in row order
    const int a0 = lane < kSegU * kWarps ? cnt_sh[lane] : 0;
    int inc = a0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    __syncwarp();
    if (lane < kSegU * kWarps) cnt_sh[lane] = inc - a0;
    if (lane == 31) cnt_sh[kSegU * kWarps] = inc;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kSegU; ++u) {
    const bool k1 = (keep >> u) & 1u;
    const unsigned bal = __ballot_sync(kFull, k1);
    if (k1)
      list[cnt_sh[u * kWarps + warp] + __popc(bal & ((1u << lane) - 1u))] =
          u * kThreads + tid;
  }
  const int total = cnt_sh[kSegU * kWarps];
  if (Gated && tid == 0 && cnt_sh[kSegU * kWarps + 1])
    atomicAdd(&pruned[tb], cnt_sh[kSegU * kWarps + 1]);
  __syncthreads();
  const int nb = (total + kB - 1) / kB;
  const T* seg_x = points + (tile0 + seg0) * d;
  for (int c0 = 0; c0 < m; c0 += mc) {
    const int nc = min(mc, m - c0);
    if (!once) {
      __syncthreads();
      stage_centroids(cents, c_sh, cn_sh, c0, nc, d);
    }
    if constexpr (Staged) {
#pragma unroll
      for (int i = 0; i < kStages - 1; ++i) {
        stage_rows(seg_x, list, i, nb, total, kB, stride, d, vec, stage,
                   stage_s);
        cp_async_commit();
      }
    }
    for (int i = 0; i < nb; ++i) {
      if constexpr (Staged) {
        stage_rows(seg_x, list, i + kStages - 1, nb, total, kB, stride, d,
                   vec, stage, stage_s);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();
      }
      if (tid < min(kB, total - i * kB)) {
        const int r = list[i * kB + tid];
        const unsigned char* xs =
            Staged ? stage + (size_t)(i % kStages) * kB * stride
                         + (size_t)tid * stride
                   : reinterpret_cast<const unsigned char*>(seg_x
                                                            + (size_t)r * d);
        const float xn = norms[tile0 + seg0 + r];
        float best = c0 == 0 ? CUDART_INF_F : vals[r];
        for (int c = 0; c < nc; ++c) {
          float dt, cn;
          if (Resident) {
            dt = dot_staged<T>(xs, c_sh + (size_t)c * d, d, vec);
            cn = cn_sh[c];
          } else {
            const T* cg = cents + (size_t)(c0 + c) * d;
            dt = dot(reinterpret_cast<const T*>(xs), cg, d);
            cn = sq_norm(cg, d);
          }
          best = nan_min(best, round_d2(xn, dt, cn));
        }
        vals[r] = best;
      }
      __syncthreads();   // the stage is free for batch i + kStages
    }
    if constexpr (Staged) cp_async_wait<0>();
  }
#pragma unroll
  for (int u = 0; u < kSegU; ++u) {
    const int r = seg0 + u * kThreads + tid;
    if (r >= rows) continue;
    const bool k1 = (keep >> u) & 1u;
    if (k1)
      md_out[tile0 + r] = nan_min(mdv[u], vals[u * kThreads + tid]);
    else if (!inplace)
      md_out[tile0 + r] = mdv[u];
  }
}

// The wide path, pass 2: one block a tile. A skipped tile writes its carried
// partial and tile max (its pruned count stays the launch's 0); an active
// one reads its rows' new md in the template's order (thread tid: rows tid,
// tid + 256, ..., kU loads in flight) and reduces the sum and max as
// gated_round_kernel does (!Gated: K2 / K7, every tile active, no tile
// max).
template <bool Gated>
__global__ void __launch_bounds__(kThreads)
wide_tile_kernel(const float* __restrict__ md_out,
                 const unsigned char* __restrict__ active,
                 const float* prev_partials, const float* prev_tile_max,
                 float* partials, float* tile_max,
                 const int* __restrict__ problems, int n, int block_n) {
  __shared__ float red[3 * kThreads];
  const int n_tiles = (n + block_n - 1) / block_n;
  const int r = blockIdx.x / n_tiles;
  const int b = problems ? problems[r] : r;
  const int t = blockIdx.x - r * n_tiles;
  const int tb = b * n_tiles + t;
  const int tid = threadIdx.x;
  if (Gated && !active[tb]) {
    if (tid == 0) {
      partials[tb] = prev_partials[tb];
      tile_max[tb] = prev_tile_max[tb];
    }
    return;
  }
  const long long tile0 = (long long)t * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  const float* v = md_out + (size_t)b * n + tile0;
  float local = 0.f, lmax = 0.f;
  for (int base = 0; base < block_n; base += kU * kThreads) {
    float w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = base + u * kThreads + tid;
      w[u] = r < rows ? v[r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (base + u * kThreads + tid >= rows) continue;
      local += w[u];
      lmax = nan_max(lmax, w[u]);
    }
  }
  reduce_tile(red, local, lmax, 0, partials + tb,
              Gated ? tile_max + tb : nullptr, nullptr);
}

// K5 / K8's launch: the path by width, the chunk and the wide stages; with
// a null mask, K2 / K7's (ungated: d >= 8 only, the template below).
template <typename T>
int launch_gated(const T* points, const float* norms, const T* cents,
                 const float* md_in, float* md_out, float* partials,
                 const float* center_d, const float* dc, const float* margin,
                 const unsigned char* active, const float* prev_partials,
                 const float* prev_tile_max, float* tile_max, int* pruned,
                 int batch, int n, int d, int m, int block_n, int resident,
                 const int* problems, cudaStream_t s) {
  // a list: `batch` counts the listed problems, and pruned comes zeroed
  const long long blocks = (long long)batch * ((n + block_n - 1) / block_n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // d = 2 reads a row as one 8-byte (bf16: 4-byte) load where aligned;
  // rows of whole 16-byte vectors, at most 128 bytes, read as vectors
  const bool pair = reinterpret_cast<uintptr_t>(points) % (2 * sizeof(T))
                    == 0;
  const size_t rb = (size_t)d * sizeof(T);
  const bool vec = rb % 16 == 0 && reinterpret_cast<uintptr_t>(points) % 16
                                    == 0;
  const int path = d == 2 && pair ? kRegs2
                   : d <= kNarrow  ? kRegs
                   : vec && rb <= 64 ? kVec4
                   : vec && rb <= 128 ? kVec8 : kWide;
  const bool gated = active != nullptr;
  if (!gated && d <= kNarrow) return (int)cudaErrorInvalidValue;
  if (path == kWide) {
    // a staged row's padded stride (an odd count of 16-byte units), the
    // centroids a chunk, and the rows a stage: the most (up to one a
    // thread, at least 32) that let two blocks share an SM, else one, else
    // none (unstaged: the rows read from device memory, which at fp32
    // d = 600 to 16,384 measured faster than stages of fewer rows)
    const size_t rb16 = (rb + 15) / 16;
    int stride = (int)(16 * (rb16 % 2 ? rb16 : rb16 + 1));
    const size_t base = sizeof(float) * 2 * kSeg
                        + sizeof(int) * (kSegU * kWarps + 2) + 16;
    // resident where one centroid stages beside the rest; past that width
    // (fp32 d of about 57,000) the centroids are read from device memory,
    // the same bits
    if (base + sizeof(float) * ((size_t)d + 1) > (size_t)kSmem) resident = 0;
    const int mc = resident ? min(m, max(1, kWideCents / (d + 1))) : m;
    const size_t fixed = base + (resident ? sizeof(float) * (size_t)mc
                                                * (d + 1) : 0);
    int kB = 0;
    for (size_t budget : {kWideHalf, (size_t)kSmem}) {
      for (kB = kThreads; kB >= 32; kB /= 2)
        if (fixed + (size_t)kStages * kB * stride <= budget) break;
      if (kB >= 32) break;
    }
    const bool staged = kB >= 32;
    if (!staged) kB = kThreads, stride = 0;
    const size_t smem = fixed + (size_t)kStages * kB * stride;
    const long long segs = (block_n + kSeg - 1) / kSeg;
    if (blocks * segs > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    int err = gated && !problems
                  ? (int)cudaMemsetAsync(pruned, 0, sizeof(int) * blocks, s)
                  : 0;
    if (err != 0) return err;
    const auto run = [&](auto kern) {
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
      kern<<<(unsigned)(blocks * segs), kThreads, smem, s>>>(
          points, norms, cents, md_in, md_out, center_d, dc, margin, active,
          pruned, problems, n, d, m, block_n, mc, kB, stride);
    };
    const auto by_gate = [&](auto gate) {
      constexpr bool G = decltype(gate)::value;
      if (resident && staged)
        run(wide_rows_kernel<T, true, true, G>);
      else if (resident)
        run(wide_rows_kernel<T, true, false, G>);
      else if (staged)
        run(wide_rows_kernel<T, false, true, G>);
      else
        run(wide_rows_kernel<T, false, false, G>);
      err = (int)cudaGetLastError();
      if (err != 0) return;
      wide_tile_kernel<G><<<(unsigned)blocks, kThreads, 0, s>>>(
          md_out, active, prev_partials, prev_tile_max, partials, tile_max,
          problems, n, block_n);
      err = (int)cudaGetLastError();
    };
    if (gated)
      by_gate(std::true_type{});
    else
      by_gate(std::false_type{});
    return err;
  }
  int mc = m;
  if (resident) {
    mc = min(m, (kSmem / 4 - (3 + kU) * kThreads) / (d + 1));
    if (mc < 1) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((3 + kU) * kThreads +
                                       (resident ? (size_t)mc * (d + 1) : 0));
  const auto run = [&](auto kern) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<(unsigned)blocks, kThreads, smem, s>>>(
        points, norms, cents, md_in, md_out, partials, center_d, dc, margin,
        active, prev_partials, prev_tile_max, tile_max, pruned, problems, n,
        d, m, block_n, mc);
  };
  const auto by_path = [&](auto res, auto gate) {
    constexpr bool R = decltype(res)::value, G = decltype(gate)::value;
    if constexpr (G) {
      if (path == kRegs2) return run(gated_round_kernel<T, R, kRegs2, G>);
      if (path == kRegs) return run(gated_round_kernel<T, R, kRegs, G>);
    }
    if (path == kVec4) return run(gated_round_kernel<T, R, kVec4, G>);
    run(gated_round_kernel<T, R, kVec8, G>);
  };
  if (resident && gated)
    by_path(std::true_type{}, std::true_type{});
  else if (resident)
    by_path(std::true_type{}, std::false_type{});
  else if (gated)
    by_path(std::false_type{}, std::true_type{});
  else
    by_path(std::false_type{}, std::false_type{});
  return (int)cudaGetLastError();
}

int dispatch_gated(const void* points, const float* norms, const void* cents,
                   const float* md_in, float* md_out, float* partials,
                   const float* center_d, const float* dc,
                   const float* margin, const unsigned char* active,
                   const float* prev_partials, const float* prev_tile_max,
                   float* tile_max, int* pruned, int batch, int n, int d,
                   int m, int block_n, int resident, int bf16, void* stream,
                   const int* problems = nullptr) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_gated<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), md_in, md_out, partials,
        center_d, dc, margin, active, prev_partials, prev_tile_max, tile_max,
        pruned, batch, n, d, m, block_n, resident, problems, s);
  return launch_gated<float>(
      static_cast<const float*>(points), norms,
      static_cast<const float*>(cents), md_in, md_out, partials, center_d, dc,
      margin, active, prev_partials, prev_tile_max, tile_max, pruned, batch,
      n, d, m, block_n, resident, problems, s);
}

// K2 and K7 take K5's row loop, ungated, at d >= 8 (at d = 128, m = 8 it
// measured 30x faster than the template body), and the template body below
// (at the paper's d = 2 the row loop measured slower): the same bits.
int dispatch_seed(const void* points, const float* norms, const void* cents,
                  const float* md_in, float* md_out, float* partials,
                  int batch, int n, int d, int m, int block_n, int resident,
                  int bf16, void* stream, const int* problems = nullptr) {
  if (d <= kNarrow)
    return dispatch<false>(points, norms, cents, md_in, md_out, partials,
                           nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, batch, n, d, m, block_n, resident, bf16,
                           stream, problems);
  return dispatch_gated(points, norms, cents, md_in, md_out, partials,
                        nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, batch, n, d, m, block_n, resident,
                        bf16, stream, problems);
}

}  // namespace

// Every entry point takes `bf16`: 0 for fp32 points and cents, 1 for the
// bf16 stream (both of one type; norms and all else fp32).

// Launches one seeding round (K2) on `stream`; returns cudaGetLastError().
extern "C" int distance_min_update_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, int n, int d, int m,
    int block_n, int resident, int bf16, void* stream) {
  return dispatch_seed(points, norms, cents, md_in, md_out, partials, 1, n,
                       d, m, block_n, resident, bf16, stream);
}

// Launches one seeding round of `batch` problems (K7) on `stream`; returns
// cudaGetLastError(). points (batch, n, d), norms / md_in / md_out
// (batch, n), cents (batch, m, d), partials (batch, n_tiles), contiguous.
extern "C" int distance_min_update_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, int batch, int n,
    int d, int m, int block_n, int resident, int bf16, void* stream) {
  return dispatch_seed(points, norms, cents, md_in, md_out, partials, batch,
                       n, d, m, block_n, resident, bf16, stream);
}

// The template body at every width on K7's arguments (K2: batch 1), the
// kernel K2 and K7 took before; the reference the card tests and the smoke
// script hold them to, bit for bit. The engine never calls it.
extern "C" int distance_min_update_template_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, int batch, int n,
    int d, int m, int block_n, int resident, int bf16, void* stream) {
  return dispatch<false>(points, norms, cents, md_in, md_out, partials,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         batch, n, d, m, block_n, resident, bf16, stream);
}

// Launches one gated seeding round (K5) on `stream`; returns
// cudaGetLastError(). Every output is written (a skipped tile copying the
// carries: md_in's rows, prev_partials, prev_tile_max, and 0 pruned);
// md_out may be md_in (the round in place: a skipped tile and a pruned row
// then write nothing).
extern "C" int distance_min_update_gated_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, const float* center_d,
    const float* dc, const float* margin, const unsigned char* active,
    const float* prev_partials, const float* prev_tile_max, float* tile_max,
    int* pruned, int n, int d, int m, int block_n, int resident, int bf16,
    void* stream) {
  return dispatch_gated(points, norms, cents, md_in, md_out, partials,
                        center_d, dc, margin, active, prev_partials,
                        prev_tile_max, tile_max, pruned, 1, n, d, m, block_n,
                        resident, bf16, stream);
}

// Launches one gated seeding round of `batch` problems (K8) on `stream`;
// returns cudaGetLastError(). Every array carries a leading problem axis:
// K7's, plus center_d (batch, n) and dc, margin, active, prev_partials,
// prev_tile_max, tile_max and pruned (batch, n_tiles). Every output is
// written, as for K5.
extern "C" int distance_min_update_gated_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, const float* center_d,
    const float* dc, const float* margin, const unsigned char* active,
    const float* prev_partials, const float* prev_tile_max, float* tile_max,
    int* pruned, int batch, int n, int d, int m, int block_n, int resident,
    int bf16, void* stream) {
  return dispatch_gated(points, norms, cents, md_in, md_out, partials,
                        center_d, dc, margin, active, prev_partials,
                        prev_tile_max, tile_max, pruned, batch, n, d, m,
                        block_n, resident, bf16, stream);
}

// Launches K7 over the listed problems on `stream`: problems (n_listed,)
// int32 indices into the batch, on the device, any order, each at most
// once. The grid is n_listed * n_tiles blocks, block i taking tile
// i % n_tiles of problem problems[i / n_tiles]; every array keeps the whole
// batch's layout (points (B, n, d), cents (B, m, d), ...). md (B, n) and
// partials (B, n_tiles) are updated in place for the listed problems, whose
// outputs are bitwise K7's (and K2's) on them; the other problems' entries
// are not read or written. Returns cudaGetLastError().
extern "C" int distance_min_update_listed_launch(
    const void* points, const float* norms, const void* cents, float* md,
    float* partials, const int* problems, int n_listed, int n, int d, int m,
    int block_n, int resident, int bf16, void* stream) {
  return dispatch_seed(points, norms, cents, md, md, partials, n_listed, n,
                       d, m, block_n, resident, bf16, stream, problems);
}

// Launches K8 over the listed problems on `stream` (problems as for K7's
// list): md (B, n), partials and tile_max (B, n_tiles) are the carries,
// updated in place for the listed problems (a skipped tile keeps its
// entries), and pruned (B, n_tiles) must come zeroed: the listed problems'
// counts are written into it. A listed problem's outputs are bitwise K8's
// (and K5's) on it; the other problems' entries are not read or written.
// Returns cudaGetLastError().
extern "C" int distance_min_update_gated_listed_launch(
    const void* points, const float* norms, const void* cents, float* md,
    float* partials, const float* center_d, const float* dc,
    const float* margin, const unsigned char* active, float* tile_max,
    int* pruned, const int* problems, int n_listed, int n, int d, int m,
    int block_n, int resident, int bf16, void* stream) {
  return dispatch_gated(points, norms, cents, md, md, partials, center_d, dc,
                        margin, active, partials, tile_max, tile_max, pruned,
                        n_listed, n, d, m, block_n, resident, bf16, stream,
                        problems);
}

// The template's gated instance (distance_min_update_kernel, K5's kernel
// before gated_round_kernel) on K5's arguments without the carries:
// md_out, partials and tile_max must hold the carried values and pruned
// zeros, as inactive tiles leave them. The reference the card tests and the
// smoke script hold K5 to, bit for bit; the engine never calls it.
extern "C" int distance_min_update_gated_template_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, const float* center_d,
    const float* dc, const float* margin, const unsigned char* active,
    float* tile_max, int* pruned, int n, int d, int m, int block_n,
    int resident, int bf16, void* stream) {
  return dispatch<true>(points, norms, cents, md_in, md_out, partials,
                        center_d, dc, margin, active, tile_max, pruned, 1, n,
                        d, m, block_n, resident, bf16, stream);
}

// K3, K6, K10a and K10b: one tiled Lloyd assignment round on Hopper,
// ungated, bound-gated, and each over a batch of independent problems; K4
// and K9: the untiled round, one problem and a batch of them.
//
// K3 replaces src/repro/kernels/lloyd_assign.py::lloyd_assign_tiled_pallas
// (the TPU kernel's pallas_call at line 346). For every row x and centroid
// c it forms d2 = max(||x||^2 - 2 x.c + ||c||^2, 0) with the cached fp32
// norm, and writes
//   labels[x]  argmin over c (strict <, ascending c: the first minimum wins,
//              as jnp.argmin / torch.argmin do),
//   md[x]      the minimum d2,
// and per block_n-row tile t
//   partials[t] the sum of md over the tile's rows (the inertia partial),
//   gaps[t]     min over its rows of sqrt(second best d2) - sqrt(best d2),
//               +inf at k = 1 (no runner-up),
// and per super-tile s (tps consecutive tiles)
//   ssums[s, c, :]  the sum of the rows labelled c, scounts[s, c] their count.
//
// What bounds it on the H100: bytes at the paper's shape. A row moves 20 B
// (x 8, norm 4, label 4, md 4), so n = 4M is 80 MB, about 24 us at
// 3.35 TB/s; the distance arithmetic (2d + 3 flops per row and centroid,
// 1.4 GFLOP at k = 50) would take about 21 us at the 67 TFLOP/s fp32 rate,
// and the argmin's compares and selects roughly double the instructions.
// Wide problems (d = 128, k = 64) are bound by the fp32 arithmetic instead.
//
// Design. The sums must come out the same bits on every run (the movement
// bound of the next slice compares rounds bitwise), so there are no float
// atomics anywhere. K3 takes one of three routes, by width only, each
// writing the template's bits (below), which the template entry
// (lloyd_assign_tiled_template_launch, called only by the card tests and the
// smoke script) computes:
//   - d >= 8 within the screened widths (screen::screened): the screened
//     route below (K10a's with one problem, on K6's persistent grid), its
//     sqrt(second) into the caller's (n,) scratch;
//   - every other width: the row pass (the second best kept: labels, D² and
//     sqrt(second); below d = 8 untiled_row_kernel, R rows a thread in
//     registers; past the screened widths wide_row_kernel, one row a
//     thread read from device memory), its centroids staged in chunks, then
//     pass B's tiled instance and the super reduce, as K6's split route.
// No round stages the whole (k, d) block any more, so none has a k that
// shared memory caps. The template is two kernels, launched back to back on
// one stream:
//   1. assign_tile_kernel: one block per tile, thread t owning rows
//      t, t + 256, t + 512, ... The (k, d) centroid block and its norms are
//      staged in shared memory once. At d = 2 (the paper's) the row stays in
//      registers and four rows share each pass over the centroids, so each
//      centroid is read from shared memory once per four rows; other d take
//      one row at a time. Labels go to shared memory; the partial and gap
//      are reduced in a fixed tree. Then the tile's cluster sums: warp w
//      takes its 32-row chunks in ascending order; in a chunk the lanes that
//      share a label (__match_any_sync) add their rows in lane order by
//      shuffles, and the group's first lane adds the result into warp w's
//      own (k, cols) accumulator in shared memory. So the work is
//      O(block_n * (d + 1)) and no two threads ever add to one address; the
//      8 warps' accumulators are then added in warp order into a
//      (n_tiles, k, d + 1) scratch array. Columns (d coordinates and the
//      count) go in slices of `cols`, the most that fit the shared-memory
//      budget next to the staged centroids (the wrapper computes it:
//      ops.assign_cols).
//   2. super_reduce_kernel: one block per super-tile adds its tps tiles'
//      sums in ascending tile order, the same sequential order as the TPU
//      kernel's resident accumulator.
//
// K6 replaces lloyd_assign.py::lloyd_assign_gated_pallas (its pallas_call at
// line 484). It is K3 over the tiles the movement gate marks active (a
// super-aligned set: repro_torch.core.bounds.expand_active_supers), with the
// per-point Hamerly prune (bounds.assign_point_prune): a row whose carried
// label's centroid did not move (delta == 0) and whose carried lower bound
// clears the tile's threshold, prev_lb - sqrt(prev_md) >= thresh_t, takes its
// label and D² from the carry and sets lb = prev_lb - absorb_t, with no
// k-way loop; it still enters the tile's cluster sums under its label. Every
// other row writes lb = sqrt(second best). The kernels write every output:
// a skipped tile copies its rows' carried labels, D² and lb and its carried
// partial and gap, and super_reduce_kernel copies a skipped super's carried
// sums and counts, which is what the TPU kernel's input_output_aliases did
// (the outputs start empty; the pruned counts start at zero). An all-active
// launch in which nothing prunes is bitwise K3. K6 takes one of two routes,
// by width only:
//   - d >= 8 within the screened widths (screen::screened): the screened
//     route below, as K10b's with one problem, on a persistent grid (one
//     warpgroup a CTA, the centroids staged once a CTA, items of rows
//     walked in turn), and at d = 128 (the IVF build's width) rows of
//     several 128-byte chunks staged by 16-byte cp.async copies;
//   - otherwise (d < 8, the paper's d = 2, or rows past 512 bytes) the split
//     row pass: row_kernel, the template's row arithmetic (the prune, then
//     exact_d2 and fold for the rows it keeps, listed in shared memory and
//     taken up to four a thread at d = 2) in blocks of 512 rows, which
//     writes labels, D² and lb, then the screened route's pass B and super
//     reduce for the partials, gaps and sums.
// Both give the template's bits, which the template's own gated instance
// (assign_tile_kernel, K6's route before; lloyd_assign_gated_template_launch,
// called only by the card tests and the smoke script) checks bit for bit. At
// d = 2 the template pass skips the centroid loop only when all four of a
// thread's rows prune; its bits do not depend on that.
//
// K10a replaces lloyd_assign.py::lloyd_assign_tiled_batched_pallas (its
// pallas_call at line 544): K3 over B independent problems in one launch;
// K10b replaces lloyd_assign.py::lloyd_assign_gated_batched_pallas (its
// pallas_call at line 666): K6 over B problems, each with its own gate (the
// (B, n_tiles) mask read on the device, the full grid launched). Row b of
// either is bitwise K3 (K6) on problem b, and an all-active K10b with no
// carried bound is bitwise K10a. At d < 8, and past the widths below, K10a
// runs K3's row pass and K10b K6's split row pass with a problem index
// (blocks of one problem's rows, every pointer offset to the problem), then
// pass B over every problem's tiles.
//
// At d >= 8 (the row padded to the tensor cores' depth, 8 fp32 or 16 bf16
// values, at most 512 bytes: screen::screened) they, K6, K4 and K9 take the
// screened route, which writes the template's bits. What bounds the
// template at the PQ codebook sweep (B = 1664, n = 16384, d = 16, k = 256;
// 6.98e9 row and centroid pairs a round) is its fp32 fused multiply-adds,
// 2.4e11 flops, 3.65 ms at 67 TFLOP/s; one block of 256 threads per SM
// held the 8 warps' cluster-sum accumulators (175 KB) through its centroid
// loop. The screened route is two passes and the super reduce:
//
//   Pass A (screen::screen_kernel): one warpgroup per CTA, three CTAs an SM
//   (four for the ungated d = 16 instance at k <= 256), each CTA cta_rows
//   rows of one tile (K6 and K4, one problem: a
//   persistent grid whose CTAs walk such items, staging the centroids
//   once). It stages the problem's
//   centroids (256 at a time, zero-padded) and the chunk's norms cn,
//   computed as the template does (+inf past k), in the 128-byte swizzle
//   wgmma reads; nothing it stages grows with k, so k is bounded only by
//   the 16-bit candidate index (kMaxK). Past one chunk (k > 256) a
//   pre-pass (centroid_norms_kernel) writes every cn into the caller's
//   (B, k) scratch, where the problem's largest, each chunk's and the
//   recheck's are read; that instance (Chunked) is compiled apart, so the
//   resident one keeps its registers.
//   K10b and K6 first apply the template's prune to every row (pruned rows
//   write the carried label and D² and lb = prev_lb - absorb) and list the
//   rest in shared memory, so only those are screened. Rows go in batches
//   of 64, loaded one batch ahead by cp.async. For each 128 centroids one wgmma
//   chain forms acc = x . c on the tensor cores (m64n128k8 TF32 for fp32
//   streams, which reads each operand's top 19 bits; m64n128k16 bf16 for
//   bf16 streams, whose products are exact in fp32), and the epilogue forms
//   A' = fmaf(-2, acc, cn) (A = A' + xn screens D² = xn - 2 x.c + cn), the
//   minimum of each group of 8 values of a row in one thread, the row's two
//   smallest group minima so far over the quad that shares it (a2 the
//   second), T' = min(max(a2, -xn) + 2 eps, FLT_MAX), and the candidates
//   A' <= T' (from the sign bit of T' - A'), at most 16 kept a row. The
//   recheck computes each candidate's D² with exact_d2, the template's
//   arithmetic, and merges on (value, index): the least value, the first
//   index that attains it, and the second smallest value (multiset sense),
//   which is what the template's ascending fold gives over all k. A row
//   whose xn, x or A' may not be finite (S + 2 eps below is not under 1e37),
//   or that has more than 16 candidates, takes the template's full scan
//   with fold. Pass A writes labels, md and lbo = sqrt(second) (K10b: its
//   lb; K10a: a (B, n) scratch; K4 and K9, which keep no bound: none),
//   counts its pruned rows into `pruned` with integer atomics, and adds its
//   counters to `stats`.
//
//   Pass B (screen::reduce_kernel): the template's code after its row loop,
//   on pass A's labels, md and lb: per tile the partial and the gap in the
//   template's thread order and tree, and the cluster sums in its warp,
//   chunk and lane order. A tile's d + 1 columns go in slices of at most 8
//   to adjacent blocks (a column's sums do not depend on the slicing), so
//   three blocks share an SM and the tile's rows are read from device
//   memory about once; a chunk's values of the slice are loaded together.
//   Where one block cannot hold (k, 1) accumulators a warp, the centroids
//   go in equal chunks to adjacent blocks too (reduce_k_chunk), each adding
//   the rows whose label lies in its chunk, in the same order.
//   Its untiled instance (K4, K9) writes no partial or gap and weighs the
//   rows as the template's untiled instance does. Then super_reduce_kernel
//   as before (one super a problem for K4 and K9).
//
// Why the recheck is exact. Let E_c be the D² the template computes for
// centroid c and A_c = A'_c + xn the screened value, |A_c - E_c| <= eps
// (below; both clamped at 0, which is 1-Lipschitz). The two centroids with
// the smallest A have E <= A + eps, so E(2) <= A(2) + eps. A centroid that
// can be the template's best or second has E_c <= E(2), so
// A_c <= E_c + eps <= A(2) + 2 eps <= T' + xn: it is a candidate, because
// a2 is the second smallest of a subset of the A' (group minima, of the
// wgmmas done so far), so a2 >= A'(2). Every other centroid has E_c > E(2)
// and cannot change the best, its first index or the second.
//
// Deriving eps, per row, in fp32 with margin. u = 2^-24. P = sqrt(xx)
// sqrt(cnmax) (1 + 2^-9) bounds sum_j |x_j c_j| for every centroid (xx the
// row's fmaf sum of squares, cnmax the largest cn; the 2^-9 covers their
// rounding and the square roots for d < 2^13). S = |xn| + cnmax + 3 P
// bounds every magnitude in both combinations. The terms:
//   TF32 operands, truncated (2^-10 relative each; truncation is the worst
//     case): each product within (2^-9 + 2^-20) |x_j c_j|, times 2 for
//     -2 acc: 2 (2^-9 + 2^-20) P; bf16 products are exact: 0;
//   the tensor cores' fp32 accumulation, which has no IEEE guarantee: a
//     generous 2^-20 (8 fp32 ulps) per add relative to the sum of
//     magnitudes, d + 1 adds: 2 (d + 1) 2^-20 (1 + 2^-8) P;
//   the template's fmaf chain: gamma_d = d u / (1 - d u), times 2:
//     2 gamma_d P;
//   the roundings of A' = fmaf(-2, acc, cn) (one), of xn - 2 dt and + cn
//     (two) and of T' itself (one): 4 u S;
//   underflow and flushed denormals: d 2^-124 (1 + sqrt(xx) + sqrt(cnmax)).
// eps = (1 + 2^-7) (rel P + 4 u S + d 2^-124 (1 + sqrt(xx) + sqrt(cnmax))),
// rel = 2 (rho + (d + 1) 2^-20 (1 + 2^-8)) + 2 gamma_d, rho = 2^-9 + 2^-20
// (TF32) or 0 (bf16): screen_eps. tests/test_torch_screen.py holds a copy
// of the candidate rule and checks it on adversarial data.
//
// The route's work depends on the data: candidates per row and rows on the
// full scan are counted into `stats` (lloyd_assign.screen_stats).
// K4 replaces lloyd_assign.py::lloyd_assign_pallas (its pallas_call at line
// 111): labels and D² per row, and the cluster sums and counts over ALL rows,
// (k, d) and (k,), with no per-tile partials or gaps. The TPU kernel folded
// each tile's one-hot product into one resident accumulator, tile after
// tile. Here the sums keep the order of K3's template with one super
// spanning every tile (the template's untiled instance, assign_tile_kernel
// with Untiled = true): each block_n-row tile's sums in the template's warp,
// chunk and lane order into a (n_tiles, k, d + 1) scratch array, then every
// tile added in ascending order, the TPU's order. So labels and D² are K3's
// bits, and no float atomics set the sums. A weighted fit passes one weight
// per row: the row enters the sums as w·x and its count as w, on the same
// fixed tree. This fuses the reference's segment_update, which recomputes
// the sums with the weights after the TPU kernel. K4 takes one of three
// routes, by width only:
//   - d >= 8 within the screened widths (screen::screened): the screened
//     route's pass A below (K10a's, with one problem) on K6's persistent
//     grid, which writes labels and D²;
//   - d = 2 (the paper's): the row pass, untiled_row_kernel: R consecutive
//     rows a thread (R = 4 or 8, held in registers and loaded as 16-byte
//     vectors), exact_d2 and the fold's best and first label over the
//     centroids staged a block (in chunks past kRowBudget), in blocks of
//     128 threads;
//   both then run pass B's untiled instance (screen::reduce_kernel: the
//   template's sums with the weights, in column slices, no partial or gap)
//   and the all-tile reduce (chain_reduce_kernel: a block takes 8 outputs,
//   stages their values of every tile in shared memory with every copy in
//   flight, and one thread an output adds them in ascending tile order);
//   - every other width (d = 1, 3..7, rows past the screened widths): the
//     row pass without the second best (untiled_row_kernel's D = 0 instance
//     below d = 8, wide_row_kernel past the screened widths), then the same
//     pass B and all-tile reduce.
// What bounds it on the H100 at the paper's shape: bytes, as K3 (80 MB at
// n = 4M, d = 2, about 24 us), the weights adding 4 bytes a row; the fold
// is about 10 issued instructions a (row, centroid) pair (2 FFMA, the
// three pinned adds, the clamp, a compare and two selects; 8 on fp32
// streams, which clamp after the fold), about 0.06 ms of issue for 2e8
// pairs on 132 SMs, and pass B's shuffle chains come next.
//
// K9 replaces lloyd_assign.py::lloyd_assign_batched_pallas (its pallas_call
// at line 201): K4 over B independent problems, as K10a is to K3. At d >= 8
// (screen::screened) it takes the screened route's pass A with B problems
// (K10a's grid), then pass B's untiled instance and the all-tile reduce,
// one super a problem; at every other width K4's row pass with a problem
// index, then the same. Row b is K4 on problem b, bitwise. It takes no weights, as the reference's batched problems take
// none. At the PQ codebook sweep (B = 1664, n = 16384, d = 16, k = 256) its
// fp32-FMA bound is K10a's, 3.65 ms; the screen's, 0.77 ms.
//
// Both routes of K4 and K9 write the template's bits in all four outputs;
// the template's untiled instance stays reachable
// (lloyd_assign_template_launch, lloyd_assign_batched_template_launch),
// called only by the card tests and the smoke script, which hold K4 and K9
// to it bit for bit.
//
// All six also take a bf16 point stream (the engine's precision="bf16", the
// TPU kernels' bf16 tiles into the MXU): assign_tile_kernel is instantiated
// on the stream type T of `points` and `cents`, float or __nv_bfloat16. The
// centroids are widened into the fp32 staging once per block (the same
// shared memory as fp32's, so ops.assign_smem_bytes and ops.assign_cols do
// not change), and every row read (the d = 2 and d = 16 register paths, the
// runtime-d loop, the cluster-sum pass) widens its values. A bf16 value
// converts to float exactly and every later operation is the fp32
// instance's, in the same order, so a bf16 launch is bitwise the fp32
// launch on the points and centroids rounded to bf16 and widened back: the
// cluster sums add the rounded rows, as the TPU kernel's do. Norms, D²,
// partials, gaps, sums, counts and the gate stay fp32; super_reduce_kernel
// reads only fp32 and is shared. The stream halves x's bytes (a row at
// d = 2 moves 16 B instead of 20). The screened route (K10a, K10b at
// d >= 8) is templated on the stream type the same way and runs bf16
// streams on the bf16 tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// D² of one row and one centroid, the round's arithmetic: the dot product
// as fused multiply-adds in ascending j from 0, x(j) and c(j) the widened
// stream values, then max(xn - 2 dt + cn, 0). nvcc 12.9 compiled the
// template's earlier `xn - 2.f * dt + cn` to three FADDs (2dt as dt + dt,
// then xn - 2dt, then + cn; read from the SASS of every instance), so the
// three adds are pinned in that form here: the single-problem rounds keep
// their bits, and the screen's recheck (below) reproduces them. D > 0
// unrolls the loop. raw_d2 is the value before the clamp.
template <int D, typename XF, typename CF>
__device__ __forceinline__ float raw_d2(XF x, CF c, int d, float xn,
                                        float cn) {
  float dt = 0.f;
  if constexpr (D > 0) {
#pragma unroll
    for (int j = 0; j < D; ++j) dt = fmaf(x(j), c(j), dt);
  } else {
    for (int j = 0; j < d; ++j) dt = fmaf(x(j), c(j), dt);
  }
  return __fadd_rn(__fsub_rn(xn, __fadd_rn(dt, dt)), cn);
}
template <int D, typename XF, typename CF>
__device__ __forceinline__ float exact_d2(XF x, CF c, int d, float xn,
                                          float cn) {
  return nan_max(raw_d2<D>(x, c, d, xn, cn), 0.f);
}

// Folds centroid c's d2 into a row's (best, second, label): where d2 <
// best it becomes the best and the old best the second, else where d2 <
// second it becomes the second (NaN never does), by selects, not branches.
__device__ __forceinline__ void fold(float d2, int c, float& best,
                                     float& second, int& a) {
  const bool lt_best = d2 < best, lt_second = d2 < second;
  second = lt_best ? best : (lt_second ? d2 : second);
  best = lt_best ? d2 : best;
  a = lt_best ? c : a;
}

// The tile's partial (the sum of md) and gap (nan_min of lb - sqrt(md))
// from each thread's share, in a fixed tree; thread 0 writes both.
__device__ __forceinline__ void tile_partial_gap(float* red_sum,
                                                 float* red_gap,
                                                 float local_sum,
                                                 float local_gap,
                                                 float* partial, float* gap) {
  const int tid = threadIdx.x;
  red_sum[tid] = local_sum;
  red_gap[tid] = local_gap;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red_sum[tid] += red_sum[tid + s];
      red_gap[tid] = nan_min(red_gap[tid], red_gap[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    *partial = red_sum[0];
    *gap = red_gap[0];
  }
}

// The tile's cluster sums and counts into out (k, d + 1) from the labels in
// lab_sh, columns j_begin .. j_end - 1 (default all d + 1), `cols` columns
// (j0 .. j0 + cols - 1) at a time: warp w
// takes its 32-row chunks in ascending order, the lanes of one label add
// their rows in lane order, and the 8 warps' accumulators are added in warp
// order. Each column's sums are the same bits whatever `cols` is. `weights`
// (Untiled only; may be null) are offset to the problem. kCols > 0 (the
// screened route's pass B, cols <= kCols): a chunk's values of all its
// columns are loaded one chunk ahead, and its columns' group sums go in one
// pass over each group's lanes.
template <typename T, bool Untiled, int kCols = 0>
__device__ __forceinline__ void tile_cluster_sums(
    const T* tile_x, const float* weights, long long tile0,
    const int* lab_sh, float* acc_sh, float* out, int rows, int d, int k,
    int cols, int j_begin = 0, int j_end = -1) {
  const int tid = threadIdx.x;
  const int width = j_end < 0 ? d + 1 : j_end;
  const int warp = tid / 32, lane = tid % 32;
  float* acc = acc_sh + (size_t)warp * k * cols;
  for (int j0 = j_begin; j0 < width; j0 += cols) {
    const int nc = min(cols, width - j0);
    for (int i = tid; i < kWarps * k * cols; i += kThreads) acc_sh[i] = 0.f;
    __syncthreads();
    // kCols > 0: a chunk's values are loaded one chunk ahead
    float nx[kCols > 0 ? kCols : 1];
    const auto load_vals = [&](int chunk) {
      const int r = chunk + lane;
#pragma unroll
      for (int jj = 0; jj < (kCols > 0 ? kCols : 1); ++jj)
        nx[jj] = jj < nc && r < rows
                     ? (j0 + jj < d ? widen(tile_x[(size_t)r * d + j0 + jj])
                                    : 1.f)
                     : 0.f;
    };
    if constexpr (kCols > 0) load_vals(warp * 32);
    for (int chunk = warp * 32; chunk < rows; chunk += kThreads) {
      const int r = chunk + lane;
      const int lab = r < rows ? lab_sh[r] : -1;
      const unsigned peers = __match_any_sync(kFull, lab);
      const int rounds = __reduce_max_sync(kFull, __popc(peers));
      const bool lead = lab >= 0 && __ffs(peers) - 1 == lane;
      const float wr = Untiled && weights != nullptr && lab >= 0
                           ? weights[tile0 + r] : 1.f;
      // a lane past the tile's rows (lab < 0) reads nothing and adds 0
      const auto value = [&](int jj) {
        const int j = j0 + jj;
        return lab < 0 ? 0.f
                       : (j < d ? widen(tile_x[(size_t)r * d + j]) : 1.f);
      };
      const auto add = [&](int jj, float x) {
        const float v = Untiled ? x * wr : x;
        float s = 0.f;
        unsigned rest = peers;
        for (int t = 0; t < rounds; ++t) {   // the group's lanes, ascending
          const int src = rest ? __ffs(rest) - 1 : lane;
          const float got = __shfl_sync(kFull, v, src);
          if (rest) {
            s += got;
            rest &= rest - 1;
          }
        }
        if (lead) acc[(size_t)lab * cols + jj] += s;
      };
      if constexpr (kCols > 0) {
        // the columns' group sums in one pass over the group's lanes: each
        // column's adds are add()'s, in the same order
        float xv[kCols], sv[kCols];
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          xv[jj] = Untiled ? nx[jj] * wr : nx[jj];
          sv[jj] = 0.f;
        }
        if (chunk + kThreads < rows) load_vals(chunk + kThreads);
        unsigned rest = peers;
        for (int t = 0; t < rounds; ++t) {   // the group's lanes, ascending
          const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            if (jj < nc) {
              const float got = __shfl_sync(kFull, xv[jj], src);
              if (rest) sv[jj] += got;
            }
          if (rest) rest &= rest - 1;
        }
        if (lead)
#pragma unroll
          for (int jj = 0; jj < kCols; ++jj)
            if (jj < nc) acc[(size_t)lab * cols + jj] += sv[jj];
      } else {
        for (int jj = 0; jj < nc; ++jj) add(jj, value(jj));
      }
      __syncwarp();
    }
    __syncthreads();
    for (int o = tid; o < k * nc; o += kThreads) {
      const int c = o / nc, jj = o % nc;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w)
        s += acc_sh[((size_t)w * k + c) * cols + jj];
      out[(size_t)c * (d + 1) + j0 + jj] = s;
    }
    __syncthreads();
  }
}

// The gated kernel's extra inputs and outputs (null for K3 / K10a), each
// with a leading problem axis when batched (K10b).
struct Gate {
  const float* delta;          // (k,) centroid movement
  const float* thresh;         // (n_tiles,) prune threshold
  const float* absorb;         // (n_tiles,) lb decay of pruned rows
  const int* prev_a;           // (n,) carried labels
  const float* prev_md;        // (n,) carried D²
  const float* prev_lb;        // (n,) carried lower bounds
  const unsigned char* active; // (n_tiles,) the super-aligned active mask
  float* lb;                   // (n,) lower bounds out
  int* pruned;                 // (n_tiles,) pruned rows per tile
  // The carried tile and super outputs. The kernels write every output, a
  // skipped tile copying its rows' labels, D² and lb and its partial and
  // gap from the carries, a skipped super its sums and counts (the TPU
  // kernel's input_output_aliases).
  const float* prev_partials;  // (n_tiles,)
  const float* prev_gaps;      // (n_tiles,)
  const float* prev_ssums;     // (n_super, k, d)
  const float* prev_scounts;   // (n_super, k)
};

// A skipped tile's carried rows [r0, r1) into labels, md and lb (the gated
// rounds' outputs start empty), `threads` threads from thread `tid`.
__device__ __forceinline__ void copy_row_carries(const Gate& g, int* labels,
                                                 float* md, float* lb,
                                                 long long r0, long long r1,
                                                 int tid, int threads) {
  for (long long row = r0 + tid; row < r1; row += threads) {
    labels[row] = g.prev_a[row];
    md[row] = g.prev_md[row];
    lb[row] = g.prev_lb[row];
  }
}

// D > 0: the dimension is D, known at compile time, and R = 4 rows share
// each pass over the centroids. D == 0: the dimension is the runtime d.
// Gated = false is K3 / K10a, Gated = true is K6 / K10b, Untiled = true
// is K4 / K9: no partials or gaps (null), and non-null weights (K4) weigh
// each row's entry in the cluster sums. The switches are compile-time, so
// K3's and K6's instances carry none of K4's code. T is the stream type of
// points and cents (float or bf16).
template <typename T, int D, bool Gated, bool Untiled>
__global__ void __launch_bounds__(kThreads)
assign_tile_kernel(const T* __restrict__ points,
                   const float* __restrict__ norms,
                   const T* __restrict__ cents,
                   const float* __restrict__ weights,
                   int* __restrict__ labels, float* __restrict__ md,
                   float* __restrict__ partials, float* __restrict__ gaps,
                   float* __restrict__ tile_acc,  // (n_tiles, k, d + 1)
                   Gate g, int n, int d, int k, int block_n, int cols) {
  // problem b, tile t of it; its arrays are offset to problem b
  const int n_tiles = (n + block_n - 1) / block_n;
  const int b = blockIdx.x / n_tiles;
  const int t = blockIdx.x - b * n_tiles;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * k * d;
  labels += (size_t)b * n;
  md += (size_t)b * n;
  if (Untiled) {
    if (weights != nullptr) weights += (size_t)b * n;
  } else {
    partials += (size_t)b * n_tiles;
    gaps += (size_t)b * n_tiles;
  }
  if (Gated) {
    g.delta += (size_t)b * k;
    g.thresh += (size_t)b * n_tiles;
    g.absorb += (size_t)b * n_tiles;
    g.prev_a += (size_t)b * n;
    g.prev_md += (size_t)b * n;
    g.prev_lb += (size_t)b * n;
    g.active += (size_t)b * n_tiles;
    g.lb += (size_t)b * n;
    g.pruned += (size_t)b * n_tiles;
    if (!g.active[t]) {  // skipped: the carries are copied
      const long long r0 = (long long)t * block_n;
      copy_row_carries(g, labels, md, g.lb, r0,
                       min(r0 + block_n, (long long)n), threadIdx.x,
                       kThreads);
      if (threadIdx.x == 0) {
        partials[t] = g.prev_partials[(size_t)b * n_tiles + t];
        gaps[t] = g.prev_gaps[(size_t)b * n_tiles + t];
        g.pruned[t] = 0;
      }
      return;
    }
  }
  constexpr int R = D > 0 ? 4 : 1;
  constexpr int DR = D > 0 ? D : 1;
  extern __shared__ float smem[];
  const int width = d + 1;
  float* c_sh = smem;                                  // (k, d)
  float* cn_sh = c_sh + (size_t)k * d;                 // (k,)
  float* red_sum = cn_sh + k;                          // (kThreads,)
  float* red_gap = red_sum + kThreads;                 // (kThreads,)
  float* acc_sh = red_gap + kThreads;                  // (kWarps, k, cols)
  int* lab_sh = reinterpret_cast<int*>(acc_sh + (size_t)kWarps * k * cols);
  //                                                      (block_n,)
  float* delta_sh = reinterpret_cast<float*>(lab_sh + block_n);  // (k,) K6
  int* cnt_sh = reinterpret_cast<int*>(red_gap);  // pruned tree, reuses red_gap
  const int tid = threadIdx.x;

  for (int i = tid; i < k * d; i += kThreads) c_sh[i] = widen(cents[i]);
  if (Gated)
    for (int c = tid; c < k; c += kThreads) delta_sh[c] = g.delta[c];
  __syncthreads();
  for (int c = tid; c < k; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_sh[c * d + j], c_sh[c * d + j], s);
    cn_sh[c] = s;
  }
  __syncthreads();

  const long long tile0 = (long long)t * block_n;
  const T* tile_x = points + tile0 * d;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  const float thresh_t = Gated ? g.thresh[t] : 0.f;
  const float absorb_t = Gated ? g.absorb[t] : 0.f;
  float local_sum = 0.f;
  float local_gap = CUDART_INF_F;
  int local_pruned = 0;
  for (int base = tid; base < rows; base += R * kThreads) {
    float xr[R][DR], xn[R], best[R], second[R];
    int a[R];
    bool prune[R];
    bool need = !Gated;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = base + q * kThreads;
      const bool ok = r < rows;
      prune[q] = false;
      if (Gated && ok) {  // bounds.assign_point_prune
        const long long row = tile0 + r;
        const int pa = g.prev_a[row];
        const float pmd = g.prev_md[row];
        prune[q] = delta_sh[pa] == 0.f &&
                   __fsub_rn(g.prev_lb[row], sqrtf(pmd)) >= thresh_t;
        need |= !prune[q];
      }
      if constexpr (D > 0) {
#pragma unroll
        for (int j = 0; j < D; ++j)
          xr[q][j] = ok ? widen(tile_x[(size_t)r * D + j]) : 0.f;
      }
      xn[q] = ok ? norms[tile0 + r] : 0.f;
      best[q] = second[q] = CUDART_INF_F;
      a[q] = 0;
    }
    for (int c = 0; need && c < k; ++c) {
      const float* cc = c_sh + (size_t)c * d;
      const float cn = cn_sh[c];
      if constexpr (D > 0) {
        float cr[D];
#pragma unroll
        for (int j = 0; j < D; ++j) cr[j] = cc[j];
#pragma unroll
        for (int q = 0; q < R; ++q)
          fold(exact_d2<D>([&](int j) { return xr[q][j]; },
                           [&](int j) { return cr[j]; }, d, xn[q], cn),
               c, best[q], second[q], a[q]);
      } else {
        const T* x = tile_x + (size_t)base * d;
        fold(exact_d2<0>([&](int j) { return widen(x[j]); },
                         [&](int j) { return cc[j]; }, d, xn[0], cn),
             c, best[0], second[0], a[0]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = base + q * kThreads;
      if (r < rows) {
        float lb = sqrtf(second[q]);
        if (Gated && prune[q]) {
          a[q] = g.prev_a[tile0 + r];
          best[q] = g.prev_md[tile0 + r];
          lb = __fsub_rn(g.prev_lb[tile0 + r], absorb_t);
          ++local_pruned;
        }
        labels[tile0 + r] = a[q];
        md[tile0 + r] = best[q];
        if (Gated) g.lb[tile0 + r] = lb;
        lab_sh[r] = a[q];
        local_sum += best[q];
        local_gap = nan_min(local_gap, lb - sqrtf(best[q]));
      }
    }
  }
  if (Gated) {  // the pruned count, in the buffers the sum tree uses next
    cnt_sh[tid] = local_pruned;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
      if (tid < s) cnt_sh[tid] += cnt_sh[tid + s];
      __syncthreads();
    }
    if (tid == 0) g.pruned[t] = cnt_sh[0];
    __syncthreads();
  }
  if (!Untiled)
    tile_partial_gap(red_sum, red_gap, local_sum, local_gap, partials + t,
                     gaps + t);
  tile_cluster_sums<T, Untiled>(tile_x, weights, tile0, lab_sh, acc_sh,
                                tile_acc + (size_t)blockIdx.x * k * width,
                                rows, d, k, cols);
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}
// 4-byte asynchronous copy global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// chain_reduce_kernel reads this many staged values of an output together
constexpr int kAhead = 16;
// supers of at least kLongChain tiles take chain_reduce_kernel: a block
// takes kChainOuts outputs (one 32-byte sector of each tile's values) and
// stages them kChainTiles tiles at a time
constexpr int kLongChain = 64;
constexpr int kChainOuts = 8;
constexpr int kChainTiles = 1024;

// `active` (K6, K10b; null for the ungated rounds) skips a super none of
// whose tiles computed in its problem: its sums and counts are copied from
// prev_ssums / prev_scounts. Block (i, y)
// reduces super i % n_super of problem i / n_super, its outputs
// y, y + gridDim.y, ... in units of blockDim.x (each output's tiles added
// in ascending order, whatever the split). Ungated supers of kLongChain
// tiles or more (K4's one super) take chain_reduce_kernel instead.
__global__ void __launch_bounds__(kThreads)
super_reduce_kernel(const float* __restrict__ tile_acc, float* __restrict__ ssums,
                    float* __restrict__ scounts,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ prev_ssums,
                    const float* __restrict__ prev_scounts, int n_tiles,
                    int d, int k, int tps) {
  const int width = d + 1;
  const int n_super = (n_tiles + tps - 1) / tps;
  const int b = blockIdx.x / n_super;
  const int s = blockIdx.x - b * n_super;
  tile_acc += (size_t)b * n_tiles * k * width;
  ssums += (size_t)b * n_super * k * d;
  scounts += (size_t)b * n_super * k;
  const int t_end = min((s + 1) * tps, n_tiles);
  const int first = blockIdx.y * blockDim.x + threadIdx.x;
  const int step = gridDim.y * blockDim.x;
  if (active != nullptr) {
    active += (size_t)b * n_tiles;
    bool any = false;
    for (int t = s * tps; t < t_end; ++t) any |= active[t] != 0;
    if (!any) {
      const size_t o = ((size_t)b * n_super + s) * k;
      for (int i = first; i < k * d; i += step)
        ssums[(size_t)s * k * d + i] = prev_ssums[o * d + i];
      for (int c = first; c < k; c += step)
        scounts[(size_t)s * k + c] = prev_scounts[o + c];
      return;
    }
  }
  for (int o = first; o < k * width; o += step) {
    float acc = 0.f;
    for (int t = s * tps; t < t_end; ++t)
      acc += tile_acc[(size_t)t * k * width + o];
    const int c = o / width, j = o % width;
    if (j == d)
      scounts[(size_t)s * k + c] = acc;
    else
      ssums[((size_t)s * k + c) * d + j] = acc;
  }
}

// The super reduce of supers spanning many tiles (K4's one super: 977 at
// the paper's shape), where one thread's chain of loads, however far ahead,
// holds few bytes in flight: block (i, y) takes outputs y * kChainOuts ..
// + kChainOuts - 1 of super i % n_super of problem i / n_super, all 256
// threads stage their values of up to kChainTiles tiles into shared memory
// with cp.async (every copy in flight at once), and one thread an output
// adds them in ascending tile order from 0, super_reduce_kernel's chain.
// Ungated only (no `active`).
__global__ void __launch_bounds__(kThreads)
chain_reduce_kernel(const float* __restrict__ tile_acc,
                    float* __restrict__ ssums, float* __restrict__ scounts,
                    int n_tiles, int d, int k, int tps) {
  __shared__ float vals[kChainTiles * kChainOuts];   // (tile, output)
  const int width = d + 1;
  const int n_super = (n_tiles + tps - 1) / tps;
  const int b = blockIdx.x / n_super;
  const int s = blockIdx.x - b * n_super;
  tile_acc += (size_t)b * n_tiles * k * width;
  ssums += (size_t)b * n_super * k * d;
  scounts += (size_t)b * n_super * k;
  const int t0 = s * tps;
  const int nt = min(t0 + tps, n_tiles) - t0;
  const int o0 = blockIdx.y * kChainOuts;
  const int no = min(kChainOuts, k * width - o0);
  const size_t stride = (size_t)k * width;
  const float* p = tile_acc + (size_t)t0 * stride + o0;
  const int tid = threadIdx.x;
  const uint32_t vals_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(vals));
  float acc = 0.f;
  for (int c0 = 0; c0 < nt; c0 += kChainTiles) {
    const int ct = min(kChainTiles, nt - c0);
    for (int i = tid; i < ct * kChainOuts; i += kThreads) {
      const int t = i / kChainOuts, g = i - t * kChainOuts;
      if (g < no)
        cp_async4(vals_s + 4 * i, p + (size_t)(c0 + t) * stride + g, 4);
    }
    cp_async_commit();
    cp_async_wait0();
    __syncthreads();
    if (tid < no) {
      // kAhead values read together, then added in order
      int t = 0;
      for (; t + kAhead <= ct; t += kAhead) {
        float v[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u)
          v[u] = vals[(t + u) * kChainOuts + tid];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) acc += v[u];
      }
      for (; t < ct; ++t) acc += vals[t * kChainOuts + tid];
    }
    __syncthreads();
  }
  if (tid < no) {
    const int o = o0 + tid, c = o / width, j = o - c * width;
    if (j == d)
      scounts[(size_t)s * k + c] = acc;
    else
      ssums[((size_t)s * k + c) * d + j] = acc;
  }
}

// the card's SM count
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return max(sms, 1);
}

// The super reduce over batch problems of n_super supers: ungated supers of
// kLongChain tiles or more by chain_reduce_kernel; otherwise
// super_reduce_kernel, the outputs of a super split over blocks, four a
// thread of kThreads, or, where that grid would leave most SMs idle, halved
// down to one warp's 32 a block, so that the chains run on many SMs
int launch_super_reduce(const float* tile_acc, float* ssums, float* scounts,
                        const unsigned char* active, const float* prev_ssums,
                        const float* prev_scounts, int batch, int n_tiles,
                        int d, int k, int tps, cudaStream_t s) {
  const int n_super = (n_tiles + tps - 1) / tps;
  const int outs = k * (d + 1);
  const int groups = (outs + kChainOuts - 1) / kChainOuts;
  if (active == nullptr && tps >= kLongChain && groups <= 65535) {
    chain_reduce_kernel<<<dim3((unsigned)batch * n_super, (unsigned)groups),
                          kThreads, 0, s>>>(tile_acc, ssums, scounts,
                                            n_tiles, d, k, tps);
    return (int)cudaGetLastError();
  }
  const auto splits = [&](int per) { return (outs + per - 1) / per; };
  int per = 4 * kThreads;
  const long long want = 2LL * sm_count();
  while (per > 32 && (long long)batch * n_super * splits(per) < want)
    per /= 2;
  super_reduce_kernel<<<dim3((unsigned)batch * n_super,
                             (unsigned)min(splits(per), 65535)),
                        min(per, kThreads), 0, s>>>(
      tile_acc, ssums, scounts, active, prev_ssums, prev_scounts, n_tiles, d,
      k, tps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10a and K10b at d >= 8: the screened route (see the header).

namespace screen {

constexpr int kThreadsA = 128;   // pass A: one warpgroup
constexpr int kRows = 64;        // rows of one wgmma tile (a batch)
constexpr int kN = 256;          // centroids staged at once (a chunk)
constexpr int kNH = 128;         // centroids of one wgmma (half a chunk)
constexpr int kMaxCand = 16;     // candidates kept per row
constexpr int kMaxChunks = 4;    // 128-byte column chunks: d * bytes <= 512
constexpr int kCChunk = kN * 128;     // one column chunk of a centroid tile
constexpr int kXChunk = kRows * 128;  // one column chunk of a row tile
constexpr int kTargetCtas = 4096;     // pass A's grid is cut finer below this
constexpr size_t kReduceBudget = 72 * 1024;   // pass B: three blocks an SM
constexpr int kSliceCols = 8;    // pass B: the most columns a slice
constexpr int kCandStride = kMaxCand + 1;     // a row's list: distinct banks
using Cand = unsigned short;     // a candidate's index
constexpr int kMaxK = 65535;     // the most centroids a Cand indexes
// the recheck's merge: a row's best, second and label from its second
// thread
constexpr int kMergeBytes = 3 * 4 * kRows;

// columns d padded to the wgmma depth: 8 (TF32) or 16 (bf16) values
__host__ __device__ inline int padded_d(int d, bool bf16) {
  const int q = bf16 ? 16 : 8;
  return (d + q - 1) / q * q;
}

// whether K6, K10a, K10b, K4 and K9 take the screened route at width d
__host__ __device__ inline bool screened(int d, bool bf16) {
  return d >= 8 && padded_d(d, bf16) * (bf16 ? 2 : 4) <= kMaxChunks * 128;
}

// pass A's shared memory, byte offsets from a 1024-aligned base: the
// centroid tile (chunks of 256 rows x 128 B), two row tiles (chunks of 64
// rows x 128 B each: one computed on, one loading), the staged centroids'
// cn (256), the candidate lists (64 x 17), their counts, xn and eps (64
// each), the recheck's merge (3 x 64), the two row tiles' norms (2 x 64),
// the row list (K10b only, cta_rows), counters. Nothing in it grows with
// k: a chunk's norms are staged with the chunk, so k is bounded only by the
// 16-bit candidate index (kMaxK).
struct Layout {
  int c_off, x_off, cn_off, cand_off, cnt_off, xn_off, eps_off, merge_off,
      xnb_off, list_off, misc_off, bytes;
  __host__ __device__ Layout(int d, bool bf16, int cta_rows, bool gated) {
    const int chunks = (padded_d(d, bf16) * (bf16 ? 2 : 4) + 127) / 128;
    c_off = 0;
    x_off = c_off + chunks * kCChunk;
    cn_off = x_off + 2 * chunks * kXChunk;
    cand_off = cn_off + 4 * kN;
    cnt_off = cand_off + (2 * kRows * kCandStride + 3) / 4 * 4;
    xn_off = cnt_off + 4 * kRows;
    eps_off = xn_off + 4 * kRows;
    merge_off = eps_off + 4 * kRows;
    xnb_off = merge_off + kMergeBytes;
    list_off = xnb_off + 2 * 4 * kRows;
    misc_off = list_off + (gated ? (2 * cta_rows + 7) / 8 * 8 : 0);
    bytes = misc_off + 64 + 1024;   // + the base's alignment
  }
};

// byte offset of (row r, byte b) in a tile of 128-byte rows under the
// 128-byte swizzle (16-byte unit u of row r at unit u ^ (r % 8)), the layout
// the wgmma descriptors below read
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15);
}

__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(16 >> 4) << 16
         | static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// makes shared-memory stores of this thread visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// keeps the compiler from reading wgmma's registers before the wait
__device__ __forceinline__ void fence_regs(float (&r)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D64                                                                \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63"
#define WG_R8(i)                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),                \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// acc (+)= A B over one 32-byte depth step: m64n128k8 in TF32 (the
// hardware reads each fp32 operand's top 19 bits) or m64n128k16 in bf16,
// A (rows) and B (128 centroids) K-major in shared memory, fp32
// accumulate; `accumulate` 0 overwrites acc
template <bool Bf16>
__device__ __forceinline__ void wgmma_step(float (&d)[64], uint64_t da,
                                           uint64_t db, int accumulate) {
  if constexpr (Bf16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
          WG_R8(48), WG_R8(56)
        : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_D64
        "}, %64, %65, p, 1, 1;\n}\n"
        : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
          WG_R8(48), WG_R8(56)
        : "l"(da), "l"(db), "r"(accumulate));
  }
}
#undef WG_R8
#undef WG_D64

// the stream's values as raw bits (staged as they are) and widened
template <typename T>
using Bits = std::conditional_t<std::is_same<T, float>::value, unsigned int,
                                unsigned short>;
__device__ __forceinline__ float widen_bits(unsigned int v) {
  return __uint_as_float(v);
}
__device__ __forceinline__ float widen_bits(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// the screen's margin eps for one row (the header's derivation): P bounds
// sum_j |x_j c_j| for every centroid, S every magnitude in the two
// combinations; `rel` is the per-problem relative term. Returns -1 (the
// row takes the full scan) unless S + 2 eps < 1e37, false for inf and NaN
__device__ __forceinline__ float screen_eps(float xx, float xn, float cnmax,
                                            float rel, int d) {
  const float sx = sqrtf(xx), sc = sqrtf(cnmax);
  const float P = sx * sc * (1.f + 0x1p-9f);
  const float S = fabsf(xn) + cnmax + 3.f * P;
  const float eps = (1.f + 0x1p-7f) * (rel * P + 4.f * 0x1p-24f * S
                                       + (float)d * 0x1p-124f
                                             * (1.f + sx + sc));
  return S + 2.f * eps < 1e37f ? eps : -1.f;
}

// the D (> 0) values of row r of a staged tile of one 128-byte chunk (D
// values of at most 64 bytes), read as 16-byte units
template <int D, typename B>
__device__ __forceinline__ void load_row(const unsigned char* tile, int r,
                                         float (&out)[D]) {
  constexpr int kPer = 16 / sizeof(B);
#pragma unroll
  for (int u = 0; u < (D + kPer - 1) / kPer; ++u) {
    const uint4 w = *reinterpret_cast<const uint4*>(tile + swz(r, 16 * u));
    const B* v = reinterpret_cast<const B*>(&w);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (u * kPer + e < D) out[u * kPer + e] = widen_bits(v[e]);
  }
}

// byte offset of 16-byte unit u of row r in a staged tile of
// rows_per_chunk rows a 128-byte column chunk (unit u lies in chunk u / 8)
__device__ __forceinline__ int unit_off(int rows_per_chunk, int r, int u) {
  return (u >> 3) * rows_per_chunk * 128 + swz(r, 16 * (u & 7));
}

// Wide rows (D values over 64 bytes: d = 128), which registers cannot hold
// next to the accumulators: the row's sum of squares, and exact_d2's
// arithmetic (ascending fused multiply-adds, then the three adds) against
// centroid c, read unit by unit from the staged row tile and from the
// staged centroid chunk (cc null) or the problem's centroids in device
// memory.
template <int D, typename B>
__device__ __forceinline__ float wide_sumsq(const unsigned char* xt, int r) {
  constexpr int kPer = 16 / sizeof(B);
  float xx = 0.f;
#pragma unroll 4
  for (int u = 0; u < D / kPer; ++u) {
    const uint4 w =
        *reinterpret_cast<const uint4*>(xt + unit_off(kRows, r, u));
    const B* v = reinterpret_cast<const B*>(&w);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float f = widen_bits(v[e]);
      xx = fmaf(f, f, xx);
    }
  }
  return xx;
}

template <int D, typename B>
__device__ __forceinline__ float wide_d2(const unsigned char* xt, int r,
                                         const unsigned char* c_s,
                                         const B* cc, int c, float xn,
                                         float cn) {
  constexpr int kPer = 16 / sizeof(B);
  float dt = 0.f;
#pragma unroll 4
  for (int u = 0; u < D / kPer; ++u) {
    const uint4 wx =
        *reinterpret_cast<const uint4*>(xt + unit_off(kRows, r, u));
    const B* vx = reinterpret_cast<const B*>(&wx);
    if (cc == nullptr) {
      const uint4 wc =
          *reinterpret_cast<const uint4*>(c_s + unit_off(kN, c, u));
      const B* vc = reinterpret_cast<const B*>(&wc);
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        dt = fmaf(widen_bits(vx[e]), widen_bits(vc[e]), dt);
    } else {
      const B* cr = cc + (size_t)c * D + u * kPer;
#pragma unroll
      for (int e = 0; e < kPer; ++e)
        dt = fmaf(widen_bits(vx[e]), widen_bits(cr[e]), dt);
    }
  }
  return nan_max(__fadd_rn(__fsub_rn(xn, __fadd_rn(dt, dt)), cn), 0.f);
}

// The centroids' cn, exactly as the template stages it (ascending fmaf
// from 0), `count` of them, one a thread: what pass A reads past one staged
// chunk (k > 256), where it holds only the staged chunk's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
centroid_norms_kernel(const T* __restrict__ cents, float* __restrict__ cn,
                      long long count, int d) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= count) return;
  const Bits<T>* cc = reinterpret_cast<const Bits<T>*>(cents) + c * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = widen_bits(cc[j]);
    s = fmaf(v, v, s);
  }
  cn[c] = s;
}

// Pass A. Items of cta_rows rows of one tile of one problem go to CTAs (one
// warpgroup each), CTA i taking items i, i + gridDim.x, ...: for K10a, K10b
// and K9 one item a CTA; for one problem (K6, K4) a persistent grid of the
// CTAs that fit the card, which stages the centroids once and walks many
// items. The gated rounds (K10b, K6) first write an item's pruned rows from
// their carries and list the others; then the rows (K10a, K4, K9: all; the
// gated rounds: the listed ones) go in batches of 64 through the screen and
// the recheck, which write labels, md and, where lbo is not null,
// lbo = sqrt(second) (gated: g.lb). A skipped tile's rows are copied from
// the carries. D > 0: d == D and 16-byte aligned rows, staged by
// cp.async one batch ahead (D = 128: rows of several 128-byte chunks, read
// unit by unit); D == 0: any d, staged in place. stats (4): rows screened,
// their candidates, the most candidates of one row, rows on the full scan.
// Chunked (k > 256): the centroids go through the staged chunk in turn, and
// cn_g holds every centroid's cn; else (k <= 256) they are staged once and
// cn_g is not read. Registers for four CTAs an SM for the ungated D = 16
// instance with the centroids staged once (the PQ codebook sweep's), three
// for the rest (at four CTAs' 128 registers ptxas spills the others: the
// gated row list, the chunk loop, the D = 0 and D = 8 rechecks), one for
// wide rows (whose centroid tile takes up to 128 KB)
template <typename T, int D, bool Gated, bool Chunked>
__global__ void __launch_bounds__(kThreadsA,
                                  D * (int)sizeof(T) > 64
                                      ? 1
                                      : (Gated || Chunked || D != 16 ? 3 : 4))
screen_kernel(const T* __restrict__ points, const float* __restrict__ norms,
              const T* __restrict__ cents, const float* __restrict__ cn_g,
              int* __restrict__ labels,
              float* __restrict__ md, float* __restrict__ lbo, Gate g,
              unsigned long long* __restrict__ stats, int batch, int n,
              int d, int k, int block_n, int cta_rows) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  constexpr int kEs = sizeof(T);
  constexpr bool kWide = D * kEs > 64;
  using B = Bits<T>;
  const int n_tiles = (n + block_n - 1) / block_n;
  const int spt = (block_n + cta_rows - 1) / cta_rows;
  const long long n_items = (long long)batch * n_tiles * spt;
  if (Gated) lbo = g.lb;

  const int dpad = padded_d(d, kBf16);
  const int steps = dpad * kEs / 32;          // 32-byte wgmma depth steps
  const int kc = (steps + 3) / 4;             // 128-byte column chunks
  const int n_chunks = Chunked ? (k + kN - 1) / kN : 1;
  constexpr bool resident = !Chunked;
  const Layout L(d, kBf16, cta_rows, Gated);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = ((raw + 1023) & ~1023u) - raw;
  unsigned char* base = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  unsigned char* c_s = base + L.c_off;
  float* cn_s = reinterpret_cast<float*>(base + L.cn_off);
  Cand* cand_s = reinterpret_cast<Cand*>(base + L.cand_off);
  int* cnt_s = reinterpret_cast<int*>(base + L.cnt_off);
  float* xn_s = reinterpret_cast<float*>(base + L.xn_off);
  float* eps_s = reinterpret_cast<float*>(base + L.eps_off);
  float* mb_s = reinterpret_cast<float*>(base + L.merge_off);  // (64) x 3
  float* ms_s = mb_s + kRows;
  int* mi_s = reinterpret_cast<int*>(ms_s + kRows);
  float* xnb_s = reinterpret_cast<float*>(base + L.xnb_off);   // (2, 64)
  Cand* list_s = reinterpret_cast<Cand*>(base + L.list_off);
  unsigned long long* st_s =
      reinterpret_cast<unsigned long long*>(base + L.misc_off);  // (4)
  int* list_n_s = reinterpret_cast<int*>(base + L.misc_off + 32);
  int* pruned_s = list_n_s + 1;
  float* cnmax_s = reinterpret_cast<float*>(list_n_s + 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int xbuf_bytes = kc * kXChunk;
  // the row tile of buffer `buf`
  const auto x_tile = [&](int buf) { return base + L.x_off + buf * xbuf_bytes; };

  // the current item's problem: its rows, norms, centroids and outputs
  const B* xb = nullptr;
  const B* cb = nullptr;
  const float* cng = nullptr;   // the problem's cn in device memory (k > 256)
  const float* nrm = nullptr;
  int* lab_o = nullptr;
  float* md_o = nullptr;
  float* lb_o = nullptr;

  // element (r, j) of a staged tile of rows_per_chunk rows a chunk
  const auto at = [&](unsigned char* tile, int rows_per_chunk, int r,
                      int j) {
    const int bb = j * kEs;
    return tile + (bb >> 7) * rows_per_chunk * 128 + swz(r, bb & 127);
  };
  // centroids nc*256 .. +255 into the chunk, zeros past k and past d: at
  // D > 0 with 16-byte aligned centroids as 16-byte cp.async copies, all
  // in flight at once (then awaited, with the rows in flight); else value
  // by value
  constexpr int kCPer = 16 / kEs;                              // a unit's
  constexpr int kCUnits = D > 0 ? (D + kCPer - 1) / kCPer : 1;
  constexpr int kCUnitsPad = D > 0 ? (D * kEs + 31) / 32 * 2 : 1;
  const bool cvec = reinterpret_cast<uintptr_t>(cents) % 16 == 0;
  const auto stage_c = [&](int nc) {
    if (D > 0 && cvec) {
      for (int i = tid; i < kN * kCUnitsPad; i += kThreadsA) {
        const int r = i / kCUnitsPad, u = i - r * kCUnitsPad,
                  c = nc * kN + r;
        const bool live = c < k && u < kCUnits;
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       c_s + unit_off(kN, r, u))),
                   live ? cb + (size_t)c * D + u * kCPer : cb,
                   live ? 16 : 0);
      }
      cp_async_commit();
      cp_async_wait0();
    } else {
      for (int i = tid; i < kN * dpad; i += kThreadsA) {
        const int r = i / dpad, j = i - r * dpad, c = nc * kN + r;
        const B v = (c < k && j < d) ? cb[(size_t)c * d + j] : B(0);
        *reinterpret_cast<B*>(at(c_s, kN, r, j)) = v;
      }
    }
    fence_async_smem();
  };

  if (tid == 0)
    for (int i = 0; i < 4; ++i) st_s[i] = 0ull;
  const float du = (float)d * 0x1p-24f;
  const float rel =
      2.f * ((kBf16 ? 0.f : 0x1p-9f + 0x1p-20f)
             + (float)(d + 1) * 0x1p-20f * (1.f + 0x1p-8f))
      + 2.f * (du / (1.f - du));
  int cur_b = -1;
  unsigned long long n_rows = 0, n_cand = 0, max_cand = 0, n_full = 0;
  float acc[64];

  // one item: its rows' outputs (a batched grid has one item a CTA; a
  // persistent one's CTAs loop over theirs)
  const auto run_item = [&](long long item) {
    const int b = (int)(item / ((long long)n_tiles * spt));
    const int rem = (int)(item - (long long)b * n_tiles * spt);
    const int t = rem / spt;
    const int sub = rem - t * spt;
    const long long r0 = (long long)t * block_n + (long long)sub * cta_rows;
    const long long r1 = min(min(r0 + cta_rows, (long long)(t + 1) * block_n),
                             (long long)n);
    if (r0 >= r1) return;
    const size_t nb = (size_t)b * n;
    if (Gated && !g.active[(size_t)b * n_tiles + t]) {
      // skipped: the carries are copied
      copy_row_carries(g, labels, md, lbo, (long long)nb + r0,
                       (long long)nb + r1, tid, kThreadsA);
      return;
    }
    const int nrows = (int)(r1 - r0);
    xb = reinterpret_cast<const B*>(points) + nb * d;
    nrm = norms + nb;
    lab_o = labels + nb;
    md_o = md + nb;
    lb_o = lbo == nullptr ? nullptr : lbo + nb;

    if (b != cur_b) {
      // the problem's centroids' largest cn (NaN and inf kept); where one
      // chunk holds them, they and their cn, exactly as the template stages
      // it (+inf past k), are staged once; else cn is read from cn_g,
      // which centroid_norms_kernel wrote by the same arithmetic
      __syncthreads();   // the previous problem's reads are done
      cb = reinterpret_cast<const B*>(cents) + (size_t)b * k * d;
      if (!resident) cng = cn_g + (size_t)b * k;
      float cmax = 0.f;
      for (int c = tid; c < (resident ? kN : k); c += kThreadsA) {
        float s = CUDART_INF_F;
        if (c < k) {
          if (resident) {
            s = 0.f;
            for (int j = 0; j < d; ++j) {
              const float v = widen_bits(cb[(size_t)c * d + j]);
              s = fmaf(v, v, s);
            }
          } else {
            s = cng[c];
          }
          cmax = nan_max(cmax, s);
        }
        if (resident) cn_s[c] = s;
      }
      for (int o = 16; o > 0; o >>= 1)
        cmax = nan_max(cmax, __shfl_xor_sync(kFull, cmax, o));
      if (lane == 0) mb_s[warp] = cmax;
      if (resident) stage_c(0);
      __syncthreads();
      if (tid == 0) {
        float m = 0.f;
        for (int w = 0; w < kThreadsA / 32; ++w) m = nan_max(m, mb_s[w]);
        *cnmax_s = m;
      }
      cur_b = b;
    }
    if (tid == 0) {
      *list_n_s = 0;
      *pruned_s = 0;
    }
    __syncthreads();

    // the gated rounds: the prune (bounds.assign_point_prune) and the list
    // of the rest
    int total = nrows;
    if (Gated) {
      const size_t bt = (size_t)b * n_tiles + t;
      const float thresh_t = g.thresh[bt], absorb_t = g.absorb[bt];
      const int* prev_a = g.prev_a + nb;
      const float* prev_md = g.prev_md + nb;
      const float* prev_lb = g.prev_lb + nb;
      const float* delta = g.delta + (size_t)b * k;
      int local_pruned = 0;
      for (int i0 = 0; i0 < nrows; i0 += kThreadsA) {
        const int i = i0 + tid;
        bool keep = false;
        if (i < nrows) {
          const long long row = r0 + i;
          const int pa = prev_a[row];
          const float pmd = prev_md[row];
          const float plb = prev_lb[row];
          const bool prune = delta[pa] == 0.f &&
                             __fsub_rn(plb, sqrtf(pmd)) >= thresh_t;
          if (prune) {
            lab_o[row] = pa;
            md_o[row] = pmd;
            lb_o[row] = __fsub_rn(plb, absorb_t);
            ++local_pruned;
          }
          keep = !prune;
        }
        const unsigned ballot = __ballot_sync(kFull, keep);
        int at0 = 0;
        if (lane == 0 && ballot) at0 = atomicAdd(list_n_s, __popc(ballot));
        at0 = __shfl_sync(kFull, at0, 0);
        if (keep)
          list_s[at0 + __popc(ballot & ((1u << lane) - 1u))] = (Cand)i;
      }
      if (local_pruned) atomicAdd(pruned_s, local_pruned);
      __syncthreads();
      total = *list_n_s;
      if (tid == 0 && *pruned_s) atomicAdd(&g.pruned[bt], *pruned_s);
    }
    __syncthreads();
    const float cnmax = *cnmax_s;
    const auto row_of = [&](int i) -> long long {   // i-th row of the item's
      return r0 + (Gated ? list_s[i] : i);
    };

    // D > 0: batch `first`'s rows into buffer `buf` by cp.async (zeros past
    // d and past the rows), one group per call
    constexpr int kPer = 16 / kEs;                         // values a unit
    constexpr int kUnits = D > 0 ? (D + kPer - 1) / kPer : 1;
    constexpr int kUnitsPad = D > 0 ? (D * kEs + 31) / 32 * 2 : 1;
    const auto load_rows = [&](int first, int buf) {
      if (D > 0 && first < total) {
        const int cnt = min(kRows, total - first);
        unsigned char* tile = x_tile(buf);
        for (int i = tid; i < kRows * kUnitsPad; i += kThreadsA) {
          const int r = i / kUnitsPad, u = i - r * kUnitsPad;
          const bool live = r < cnt && u < kUnits;
          const B* src = live ? xb + (size_t)row_of(first + r) * D + u * kPer
                              : xb;
          cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                         tile + unit_off(kRows, r, u))),
                     src, live ? 16 : 0);
        }
        if (tid < kRows)   // and their norms
          cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(
                        xnb_s + buf * kRows + tid)),
                    tid < cnt ? nrm + row_of(first + tid) : nrm,
                    tid < cnt ? 4 : 0);
      }
      cp_async_commit();
    };

    const int q = lane & 3;
    const int row0 = warp * 16 + (lane >> 2);   // and row0 + 8
    // the wgmmas a staged chunk takes: 128 centroids each
    const auto halves = [&](int nc) { return k - nc * kN > kNH ? 2 : 1; };
    // acc = row tile x centroids hh*128 .. +127 of the staged chunk: started,
    // then awaited
    const auto mma_start = [&](uint32_t xoff, int hh) {
      wg_fence();
      for (int st = 0; st < steps; ++st) {
        const uint32_t off = (st & 3) * 32;
        const uint64_t da =
            sw128_desc(sbase + xoff + (st >> 2) * kXChunk + off);
        const uint64_t db = sw128_desc(sbase + L.c_off + (st >> 2) * kCChunk
                                       + hh * kNH * 128 + off);
        wgmma_step<kBf16>(acc, da, db, st > 0);
      }
      wg_commit();
    };
    const auto mma_wait = [&]() {
      wg_wait0();
      fence_regs(acc);
    };
    // acc becomes A' = cn - 2 acc (one rounding), column by column, cn the
    // staged chunk's
    const auto shift = [&](int hh) {
      const float* cnc = cn_s + hh * kNH;
#pragma unroll
      for (int g4 = 0; g4 < 16; ++g4) {
        const float2 cv =
            *reinterpret_cast<const float2*>(cnc + 8 * g4 + 2 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * g4 + e] = fmaf(-2.f, acc[4 * g4 + e], (e & 1) ? cv.y : cv.x);
      }
    };
    // the candidates A' <= T' of the wgmma's 128 centroids: per row half a
    // 32-bit mask (bit 2 g4 + p: column 8 g4 + 2 q + p) from the sign bits of
    // T' - A' (negative exactly when A' > T'), the quad's lanes writing in
    // lane order after the counts before them; base[h] counts the row's
    // earlier candidates (the same in the quad's four lanes)
    const auto collect = [&](int c0, const float (&T2)[2], int (&base)[2]) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned out[2] = {0u, 0u};   // bits of the rejected, two halves
#pragma unroll
        for (int e = 15; e >= 0; --e)
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            const int g4 = (16 * w + e) >> 1, p = e & 1;
            out[w] = (out[w] << 1)
                     | (__float_as_uint(__fsub_rn(T2[h], acc[4 * g4 + 2 * h + p]))
                        >> 31);
          }
        unsigned m = ~((out[1] << 16) | out[0]);
        const int mine = __popc(m);
        int before = 0, total = 0;
#pragma unroll
        for (int l = 0; l < 4; ++l) {
          const int c = __shfl_sync(kFull, mine, (lane & ~3) | l);
          before += l < q ? c : 0;
          total += c;
        }
        const int r = row0 + 8 * h;
        int at0 = base[h] + before;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          if (at0 < kMaxCand)
            cand_s[r * kCandStride + at0] =
                (Cand)(c0 + 8 * (bit >> 1) + 2 * q + (bit & 1));
          ++at0;
        }
        base[h] += total;
        if (q == 0) cnt_s[r] = base[h];
      }
    };

    load_rows(0, 0);
    for (int first = 0, it = 0; first < total; first += kRows, ++it) {
      const int count = min(kRows, total - first);
      const int buf = D > 0 ? it & 1 : 0;
      unsigned char* xt = x_tile(buf);
      float xn = 0.f;
      if constexpr (D > 0) {
        load_rows(first + kRows, buf ^ 1);   // the next batch, in flight
        cp_async_wait1();
      } else {
        // the row tile in place, zeros past d and past count
        for (int i = tid; i < kRows * dpad; i += kThreadsA) {
          const int r = i / dpad, j = i - r * dpad;
          const B v = (r < count && j < d)
                          ? xb[(size_t)row_of(first + r) * d + j] : B(0);
          *reinterpret_cast<B*>(at(xt, kRows, r, j)) = v;
        }
        if (tid < count) xn = nrm[row_of(first + tid)];
      }
      fence_async_smem();
      __syncthreads();
      const uint32_t xoff = L.x_off + buf * xbuf_bytes;
      if (resident) mma_start(xoff, 0);   // runs while the margins are computed
      if (tid < kRows) {
        float eps = -1.f;   // eps < 0: no screen (past count, or the full scan)
        if (tid < count) {
          float xx = 0.f;
          if constexpr (kWide) {
            xn = xnb_s[buf * kRows + tid];
            xx = wide_sumsq<D, B>(xt, tid);
          } else if constexpr (D > 0) {
            xn = xnb_s[buf * kRows + tid];
            float xr[D];
            load_row<D, B>(xt, tid, xr);
#pragma unroll
            for (int j = 0; j < D; ++j) xx = fmaf(xr[j], xr[j], xx);
          } else {
            for (int j = 0; j < d; ++j) {
              const float v =
                  widen_bits(*reinterpret_cast<const B*>(at(xt, kRows, tid, j)));
              xx = fmaf(v, v, xx);
            }
          }
          eps = screen_eps(xx, xn, cnmax, rel, d);
        }
        xn_s[tid] = xn;
        eps_s[tid] = eps;
      }

      __syncthreads();   // xn_s, eps_s
      float xn_r[2], eps_r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xn_r[h] = xn_s[row0 + 8 * h];
        eps_r[h] = eps_s[row0 + 8 * h];
      }
      // one pass over the centroids, 128 a wgmma: each row's smallest and
      // second smallest group minimum so far (a1, a2; a group is 8 values of
      // the row in one thread: 4 per thread and wgmma, 16 in the quad that
      // shares the row, merged into the running pair), the threshold
      // T' = max(a2, -xn) + 2 eps from them, and the wgmma's candidates
      // A' <= T'. a2 is the second smallest of some of the row's A', so it is
      // never below A'(2), and the exactness argument needs only that; T' is
      // kept finite so that padded centroids (cn = +inf) are never candidates
      // (a row without a screen takes none)
      float a1[2] = {CUDART_INF_F, CUDART_INF_F};
      float a2[2] = {CUDART_INF_F, CUDART_INF_F};
      int base[2] = {0, 0};
      for (int nc = 0; nc < n_chunks; ++nc) {
        if (!resident) {   // the chunk and its cn (+inf past k)
          __syncthreads();
          stage_c(nc);
          for (int r = tid; r < kN; r += kThreadsA)
            cn_s[r] = nc * kN + r < k ? cng[nc * kN + r] : CUDART_INF_F;
          __syncthreads();
        }
        for (int hh = 0; hh < halves(nc); ++hh) {
          if (!resident || hh > 0) mma_start(xoff, hh);
          mma_wait();
          shift(hh);
          float gm[2][4];   // [row half][group of 8]
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int G = 0; G < 4; ++G) gm[h][G] = CUDART_INF_F;
#pragma unroll
          for (int i = 0; i < 64; ++i)
            gm[(i >> 1) & 1][i >> 4] = fminf(gm[(i >> 1) & 1][i >> 4], acc[i]);
          float T2[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float lo0 = fminf(gm[h][0], gm[h][1]);
            const float lo1 = fminf(gm[h][2], gm[h][3]);
            float b1 = fminf(lo0, lo1);
            float b2 = fminf(fmaxf(lo0, lo1),
                             fminf(fmaxf(gm[h][0], gm[h][1]),
                                   fmaxf(gm[h][2], gm[h][3])));
#pragma unroll
            for (int o = 1; o <= 2; o <<= 1) {
              const float c1 = __shfl_xor_sync(kFull, b1, o);
              const float c2 = __shfl_xor_sync(kFull, b2, o);
              b2 = fminf(fmaxf(b1, c1), fminf(b2, c2));
              b1 = fminf(b1, c1);
            }
            a2[h] = fminf(fmaxf(a1[h], b1), fminf(a2[h], b2));
            a1[h] = fminf(a1[h], b1);
            T2[h] = eps_r[h] < 0.f
                        ? -CUDART_INF_F
                        : fminf(fmaxf(a2[h], -xn_r[h]) + 2.f * eps_r[h],
                                FLT_MAX);
          }
          collect(nc * kN + hh * kNH, T2, base);
        }
      }
      __syncthreads();

      // the recheck: each candidate's D² by the template's arithmetic, merged
      // on (value, index); a row without a screen takes every centroid. The
      // two threads of a row (tid, tid + 64) take alternate ones, then merge.
      const int r = tid & (kRows - 1), half = tid / kRows;
      float best = CUDART_INF_F, second = CUDART_INF_F;
      int a = 0;
      const bool full = r < count && (eps_s[r] < 0.f || cnt_s[r] > kMaxCand);
      if (r < count) {
        const float xnr = xn_s[r];
        const auto take = [&](int c, float v) {
          if (v < best || (v == best && c < a)) {
            second = best;
            best = v;
            a = c;
          } else if (v < second) {
            second = v;
          }
        };
        const auto d2_of = [&](int c, auto&& xr) {
          if constexpr (kWide) {
            return wide_d2<D, B>(xt, r, c_s, resident ? nullptr : cb, c, xnr,
                                 resident ? cn_s[c] : cng[c]);
          } else if constexpr (D > 0) {
            if (resident) {
              float cr[D];
              load_row<D, B>(c_s, c, cr);
              return exact_d2<D>([&](int j) { return xr[j]; },
                                 [&](int j) { return cr[j]; }, d, xnr,
                                 cn_s[c]);
            }
            const B* cc = cb + (size_t)c * d;
            return exact_d2<D>([&](int j) { return xr[j]; },
                               [&](int j) { return widen_bits(cc[j]); }, d,
                               xnr, cng[c]);
          } else {
            const auto xf = [&](int j) {
              return widen_bits(
                  *reinterpret_cast<const B*>(at(xt, kRows, r, j)));
            };
            if (resident)
              return exact_d2<0>(xf, [&](int j) {
                return widen_bits(
                    *reinterpret_cast<const B*>(at(c_s, kN, c, j)));
              }, d, xnr, cn_s[c]);
            const B* cc = cb + (size_t)c * d;
            return exact_d2<0>(xf, [&](int j) { return widen_bits(cc[j]); },
                               d, xnr, cng[c]);
          }
        };
        float xr[D > 0 && !kWide ? D : 1];
        if constexpr (D > 0 && !kWide) load_row<D, B>(xt, r, xr);
        if (full) {
          for (int c = half; c < k; c += 2) take(c, d2_of(c, xr));
        } else {
          const int cnt = cnt_s[r];
          int i = half;
          for (; i + 2 < cnt; i += 4) {   // two independent chains
            const int c0 = cand_s[r * kCandStride + i];
            const int c1 = cand_s[r * kCandStride + i + 2];
            const float v0 = d2_of(c0, xr), v1 = d2_of(c1, xr);
            take(c0, v0);
            take(c1, v1);
          }
          if (i < cnt) {
            const int c = cand_s[r * kCandStride + i];
            take(c, d2_of(c, xr));
          }
        }
        if (half) {
          mb_s[r] = best;
          ms_s[r] = second;
          mi_s[r] = a;
        }
      }
      __syncthreads();
      if (!half && r < count) {
        const float b2 = mb_s[r], s2 = ms_s[r];
        const int a2 = mi_s[r];
        second = fminf(fmaxf(best, b2), fminf(second, s2));
        if (b2 < best || (b2 == best && a2 < a)) {
          best = b2;
          a = a2;
        }
        const long long row = row_of(first + r);
        lab_o[row] = a;
        md_o[row] = best;
        if (lb_o != nullptr) lb_o[row] = sqrtf(second);
        const int cnt = cnt_s[r];
        if (eps_s[r] >= 0.f) {
          n_cand += cnt;
          max_cand = max(max_cand, (unsigned long long)cnt);
        }
        n_full += full;
        ++n_rows;
      }
      __syncthreads();
    }
  };
  for (long long item = blockIdx.x; item < n_items; item += gridDim.x)
    run_item(item);
  __syncthreads();
  if (n_rows) {
    atomicAdd(&st_s[0], n_rows);
    atomicAdd(&st_s[1], n_cand);
    atomicMax(&st_s[2], max_cand);
    atomicAdd(&st_s[3], n_full);
  }
  __syncthreads();
  if (tid == 0 && st_s[0]) {
    atomicAdd(&stats[0], st_s[0]);
    atomicAdd(&stats[1], st_s[1]);
    atomicMax(&stats[2], st_s[2]);
    atomicAdd(&stats[3], st_s[3]);
  }
}

// Pass B: the template's code after its row loop, on pass A's labels, md
// and lb: the partial and the gap, then the cluster sums. A tile's columns
// go in slices of `cols` to n_slices adjacent blocks (so the tile's rows
// are read from device memory about once and then from L2), and where one
// block cannot hold (k, cols) accumulators a warp, its centroids in
// n_kc chunks of kw: block (tile, chunk, slice) adds only the rows whose
// label falls in its chunk (the others take label -1, which adds nothing,
// and a cluster's group of lanes is the same). Slice 0 of chunk 0 also
// writes the partial and the gap, or for a skipped tile (the gated rounds)
// copies them from prev_partials / prev_gaps. Each column's sums
// are the template's bits whatever the slicing and the chunks. The gated rounds' pruned
// counts came from pass A. Untiled (K4, K9): the template's untiled
// instance, the labels alone read, no partial or gap, and each row weighed
// by `weights` (K4; null: 1). kC: the most columns a slice (4 for narrow
// slices, fewer registers). The launch bounds name the three blocks an SM
// it is sized for, so that ptxas does not trim registers into spills to
// fit a fourth.
template <typename T, bool Gated, bool Untiled = false,
          int kC = kSliceCols>
__global__ void __launch_bounds__(kThreads, 3)
reduce_kernel(const T* __restrict__ points, const float* __restrict__ weights,
              const int* __restrict__ labels,
              const float* __restrict__ md, const float* __restrict__ lbo,
              const unsigned char* __restrict__ active,
              const float* __restrict__ prev_partials,
              const float* __restrict__ prev_gaps,
              float* __restrict__ partials, float* __restrict__ gaps,
              float* __restrict__ tile_acc, int n, int d, int k, int block_n,
              int cols, int n_slices, int kw, int n_kc) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const int per_tile = n_kc * n_slices;
  const int tile = blockIdx.x / per_tile;
  const int kci = (blockIdx.x - tile * per_tile) / n_slices;
  const int slice = blockIdx.x - tile * per_tile - kci * n_slices;
  const int b = tile / n_tiles;
  const int t = tile - b * n_tiles;
  const int k0 = kci * kw, kn = min(kw, k - k0);   // the chunk's centroids
  if (Gated && !active[tile]) {
    if (slice == 0 && kci == 0 && threadIdx.x == 0) {
      partials[tile] = prev_partials[tile];
      gaps[tile] = prev_gaps[tile];
    }
    return;
  }
  points += (size_t)b * n * d;
  labels += (size_t)b * n;
  if (Untiled) {
    if (weights != nullptr) weights += (size_t)b * n;
  } else {
    md += (size_t)b * n;
    lbo += (size_t)b * n;
  }
  extern __shared__ float smem[];
  float* red_sum = smem;                               // (kThreads,)
  float* red_gap = red_sum + kThreads;                 // (kThreads,)
  float* acc_sh = red_gap + kThreads;                  // (kWarps, kn, cols)
  int* lab_sh = reinterpret_cast<int*>(acc_sh + (size_t)kWarps * kn * cols);
  const int tid = threadIdx.x;
  const long long tile0 = (long long)t * block_n;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  float local_sum = 0.f;
  float local_gap = CUDART_INF_F;
  // the partial and the gap (slice 0 of chunk 0 of a tiled round)
  const bool tail = !Untiled && slice == 0 && kci == 0;
  // rows tid, tid + 256, ... as the template's thread takes them, their
  // loads issued eight at a time
  constexpr int kU = 8;
  for (int r0 = tid; r0 < rows; r0 += kU * kThreads) {
    int lab[kU];
    float m[kU], lb[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u * kThreads;
      const bool ok = r < rows;
      lab[u] = ok ? labels[tile0 + r] : 0;
      m[u] = ok && tail ? md[tile0 + r] : 0.f;
      lb[u] = ok && tail ? lbo[tile0 + r] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int r = r0 + u * kThreads;
      if (r < rows) {
        lab_sh[r] = lab[u] >= k0 && lab[u] < k0 + kn ? lab[u] - k0 : -1;
        if (tail) {
          local_sum += m[u];
          local_gap = nan_min(local_gap, lb[u] - sqrtf(m[u]));
        }
      }
    }
  }
  if (tail)
    tile_partial_gap(red_sum, red_gap, local_sum, local_gap,
                     partials + tile, gaps + tile);
  const int j0 = slice * cols;
  tile_cluster_sums<T, Untiled, kC>(
      points + tile0 * d, Untiled ? weights : nullptr, tile0, lab_sh, acc_sh,
      tile_acc + ((size_t)tile * k + k0) * (d + 1), rows, d, kn, cols, j0,
      min(j0 + cols, d + 1));
}

// pass B's shared memory at `cols` columns a pass over k centroids: the
// template's, less the centroid staging
inline size_t reduce_smem_bytes(int k, int block_n, int cols) {
  return sizeof(float) * (2 * kThreads + (size_t)kWarps * k * cols + block_n);
}

// pass B's centroids a block: all k where one column of (k,) accumulators a
// warp fits the block's shared memory, else the fewest equal chunks that
// do; a caller's `kchunk` > 0 takes chunks of at most that many (the bits
// do not depend on it).
inline int reduce_k_chunk(int k, int block_n, int kchunk) {
  const int most =
      (int)((232448 / sizeof(float) - 2 * kThreads - block_n) / kWarps);
  const int parts = (k + most - 1) / most;
  const int kw = (k + parts - 1) / parts;
  return kchunk > 0 ? min(kchunk, kw) : kw;
}

// Pass B and the super reduce on the row pass's labels, md and lbo (the
// gated rounds: g.lb); the carries as `g` gives them. Untiled (K4, K9,
// which pass tps = n_tiles: one super a problem): pass B's untiled
// instance with `weights` (may be null). Returns the first CUDA error.
template <typename T, bool Gated, bool Untiled = false>
int launch_reduce(const T* points, const float* weights, const int* labels,
                  const float* md, const float* lbo, const Gate& g,
                  float* partials, float* gaps, float* tile_acc, float* ssums,
                  float* scounts, int batch, int n, int d, int k,
                  int block_n, int tps, int kchunk, cudaStream_t s) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const long long tiles = (long long)batch * n_tiles;
  const int kw = reduce_k_chunk(k, block_n, kchunk);
  const int n_kc = (k + kw - 1) / kw;
  // the columns a pass (the bits do not depend on it): the most, up to
  // kSliceCols, that let three blocks share an SM, else that fit one
  const auto fits = [&](int c, size_t budget) {
    return reduce_smem_bytes(kw, block_n, c) <= budget;
  };
  int cols_b = min(d + 1, kSliceCols);
  while (cols_b > 1 && !fits(cols_b, kReduceBudget)) --cols_b;
  if (!fits(cols_b, kReduceBudget))
    while (cols_b > 1 && !fits(cols_b, 232448)) --cols_b;
  const size_t smem_b = reduce_smem_bytes(kw, block_n, cols_b);
  const int n_slices = (d + 1 + cols_b - 1) / cols_b;
  if (tiles * n_kc * n_slices > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  // slices of at most four columns (d <= 3: the paper's d = 2) take the
  // instance with four columns' registers
  const auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_b);
    kernel<<<(unsigned)(tiles * n_kc * n_slices), kThreads, smem_b, s>>>(
        points, weights, labels, md, Gated ? g.lb : lbo,
        Gated ? g.active : nullptr, Gated ? g.prev_partials : nullptr,
        Gated ? g.prev_gaps : nullptr, partials, gaps, tile_acc, n, d, k,
        block_n, cols_b, n_slices, kw, n_kc);
  };
  if (cols_b <= 4)
    run(reduce_kernel<T, Gated, Untiled, 4>);
  else
    run(reduce_kernel<T, Gated, Untiled>);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_super_reduce(tile_acc, ssums, scounts,
                             Gated ? g.active : nullptr,
                             Gated ? g.prev_ssums : nullptr,
                             Gated ? g.prev_scounts : nullptr, batch, n_tiles,
                             d, k, tps, s);
}

// Both passes and the super reduce of one screened round; lbo is K10a's
// (batch, n) scratch (the gated rounds write g.lb; K4 and K9 pass null:
// nothing reads it). Pass A's grid: for a batch (K10a, K10b, K9) one item a
// CTA, items cut finer until there are kTargetCtas; for one problem (K6,
// K4) a persistent grid of the CTAs the card holds at once, items cut
// until there are 8 a CTA, so that each stages the centroids once. Past one
// chunk (k > 256) centroid_norms_kernel first writes every centroid's cn
// into the caller's (batch, k) scratch cn_g, which pass A reads (required
// there; not read at k <= 256). Untiled (K4, K9) runs pass A's ungated
// instance and pass B's untiled one with `weights` (may be null); kchunk
// caps pass B's centroids a block. Returns the first CUDA error.
template <typename T, bool Gated, bool Untiled = false>
int launch(const T* points, const float* norms, const T* cents,
           const float* weights, int* labels, float* md, float* lbo,
           float* partials, float* gaps, float* tile_acc, float* ssums,
           float* scounts, const Gate& g, unsigned long long* stats,
           float* cn_g, int batch, int n, int d, int k, int block_n, int tps,
           int kchunk, cudaStream_t s) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int n_tiles = (n + block_n - 1) / block_n;
  const long long tiles = (long long)batch * n_tiles;
  const auto items = [&](int rows) {
    return tiles * ((block_n + rows - 1) / rows);
  };
  // the row loads as 16-byte copies where d is 8, 16 or 128 and rows aligned
  const bool vec = reinterpret_cast<uintptr_t>(points) % 16 == 0;
  // past one chunk, every centroid's cn in device memory for pass A
  const bool chunked = k > kN;
  if (chunked) {
    if (cn_g == nullptr) return (int)cudaErrorInvalidValue;
    const long long count = (long long)batch * k;
    centroid_norms_kernel<T>
        <<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, s>>>(
            cents, cn_g, count, d);
  }
  const auto run = [&](auto kernel) -> int {
    int cta_rows = 4096;
    long long grid_a = 0;
    if (batch == 1) {
      const Layout most(d, kBf16, cta_rows, Gated);
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           most.bytes);
      int per = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreadsA,
                                                    most.bytes);
      const long long slots = (long long)max(per, 1) * sm_count();
      while (cta_rows > kRows && items(cta_rows) < 8 * slots) cta_rows /= 2;
      grid_a = items(cta_rows) < slots ? items(cta_rows) : slots;
    } else {
      while (cta_rows > kRows && items(cta_rows) < kTargetCtas)
        cta_rows /= 2;
      grid_a = items(cta_rows);
    }
    if (grid_a > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const Layout L(d, kBf16, cta_rows, Gated);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         L.bytes);
    kernel<<<(unsigned)grid_a, kThreadsA, L.bytes, s>>>(
        points, norms, cents, cn_g, labels, md, lbo, g, stats, batch, n, d,
        k, block_n, cta_rows);
    return (int)cudaGetLastError();
  };
  const auto by_width = [&](auto chunk) -> int {
    constexpr bool kChunked = decltype(chunk)::value;
    return vec && d == 16  ? run(screen_kernel<T, 16, Gated, kChunked>)
           : vec && d == 8 ? run(screen_kernel<T, 8, Gated, kChunked>)
           : vec && d == 128
               ? run(screen_kernel<T, 128, Gated, kChunked>)
               : run(screen_kernel<T, 0, Gated, kChunked>);
  };
  const int err = chunked ? by_width(std::true_type{})
                          : by_width(std::false_type{});
  if (err != 0) return err;
  return launch_reduce<T, Gated, Untiled>(points, weights, labels, md, lbo,
                                          g, partials, gaps, tile_acc, ssums,
                                          scounts, batch, n, d, k, block_n,
                                          tps, kchunk, s);
}

}  // namespace screen


// ---------------------------------------------------------------------------
// The row passes, at every width the screen does not take (d < 8, or rows
// past 512 bytes): the split row pass for K6 and K10b, the row pass for
// K3, K4, K9 and K10a (see the header).

// the row passes' blocks: small, so that blocks in their prune and in their
// fold share an SM
constexpr int kRowThreads = 128;
// a row pass's block stages at most this many bytes of centroids and lists,
// so that four blocks share an SM (their launch bounds); past it the
// centroids go in chunks, each row's best, second and label held in
// registers from chunk to chunk
constexpr int kRowBudget = 232448 / 4;

// Centroids c0 .. c0 + nc - 1 widened into c_sh (nc, d) and their cn (the
// template's ascending fmaf) into cn_sh, by the block's threads; the caller
// syncs before the fold reads them.
template <typename T>
__device__ __forceinline__ void stage_centroids(const T* __restrict__ cents,
                                                float* c_sh, float* cn_sh,
                                                int c0, int nc, int d) {
  const int tid = threadIdx.x;
  for (int i = tid; i < nc * d; i += blockDim.x)
    c_sh[i] = widen(cents[(size_t)c0 * d + i]);
  __syncthreads();
  for (int c = tid; c < nc; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_sh[c * d + j], c_sh[c * d + j], s);
    cn_sh[c] = s;
  }
}

// Where not one centroid row stages in a block (kc == 0: d past about
// 58,000), the row passes read the centroids from device memory and stage
// only their k norms, formed here by stage_centroids' arithmetic (the same
// bits).
template <typename T>
__device__ __forceinline__ void centroid_norms(const T* __restrict__ cents,
                                               float* cn_sh, int k, int d) {
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    const T* cc = cents + (size_t)c * d;
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(widen(cc[j]), widen(cc[j]), s);
    cn_sh[c] = s;
  }
}

// The fold of listed rows list_s[i0 .. i0 + RR) (block-relative; rows past
// `total` are not folded): exact_d2 and fold over every centroid in
// ascending order, the RR rows sharing each pass over the staged centroids,
// as the template's rows of one thread do; writes labels, D² and
// lb = sqrt(second). Every thread of the block calls it (with i0 past
// `total` where it has no row): where kc < k, chunk 0 is staged by the
// caller and each later chunk here.
template <typename T, int D, int RR>
__device__ __forceinline__ void fold_listed(
    const T* __restrict__ points, const float* __restrict__ norms,
    const T* __restrict__ cents, float* c_sh, float* cn_sh,
    const int* list_s, int i0, int total, int blk0, int d, int k, int kc,
    int* __restrict__ labels, float* __restrict__ md, float* __restrict__ lb) {
  constexpr int DR = D > 0 ? D : 1;
  float xr[RR][DR], xn[RR], best[RR], second[RR];
  int a[RR], row[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const bool ok = i0 + q < total;
    row[q] = ok ? blk0 + list_s[i0 + q] : -1;
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < D; ++j)
        xr[q][j] = ok ? widen(points[(size_t)row[q] * D + j]) : 0.f;
    }
    xn[q] = ok ? norms[row[q]] : 0.f;
    best[q] = second[q] = CUDART_INF_F;
    a[q] = 0;
  }
  const int step = kc > 0 ? kc : k;   // kc == 0: from device memory
  for (int c0 = 0; c0 < k; c0 += step) {
    if (c0 > 0) {
      __syncthreads();   // the last chunk's reads are done
      stage_centroids(cents, c_sh, cn_sh, c0, min(kc, k - c0), d);
      __syncthreads();
    }
    const int nc = row[0] < 0 ? 0 : min(step, k - c0);
    for (int c = 0; c < nc; ++c) {
      const float* cc = c_sh + (size_t)c * d;
      const float cn = cn_sh[c];
      if constexpr (D > 0) {
        float cr[D];
#pragma unroll
        for (int j = 0; j < D; ++j) cr[j] = cc[j];
#pragma unroll
        for (int q = 0; q < RR; ++q)
          fold(exact_d2<D>([&](int j) { return xr[q][j]; },
                           [&](int j) { return cr[j]; }, d, xn[q], cn),
               c0 + c, best[q], second[q], a[q]);
      } else if (kc > 0) {
        const T* x = points + (size_t)row[0] * d;
        fold(exact_d2<0>([&](int j) { return widen(x[j]); },
                         [&](int j) { return cc[j]; }, d, xn[0], cn),
             c0 + c, best[0], second[0], a[0]);
      } else {
        const T* x = points + (size_t)row[0] * d;
        const T* cg = cents + (size_t)c * d;
        fold(exact_d2<0>([&](int j) { return widen(x[j]); },
                         [&](int j) { return widen(cg[j]); }, d, xn[0], cn),
             c, best[0], second[0], a[0]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    if (row[q] < 0) continue;
    labels[row[q]] = a[q];
    md[row[q]] = best[q];
    lb[row[q]] = sqrtf(second[q]);
  }
}

// K6's row pass: the template's row arithmetic on blocks of kRowThreads * R
// rows (R = 4 at D = 2) that need not lie in one tile. First each thread's R
// consecutive rows (16-byte loads of the carries where `vec`): a skipped
// tile's row copies its carries, and an active row takes the prune
// (bounds.assign_point_prune, delta read from device memory): a pruned row
// writes its carried label and D² and lb = prev_lb - absorb, the others are
// listed in shared memory. Then the listed rows go through exact_d2 and fold
// over every centroid (fold_listed, kc staged at a time), 1, 2 or 4 to a
// thread (at D = 2; one at other d) as their count asks, so that only the
// rows the prune keeps pay for the fold and as many warps as can take part.
// Each tile's pruned rows are added into g.pruned (zeroed by the caller)
// with integer atomics. A batch (K10b) runs bpp blocks a problem: block i
// takes row block i % bpp of problem i / bpp, every pointer offset to the
// problem (as assign_tile_kernel's), so problem b's rows are K6's on b.
template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads, 4)
row_kernel(const T* __restrict__ points, const float* __restrict__ norms,
           const T* __restrict__ cents, int* __restrict__ labels,
           float* __restrict__ md, Gate g, int n, int d, int k, int kc,
           int block_n, int vec, int bpp) {
  constexpr int R = D > 0 ? 4 : 1;
  extern __shared__ float smem[];
  float* c_sh = smem;                                   // (kc, d)
  float* cn_sh = c_sh + (size_t)kc * d;                 // (kc,), or (k,)
  int* cnt_sh = reinterpret_cast<int*>(cn_sh + (kc > 0 ? kc : k));
  int* list_s = cnt_sh + R * kRowThreads;               // (R * 128,)
  __shared__ int list_n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / bpp;
  const int n_tiles = (n + block_n - 1) / block_n;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * k * d;
  labels += (size_t)b * n;
  md += (size_t)b * n;
  g.delta += (size_t)b * k;
  g.thresh += (size_t)b * n_tiles;
  g.absorb += (size_t)b * n_tiles;
  g.prev_a += (size_t)b * n;
  g.prev_md += (size_t)b * n;
  g.prev_lb += (size_t)b * n;
  g.active += (size_t)b * n_tiles;
  g.lb += (size_t)b * n;
  g.pruned += (size_t)b * n_tiles;
  vec = vec && ((reinterpret_cast<uintptr_t>(g.prev_a)
                 | reinterpret_cast<uintptr_t>(g.prev_md)
                 | reinterpret_cast<uintptr_t>(g.prev_lb)) % 16 == 0);
  const int blk0 = (blockIdx.x - b * bpp) * R * kRowThreads;  // n < 2^31
  const int t0 = blk0 / block_n;
  for (int i = tid; i < R * kRowThreads; i += kRowThreads) cnt_sh[i] = 0;
  if (tid == 0) list_n = 0;
  if (kc > 0)
    stage_centroids(cents, c_sh, cn_sh, 0, min(kc, k), d);   // chunk 0
  else
    centroid_norms(cents, cn_sh, k, d);
  // the thread's R rows: every load first, so they are in flight together
  const int row0 = blk0 + R * tid;
  int pa[R];
  float pmd[R], plb[R];
  bool loaded = false;
  if constexpr (R == 4) {
    if (vec && row0 + R <= n) {
      const int4 va = *reinterpret_cast<const int4*>(g.prev_a + row0);
      const float4 vm = *reinterpret_cast<const float4*>(g.prev_md + row0);
      const float4 vl = *reinterpret_cast<const float4*>(g.prev_lb + row0);
      pa[0] = va.x, pa[1] = va.y, pa[2] = va.z, pa[3] = va.w;
      pmd[0] = vm.x, pmd[1] = vm.y, pmd[2] = vm.z, pmd[3] = vm.w;
      plb[0] = vl.x, plb[1] = vl.y, plb[2] = vl.z, plb[3] = vl.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const bool ok = row0 + e < n;
      pa[e] = ok ? g.prev_a[row0 + e] : 0;
      pmd[e] = ok ? g.prev_md[row0 + e] : 0.f;
      plb[e] = ok ? g.prev_lb[row0 + e] : 0.f;
    }
  }
  bool live[R];
  float th[R], ab[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int row = row0 + e;
    const bool ok = row < n;
    const int t = ok ? row / block_n : 0;
    live[e] = ok && g.active[t];
    th[e] = g.thresh[t];
    ab[e] = g.absorb[t];
    if (ok && !live[e]) {   // skipped: its carries
      labels[row] = pa[e];
      md[row] = pmd[e];
      g.lb[row] = plb[e];
    }
  }
  // the prune, and the list of the rows it keeps (block-relative)
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int row = row0 + e;
    bool keep = false, prune = false;
    if (live[e]) {
      prune = g.delta[pa[e]] == 0.f &&
              __fsub_rn(plb[e], sqrtf(pmd[e])) >= th[e];
      if (prune) {
        labels[row] = pa[e];
        md[row] = pmd[e];
        g.lb[row] = __fsub_rn(plb[e], ab[e]);
      }
      keep = !prune;
    }
    // a warp's rows (32 R consecutive) lie in one tile when block_n is a
    // multiple of 32 R
    const unsigned pr = __ballot_sync(kFull, prune);
    if (block_n % (32 * R) == 0) {
      if (lane == 0 && pr)
        atomicAdd(&cnt_sh[row / block_n - t0], __popc(pr));
    } else if (prune) {
      atomicAdd(&cnt_sh[row / block_n - t0], 1);
    }
    const unsigned ballot = __ballot_sync(kFull, keep);
    int at0 = 0;
    if (lane == 0 && ballot) at0 = atomicAdd(&list_n, __popc(ballot));
    at0 = __shfl_sync(kFull, at0, 0);
    if (keep)
      list_s[at0 + __popc(ballot & ((1u << lane) - 1u))] = row - blk0;
  }
  __syncthreads();
  const int total = list_n;
  // rows a thread: as few as let every listed row into one pass (a block
  // lists at most R * kRowThreads rows)
  const int rr = R == 1 || total <= kRowThreads ? 1
                 : total <= 2 * kRowThreads ? 2 : 4;
  const int i0 = tid * rr;
  if (rr == 1)
    fold_listed<T, D, 1>(points, norms, cents, c_sh, cn_sh, list_s, i0,
                         total, blk0, d, k, kc, labels, md, g.lb);
  else if (rr == 2)
    fold_listed<T, D, R == 1 ? 1 : 2>(points, norms, cents, c_sh, cn_sh,
                                      list_s, i0, total, blk0, d, k, kc,
                                      labels, md, g.lb);
  else
    fold_listed<T, D, R>(points, norms, cents, c_sh, cn_sh, list_s, i0,
                         total, blk0, d, k, kc, labels, md, g.lb);
  __syncthreads();
  for (int i = tid; i < R * kRowThreads; i += kRowThreads)
    if (cnt_sh[i]) atomicAdd(&g.pruned[t0 + i], cnt_sh[i]);
}

// K6's row pass stages kc centroids at a time: all k where they and the
// lists fit kRowBudget, else the most that do (wide rows: the most that
// fit a block); 0 where not one fits (the centroids then read from device
// memory, their k norms staged).
inline int split_k_chunk(int d, int k) {
  const int lists = 2 * 4 * (d == 2 ? 4 : 1) * kRowThreads;
  const int per = 4 * (d + 1);
  const int kc = (kRowBudget - lists) / per;
  return min(k, kc >= 1 ? kc : (232448 - lists) / per);
}

// K6's split round (K10b's with `batch` problems): the row pass, then
// screen::launch_reduce (the template's partials, gaps and sums, and the
// super reduce). Returns the first CUDA error.
template <typename T>
int launch_split(const T* points, const float* norms, const T* cents,
                 int* labels, float* md, float* partials, float* gaps,
                 float* tile_acc, float* ssums, float* scounts, const Gate& g,
                 int batch, int n, int d, int k, int block_n, int tps,
                 int kchunk, cudaStream_t s) {
  const int R = d == 2 ? 4 : 1;
  const long long bpp =
      ((long long)n + R * kRowThreads - 1) / (R * kRowThreads);
  const long long grid = bpp * batch;
  const int kc = split_k_chunk(d, k);
  const size_t smem = sizeof(float) * (kc > 0 ? (size_t)kc * (d + 1) : k)
                      + 2 * sizeof(int) * R * kRowThreads;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // the carries read as 16-byte vectors where they are aligned
  const int vec = reinterpret_cast<uintptr_t>(g.prev_a) % 16 == 0
                  && reinterpret_cast<uintptr_t>(g.prev_md) % 16 == 0
                  && reinterpret_cast<uintptr_t>(g.prev_lb) % 16 == 0;
  const auto run = [&](auto kernel) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<(unsigned)grid, kRowThreads, smem, s>>>(
        points, norms, cents, labels, md, g, n, d, k, kc, block_n, vec,
        (int)bpp);
  };
  if (d == 2)
    run(row_kernel<T, 2>);
  else
    run(row_kernel<T, 0>);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return screen::launch_reduce<T, true>(points, nullptr, labels, md, g.lb, g,
                                        partials, gaps, tile_acc, ssums,
                                        scounts, batch, n, d, k, block_n, tps,
                                        kchunk, s);
}

// ---------------------------------------------------------------------------
// K3, K4, K9 and K10a off the screened widths: the row pass (see the
// header), then the screened route's pass B and super reduce.

// the widest row of the row pass's narrow instance (D = 0)
constexpr int kNarrow = 7;

// raw_d2 of a row of d <= kNarrow values in registers and a centroid staged
// as (c0 .. c6, cn): the fmaf chain in ascending j stopping at d, then the
// three pinned adds
__device__ __forceinline__ float narrow_raw_d2(const float (&x)[kNarrow],
                                               const float4& lo,
                                               const float4& hi, int d,
                                               float xn) {
  const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  float dt = 0.f;
#pragma unroll
  for (int j = 0; j < kNarrow; ++j)
    if (j < d) dt = fmaf(x[j], c[j], dt);
  return __fadd_rn(__fsub_rn(xn, __fadd_rn(dt, dt)), c[7]);
}

// The row pass: labels and D² of R consecutive rows a thread (from
// R * (blockIdx.x * kRowThreads + tid)) by the template's arithmetic,
// exact_d2 over every centroid in ascending order, and the fold's best and
// first label, which is all K4 keeps: a centroid takes the row where its D²
// is below the best so far (strict <, so the first minimum wins and NaN
// never does, as in fold). Second (K3): the fold also keeps the second
// best, and lbo = sqrt(second) is written. On fp32 streams the clamp at 0
// is applied after the fold, which saves two of about ten instructions a
// (row, centroid) pair and keeps the bits (the comment at the clamp). The
// rows are held in registers, read as 16-byte vectors at D = 2 where `vec`
// (points, norms, labels, md and lbo 16-byte aligned) and all of the
// thread's rows lie below n. D = 2: each centroid staged as (c0, c1, cn, 0),
// one 16-byte broadcast; D = 0 (d < 8): as (c0 .. c6, cn), two. The
// centroids are staged kc at a time (row_k_chunk); a row's best, second and
// label stay in registers from chunk to chunk. A batch (K9, K10a) runs bpp
// blocks a problem, block i taking row block i % bpp of problem i / bpp
// with every pointer offset to the problem, so problem b's rows are the
// single pass's on b (`vec` is rechecked on the offset pointers).
template <typename T, int D, int R, bool Second>
__global__ void __launch_bounds__(kRowThreads, 4)
untiled_row_kernel(const T* __restrict__ points,
                   const float* __restrict__ norms,
                   const T* __restrict__ cents, int* __restrict__ labels,
                   float* __restrict__ md, float* __restrict__ lbo, int n,
                   int d, int k, int kc, int vec, int bpp) {
  static_assert(R % 4 == 0, "R a multiple of 4");
  constexpr int kV = D == 2 ? 1 : 2;           // float4s a staged centroid
  constexpr int DX = D == 2 ? 2 : kNarrow;     // a row's values held
  extern __shared__ float4 c4[];               // (kc, kV)
  const int tid = threadIdx.x;
  const int b = blockIdx.x / bpp;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * k * d;
  labels += (size_t)b * n;
  md += (size_t)b * n;
  if constexpr (Second) lbo += (size_t)b * n;
  vec = vec && ((reinterpret_cast<uintptr_t>(points)
                 | reinterpret_cast<uintptr_t>(norms)
                 | reinterpret_cast<uintptr_t>(labels)
                 | reinterpret_cast<uintptr_t>(md)
                 | reinterpret_cast<uintptr_t>(lbo)) % 16 == 0);
  const long long row0 =
      ((long long)(blockIdx.x - b * bpp) * kRowThreads + tid) * R;
  const auto stage = [&](int c0) {   // centroids c0 .. c0 + kc - 1
    const int nc = min(kc, k - c0);
    for (int c = tid; c < nc; c += kRowThreads) {
      const T* src = cents + (size_t)(c0 + c) * d;
      if constexpr (D == 2) {
        const float u = widen(src[0]), v = widen(src[1]);
        c4[c] = make_float4(u, v, fmaf(v, v, fmaf(u, u, 0.f)), 0.f);
      } else {
        float v[8];
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < kNarrow; ++j) {
          v[j] = j < d ? widen(src[j]) : 0.f;
          if (j < d) s = fmaf(v[j], v[j], s);
        }
        v[7] = s;
        c4[2 * c] = make_float4(v[0], v[1], v[2], v[3]);
        c4[2 * c + 1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  };
  stage(0);
  float x[R][DX], xn[R], best[R], second[R];
  int a[R], z[R];
  const bool whole = vec && row0 + R <= n;
  bool loaded = false;
  if constexpr (D == 2) {
    if (whole) {
      const uint4* src = reinterpret_cast<const uint4*>(points + row0 * 2);
      if constexpr (std::is_same<T, float>::value) {   // two rows a unit
#pragma unroll
        for (int i = 0; i < R / 2; ++i) {
          const uint4 w = src[i];
          x[2 * i][0] = __uint_as_float(w.x);
          x[2 * i][1] = __uint_as_float(w.y);
          x[2 * i + 1][0] = __uint_as_float(w.z);
          x[2 * i + 1][1] = __uint_as_float(w.w);
        }
      } else {   // four rows a unit; a bf16 value widens as its bits << 16
#pragma unroll
        for (int i = 0; i < R / 4; ++i) {
          const uint4 w = src[i];
          const unsigned h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[4 * i + e][0] = __uint_as_float(h[e] << 16);
            x[4 * i + e][1] = __uint_as_float(h[e] & 0xffff0000u);
          }
        }
      }
      const float4* nsrc = reinterpret_cast<const float4*>(norms + row0);
#pragma unroll
      for (int i = 0; i < R / 4; ++i) {
        const float4 w = nsrc[i];
        xn[4 * i] = w.x, xn[4 * i + 1] = w.y, xn[4 * i + 2] = w.z,
        xn[4 * i + 3] = w.w;
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const bool ok = row0 + q < n;
#pragma unroll
      for (int j = 0; j < DX; ++j)
        x[q][j] = ok && j < d ? widen(points[(row0 + q) * d + j]) : 0.f;
      xn[q] = ok ? norms[row0 + q] : 0.f;
    }
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    best[q] = second[q] = CUDART_INF_F;
    a[q] = 0;
    z[q] = -1;
  }
  // fp32 streams fold the values before the clamp at 0 and clamp after
  // (below); bf16 streams, whose rows' fp32 norms leave many values at or
  // below 0, clamp each value as the template does
  constexpr bool kLate = std::is_same<T, float>::value;
  const auto d2 = [&](int q, const float4& lo, const float4& hi) {
    if constexpr (D == 2)
      return raw_d2<2>([&](int j) { return x[q][j]; },
                       [&](int j) { return j ? lo.y : lo.x; }, 2, xn[q],
                       lo.z);
    else
      return narrow_raw_d2(x[q], lo, hi, d, xn[q]);
  };
  const auto cent = [&](int c, float4& lo, float4& hi) {
    lo = c4[kV * c];
    hi = kV == 2 ? c4[kV * c + 1] : lo;
  };
  for (int c0 = 0; c0 < k; c0 += kc) {
    if (c0 > 0) {
      __syncthreads();   // the last chunk's reads are done
      stage(c0);
    }
    __syncthreads();     // the staged chunk
    const int nc = min(kc, k - c0);
    for (int c = 0; c < nc; ++c) {
      float4 lo, hi;
      cent(c, lo, hi);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const float v = kLate ? d2(q, lo, hi) : nan_max(d2(q, lo, hi), 0.f);
        if constexpr (Second) {
          fold(v, c0 + c, best[q], second[q], a[q]);
        } else if (v < best[q]) {
          best[q] = v;
          a[q] = c0 + c;
        }
      }
    }
    // The clamp at 0, after the fold (fp32). Where the least value is
    // above 0, every value is (or NaN), the clamp changes none, and the
    // fold on the unclamped values picked the template's label and D².
    // Otherwise the template's D² is +0 and its label the first centroid
    // whose value is at most 0 (clamped to +0, which no later value
    // beats): it lies in the chunk where the best first fell to 0 or
    // below, and is found again there (rare with the stream's own norms: a
    // row on a centroid). The template's second is the clamped second.
    if constexpr (kLate) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (z[q] < 0 && best[q] <= 0.f) {
          int c = 0;
          float4 lo, hi;
          for (;; ++c) {
            cent(c, lo, hi);
            if (d2(q, lo, hi) <= 0.f) break;
          }
          z[q] = c0 + c;
        }
    }
  }
  if constexpr (kLate) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (z[q] >= 0) {
        a[q] = z[q];
        best[q] = 0.f;
      }
      if (Second && !(second[q] > 0.f)) second[q] = 0.f;
    }
  }
  if (whole) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      reinterpret_cast<int4*>(labels + row0)[i] =
          make_int4(a[4 * i], a[4 * i + 1], a[4 * i + 2], a[4 * i + 3]);
      reinterpret_cast<float4*>(md + row0)[i] = make_float4(
          best[4 * i], best[4 * i + 1], best[4 * i + 2], best[4 * i + 3]);
      if constexpr (Second)
        reinterpret_cast<float4*>(lbo + row0)[i] = make_float4(
            sqrtf(second[4 * i]), sqrtf(second[4 * i + 1]),
            sqrtf(second[4 * i + 2]), sqrtf(second[4 * i + 3]));
    }
  } else {
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (row0 + q < n) {
        labels[row0 + q] = a[q];
        md[row0 + q] = best[q];
        if constexpr (Second) lbo[row0 + q] = sqrtf(second[q]);
      }
  }
}

// The row pass past the narrow widths (rows the screen does not take and
// wider than kNarrow: fp32 d > 128, bf16 d > 256): one row a thread,
// exact_d2 and fold over every centroid in ascending order with the row read
// from device memory, the template's runtime-d loop; the centroids and their
// cn staged kc at a time (stage_centroids, the template's arithmetic), the
// row's best, second and label held in registers from chunk to chunk.
// Writes labels, D² and (Second) lbo = sqrt(second); the problem index as
// untiled_row_kernel's.
template <typename T, bool Second>
__global__ void __launch_bounds__(kRowThreads, 4)
wide_row_kernel(const T* __restrict__ points, const float* __restrict__ norms,
                const T* __restrict__ cents, int* __restrict__ labels,
                float* __restrict__ md, float* __restrict__ lbo, int n,
                int d, int k, int kc, int bpp) {
  extern __shared__ float smem[];
  float* c_sh = smem;                                   // (kc, d)
  float* cn_sh = c_sh + (size_t)kc * d;                 // (kc,), or (k,)
  const int b = blockIdx.x / bpp;
  points += (size_t)b * n * d;
  norms += (size_t)b * n;
  cents += (size_t)b * k * d;
  const long long row =
      (long long)(blockIdx.x - b * bpp) * kRowThreads + threadIdx.x;
  const bool ok = row < n;
  const T* x = points + (ok ? row : 0) * d;
  const float xn = ok ? norms[row] : 0.f;
  float best = CUDART_INF_F, second = CUDART_INF_F;
  int a = 0;
  if (kc == 0) {   // the centroids from device memory, their norms staged
    centroid_norms(cents, cn_sh, k, d);
    __syncthreads();
    for (int c = 0; ok && c < k; ++c) {
      const T* cg = cents + (size_t)c * d;
      fold(exact_d2<0>([&](int j) { return widen(x[j]); },
                       [&](int j) { return widen(cg[j]); }, d, xn, cn_sh[c]),
           c, best, second, a);
    }
  }
  for (int c0 = 0; c0 < (kc > 0 ? k : 0); c0 += kc) {
    if (c0 > 0) __syncthreads();   // the last chunk's reads are done
    const int nc = min(kc, k - c0);
    stage_centroids(cents, c_sh, cn_sh, c0, nc, d);
    __syncthreads();
    if (!ok) continue;
    for (int c = 0; c < nc; ++c) {
      const float* cc = c_sh + (size_t)c * d;
      fold(exact_d2<0>([&](int j) { return widen(x[j]); },
                       [&](int j) { return cc[j]; }, d, xn, cn_sh[c]),
           c0 + c, best, second, a);
    }
  }
  if (!ok) return;
  labels[(size_t)b * n + row] = a;
  md[(size_t)b * n + row] = best;
  if constexpr (Second) lbo[(size_t)b * n + row] = sqrtf(second);
}

// the row pass's centroids a chunk: all k where their staging (16 bytes a
// centroid at d = 2, 32 below d = 8, 4 (d + 1) past) fits kRowBudget, else
// the most that do (one at least where one fits a block: a wide row's block
// takes what it needs); 0 where not one does (the centroids then read from
// device memory, their k norms staged).
inline int row_k_chunk(int d, int k) {
  const long long per = d == 2 ? 16 : d <= kNarrow ? 32 : 4LL * (d + 1);
  if (per > 232448) return 0;
  return min(k, max(1, (int)(kRowBudget / per)));
}

// The row pass over `batch` problems of n rows: K4 and K9 (Second false),
// K3 and K10a (Second: lbo too), at every width the screen does not take.
// At d = 2 8 rows a thread where that still gives every SM four blocks, else
// 4 (fit_minibatch's 262,144-row batches: 512 blocks); other d < 8, 4; past
// kNarrow, one (wide_row_kernel). Returns the first CUDA error.
template <typename T, bool Second>
int launch_rows(const T* points, const float* norms, const T* cents,
                int* labels, float* md, float* lbo, int batch, int n, int d,
                int k, cudaStream_t s) {
  const bool vec = (reinterpret_cast<uintptr_t>(points)
                    | reinterpret_cast<uintptr_t>(norms)
                    | reinterpret_cast<uintptr_t>(labels)
                    | reinterpret_cast<uintptr_t>(md)
                    | reinterpret_cast<uintptr_t>(lbo)) % 16 == 0;
  const int kc = row_k_chunk(d, k);
  const size_t smem =
      kc > 0 ? (size_t)(d == 2 ? 16 : d <= kNarrow ? 32 : 4 * (d + 1)) * kc
             : sizeof(float) * (size_t)k;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const auto blocks = [&](int rows) {
    const long long per = (long long)rows * kRowThreads;
    return ((long long)n + per - 1) / per;
  };
  const auto run = [&](auto kernel, int rows) -> int {
    const long long bpp = blocks(rows);
    if (bpp * batch > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kernel<<<(unsigned)(bpp * batch), kRowThreads, smem, s>>>(
        points, norms, cents, labels, md, lbo, n, d, k, kc, (int)vec,
        (int)bpp);
    return (int)cudaGetLastError();
  };
  if (d == 2) {
    if (blocks(8) * batch >= 4LL * sm_count())
      return run(untiled_row_kernel<T, 2, 8, Second>, 8);
    return run(untiled_row_kernel<T, 2, 4, Second>, 4);
  }
  if (d >= 1 && d <= kNarrow)
    return run(untiled_row_kernel<T, 0, 4, Second>, 4);
  const long long bpp = blocks(1);
  if (bpp * batch > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  cudaFuncSetAttribute(wide_row_kernel<T, Second>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  wide_row_kernel<T, Second><<<(unsigned)(bpp * batch), kRowThreads, smem,
                               s>>>(points, norms, cents, labels, md, lbo, n,
                                    d, k, kc, (int)bpp);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool Gated, bool Untiled>
int launch_assign(const T* points, const float* norms, const T* cents,
                  const float* weights, int* labels, float* md,
                  float* partials, float* gaps, float* tile_acc,
                  const Gate& g, int batch, int n, int d, int k, int block_n,
                  int cols, cudaStream_t s) {
  const unsigned grid = (unsigned)batch * ((n + block_n - 1) / block_n);
  const size_t smem = sizeof(float) * ((size_t)k * d + k + 2 * kThreads +
                                       (size_t)kWarps * k * cols + block_n +
                                       (Gated ? k : 0));
  cudaFuncSetAttribute(assign_tile_kernel<T, D, Gated, Untiled>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  assign_tile_kernel<T, D, Gated, Untiled><<<grid, kThreads, smem, s>>>(
      points, norms, cents, weights, labels, md, partials, gaps, tile_acc, g,
      n, d, k, block_n, cols);
  return (int)cudaGetLastError();
}

// The template: assign_tile_kernel, then the super reduce. Untiled (K4 / K9)
// takes null partials and gaps and `tps` = n_tiles: one super spanning every
// tile. `cols` columns of 8 warp-private (k, cols) accumulators must fit the
// shared memory next to the whole (k, d) centroid block
// (ops.assign_smem_bytes).
template <typename T, bool Gated, bool Untiled>
int launch_round(const T* points, const float* norms, const T* cents,
                 const float* weights, int* labels, float* md,
                 float* partials, float* gaps, float* tile_acc, float* ssums,
                 float* scounts, const Gate& g, int batch, int n, int d,
                 int k, int block_n, int tps, int cols, cudaStream_t s) {
  const int n_tiles = (n + block_n - 1) / block_n;
  if ((long long)batch * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const int err =
      d == 2 ? launch_assign<T, 2, Gated, Untiled>(
                   points, norms, cents, weights, labels, md, partials, gaps,
                   tile_acc, g, batch, n, d, k, block_n, cols, s)
      : d == 16
          ? launch_assign<T, 16, Gated, Untiled>(
                points, norms, cents, weights, labels, md, partials, gaps,
                tile_acc, g, batch, n, d, k, block_n, cols, s)
          : launch_assign<T, 0, Gated, Untiled>(
                points, norms, cents, weights, labels, md, partials, gaps,
                tile_acc, g, batch, n, d, k, block_n, cols, s);
  if (err != 0) return err;
  return launch_super_reduce(tile_acc, ssums, scounts,
                             Gated ? g.active : nullptr,
                             Gated ? g.prev_ssums : nullptr,
                             Gated ? g.prev_scounts : nullptr, batch, n_tiles,
                             d, k, tps, s);
}

// The stream type is the caller's: bf16 != 0 reads points and cents as
// __nv_bfloat16, else as float.
template <bool Gated, bool Untiled>
int dispatch(const void* points, const float* norms, const void* cents,
             const float* weights, int* labels, float* md, float* partials,
             float* gaps, float* tile_acc, float* ssums, float* scounts,
             const Gate& g, int batch, int n, int d, int k, int block_n,
             int tps, int cols, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_round<__nv_bfloat16, Gated, Untiled>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), weights, labels, md,
        partials, gaps, tile_acc, ssums, scounts, g, batch, n, d, k, block_n,
        tps, cols, s);
  return launch_round<float, Gated, Untiled>(
      static_cast<const float*>(points), norms,
      static_cast<const float*>(cents), weights, labels, md, partials, gaps,
      tile_acc, ssums, scounts, g, batch, n, d, k, block_n, tps, cols, s);
}

// The assignment rounds, and their routes on the card: the one rule, read
// by the launches below and, through lloyd_assign_route, by the wrappers.
enum Round { kK3 = 0, kK6 = 1, kK4 = 2, kK10a = 3, kK10b = 4, kK9 = 5 };
enum Route { kTemplate = 0, kScreened = 1, kRowPass = 2, kSplit = 3 };

// The screened route where screen::screened(d, bf16); at every other width
// (d < 8, and rows past the screened widths) the split row pass for the
// gated rounds (K6, K10b) and the row pass for the others (K3, K4, K9,
// K10a). No round takes the template: it stays reachable through the
// *_template entries alone.
inline Route route_of(int round, int d, bool bf16) {
  if (screen::screened(d, bf16)) return kScreened;
  return round == kK6 || round == kK10b ? kSplit : kRowPass;
}

// The most centroids a route takes at width d: the screened route's 16-bit
// candidate index; the row passes any where one centroid row fits a block
// (both stage their centroids in chunks), else as many as their norms fit
// (the centroids read from device memory).
inline int route_max_k(Route r, int d) {
  switch (r) {
    case kScreened: return screen::kMaxK;
    case kRowPass: return 4LL * (d + 1) <= 232448 ? 0x7fffffff : 232448 / 4;
    case kSplit:
      return split_k_chunk(d, 1) >= 1
                 ? 0x7fffffff
                 : (232448 - 2 * 4 * kRowThreads * 4) / 4;
    default: return -1;
  }
}

// The row pass with the second best into lbo (K3, K10a), then pass B's
// tiled instance and the super reduce, over `batch` problems. Returns the
// first CUDA error.
template <typename T>
int launch_rows_tiled(const T* points, const float* norms, const T* cents,
                      int* labels, float* md, float* lbo, float* partials,
                      float* gaps, float* tile_acc, float* ssums,
                      float* scounts, int batch, int n, int d, int k,
                      int block_n, int tps, int kchunk, cudaStream_t s) {
  if (lbo == nullptr) return (int)cudaErrorInvalidValue;
  const int err = launch_rows<T, true>(points, norms, cents, labels, md, lbo,
                                       batch, n, d, k, s);
  if (err != 0) return err;
  return screen::launch_reduce<T, false>(points, nullptr, labels, md, lbo,
                                         Gate{}, partials, gaps, tile_acc,
                                         ssums, scounts, batch, n, d, k,
                                         block_n, tps, kchunk, s);
}

// The batched rounds (K10a, K10b) by route_of: the screened route, else
// the row pass (K10a: lbo, the caller's (batch, n) scratch, required) or
// the split row pass (K10b); cn_g as screen::launch's.
template <bool Gated>
int dispatch_batched(const void* points, const float* norms,
                     const void* cents, int* labels, float* md, float* lbo,
                     float* partials, float* gaps, float* tile_acc,
                     float* ssums, float* scounts, const Gate& g,
                     unsigned long long* stats, float* cn_g, int batch, int n,
                     int d, int k, int block_n, int tps, int kchunk,
                     int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto* p, auto* c) -> int {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(p)>>;
    if (route_of(Gated ? kK10b : kK10a, d, bf16 != 0) != kScreened) {
      if constexpr (Gated)
        return launch_split<T>(p, norms, c, labels, md, partials, gaps,
                               tile_acc, ssums, scounts, g, batch, n, d, k,
                               block_n, tps, kchunk, s);
      else
        return launch_rows_tiled<T>(p, norms, c, labels, md, lbo, partials,
                                    gaps, tile_acc, ssums, scounts, batch, n,
                                    d, k, block_n, tps, kchunk, s);
    }
    if ((!Gated && lbo == nullptr) || stats == nullptr)
      return (int)cudaErrorInvalidValue;
    return screen::launch<T, Gated>(p, norms, c, nullptr, labels, md, lbo,
                                    partials, gaps, tile_acc, ssums, scounts,
                                    g, stats, cn_g, batch, n, d, k, block_n,
                                    tps, kchunk, s);
  };
  if (bf16)
    return go(static_cast<const __nv_bfloat16*>(points),
              static_cast<const __nv_bfloat16*>(cents));
  return go(static_cast<const float*>(points),
            static_cast<const float*>(cents));
}

// K3 by route_of: the screened route (pass A on K6's persistent grid, lbo
// the caller's (n,) scratch for sqrt(second), stats required, cn_g as
// screen::launch's), else the row pass with the second best into lbo; each
// then pass B's tiled instance and the super reduce. Returns the first CUDA
// error.
template <typename T>
int launch_tiled(const T* points, const float* norms, const T* cents,
                 int* labels, float* md, float* lbo, float* partials,
                 float* gaps, float* tile_acc, float* ssums, float* scounts,
                 unsigned long long* stats, float* cn_g, int n, int d, int k,
                 int block_n, int tps, int kchunk, cudaStream_t s) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  if (route_of(kK3, d, kBf16) == kScreened) {
    if (lbo == nullptr || stats == nullptr) return (int)cudaErrorInvalidValue;
    return screen::launch<T, false>(points, norms, cents, nullptr, labels,
                                    md, lbo, partials, gaps, tile_acc, ssums,
                                    scounts, Gate{}, stats, cn_g, 1, n, d, k,
                                    block_n, tps, kchunk, s);
  }
  return launch_rows_tiled<T>(points, norms, cents, labels, md, lbo, partials,
                              gaps, tile_acc, ssums, scounts, 1, n, d, k,
                              block_n, tps, kchunk, s);
}

// K4 (round kK4, batch 1; weights may be null) and K9 (kK9, batch B, no
// weights) by route_of: the screened route (stats required, cn_g as
// screen::launch's) or the row pass, each then pass B's untiled instance
// and the all-tile reduce. Returns the first CUDA error.
template <typename T>
int launch_untiled(int round, const T* points, const float* norms,
                   const T* cents, const float* weights, int* labels,
                   float* md, float* tile_acc, float* sums, float* counts,
                   unsigned long long* stats, float* cn_g, int batch, int n,
                   int d, int k, int block_n, int kchunk, cudaStream_t s) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const int n_tiles = (n + block_n - 1) / block_n;
  if ((long long)batch * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  if (route_of(round, d, kBf16) == kScreened) {
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    return screen::launch<T, false, true>(
        points, norms, cents, weights, labels, md, nullptr, nullptr, nullptr,
        tile_acc, sums, counts, Gate{}, stats, cn_g, batch, n, d, k, block_n,
        n_tiles, kchunk, s);
  }
  const int err = launch_rows<T, false>(points, norms, cents, labels, md,
                                        nullptr, batch, n, d, k, s);
  if (err != 0) return err;
  return screen::launch_reduce<T, false, true>(
      points, weights, labels, md, nullptr, Gate{}, nullptr, nullptr,
      tile_acc, sums, counts, batch, n, d, k, block_n, n_tiles, kchunk, s);
}

// K4 and K9 on the caller's stream type, as dispatch
int dispatch_untiled(int round, const void* points, const float* norms,
                     const void* cents, const float* weights, int* labels,
                     float* md, float* tile_acc, float* sums, float* counts,
                     unsigned long long* stats, float* cn_g, int batch, int n,
                     int d, int k, int block_n, int kchunk, int bf16,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_untiled<__nv_bfloat16>(
        round, static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), weights, labels, md,
        tile_acc, sums, counts, stats, cn_g, batch, n, d, k, block_n, kchunk,
        s);
  return launch_untiled<float>(round, static_cast<const float*>(points),
                               norms, static_cast<const float*>(cents),
                               weights, labels, md, tile_acc, sums, counts,
                               stats, cn_g, batch, n, d, k, block_n, kchunk,
                               s);
}

}  // namespace

// Every entry point takes `bf16`: 0 for fp32 points and cents, 1 for the
// bf16 stream (both of one type; norms, weights and all else fp32). The
// rounds' entries take `kchunk`: kchunk > 0 caps pass B's centroids a block
// (a test hook: the bits do not depend on it; 0, which the engine passes,
// is pass B's own choice, screen::reduce_k_chunk); the template entries
// take `cols`, the template's columns a pass, instead. On the screened
// route the rounds take cn_scratch, (B, k) floats (B = 1 for one problem),
// where pass A writes every centroid's norm past k = 256 (not read at
// k <= 256).

// The card route of assignment round `round` (0 K3, 1 K6, 2 K4, 3 K10a,
// 4 K10b, 5 K9) at width d on the stream (bf16 != 0: bf16): 1 the screened
// route, 2 the row pass (K3, K4, K9, K10a), 3 the split row pass (K6,
// K10b); 0, the template, is no round's. *max_k gets the most centroids
// the route takes.
extern "C" int lloyd_assign_route(int round, int d, int bf16, int* max_k) {
  const Route r = route_of(round, d, bf16 != 0);
  *max_k = route_max_k(r, d);
  return (int)r;
}

// One tiled assignment round (K3) on `stream`, by lloyd_assign_route;
// returns the first CUDA error. lb_scratch (n,) floats is required, stats
// (4) as K10a's on the screened route.
extern "C" int lloyd_assign_tiled_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, float* lb_scratch, unsigned long long* stats,
    float* cn_scratch, int n, int d, int k, int block_n, int tps, int kchunk,
    int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_tiled<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), labels, md, lb_scratch,
        partials, gaps, tile_acc, ssums, scounts, stats, cn_scratch, n, d, k,
        block_n, tps, kchunk, s);
  return launch_tiled<float>(static_cast<const float*>(points), norms,
                             static_cast<const float*>(cents), labels, md,
                             lb_scratch, partials, gaps, tile_acc, ssums,
                             scounts, stats, cn_scratch, n, d, k, block_n,
                             tps, kchunk, s);
}

// The template's ungated instance (assign_tile_kernel, then
// super_reduce_kernel: K3's route before the screened route and the row
// pass), at any d whose staging fits `cols`: the reference the card tests
// and the smoke script hold K3 to, bit for bit. The engine never calls it.
// The arguments are K3's without lb_scratch, stats, cn_scratch and kchunk.
extern "C" int lloyd_assign_tiled_template_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int n, int d, int k, int block_n, int tps, int cols,
    int bf16, void* stream) {
  return dispatch<false, false>(points, norms, cents, nullptr, labels, md,
                                partials, gaps, tile_acc, ssums, scounts,
                                Gate{}, 1, n, d, k, block_n, tps, cols, bf16,
                                stream);
}

// Launches both kernels of one assignment round of `batch` problems (K10a)
// on `stream`; returns cudaGetLastError(). Every array carries a leading
// problem axis: points (batch, n, d), cents (batch, k, d), labels / md
// (batch, n), partials / gaps (batch, n_tiles), tile_acc
// (batch, n_tiles, k, d + 1), ssums (batch, n_super, k, d), scounts
// (batch, n_super, k). lb_scratch (batch, n) floats is required; on the
// screened route cn_scratch (batch, k) floats and stats (4) unsigned 64-bit
// counters (screened rows, their candidates, the most of one row, rows on
// the full scan; added to, the caller zeroes them) are too; elsewhere they
// are not read.
extern "C" int lloyd_assign_tiled_batched_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, float* lb_scratch, unsigned long long* stats,
    float* cn_scratch, int batch, int n, int d, int k, int block_n, int tps,
    int kchunk, int bf16, void* stream) {
  return dispatch_batched<false>(points, norms, cents, labels, md,
                                 lb_scratch, partials, gaps, tile_acc, ssums,
                                 scounts, Gate{}, stats, cn_scratch, batch, n,
                                 d, k, block_n, tps, kchunk, bf16, stream);
}

// 1 where K6, K10a, K10b, K3, K4 and K9 take the screened route for width d
// and the stream (bf16 != 0: bf16), else 0.
extern "C" int lloyd_assign_screened(int d, int bf16) {
  return screen::screened(d, bf16 != 0) ? 1 : 0;
}

// One gated assignment round (K6) on `stream`, by lloyd_assign_route: the
// screened route (stats (4) as K10a's and cn_scratch (k,) required there),
// else the split row pass. Returns the first CUDA error. Every output is
// written: labels, md and lb (n,), partials, gaps and pruned (n_tiles,),
// ssums and scounts as K3's, a skipped tile or super copying the carries
// prev_* (the inputs of the same shapes); pruned must be zeros. `active`
// must be super-aligned.
extern "C" int lloyd_assign_gated_launch(
    const void* points, const float* norms, const void* cents,
    const float* delta, const float* thresh, const float* absorb,
    const int* prev_a, const float* prev_md, const float* prev_lb,
    const float* prev_partials, const float* prev_gaps,
    const float* prev_ssums, const float* prev_scounts,
    const unsigned char* active, int* labels, float* md, float* lb,
    float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int* pruned, unsigned long long* stats,
    float* cn_scratch, int n, int d, int k, int block_n, int tps, int kchunk,
    int bf16, void* stream) {
  const Gate g{delta,  thresh, absorb,        prev_a,    prev_md,
               prev_lb, active, lb,           pruned,    prev_partials,
               prev_gaps, prev_ssums, prev_scounts};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route_of(kK6, d, bf16 != 0) == kScreened) {
    if (stats == nullptr) return (int)cudaErrorInvalidValue;
    if (bf16)
      return screen::launch<__nv_bfloat16, true>(
          static_cast<const __nv_bfloat16*>(points), norms,
          static_cast<const __nv_bfloat16*>(cents), nullptr, labels, md,
          nullptr, partials, gaps, tile_acc, ssums, scounts, g, stats,
          cn_scratch, 1, n, d, k, block_n, tps, kchunk, s);
    return screen::launch<float, true>(
        static_cast<const float*>(points), norms,
        static_cast<const float*>(cents), nullptr, labels, md, nullptr,
        partials, gaps, tile_acc, ssums, scounts, g, stats, cn_scratch, 1, n,
        d, k, block_n, tps, kchunk, s);
  }
  if (bf16)
    return launch_split<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), labels, md, partials, gaps,
        tile_acc, ssums, scounts, g, 1, n, d, k, block_n, tps, kchunk, s);
  return launch_split<float>(static_cast<const float*>(points), norms,
                             static_cast<const float*>(cents), labels, md,
                             partials, gaps, tile_acc, ssums, scounts, g, 1,
                             n, d, k, block_n, tps, kchunk, s);
}

// The template's gated instance (assign_tile_kernel, as K6 ran before the
// screened and split routes), at any d whose staging fits `cols`: the
// reference the card tests and the smoke script hold K6 to, bit for bit.
// The engine never calls it. The arguments are K6's without stats,
// cn_scratch and kchunk, with `cols`.
extern "C" int lloyd_assign_gated_template_launch(
    const void* points, const float* norms, const void* cents,
    const float* delta, const float* thresh, const float* absorb,
    const int* prev_a, const float* prev_md, const float* prev_lb,
    const float* prev_partials, const float* prev_gaps,
    const float* prev_ssums, const float* prev_scounts,
    const unsigned char* active, int* labels, float* md, float* lb,
    float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int* pruned, int n, int d, int k, int block_n, int tps,
    int cols, int bf16, void* stream) {
  const Gate g{delta,  thresh, absorb,        prev_a,    prev_md,
               prev_lb, active, lb,           pruned,    prev_partials,
               prev_gaps, prev_ssums, prev_scounts};
  return dispatch<true, false>(points, norms, cents, nullptr, labels, md,
                               partials, gaps, tile_acc, ssums, scounts, g, 1,
                               n, d, k, block_n, tps, cols, bf16, stream);
}

// Launches both kernels of one gated assignment round of `batch` problems
// (K10b) on `stream`; returns cudaGetLastError(). Every array carries a
// leading problem axis: K10a's, plus delta (batch, k), thresh / absorb /
// active / pruned (batch, n_tiles), prev_a / prev_md / prev_lb / lb
// (batch, n), and the carries prev_partials / prev_gaps / prev_ssums /
// prev_scounts of the outputs' shapes. As for K6, every output is written
// (a skipped tile or super copying the carries), pruned must be zeros and
// `active` must be super-aligned in every problem. stats and cn_scratch as
// K10a's (required on the screened route). Off it, K6's split row pass with
// a problem index.
extern "C" int lloyd_assign_gated_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* delta, const float* thresh, const float* absorb,
    const int* prev_a, const float* prev_md, const float* prev_lb,
    const float* prev_partials, const float* prev_gaps,
    const float* prev_ssums, const float* prev_scounts,
    const unsigned char* active, int* labels, float* md, float* lb,
    float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int* pruned, unsigned long long* stats,
    float* cn_scratch, int batch, int n, int d, int k, int block_n, int tps,
    int kchunk, int bf16, void* stream) {
  const Gate g{delta,  thresh, absorb,        prev_a,    prev_md,
               prev_lb, active, lb,           pruned,    prev_partials,
               prev_gaps, prev_ssums, prev_scounts};
  return dispatch_batched<true>(points, norms, cents, labels, md, nullptr,
                                partials, gaps, tile_acc, ssums, scounts, g,
                                stats, cn_scratch, batch, n, d, k, block_n,
                                tps, kchunk, bf16, stream);
}

// One untiled assignment round (K4) on `stream`, by lloyd_assign_route: the
// screened route (stats (4) as K10a's and cn_scratch (k,) required there)
// or the row pass, each then pass B and the all-tile reduce. Returns the
// first CUDA error. `weights` (n,) may be null
// (every row weighs 1). sums (k, d) and counts (k,) are over all rows;
// tile_acc is (n_tiles, k, d + 1) scratch.
extern "C" int lloyd_assign_launch(const void* points, const float* norms,
                                   const void* cents, const float* weights,
                                   int* labels, float* md, float* tile_acc,
                                   float* sums, float* counts,
                                   unsigned long long* stats,
                                   float* cn_scratch, int n, int d, int k,
                                   int block_n, int kchunk, int bf16,
                                   void* stream) {
  return dispatch_untiled(kK4, points, norms, cents, weights, labels, md,
                          tile_acc, sums, counts, stats, cn_scratch, 1, n, d,
                          k, block_n, kchunk, bf16, stream);
}

// One untiled assignment round of `batch` problems (K9) on `stream`, by
// lloyd_assign_route: the screened route (stats and cn_scratch (batch, k)
// required), else the row pass with a problem index; each then pass B and
// the all-tile reduce. Returns the first CUDA error. Every array
// carries a leading problem axis: points (batch, n, d), norms / labels /
// md (batch, n), cents and sums (batch, k, d), counts (batch, k), tile_acc
// (batch, n_tiles, k, d + 1).
extern "C" int lloyd_assign_batched_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* tile_acc, float* sums, float* counts,
    unsigned long long* stats, float* cn_scratch, int batch, int n, int d,
    int k, int block_n, int kchunk, int bf16, void* stream) {
  return dispatch_untiled(kK9, points, norms, cents, nullptr, labels, md,
                          tile_acc, sums, counts, stats, cn_scratch, batch, n,
                          d, k, block_n, kchunk, bf16, stream);
}

// The template's untiled instance (assign_tile_kernel with Untiled = true,
// then super_reduce_kernel with one super: K4's route before the screened
// route and the row pass), at any d whose staging fits `cols`: the
// reference the card tests and the smoke script hold K4 to, bit for bit.
// The engine never calls it. The arguments are K4's, without stats,
// cn_scratch and kchunk.
extern "C" int lloyd_assign_template_launch(
    const void* points, const float* norms, const void* cents,
    const float* weights, int* labels, float* md, float* tile_acc,
    float* sums, float* counts, int n, int d, int k, int block_n, int cols,
    int bf16, void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  return dispatch<false, true>(points, norms, cents, weights, labels, md,
                               nullptr, nullptr, tile_acc, sums, counts,
                               Gate{}, 1, n, d, k, block_n, n_tiles, cols,
                               bf16, stream);
}

// The template's untiled instance over `batch` problems (K9's route before
// the screened route), as lloyd_assign_template_launch is to K4: the
// arguments of lloyd_assign_batched_launch without stats, cn_scratch and
// kchunk.
extern "C" int lloyd_assign_batched_template_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* tile_acc, float* sums, float* counts, int batch, int n,
    int d, int k, int block_n, int cols, int bf16, void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  return dispatch<false, true>(points, norms, cents, nullptr, labels, md,
                               nullptr, nullptr, tile_acc, sums, counts,
                               Gate{}, batch, n, d, k, block_n, n_tiles, cols,
                               bf16, stream);
}

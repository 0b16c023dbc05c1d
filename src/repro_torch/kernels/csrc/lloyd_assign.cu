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
// atomics anywhere. Two kernels, launched back to back on one stream:
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
// other row writes lb = sqrt(second best). The full grid is launched; a
// block whose tile is inactive exits at once, and super_reduce_kernel skips
// a super with no active tile. All outputs start as copies of the carries
// (the wrapper makes them), so skipped tiles and supers keep their carried
// values, which is what the TPU kernel's input_output_aliases did. K6 is the
// same template as K3: an all-active launch in which nothing prunes is
// bitwise K3. At d = 2 four rows share a pass over the centroids, so the
// pass is skipped only when all four of a thread's rows prune.
//
// K10a replaces lloyd_assign.py::lloyd_assign_tiled_batched_pallas (its
// pallas_call at line 544): K3 over B independent problems in one launch of
// each kernel. The grids are B * n_tiles and B * n_super blocks along x,
// block i taking tile (super) i % n_tiles (n_super) of problem i / n_tiles
// (n_super), its pointers offset to that problem's points, norms,
// centroids, labels, D², partials, gaps, tile scratch and super sums; then
// it runs K3's code unchanged, with the same `cols` (a function of d, k and
// block_n only), so row b is bitwise K3 on problem b. K3 and K6 are the
// launches with B = 1. At the PQ codebook sweep (B = 1664, n = 16384,
// d = 16, k = 256) the distance arithmetic is 2.4e11 flops a round, 3.6 ms
// at the fp32 rate, against 1.9 GB of traffic (0.57 ms): operation-bound.
// There d = 16 is compiled like d = 2, the row in registers and four rows
// to a pass over the centroids: the runtime-d loop re-reads each row from
// memory for every centroid and took ten times as long on the H100
// (PERF.md, the TPU kernel table).
// The fused multiply-adds are the same, in the same order, so K3's bits at
// d = 16 do not change.
//
// K10b replaces lloyd_assign.py::lloyd_assign_gated_batched_pallas (its
// pallas_call at line 666): K6 over B independent problems in one launch of
// each kernel, each problem with its own gate. It is K10a's grids on K6's
// code: besides K10a's pointers every gate array is offset to its problem,
// delta by b*k, thresh, absorb, the active mask and pruned by b*n_tiles, and
// the carried labels, D² and lower bounds and the lower bounds out by b*n;
// super_reduce_kernel reads its problem's mask. The TPU kernel visited
// each problem's compacted list of super-aligned active tiles; here the full
// grids are launched and read the (B, n_tiles) mask, so a block of a tile
// (or a super) inactive in its problem exits at once and its carries stay.
// Row b is then K6 on problem b, bitwise; K6 is the launch with B = 1. At
// the PQ codebook sweep with every tile active and nothing pruned its
// operation bound is K10a's, 3.65 ms; the d = 16 register path serves it as
// it serves K10a.
// K4 replaces lloyd_assign.py::lloyd_assign_pallas (its pallas_call at line
// 111): labels and D² per row, and the cluster sums and counts over ALL rows,
// (k, d) and (k,), with no per-tile partials or gaps. The TPU kernel folded
// each tile's one-hot product into one resident accumulator, tile after
// tile. Here it is K3's template with the partials and gaps compiled out
// (Untiled = true) and one super spanning every tile: assign_tile_kernel
// writes each tile's sums into the scratch array as for K3, and
// super_reduce_kernel, one block, adds them in ascending tile order, the
// TPU's order. So labels and D² are K3's bits, and no float atomics set
// the sums. A weighted fit passes one weight per row: the row enters the
// sums as w·x and its count as w, on the same fixed tree. This fuses the
// reference's segment_update, which recomputes the sums with the weights
// after the TPU kernel. What bounds it on the H100: bytes, as K3 (80 MB at
// n = 4M, d = 2, about 24 us), the weights adding 4 bytes a row; the
// reduce over tiles is one block's loop over n_tiles, a few tens of us at
// the paper's shape.
//
// K9 replaces lloyd_assign.py::lloyd_assign_batched_pallas (its pallas_call
// at line 201): K4 over B independent problems, as K10a is to K3. Both
// grids are B blocks wide per tile (per problem for the reduce); block i
// takes tile i % n_tiles of problem i / n_tiles, its pointers offset to that
// problem, and the reduce's block b adds problem b's tiles. Row b is K4 on
// problem b, bitwise. It takes no weights, as the reference's batched
// problems take none. At the PQ codebook sweep (B = 1664, n = 16384,
// d = 16, k = 256) its operation bound is K10a's, 3.65 ms.
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
// d = 2 moves 16 B instead of 20); K10a and K10b at the sweep stay bound by
// their fp32 arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

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

// Folds centroid c's d2 into a row's (best, second, label).
__device__ __forceinline__ void fold(float d2, int c, float& best,
                                     float& second, int& a) {
  if (d2 < best) {
    second = best;
    best = d2;
    a = c;
  } else if (d2 < second) {
    second = d2;
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
};

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
    if (!g.active[t]) return;  // skipped: carries stay
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
        for (int q = 0; q < R; ++q) {
          float dt = 0.f;
#pragma unroll
          for (int j = 0; j < D; ++j) dt = fmaf(xr[q][j], cr[j], dt);
          fold(nan_max(xn[q] - 2.f * dt + cn, 0.f), c, best[q], second[q],
               a[q]);
        }
      } else {
        const T* x = tile_x + (size_t)base * d;
        float dt = 0.f;
        for (int j = 0; j < d; ++j) dt = fmaf(widen(x[j]), cc[j], dt);
        fold(nan_max(xn[0] - 2.f * dt + cn, 0.f), c, best[0], second[0],
             a[0]);
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
  if (!Untiled) {
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
      partials[t] = red_sum[0];
      gaps[t] = red_gap[0];
    }
  }

  // cluster sums, `cols` columns (j0 .. j0 + cols - 1 of d + 1) at a time
  const int warp = tid / 32, lane = tid % 32;
  float* acc = acc_sh + (size_t)warp * k * cols;
  float* out = tile_acc + (size_t)blockIdx.x * k * width;  // (b, t)
  for (int j0 = 0; j0 < width; j0 += cols) {
    const int nc = min(cols, width - j0);
    for (int i = tid; i < kWarps * k * cols; i += kThreads) acc_sh[i] = 0.f;
    __syncthreads();
    for (int chunk = warp * 32; chunk < rows; chunk += kThreads) {
      const int r = chunk + lane;
      const int lab = r < rows ? lab_sh[r] : -1;
      const unsigned peers = __match_any_sync(kFull, lab);
      const int rounds = __reduce_max_sync(kFull, __popc(peers));
      const bool lead = lab >= 0 && __ffs(peers) - 1 == lane;
      const float wr = Untiled && weights != nullptr && lab >= 0
                           ? weights[tile0 + r] : 1.f;
      for (int jj = 0; jj < nc; ++jj) {
        const int j = j0 + jj;
        // a lane past the tile's rows (lab < 0) reads nothing and adds 0
        const float x =
            lab < 0 ? 0.f : (j < d ? widen(tile_x[(size_t)r * d + j]) : 1.f);
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
      }
      __syncwarp();
    }
    __syncthreads();
    for (int o = tid; o < k * nc; o += kThreads) {
      const int c = o / nc, jj = o % nc;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w)
        s += acc_sh[((size_t)w * k + c) * cols + jj];
      out[(size_t)c * width + j0 + jj] = s;
    }
    __syncthreads();
  }
}

// `active` (K6, K10b) skips a super none of whose tiles computed in its
// problem: its carried sums and counts stay. Block i reduces super
// i % n_super of problem i / n_super.
__global__ void __launch_bounds__(kThreads)
super_reduce_kernel(const float* __restrict__ tile_acc, float* __restrict__ ssums,
                    float* __restrict__ scounts,
                    const unsigned char* __restrict__ active, int n_tiles,
                    int d, int k, int tps) {
  const int width = d + 1;
  const int n_super = (n_tiles + tps - 1) / tps;
  const int b = blockIdx.x / n_super;
  const int s = blockIdx.x - b * n_super;
  tile_acc += (size_t)b * n_tiles * k * width;
  ssums += (size_t)b * n_super * k * d;
  scounts += (size_t)b * n_super * k;
  const int t_end = min((s + 1) * tps, n_tiles);
  if (active != nullptr) {
    active += (size_t)b * n_tiles;
    bool any = false;
    for (int t = s * tps; t < t_end; ++t) any |= active[t] != 0;
    if (!any) return;
  }
  for (int o = threadIdx.x; o < k * width; o += kThreads) {
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

// Untiled (K4 / K9) takes null partials and gaps and `tps` = n_tiles: one
// super spanning every tile.
template <typename T, bool Gated, bool Untiled>
int launch_round(const T* points, const float* norms, const T* cents,
                 const float* weights, int* labels, float* md,
                 float* partials, float* gaps, float* tile_acc, float* ssums,
                 float* scounts, const Gate& g, int batch, int n, int d,
                 int k, int block_n, int tps, int cols, cudaStream_t s) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const int n_super = (n_tiles + tps - 1) / tps;
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
  super_reduce_kernel<<<(unsigned)batch * n_super, kThreads, 0, s>>>(
      tile_acc, ssums, scounts, Gated ? g.active : nullptr, n_tiles, d, k,
      tps);
  return (int)cudaGetLastError();
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

}  // namespace

// Every entry point takes `bf16`: 0 for fp32 points and cents, 1 for the
// bf16 stream (both of one type; norms, weights and all else fp32).

// Launches both kernels of one assignment round (K3) on `stream`; returns
// cudaGetLastError(). `cols` columns of 8 warp-private (k, cols)
// accumulators must fit the shared memory the caller budgeted
// (repro_torch.kernels.ops.assign_smem_bytes).
extern "C" int lloyd_assign_tiled_launch(
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
// (batch, n_super, k).
extern "C" int lloyd_assign_tiled_batched_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int batch, int n, int d, int k, int block_n, int tps,
    int cols, int bf16, void* stream) {
  return dispatch<false, false>(points, norms, cents, nullptr, labels, md,
                                partials, gaps, tile_acc, ssums, scounts,
                                Gate{}, batch, n, d, k, block_n, tps, cols,
                                bf16, stream);
}

// Launches both kernels of one gated assignment round (K6) on `stream`;
// returns cudaGetLastError(). labels, md, lb, partials, gaps, ssums and
// scounts must hold the carried values and pruned zeros: skipped tiles and
// supers leave them as they are. `active` must be super-aligned.
extern "C" int lloyd_assign_gated_launch(
    const void* points, const float* norms, const void* cents,
    const float* delta, const float* thresh, const float* absorb,
    const int* prev_a, const float* prev_md, const float* prev_lb,
    const unsigned char* active, int* labels, float* md, float* lb,
    float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int* pruned, int n, int d, int k, int block_n, int tps,
    int cols, int bf16, void* stream) {
  const Gate g{delta, thresh, absorb, prev_a, prev_md, prev_lb, active, lb,
               pruned};
  return dispatch<true, false>(points, norms, cents, nullptr, labels, md,
                               partials, gaps, tile_acc, ssums, scounts, g, 1,
                               n, d, k, block_n, tps, cols, bf16, stream);
}

// Launches both kernels of one gated assignment round of `batch` problems
// (K10b) on `stream`; returns cudaGetLastError(). Every array carries a
// leading problem axis: K10a's, plus delta (batch, k), thresh / absorb /
// active / pruned (batch, n_tiles), prev_a / prev_md / prev_lb / lb
// (batch, n). The outputs must hold the carries and pruned zeros, and
// `active` must be super-aligned in every problem, as for K6.
extern "C" int lloyd_assign_gated_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* delta, const float* thresh, const float* absorb,
    const int* prev_a, const float* prev_md, const float* prev_lb,
    const unsigned char* active, int* labels, float* md, float* lb,
    float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int* pruned, int batch, int n, int d, int k, int block_n,
    int tps, int cols, int bf16, void* stream) {
  const Gate g{delta, thresh, absorb, prev_a, prev_md, prev_lb, active, lb,
               pruned};
  return dispatch<true, false>(points, norms, cents, nullptr, labels, md,
                               partials, gaps, tile_acc, ssums, scounts, g,
                               batch, n, d, k, block_n, tps, cols, bf16,
                               stream);
}

// Launches both kernels of one untiled assignment round (K4) on `stream`;
// returns cudaGetLastError(). `weights` (n,) may be null (every row weighs
// 1). sums (k, d) and counts (k,) are over all rows; tile_acc is
// (n_tiles, k, d + 1) scratch.
extern "C" int lloyd_assign_launch(const void* points, const float* norms,
                                   const void* cents, const float* weights,
                                   int* labels, float* md, float* tile_acc,
                                   float* sums, float* counts, int n, int d,
                                   int k, int block_n, int cols, int bf16,
                                   void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  return dispatch<false, true>(points, norms, cents, weights, labels, md,
                               nullptr, nullptr, tile_acc, sums, counts,
                               Gate{}, 1, n, d, k, block_n, n_tiles, cols,
                               bf16, stream);
}

// Launches both kernels of one untiled assignment round of `batch` problems
// (K9) on `stream`; returns cudaGetLastError(). Every array carries a
// leading problem axis: points (batch, n, d), norms / labels / md
// (batch, n), cents and sums (batch, k, d), counts (batch, k), tile_acc
// (batch, n_tiles, k, d + 1).
extern "C" int lloyd_assign_batched_launch(
    const void* points, const float* norms, const void* cents, int* labels,
    float* md, float* tile_acc, float* sums, float* counts, int batch, int n,
    int d, int k, int block_n, int cols, int bf16, void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  return dispatch<false, true>(points, norms, cents, nullptr, labels, md,
                               nullptr, nullptr, tile_acc, sums, counts,
                               Gate{}, batch, n, d, k, block_n, n_tiles, cols,
                               bf16, stream);
}

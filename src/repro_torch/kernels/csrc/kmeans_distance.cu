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
// inactive exits at once, having read one byte. Its outputs were made copies
// of the carried min_d2, partials and tile_max by the wrapper, so a skipped
// tile leaves them untouched (the TPU kernel's input_output_aliases).
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
// mask, tile_max and pruned by b*n_tiles. The TPU kernel visited each
// problem's compacted list of active tiles (a (B, n_tiles) id map and a
// (B,) count); here the full B * n_tiles grid is launched and reads the
// (B, n_tiles) mask, so a block whose tile is inactive in its problem exits
// at once and its carried outputs stay. Row b of a K8 launch is then K5 on
// problem b, bitwise.
//
// All four are one template: an active tile's unpruned rows go through the
// same code as K2's, in the same order, and a pruned row holds the value K2
// would write (min(md, d2) = md when d2 >= md), so an active tile's partial
// is bitwise K2's partial. K2 and K5 are the launches with B = 1.
//
// Each of the four also takes a bf16 point stream (the engine's
// precision="bf16", the TPU kernels' bf16 tiles into the MXU): the template
// is instantiated on the stream type T of `points` and `cents`, float or
// __nv_bfloat16. A bf16 value converts to float exactly, and every operation
// after the conversion is the fp32 instance's, in the same order: the cached
// norms, md, the partials and the gate stay fp32. So a bf16 launch is
// bitwise the fp32 launch on the points and centroids rounded to bf16 and
// widened back. Resident, the (m, d) centroid block is widened once into the
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
// Design. One thread block owns one tile and loops over its rows, 256 rows
// at a time, so reads of x, norms and md are coalesced and each is read
// once. Every thread keeps its own running sum in ascending row order, and
// the block reduces the 256 sums in a fixed tree: the partials are the same
// bits on every run. Resident = true stages the (m, d) centroid block and
// its norms in shared memory once per block (the paper's constant memory);
// Resident = false reads the centroids from global memory on every use and
// recomputes their norms there (Fig. 2's global-memory variant). The prune
// test is written with explicit round-to-nearest operations, so it is the
// same four roundings as the plain PyTorch version's. min and max propagate
// NaN like torch.minimum / torch.maximum.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS
constexpr float kRelScale = 1.0f + 1e-6f;  // 1 + bounds._REL in fp32

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

// bounds.seed_point_prune for one row
__device__ __forceinline__ bool seed_point_prune(float md, float cd, float dc,
                                                 float margin) {
  const float lo = fmaxf(__fsub_rn(dc, cd), 0.f);
  return __fmul_rn(lo, lo) >= __fadd_rn(__fmul_rn(md, kRelScale), margin);
}

// Gated = false is K2 / K7 (the gate pointers are null); Gated = true is K5
// / K8. T is the stream type of points and cents (float or bf16).
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
                           int n, int d, int m, int block_n) {
  // problem b, tile t of it; its arrays are offset to problem b
  const int n_tiles = (n + block_n - 1) / block_n;
  const int b = blockIdx.x / n_tiles;
  const int t = blockIdx.x - b * n_tiles;
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
  float* c_sh = smem + (Gated ? 3 : 1) * kThreads;  // (m, d) staged centroids
  float* cn_sh = c_sh + (size_t)m * d;     // (m,) their norms
  const int tid = threadIdx.x;

  if (Resident) {
    for (int i = tid; i < m * d; i += kThreads) c_sh[i] = widen(cents[i]);
    __syncthreads();
    for (int c = tid; c < m; c += kThreads) cn_sh[c] = sq_norm(c_sh + (size_t)c * d, d);
    __syncthreads();
  }

  const long long tile0 = (long long)t * block_n;
  const float dc_t = Gated ? dc[t] : 0.f;
  const float margin_t = Gated ? margin[t] : 0.f;
  float local = 0.f;
  float lmax = 0.f;
  int lcnt = 0;
  for (int r = tid; r < block_n; r += kThreads) {
    const long long row = tile0 + r;
    if (row >= n) break;
    const float md = md_in[row];
    float v;
    if (Gated && seed_point_prune(md, center_d[row], dc_t, margin_t)) {
      v = md;
      ++lcnt;
    } else {
      const T* x = points + row * d;
      const float xn = norms[row];
      float best = CUDART_INF_F;
      for (int c = 0; c < m; ++c) {
        float d2;
        if (Resident) {
          const float* cc = c_sh + (size_t)c * d;
          d2 = nan_max(xn - 2.f * dot(x, cc, d) + cn_sh[c], 0.f);
        } else {
          const T* cc = cents + (size_t)c * d;
          d2 = nan_max(xn - 2.f * dot(x, cc, d) + sq_norm(cc, d), 0.f);
        }
        best = nan_min(best, d2);
      }
      v = nan_min(md, best);
    }
    md_out[row] = v;
    local += v;
    if (Gated) lmax = nan_max(lmax, v);
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

template <typename T, bool Gated>
int launch(const T* points, const float* norms, const T* cents,
           const float* md_in, float* md_out, float* partials,
           const float* center_d, const float* dc, const float* margin,
           const unsigned char* active, float* tile_max, int* pruned, int batch,
           int n, int d, int m, int block_n, int resident, cudaStream_t s) {
  const long long blocks = (long long)batch * ((n + block_n - 1) / block_n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)blocks;
  const size_t smem = sizeof(float) * ((Gated ? 3 : 1) * kThreads +
                                       (resident ? (size_t)m * d + m : 0));
  if (resident) {
    auto kern = distance_min_update_kernel<T, true, Gated>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<grid, kThreads, smem, s>>>(points, norms, cents, md_in, md_out,
                                      partials, center_d, dc, margin, active,
                                      tile_max, pruned, n, d, m, block_n);
  } else {
    distance_min_update_kernel<T, false, Gated><<<grid, kThreads, smem, s>>>(
        points, norms, cents, md_in, md_out, partials, center_d, dc, margin,
        active, tile_max, pruned, n, d, m, block_n);
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
             int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, Gated>(
        static_cast<const __nv_bfloat16*>(points), norms,
        static_cast<const __nv_bfloat16*>(cents), md_in, md_out, partials,
        center_d, dc, margin, active, tile_max, pruned, batch, n, d, m,
        block_n, resident, s);
  return launch<float, Gated>(
      static_cast<const float*>(points), norms,
      static_cast<const float*>(cents), md_in, md_out, partials, center_d, dc,
      margin, active, tile_max, pruned, batch, n, d, m, block_n, resident, s);
}

}  // namespace

// Every entry point takes `bf16`: 0 for fp32 points and cents, 1 for the
// bf16 stream (both of one type; norms and all else fp32).

// Launches one seeding round (K2) on `stream`; returns cudaGetLastError().
extern "C" int distance_min_update_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, int n, int d, int m,
    int block_n, int resident, int bf16, void* stream) {
  return dispatch<false>(points, norms, cents, md_in, md_out, partials,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         1, n, d, m, block_n, resident, bf16, stream);
}

// Launches one seeding round of `batch` problems (K7) on `stream`; returns
// cudaGetLastError(). points (batch, n, d), norms / md_in / md_out
// (batch, n), cents (batch, m, d), partials (batch, n_tiles), contiguous.
extern "C" int distance_min_update_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, int batch, int n,
    int d, int m, int block_n, int resident, int bf16, void* stream) {
  return dispatch<false>(points, norms, cents, md_in, md_out, partials,
                         nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                         batch, n, d, m, block_n, resident, bf16, stream);
}

// Launches one gated seeding round (K5) on `stream`; returns
// cudaGetLastError(). md_out, partials and tile_max must hold the carried
// values and pruned zeros: inactive tiles leave them as they are.
extern "C" int distance_min_update_gated_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, const float* center_d,
    const float* dc, const float* margin, const unsigned char* active,
    float* tile_max, int* pruned, int n, int d, int m, int block_n,
    int resident, int bf16, void* stream) {
  return dispatch<true>(points, norms, cents, md_in, md_out, partials,
                        center_d, dc, margin, active, tile_max, pruned, 1, n,
                        d, m, block_n, resident, bf16, stream);
}

// Launches one gated seeding round of `batch` problems (K8) on `stream`;
// returns cudaGetLastError(). Every array carries a leading problem axis:
// K7's, plus center_d (batch, n) and dc, margin, active, tile_max and
// pruned (batch, n_tiles). md_out, partials and tile_max must hold the
// carried values and pruned zeros, as for K5.
extern "C" int distance_min_update_gated_batched_launch(
    const void* points, const float* norms, const void* cents,
    const float* md_in, float* md_out, float* partials, const float* center_d,
    const float* dc, const float* margin, const unsigned char* active,
    float* tile_max, int* pruned, int batch, int n, int d, int m, int block_n,
    int resident, int bf16, void* stream) {
  return dispatch<true>(points, norms, cents, md_in, md_out, partials,
                        center_d, dc, margin, active, tile_max, pruned, batch,
                        n, d, m, block_n, resident, bf16, stream);
}

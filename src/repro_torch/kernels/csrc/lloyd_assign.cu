// K3: one tiled Lloyd assignment round on Hopper.
//
// Replaces src/repro/kernels/lloyd_assign.py::lloyd_assign_tiled_pallas
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

// D > 0: the dimension is D, known at compile time, and R = 4 rows share
// each pass over the centroids. D == 0: the dimension is the runtime d.
template <int D>
__global__ void __launch_bounds__(kThreads)
assign_tile_kernel(const float* __restrict__ points,
                   const float* __restrict__ norms,
                   const float* __restrict__ cents,
                   int* __restrict__ labels, float* __restrict__ md,
                   float* __restrict__ partials, float* __restrict__ gaps,
                   float* __restrict__ tile_acc,  // (n_tiles, k, d + 1)
                   int n, int d, int k, int block_n, int cols) {
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
  const int tid = threadIdx.x;

  for (int i = tid; i < k * d; i += kThreads) c_sh[i] = cents[i];
  __syncthreads();
  for (int c = tid; c < k; c += kThreads) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_sh[c * d + j], c_sh[c * d + j], s);
    cn_sh[c] = s;
  }
  __syncthreads();

  const long long tile0 = (long long)blockIdx.x * block_n;
  const float* tile_x = points + tile0 * d;
  const int rows = (int)min((long long)block_n, (long long)n - tile0);
  float local_sum = 0.f;
  float local_gap = CUDART_INF_F;
  for (int base = tid; base < rows; base += R * kThreads) {
    float xr[R][DR], xn[R], best[R], second[R];
    int a[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = base + q * kThreads;
      const bool ok = r < rows;
      if constexpr (D > 0) {
#pragma unroll
        for (int j = 0; j < D; ++j) xr[q][j] = ok ? tile_x[(size_t)r * D + j] : 0.f;
      }
      xn[q] = ok ? norms[tile0 + r] : 0.f;
      best[q] = second[q] = CUDART_INF_F;
      a[q] = 0;
    }
    for (int c = 0; c < k; ++c) {
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
        const float* x = tile_x + (size_t)base * d;
        float dt = 0.f;
        for (int j = 0; j < d; ++j) dt = fmaf(x[j], cc[j], dt);
        fold(nan_max(xn[0] - 2.f * dt + cn, 0.f), c, best[0], second[0],
             a[0]);
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = base + q * kThreads;
      if (r < rows) {
        labels[tile0 + r] = a[q];
        md[tile0 + r] = best[q];
        lab_sh[r] = a[q];
        local_sum += best[q];
        local_gap = nan_min(local_gap, sqrtf(second[q]) - sqrtf(best[q]));
      }
    }
  }
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
    partials[blockIdx.x] = red_sum[0];
    gaps[blockIdx.x] = red_gap[0];
  }

  // cluster sums, `cols` columns (j0 .. j0 + cols - 1 of d + 1) at a time
  const int warp = tid / 32, lane = tid % 32;
  float* acc = acc_sh + (size_t)warp * k * cols;
  float* out = tile_acc + (size_t)blockIdx.x * k * width;
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
      for (int jj = 0; jj < nc; ++jj) {
        const int j = j0 + jj;
        const float v = lab < 0 ? 0.f : (j < d ? tile_x[(size_t)r * d + j] : 1.f);
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

__global__ void __launch_bounds__(kThreads)
super_reduce_kernel(const float* __restrict__ tile_acc, float* __restrict__ ssums,
                    float* __restrict__ scounts, int n_tiles, int d, int k,
                    int tps) {
  const int width = d + 1;
  const int s = blockIdx.x;
  const int t_end = min((s + 1) * tps, n_tiles);
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

template <int D>
int launch_assign(const float* points, const float* norms, const float* cents,
                  int* labels, float* md, float* partials, float* gaps,
                  float* tile_acc, int n, int d, int k, int block_n, int cols,
                  size_t smem, cudaStream_t s) {
  const int n_tiles = (n + block_n - 1) / block_n;
  cudaFuncSetAttribute(assign_tile_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  assign_tile_kernel<D><<<n_tiles, kThreads, smem, s>>>(
      points, norms, cents, labels, md, partials, gaps, tile_acc, n, d, k,
      block_n, cols);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches both kernels of one assignment round on `stream`; returns
// cudaGetLastError(). `cols` columns of 8 warp-private (k, cols)
// accumulators must fit the shared memory the caller budgeted
// (repro_torch.kernels.ops.assign_smem_bytes).
extern "C" int lloyd_assign_tiled_launch(
    const float* points, const float* norms, const float* cents, int* labels,
    float* md, float* partials, float* gaps, float* tile_acc, float* ssums,
    float* scounts, int n, int d, int k, int block_n, int tps, int cols,
    void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const int n_super = (n_tiles + tps - 1) / tps;
  const size_t smem = sizeof(float) * ((size_t)k * d + k + 2 * kThreads +
                                       (size_t)kWarps * k * cols + block_n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err =
      d == 2 ? launch_assign<2>(points, norms, cents, labels, md, partials,
                                gaps, tile_acc, n, d, k, block_n, cols, smem, s)
             : launch_assign<0>(points, norms, cents, labels, md, partials,
                                gaps, tile_acc, n, d, k, block_n, cols, smem, s);
  if (err != 0) return err;
  super_reduce_kernel<<<n_super, kThreads, 0, s>>>(tile_acc, ssums, scounts,
                                                   n_tiles, d, k, tps);
  return (int)cudaGetLastError();
}

// K2: one k-means++ seeding round on Hopper.
//
// Replaces src/repro/kernels/kmeans_distance.py::distance_min_update_pallas
// (the TPU kernel's pallas_call at line 125). It computes, for every row x
//   new_md[x] = min(md[x], min_c max(||x||^2 - 2 x.c + ||c||^2, 0))
// with the cached fp32 norm ||x||^2, and one partial sum of new_md per
// block_n-row tile (tail rows past n enter no partial). The partials are the
// tiles the two-level `tiled` sampler draws from, so their boundaries are
// exactly those of repro_torch.core.sampling.tile_partials.
//
// What bounds it on the H100: bytes. At the paper's d = 2 a row moves 20 B
// (x 8, norm 4, md in 4, md out 4) and costs 2d + 3 flops per centroid, so
// one round at n = 4M is 80 MB against 3.35 TB/s, about 24 us, and the
// arithmetic is far below the fp32 rate. At d = 2 there is no product to
// put on tensor cores, so the kernel uses fp32 FMA only (no TF32).
//
// Design. One thread block owns one tile and loops over its rows, 256 rows
// at a time, so reads of x, norms and md are coalesced and each is read
// once. Every thread keeps its own running sum in ascending row order, and
// the block reduces the 256 sums in a fixed tree: the partials are the same
// bits on every run. Resident = true stages the (m, d) centroid block and
// its norms in shared memory once per block (the paper's constant memory);
// Resident = false reads the centroids from global memory on every use and
// recomputes their norms there (Fig. 2's global-memory variant); the
// compiler may round the two differently, both within the D² tolerance.
// min and max propagate NaN like torch.minimum / torch.maximum.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float sq_norm(const float* c, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(c[j], c[j], s);
  return s;
}

__device__ __forceinline__ float dot(const float* x, const float* c, int d) {
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(x[j], c[j], s);
  return s;
}

template <bool Resident>
__global__ void __launch_bounds__(kThreads)
distance_min_update_kernel(const float* __restrict__ points,
                           const float* __restrict__ norms,
                           const float* __restrict__ cents,
                           const float* __restrict__ md_in,
                           float* __restrict__ md_out,
                           float* __restrict__ partials,
                           int n, int d, int m, int block_n) {
  extern __shared__ float smem[];
  float* red = smem;                       // (kThreads,) reduction buffer
  float* c_sh = smem + kThreads;           // (m, d) staged centroids
  float* cn_sh = c_sh + (size_t)m * d;     // (m,) their norms
  const int tid = threadIdx.x;

  if (Resident) {
    for (int i = tid; i < m * d; i += kThreads) c_sh[i] = cents[i];
    __syncthreads();
    for (int c = tid; c < m; c += kThreads) cn_sh[c] = sq_norm(c_sh + (size_t)c * d, d);
    __syncthreads();
  }
  const float* c_src = Resident ? c_sh : cents;

  const long long tile0 = (long long)blockIdx.x * block_n;
  float local = 0.f;
  for (int r = tid; r < block_n; r += kThreads) {
    const long long row = tile0 + r;
    if (row >= n) break;
    const float* x = points + row * d;
    const float xn = norms[row];
    float best = CUDART_INF_F;
    for (int c = 0; c < m; ++c) {
      const float* cc = c_src + (size_t)c * d;
      const float cn = Resident ? cn_sh[c] : sq_norm(cc, d);
      const float d2 = nan_max(xn - 2.f * dot(x, cc, d) + cn, 0.f);
      best = nan_min(best, d2);
    }
    const float v = nan_min(md_in[row], best);
    md_out[row] = v;
    local += v;
  }

  red[tid] = local;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partials[blockIdx.x] = red[0];
}

}  // namespace

// Launches one seeding round on `stream`; returns cudaGetLastError().
extern "C" int distance_min_update_launch(
    const float* points, const float* norms, const float* cents,
    const float* md_in, float* md_out, float* partials, int n, int d, int m,
    int block_n, int resident, void* stream) {
  const int n_tiles = (n + block_n - 1) / block_n;
  const size_t smem =
      sizeof(float) * (kThreads + (resident ? (size_t)m * d + m : 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    auto kern = distance_min_update_kernel<true>;
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    kern<<<n_tiles, kThreads, smem, s>>>(points, norms, cents, md_in, md_out,
                                         partials, n, d, m, block_n);
  } else {
    distance_min_update_kernel<false><<<n_tiles, kThreads, smem, s>>>(
        points, norms, cents, md_in, md_out, partials, n, d, m, block_n);
  }
  return (int)cudaGetLastError();
}

// K1: the once-per-call prologue on Hopper, for one problem or a batch of
// independent problems.
//
// Replaces src/repro/kernels/kmeans_distance.py::seed_prologue_pallas (the
// TPU kernel's pallas_call at line 416). One pass per block_n-row tile t
// computes everything the gated rounds cache:
//   norms[x]     ||x||^2 in fp32,
//   centers[t]   the mean of the tile's valid rows (d,),
//   radii[t]     sqrt of the largest squared distance of a valid row to it,
//   center_d[x]  each row's distance to its tile's center.
//
// The norms are bitwise those of repro_torch.core.bounds.point_norms: the
// columns are added in ascending order, one round-to-nearest product and one
// round-to-nearest add each (no FMA contraction). Both the gated and the
// ungated rounds stream them, and gated == ungated depends on it. Centers,
// radii and center_d may differ from the plain version by ulps: the bounds
// built from them are sufficient conditions with fp32 head-room, not values.
//
// What bounds it on the H100: bytes. At d = 2 a row reads 8 B and writes
// 8 B (norm, center_d), 64 MB at n = 4M, about 19 us at 3.35 TB/s; the
// arithmetic is a few flops a row.
//
// Design. One block owns one tile and reads it twice: once for the mean,
// once for the distances; the second read of the tile's 32 KB (d = 2) should
// hit L2. The mean: thread t takes column t % c and rows t / c, t / c + R, ...
// of a c-column slice (c = min(d, 256), R = 256 / c row lanes), so a warp
// reads consecutive addresses; then one thread per column adds the R lane
// sums in ascending lane order. Every order is fixed, so two launches give
// the same bits. The radius is a fixed max tree.
//
// The batched form runs the prologue of B independent problems in one
// launch. The TPU side has no kernel of its own for it: under jax.vmap the
// reference batches seed_prologue_pallas through pallas_call's generic rule.
// Here the grid is B * n_tiles blocks along x, as K7's is: block i takes
// tile t = i % n_tiles of problem b = i / n_tiles, whose rows are rows
// b*n + t*block_n onward of the (B*n, d) points and whose ball is entry i of
// the (B*n_tiles) centers and radii, and then runs the single kernel's code
// unchanged, so row b is bitwise K1 on problem b. The single K1 is the
// launch with B = 1. At the PQ codebook sweep (B = 1664, n = 16384, d = 16)
// it moves 2.2 GB, about 0.65 ms at 3.35 TB/s. The row offset is the one
// index the batch adds, and the launch bound keeps the single K1's 32
// registers: eight blocks of 256 threads per SM, one wave at the paper's
// 977 tiles (with 40 registers, six blocks per SM, K1 took a quarter
// longer there on the H100).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS

__global__ void __launch_bounds__(kThreads, 8)
seed_prologue_kernel(const float* __restrict__ points,
                     float* __restrict__ norms, float* __restrict__ centers,
                     float* __restrict__ radii, float* __restrict__ center_d,
                     int n, int d, int block_n) {
  // problem b; the tile's first row within the problem and in the batch
  const int n_tiles = (n + block_n - 1) / block_n;
  const int b = blockIdx.x / n_tiles;
  const long long first = (long long)(blockIdx.x - b * n_tiles) * block_n;
  const long long tile0 = (long long)b * n + first;
  extern __shared__ float smem[];
  float* red = smem;             // (kThreads,) lane sums, then the max tree
  float* ctr = smem + kThreads;  // (d,) the tile's center
  const int tid = threadIdx.x;
  const float* tile_x = points + tile0 * d;
  const int rows = (int)min((long long)block_n, (long long)n - first);
  const float cnt = fmaxf((float)rows, 1.f);

  // pass 1: the center, c columns at a time
  for (int j0 = 0; j0 < d; j0 += kThreads) {
    const int c = min(d - j0, kThreads);
    const int lanes = kThreads / c;
    const int col = tid % c, lane = tid / c;
    float s = 0.f;
    if (lane < lanes)
      for (int r = lane; r < rows; r += lanes)
        s += tile_x[(size_t)r * d + j0 + col];
    red[tid] = s;
    __syncthreads();
    if (tid < c) {
      float t = 0.f;
      for (int l = 0; l < lanes; ++l) t += red[l * c + tid];
      ctr[j0 + tid] = t / cnt;
    }
    __syncthreads();
  }
  for (int j = tid; j < d; j += kThreads)
    centers[(size_t)blockIdx.x * d + j] = ctr[j];

  // pass 2: norms, distances to the center, the radius
  float lmax = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    const float* x = tile_x + (size_t)r * d;
    float nrm = __fmul_rn(x[0], x[0]);
    float d2 = 0.f;
    for (int j = 0; j < d; ++j) {
      if (j > 0) nrm = __fadd_rn(nrm, __fmul_rn(x[j], x[j]));
      const float diff = x[j] - ctr[j];
      d2 = fmaf(diff, diff, d2);
    }
    norms[tile0 + r] = nrm;
    center_d[tile0 + r] = sqrtf(d2);
    lmax = fmaxf(lmax, d2);
  }
  red[tid] = lmax;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) radii[blockIdx.x] = sqrtf(red[0]);
}

int launch(const float* points, float* norms, float* centers, float* radii,
           float* center_d, int batch, int n, int d, int block_n,
           cudaStream_t s) {
  const long long blocks = (long long)batch * ((n + block_n - 1) / block_n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (kThreads + (size_t)d);
  cudaFuncSetAttribute(seed_prologue_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  seed_prologue_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      points, norms, centers, radii, center_d, n, d, block_n);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the prologue on `stream`; returns cudaGetLastError().
extern "C" int seed_prologue_launch(const float* points, float* norms,
                                    float* centers, float* radii,
                                    float* center_d, int n, int d, int block_n,
                                    void* stream) {
  return launch(points, norms, centers, radii, center_d, 1, n, d, block_n,
                static_cast<cudaStream_t>(stream));
}

// Launches the prologue of `batch` problems on `stream`; returns
// cudaGetLastError(). points (batch, n, d), norms / center_d (batch, n),
// centers (batch, n_tiles, d), radii (batch, n_tiles), contiguous.
extern "C" int seed_prologue_batched_launch(const float* points, float* norms,
                                            float* centers, float* radii,
                                            float* center_d, int batch, int n,
                                            int d, int block_n, void* stream) {
  return launch(points, norms, centers, radii, center_d, batch, n, d, block_n,
                static_cast<cudaStream_t>(stream));
}

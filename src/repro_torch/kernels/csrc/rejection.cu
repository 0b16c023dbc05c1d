// K11 and K12: the two small kernels of rejection seeding on Hopper.
//
// K11 replaces src/repro/kernels/kmeans_distance.py::row_min_d2_pallas (the
// TPU kernel's body at line 274). For the row x = points[idx] it computes
//   out = min_{j < count} sum_c (x_c - pending_j,c)^2,  +inf when count = 0,
// the exact weight p of the row a rejection round proposed. idx and count
// are read from device memory, so the host never learns the drawn index.
//
// K12 replaces kmeans_distance.py::tile_cap_pallas (body at line 329). For
// every tile ball (center_t, r_t) of the prologue it computes
//   cap_t = (sqrt(min_{j < count} sum_c (center_t,c - pending_j,c)^2) + r_t)^2,
// +inf everywhere when count = 0: by the triangle inequality no row of tile
// t is farther than that from the pending block, so cap_t bounds the tile's
// current D² from its summary alone.
//
// Both are the TPU kernels' diff-square form, not the matmul form. Every
// squared distance adds the d columns in ascending order, one
// round-to-nearest product and one round-to-nearest add each (__fmul_rn /
// __fadd_rn, no FMA contraction), and the cap uses __fsqrt_rn: the same
// roundings as the plain PyTorch versions (row_min_d2_torch, tile_cap_torch),
// so kernel and plain version agree bitwise. The min over pending slots is
// exact in any order; min propagates NaN like torch.amin.
//
// What bounds them: launch latency. K11 reads one row and the (P, d)
// pending block (at d = 2, P = 8: 72 B); K12 reads T (d + 1) + P d floats
// and writes T (at n = 4M, d = 2: 977 tiles, about 16 KB). Both are far
// below a microsecond of memory traffic or arithmetic.
//
// Design. K11 is one warp: the row is staged in shared memory by the warp,
// each lane takes pending slots lane, lane + 32, ..., and a shuffle tree
// takes the min. K12 is one thread per tile with the pending block staged
// in shared memory.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCapThreads = 256;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// sum_c (a_c - b_c)^2 in ascending column order, every operation rounded
__device__ __forceinline__ float diff_sq(const float* a, const float* b,
                                         int d) {
  float s = 0.f;
  for (int c = 0; c < d; ++c) {
    const float t = __fsub_rn(a[c], b[c]);
    s = c == 0 ? __fmul_rn(t, t) : __fadd_rn(s, __fmul_rn(t, t));
  }
  return s;
}

__global__ void __launch_bounds__(32)
row_min_d2_kernel(const float* __restrict__ points,
                  const long long* __restrict__ idx,
                  const float* __restrict__ pending,
                  const int* __restrict__ count, float* __restrict__ out,
                  long long n, int d, int p) {
  extern __shared__ float row[];  // (d,) the gathered row
  const int lane = threadIdx.x;
  const long long i = *idx;
  if (i < 0 || i >= n) {  // no such row: the accept test then rejects
    if (lane == 0) *out = CUDART_NAN_F;
    return;
  }
  for (int c = lane; c < d; c += 32) row[c] = points[i * d + c];
  __syncwarp();
  const int cnt = *count;
  float best = CUDART_INF_F;
  for (int j = lane; j < p && j < cnt; j += 32)
    best = nan_min(best, diff_sq(row, pending + (size_t)j * d, d));
  for (int off = 16; off > 0; off >>= 1)
    best = nan_min(best, __shfl_down_sync(0xffffffffu, best, off));
  if (lane == 0) *out = best;
}

__global__ void __launch_bounds__(kCapThreads)
tile_cap_kernel(const float* __restrict__ centers,
                const float* __restrict__ radii,
                const float* __restrict__ pending,
                const int* __restrict__ count, float* __restrict__ out,
                int n_tiles, int d, int p) {
  extern __shared__ float pend[];  // (p, d) the pending block
  const int cnt = *count;
  if (cnt > 0)
    for (int i = threadIdx.x; i < p * d; i += kCapThreads) pend[i] = pending[i];
  __syncthreads();
  const int t = blockIdx.x * kCapThreads + threadIdx.x;
  if (t >= n_tiles) return;
  if (cnt <= 0) {
    out[t] = CUDART_INF_F;
    return;
  }
  const float* c = centers + (size_t)t * d;
  float best = CUDART_INF_F;
  for (int j = 0; j < p && j < cnt; ++j)
    best = nan_min(best, diff_sq(c, pend + (size_t)j * d, d));
  const float v = __fadd_rn(__fsqrt_rn(best), radii[t]);
  out[t] = __fmul_rn(v, v);
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Launches K11 on `stream`: out (a 0-d fp32) = min D² of points[*idx] to
// pending[: *count]. Returns cudaGetLastError().
extern "C" int row_min_d2_launch(const float* points, const long long* idx,
                                 const float* pending, const int* count,
                                 float* out, long long n, int d, int p,
                                 void* stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  const int err = set_smem((const void*)row_min_d2_kernel, smem);
  if (err) return err;
  row_min_d2_kernel<<<1, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      points, idx, pending, count, out, n, d, p);
  return (int)cudaGetLastError();
}

// Launches K12 on `stream`: out (n_tiles,) fp32 caps of the tile balls
// against pending[: *count]. Returns cudaGetLastError().
extern "C" int tile_cap_launch(const float* centers, const float* radii,
                               const float* pending, const int* count,
                               float* out, int n_tiles, int d, int p,
                               void* stream) {
  const size_t smem = sizeof(float) * (size_t)p * d;
  const int err = set_smem((const void*)tile_cap_kernel, smem);
  if (err) return err;
  const int blocks = (n_tiles + kCapThreads - 1) / kCapThreads;
  tile_cap_kernel<<<blocks, kCapThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      centers, radii, pending, count, out, n_tiles, d, p);
  return (int)cudaGetLastError();
}

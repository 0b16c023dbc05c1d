// K11 and K12: the two small kernels of rejection seeding on Hopper.
//
// K11 replaces src/repro/kernels/kmeans_distance.py::row_min_d2_pallas (the
// TPU kernel's body at line 274). For each of A drawn rows x = points[idx[a]]
// it computes
//   out[a] = min_{j < count} sum_c (x_c - pending_j,c)^2,  +inf when count = 0,
// the exact weight p of that row: one launch prices every proposal of a
// rejection round. idx and count are read from device memory, so the host
// never learns the drawn indices; an index outside [0, n) gives NaN (the
// bits of the plain version's), which the accept test rejects.
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
// What bounds them: launch latency. K11 reads A rows and the (P, d) pending
// block (at d = 2, P = 8, A = 8: 128 B); K12 reads T (d + 1) + P d floats
// and writes T (at n = 4M, d = 2: 977 tiles, about 16 KB). Both are far
// below a microsecond of memory traffic or arithmetic.
//
// Design. K11 is one warp per drawn row, four to a block: each lane takes
// pending slots lane, lane + 32, ... and reads the row from device memory
// (every lane the same address, so one load serves the warp; any d), and a
// shuffle tree takes the min. K12 is one thread per tile; the pending block
// passes through shared memory in stages of kCapFloats floats: whole slots
// where one fits (the tile's running minimum carried in a register across
// stages), else one slot in column chunks (the slot's diff-square sum
// carried in a register, its columns still added in ascending order), so
// any (P, d) takes the same bits.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRowWarps = 4;        // K11: warps (drawn rows) a block
constexpr int kCapThreads = 256;
constexpr int kCapFloats = 12288;   // K12: floats of one stage (48 KB)

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// continues sum_c (a_c - b_c)^2 over columns [c0, c1) from s, in ascending
// column order, every operation rounded; column 0 starts the sum
__device__ __forceinline__ float diff_sq(const float* a, const float* b,
                                         int c0, int c1, float s) {
  for (int c = c0; c < c1; ++c) {
    const float t = __fsub_rn(a[c], b[c - c0]);
    s = c == 0 ? __fmul_rn(t, t) : __fadd_rn(s, __fmul_rn(t, t));
  }
  return s;
}

__global__ void __launch_bounds__(32 * kRowWarps)
row_min_d2_kernel(const float* __restrict__ points,
                  const long long* __restrict__ idx,
                  const float* __restrict__ pending,
                  const int* __restrict__ count, float* __restrict__ out,
                  long long n, int d, int p, int a) {
  const int w = blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= a) return;
  const long long i = idx[w];
  if (i < 0 || i >= n) {  // no such row: the accept test then rejects
    if (lane == 0) out[w] = __int_as_float(0x7fc00000);  // torch.nan's bits
    return;
  }
  const float* row = points + i * d;
  const int cnt = *count;
  float best = CUDART_INF_F;
  for (int j = lane; j < p && j < cnt; j += 32)
    best = nan_min(best, diff_sq(row, pending + (size_t)j * d, 0, d, 0.f));
  for (int off = 16; off > 0; off >>= 1)
    best = nan_min(best, __shfl_down_sync(0xffffffffu, best, off));
  if (lane == 0) out[w] = best;
}

__global__ void __launch_bounds__(kCapThreads)
tile_cap_kernel(const float* __restrict__ centers,
                const float* __restrict__ radii,
                const float* __restrict__ pending,
                const int* __restrict__ count, float* __restrict__ out,
                int n_tiles, int d, int p) {
  __shared__ float stage[kCapFloats];
  const int cnt = *count;
  const int t = blockIdx.x * kCapThreads + threadIdx.x;
  const int live = min(p, cnt);
  if (live <= 0) {
    if (t < n_tiles) out[t] = CUDART_INF_F;
    return;
  }
  // whole slots a stage where one fits, else one slot in column chunks
  const int slots = max(1, min(live, kCapFloats / d));
  const int cols = min(d, kCapFloats);
  const float* c = centers + (size_t)(t < n_tiles ? t : 0) * d;
  float best = CUDART_INF_F;
  for (int j0 = 0; j0 < live; j0 += slots) {
    const int nj = min(slots, live - j0);
    float s = 0.f;
    for (int c0 = 0; c0 < d; c0 += cols) {
      const int nc = min(cols, d - c0);
      __syncthreads();   // the previous stage is read
      for (int e = threadIdx.x; e < nj * nc; e += kCapThreads)
        stage[e] = pending[(size_t)(j0 + e / nc) * d + c0 + e % nc];
      __syncthreads();
      if (t >= n_tiles) continue;
      if (nc == d) {
        for (int jj = 0; jj < nj; ++jj)
          best = nan_min(best, diff_sq(c, stage + (size_t)jj * d, 0, d, 0.f));
      } else {
        s = diff_sq(c, stage, c0, c0 + nc, s);
      }
    }
    if (cols < d) best = nan_min(best, s);
  }
  if (t >= n_tiles) return;
  const float v = __fadd_rn(__fsqrt_rn(best), radii[t]);
  out[t] = __fmul_rn(v, v);
}

}  // namespace

// Launches K11 on `stream`: out (a) fp32, out[i] = min D² of points[idx[i]]
// to pending[: *count]. Returns cudaGetLastError().
extern "C" int row_min_d2_launch(const float* points, const long long* idx,
                                 const float* pending, const int* count,
                                 float* out, long long n, int d, int p, int a,
                                 void* stream) {
  const int blocks = (a + kRowWarps - 1) / kRowWarps;
  row_min_d2_kernel<<<blocks, 32 * kRowWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      points, idx, pending, count, out, n, d, p, a);
  return (int)cudaGetLastError();
}

// Launches K12 on `stream`: out (n_tiles,) fp32 caps of the tile balls
// against pending[: *count]. Returns cudaGetLastError().
extern "C" int tile_cap_launch(const float* centers, const float* radii,
                               const float* pending, const int* count,
                               float* out, int n_tiles, int d, int p,
                               void* stream) {
  const int blocks = (n_tiles + kCapThreads - 1) / kCapThreads;
  tile_cap_kernel<<<blocks, kCapThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      centers, radii, pending, count, out, n_tiles, d, p);
  return (int)cudaGetLastError();
}

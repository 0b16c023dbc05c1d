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
// Batched rejection seeding runs both over B problems in one launch, row b
// the single launch on problem b: K11 one warp per (problem, drawn row), the
// tile envelope a run of blocks per problem with the problem's own count and
// arrival counters.
//
// tile_envelope_kernel is K12 as a hier round uses it, one launch a round
// with a live pending slot: the caps, then the round's envelope from them
// (the capped tile masses, which tiles tightened, and their count), which
// took five more launches of elementwise ops and a sum. Its cap has K12's
// bits, and the rest is the plain version's arithmetic (one rounded
// product, two compares, an exact integer count).
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

// warp w prices drawn row w % a of problem w / a (batch 1: the single
// launch); every array is offset to that problem
__global__ void __launch_bounds__(32 * kRowWarps)
row_min_d2_kernel(const float* __restrict__ points,
                  const long long* __restrict__ idx,
                  const float* __restrict__ pending,
                  const int* __restrict__ count, float* __restrict__ out,
                  long long n, int d, int p, int a, int batch) {
  const long long w = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)a * batch) return;
  const long long b = w / a;
  points += b * n * d;
  pending += b * p * d;
  count += b;
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

// K12's cap of tile t against pending[: cnt]; every thread of the block
// calls it (the pending block passes through `stage`), a t past n_tiles
// gets 0
__device__ float tile_cap_of(const float* __restrict__ centers,
                             const float* __restrict__ radii,
                             const float* __restrict__ pending, int cnt,
                             int t, int n_tiles, int d, int p, float* stage) {
  const int live = min(p, cnt);
  if (live <= 0) return CUDART_INF_F;
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
  if (t >= n_tiles) return 0.f;
  const float v = __fadd_rn(__fsqrt_rn(best), radii[t]);
  return __fmul_rn(v, v);
}

__global__ void __launch_bounds__(kCapThreads)
tile_cap_kernel(const float* __restrict__ centers,
                const float* __restrict__ radii,
                const float* __restrict__ pending,
                const int* __restrict__ count, float* __restrict__ out,
                int n_tiles, int d, int p) {
  __shared__ float stage[kCapFloats];
  const int t = blockIdx.x * kCapThreads + threadIdx.x;
  const float cap = tile_cap_of(centers, radii, pending, *count, t, n_tiles,
                                d, p, stage);
  if (t < n_tiles) out[t] = cap;
}

// a hier round's tile envelope: K12's cap, capw = cap * tile_w (one
// rounding; inf * 0 is NaN), ph = capw < partials ? capw : partials,
// tight = ph < partials (a NaN loses every compare, as torch's), and the
// count of tight tiles: each block's count summed exactly into acc[0],
// which the last block to arrive (acc[1] wraps to 0) takes and clears.
// Batched, blocks (b, i) for i < bpp take tiles i * kCapThreads + tid of
// problem b, every array offset to it (tile_w by w_stride: 0 where the
// problems share one), and problem b counts in acc[2b], acc[2b + 1]; a
// problem whose count is 0 gets +inf caps, ph = partials and no tight tile,
// the bits of its single launch
__global__ void __launch_bounds__(kCapThreads)
tile_envelope_kernel(const float* __restrict__ centers,
                     const float* __restrict__ radii,
                     const float* __restrict__ pending,
                     const int* __restrict__ count,
                     const float* __restrict__ tile_w,
                     const float* __restrict__ partials,
                     float* __restrict__ cap, float* __restrict__ ph,
                     bool* __restrict__ tight, int* __restrict__ n_tight,
                     unsigned* __restrict__ acc, int n_tiles, int d, int p,
                     int bpp, int w_stride) {
  __shared__ float stage[kCapFloats];
  const int b = blockIdx.x / bpp;
  const int blk = blockIdx.x - b * bpp;
  const size_t off = (size_t)b * n_tiles;
  centers += off * d;
  radii += off;
  pending += (size_t)b * p * d;
  count += b;
  tile_w += (size_t)b * w_stride;
  partials += off;
  cap += off;
  ph += off;
  tight += off;
  n_tight += b;
  acc += 2 * b;
  const int t = blk * kCapThreads + threadIdx.x;
  const float c = tile_cap_of(centers, radii, pending, *count, t, n_tiles, d,
                              p, stage);
  __syncthreads();  // the stage is read: it holds the warps' counts next
  int* warp_tight = reinterpret_cast<int*>(stage);
  bool is_tight = false;
  if (t < n_tiles) {
    const float capw = __fmul_rn(c, tile_w[t]);
    const float part = partials[t];
    const float h = capw < part ? capw : part;
    is_tight = h < part;
    cap[t] = c;
    ph[t] = h;
    tight[t] = is_tight;
  }
  const int in_warp = __popc(__ballot_sync(0xffffffffu, is_tight));
  if (threadIdx.x % 32 == 0) warp_tight[threadIdx.x / 32] = in_warp;
  __syncthreads();
  if (threadIdx.x != 0) return;
  int sum = 0;
  for (int w = 0; w < kCapThreads / 32; ++w) sum += warp_tight[w];
  atomicAdd(reinterpret_cast<int*>(acc), sum);
  __threadfence();
  if (atomicInc(acc + 1, bpp - 1) == (unsigned)bpp - 1)
    *n_tight = atomicExch(reinterpret_cast<int*>(acc), 0);
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
      points, idx, pending, count, out, n, d, p, a, 1);
  return (int)cudaGetLastError();
}

// Launches K11 over `batch` problems on `stream`: points (batch, n, d), idx
// (batch, a), pending (batch, p, d), count (batch,); out (batch, a), row b
// bitwise the single launch on problem b. Returns cudaGetLastError().
extern "C" int row_min_d2_batched_launch(const float* points,
                                         const long long* idx,
                                         const float* pending,
                                         const int* count, float* out,
                                         long long n, int d, int p, int a,
                                         int batch, void* stream) {
  const long long blocks =
      ((long long)a * batch + kRowWarps - 1) / kRowWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  row_min_d2_kernel<<<(unsigned)blocks, 32 * kRowWarps, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      points, idx, pending, count, out, n, d, p, a, batch);
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

// Launches the tile envelope on `stream`: cap, ph (n_tiles,) fp32, tight
// (n_tiles,) bool and n_tight (one int32) of the tile balls against
// pending[: *count] (K12's cap) and the round's partials and tile masses
// tile_w. acc: two uint32 counters, 0 before the launch (it leaves them
// 0). Returns cudaGetLastError().
extern "C" int tile_envelope_launch(const float* centers, const float* radii,
                                    const float* pending, const int* count,
                                    const float* tile_w,
                                    const float* partials, float* cap,
                                    float* ph, bool* tight, int* n_tight,
                                    unsigned* acc, int n_tiles, int d, int p,
                                    void* stream) {
  const int blocks = (n_tiles + kCapThreads - 1) / kCapThreads;
  tile_envelope_kernel<<<blocks, kCapThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      centers, radii, pending, count, tile_w, partials, cap, ph, tight,
      n_tight, acc, n_tiles, d, p, blocks, 0);
  return (int)cudaGetLastError();
}

// Launches the tile envelope over `batch` problems on `stream`: centers
// (batch, n_tiles, d), radii, partials, cap, ph and tight (batch, n_tiles),
// pending (batch, p, d), count and n_tight (batch,), tile_w (batch,
// n_tiles), or (n_tiles,) shared with w_stride 0 (else n_tiles). acc: 2 *
// batch uint32 counters, 0 before the launch (it leaves them 0). Row b is
// bitwise the single launch on problem b. Returns cudaGetLastError().
extern "C" int tile_envelope_batched_launch(
    const float* centers, const float* radii, const float* pending,
    const int* count, const float* tile_w, const float* partials, float* cap,
    float* ph, bool* tight, int* n_tight, unsigned* acc, int n_tiles, int d,
    int p, int batch, int w_stride, void* stream) {
  const int bpp = (n_tiles + kCapThreads - 1) / kCapThreads;
  const long long blocks = (long long)bpp * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  tile_envelope_kernel<<<(unsigned)blocks, kCapThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      centers, radii, pending, count, tile_w, partials, cap, ph, tight,
      n_tight, acc, n_tiles, d, p, bpp, w_stride);
  return (int)cudaGetLastError();
}

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
// The template (seed_prologue_kernel; the *_template_launch entries). One
// block owns one tile and reads it twice from device memory: once for the
// mean, once for the distances. The mean: thread t takes column t % c and
// rows t / c, t / c + R, ... of a c-column slice (c = min(d, 256), R = 256 /
// c row lanes), so a warp reads consecutive addresses; then one thread per
// column adds the R lane sums in ascending lane order: 256 fixed chains,
// one per (column slice, column, lane). Every order is fixed, so two
// launches give the same bits. The radius is a fixed max tree. It holds the
// (d,) center in shared memory beside 256 floats, so the card refuses it
// past d = 57,856.
//
// The launch (K1; seed_prologue_batched_launch, the single K1 at batch 1)
// keeps every output bitwise the template's on each of its routes, which
// the width picks (seed_prologue_route):
// - Lone route (wherever the center and the chain partials fit a CTA's
//   113 KB beside one staged row: d <= 9,588). One CTA a tile stages the
//   tile's first rows in shared memory, all of them where the tile fits
//   kLoneBudget (113 KB: two CTAs an SM), by bulk asynchronous copies
//   (cp.async.bulk started by one thread, an mbarrier a piece; the floats at
//   a piece's unaligned ends copied by the threads, so any d and any ragged
//   tile take it). Each of the template's chains adds the staged rows piece
//   by piece as the copies land, in ascending order, then the rows past
//   them read from device memory (16 or 8 loads in flight a thread); the
//   lane sums are added in ascending lane order and divided as the template
//   does. Pass 2 forms each row's norm (the __fmul_rn / __fadd_rn chain) and
//   distance (the template's fmaf chain) from shared memory, or from device
//   memory again past the staged rows (a second read that mostly hits L2).
//   Rows are read in 16-byte vectors where d % 4 == 0 (8-byte where
//   d % 2 == 0; else by float), a thread a row, in an order rotated by the
//   row so that the eight threads of a quarter warp touch eight distinct
//   16-byte bank groups (the rotated chunks are put back in column order in
//   registers). So a tile that fits is read from device memory once; at the
//   PQ codebook sweep's 256 KB tiles 7/16 of the rows are staged.
// - Wide route (past d = 9,588, e.g. 60,000): the template's kernel with
//   the center kept in the centers output instead of shared memory, so any
//   d.
// A tile split over a thread-block cluster (CTA c continuing CTA c-1's
// chains through distributed shared memory) gives the same bits, but timed
// slower than the lone route at the PQ codebook sweep's tiles (PERF.md), so
// K1 has no such route.

// The batched form runs the prologue of B independent problems in one
// launch. The TPU side has no kernel of its own for it: under jax.vmap the
// reference batches seed_prologue_pallas through pallas_call's generic rule.
// Tile i of the grid is tile t = i % n_tiles of problem b = i / n_tiles,
// whose rows are rows b*n + t*block_n onward of the (B*n, d) points and
// whose ball is entry i of the (B*n_tiles) centers and radii; every kernel
// then runs the single kernel's code unchanged, so row b is bitwise K1 on
// problem b. The single K1 is the launch with B = 1. At the PQ codebook
// sweep (B = 1664, n = 16384, d = 16) it moves 2.2 GB, about 0.65 ms at
// 3.35 TB/s.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // mirrors repro_torch.kernels.ops.THREADS

// ---------------------------------------------------------------------------
// the template (kWide: the wide route, the center kept in the centers
// output instead of shared memory)
// ---------------------------------------------------------------------------

template <bool kWide>
__global__ void __launch_bounds__(kThreads, 8)
seed_prologue_kernel(const float* __restrict__ points,
                     float* __restrict__ norms, float* centers,
                     float* __restrict__ radii, float* __restrict__ center_d,
                     int n, int d, int block_n) {
  // problem b; the tile's first row within the problem and in the batch
  const int n_tiles = (n + block_n - 1) / block_n;
  const int b = blockIdx.x / n_tiles;
  const long long first = (long long)(blockIdx.x - b * n_tiles) * block_n;
  const long long tile0 = (long long)b * n + first;
  extern __shared__ float smem[];
  float* red = smem;   // (kThreads,) lane sums, then the max tree
  // (d,) the tile's center
  float* ctr = kWide ? centers + (size_t)blockIdx.x * d : smem + kThreads;
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
  if (!kWide)
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

// ---------------------------------------------------------------------------
// the lone route
// ---------------------------------------------------------------------------

namespace staged {

constexpr int kMaxPieces = 8;         // load mbarriers a CTA
constexpr int kPieceBytes = 8192;     // a piece of the staged rows, at least
// what a lone CTA stages at most: two CTAs an SM
constexpr int kLoneBudget = 113 * 1024;
// shared memory: the loads' mbarriers, then (chunks * 256) chain partials
// (the max tree's buffer after them), the (d,) center and the staged rows,
// every part 16-aligned
constexpr int kHeadBytes = 8 * kMaxPieces;

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// shared memory of a CTA staging `rows` rows of width d
inline size_t smem_bytes(int d, int rows) {
  const int chunks = (d + kThreads - 1) / kThreads;
  return kHeadBytes + 4 * ((size_t)chunks * kThreads + round4(d)
                           + (size_t)rows * d + 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// wait for phase `parity`
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Copies rows [0, held) of the tile at `src` (d floats a row) to `base`,
// in `pieces` pieces of `per` rows: the 16-byte aligned interior of a piece
// by one bulk copy on mbarrier bars[p] (started by thread 0), its unaligned
// ends by the threads. `base` keeps src's offset within 16 bytes.
__device__ __forceinline__ void stage(float* base, const float* src, int held,
                                      int d, int pieces, int per,
                                      uint64_t* bars) {
  const int m = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  for (int p = 0; p < pieces; ++p) {
    const int a = min(p * per, held) * d, e = min((p + 1) * per, held) * d;
    int x = a + (4 - (m + a) % 4) % 4, y = e - (m + e) % 4;
    if (x >= y) x = y = e;
    if (threadIdx.x == 0) {
      const uint32_t bar = smem_u32(bars + p);
      if (x < y) {
        bar_expect_tx(bar, 4u * (y - x));
        bulk_load(smem_u32(base + x), src + x, 4u * (y - x), bar);
      } else {
        bar_arrive(bar);
      }
    }
    for (int i = a + threadIdx.x; i < x; i += kThreads) base[i] = src[i];
    for (int i = y + threadIdx.x; i < e; i += kThreads) base[i] = src[i];
  }
}

// continue the template's pass-1 chains over tile rows [ra, rb); tile row
// r lies at x0[r * d] (shared memory, or device memory with more loads in
// flight, `kUnroll`)
template <int kUnroll = 4>
__device__ __forceinline__ void chain(float* part, const float* x0, int ra,
                                      int rb, int d) {
  const int tid = threadIdx.x;
  for (int j0 = 0, q = 0; j0 < d; j0 += kThreads, ++q) {
    const int c = min(d - j0, kThreads);
    const int lanes = kThreads / c;
    const int col = tid % c, lane = tid / c;
    if (lane >= lanes) continue;
    float s = part[q * kThreads + tid];
    const int r1 = ra + ((lane - ra) % lanes + lanes) % lanes;
    const float* x = x0 + (size_t)r1 * d + j0 + col;
    const size_t step = (size_t)lanes * d;
#pragma unroll kUnroll
    for (int r = r1; r < rb; r += lanes, x += step) s += *x;
    part[q * kThreads + tid] = s;
  }
}

// the center from the chains: the lane sums in ascending lane order, then
// the division, as the template
__device__ __forceinline__ void center(float* ctr, const float* part, int d,
                                       float cnt) {
  const int tid = threadIdx.x;
  for (int j0 = 0, q = 0; j0 < d; j0 += kThreads, ++q) {
    const int c = min(d - j0, kThreads);
    const int lanes = kThreads / c;
    if (tid < c) {
      float t = 0.f;
#pragma unroll 8
      for (int l = 0; l < lanes; ++l) t += part[q * kThreads + l * c + tid];
      ctr[j0 + tid] = t / cnt;
    }
  }
}

// one column of a row: the norm's rounded chain and the template's fmaf
// chain of the distance to the center
__device__ __forceinline__ void take(int j, float x, const float* ctr,
                                     float& nrm, float& d2) {
  nrm = j == 0 ? __fmul_rn(x, x) : __fadd_rn(nrm, __fmul_rn(x, x));
  const float diff = __fsub_rn(x, ctr[j]);
  d2 = fmaf(diff, diff, d2);
}

// a row's norm and squared distance to ctr, columns in ascending order; V
// floats a load; with V = 4, G 16-byte chunks a group loaded in an order
// rotated by row r (a quarter warp's 8 staged rows on 8 bank groups)
template <int V, int G>
__device__ __forceinline__ void row_stats(const float* row, const float* ctr,
                                          int d, int r, float& nrm,
                                          float& d2) {
  nrm = 0.f;
  d2 = 0.f;
  if constexpr (V == 1) {
    for (int j = 0; j < d; ++j) take(j, row[j], ctr, nrm, d2);
  } else if constexpr (V == 2) {
    const float2* r2 = reinterpret_cast<const float2*>(row);
    for (int q = 0; q < d / 2; ++q) {
      const float2 v = r2[q];
      take(2 * q, v.x, ctr, nrm, d2);
      take(2 * q + 1, v.y, ctr, nrm, d2);
    }
  } else {
    const float4* r4 = reinterpret_cast<const float4*>(row);
    const int b = G == 1 ? 0 : (r / (8 / G)) & (G - 1);
    for (int g0 = 0; g0 < d / 4; g0 += G) {
      float4 buf[G];
#pragma unroll
      for (int i = 0; i < G; ++i) buf[i] = r4[g0 + ((i + b) & (G - 1))];
      // buf[i] holds chunk g0 + (i + b) % G: rotate it back by b
#pragma unroll
      for (int k = 1; k < G; k <<= 1) {
        if (b & k) {
          float4 tmp[G];
#pragma unroll
          for (int i = 0; i < G; ++i) tmp[i] = buf[(i - k + G) & (G - 1)];
#pragma unroll
          for (int i = 0; i < G; ++i) buf[i] = tmp[i];
        }
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int j = 4 * (g0 + i);
        take(j, buf[i].x, ctr, nrm, d2);
        take(j + 1, buf[i].y, ctr, nrm, d2);
        take(j + 2, buf[i].z, ctr, nrm, d2);
        take(j + 3, buf[i].w, ctr, nrm, d2);
      }
    }
  }
}

// the max tree over the block's lmax (any order gives the same max)
__device__ __forceinline__ float block_max(float* red, float lmax) {
  const int tid = threadIdx.x;
  red[tid] = lmax;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fmaxf(red[tid], red[tid + s]);
    __syncthreads();
  }
  return red[0];
}

// blocks an SM each instance is sized for (registers)
template <int V, int G>
constexpr int kBlocks = G >= 8 ? 2 : G == 4 ? 4 : 5;

// The lone route: one CTA a tile. It stages the tile's first `cap` rows
// (kAll: the whole tile) and adds each chain over them piece by piece as
// the copies land, then over the rows past them read from device memory;
// pass 2 reads the staged rows from shared memory and the others from
// device memory again.
template <int V, int G, bool kAll>
__global__ void __launch_bounds__(kThreads, (kBlocks<V, G>))
lone_kernel(const float* __restrict__ points, float* __restrict__ norms,
            float* __restrict__ centers, float* __restrict__ radii,
            float* __restrict__ center_d, int n, int d, int block_n, int cap,
            int pieces) {
  const int tid = threadIdx.x;
  const int n_tiles = (n + block_n - 1) / block_n;
  const int b = blockIdx.x / n_tiles;
  const int first = (blockIdx.x - b * n_tiles) * block_n;
  const long long tile0 = (long long)b * n + first;
  const int rows = min(block_n, n - first);
  const int held = kAll ? rows : min(rows, cap);
  const float* tx = points + tile0 * d;

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* part = reinterpret_cast<float*>(smem + kHeadBytes);
  const int chunks = (d + kThreads - 1) / kThreads;
  float* ctr = part + chunks * kThreads;
  float* base = ctr + round4(d)
                + ((reinterpret_cast<uintptr_t>(tx) >> 2) & 3);
  const int per = (min(block_n, cap) + pieces - 1) / pieces;

  for (int i = tid; i < chunks * kThreads; i += kThreads) part[i] = 0.f;
  if (tid == 0) {
    for (int p = 0; p < pieces; ++p) bar_init(smem_u32(bars + p), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  stage(base, tx, held, d, pieces, per, bars);
  __syncthreads();   // the ends copied by the threads
  // pass 1: the chains, piece by piece as the copies land, then the rows
  // past the staged ones
  for (int p = 0; p < pieces; ++p) {
    bar_wait(smem_u32(bars + p), 0);
    chain(part, base, min(p * per, held), min((p + 1) * per, held), d);
  }
  if (!kAll) chain<(kBlocks<V, G> <= 4 ? 16 : 8)>(part, tx, held, rows, d);
  __syncthreads();
  center(ctr, part, d, fmaxf((float)rows, 1.f));
  __syncthreads();
  for (int j = tid; j < d; j += kThreads)
    centers[(size_t)blockIdx.x * d + j] = ctr[j];
  // pass 2: norms, distances to the center, the radius
  float lmax = 0.f;
  for (int r = tid; r < rows; r += kThreads) {
    float nrm, d2;
    row_stats<V, G>((kAll || r < held ? base : tx) + (size_t)r * d, ctr, d, r,
                    nrm, d2);
    norms[tile0 + r] = nrm;
    center_d[tile0 + r] = sqrtf(d2);
    lmax = fmaxf(lmax, d2);
  }
  const float v = block_max(part, lmax);
  if (tid == 0) radii[blockIdx.x] = sqrtf(v);
}

// rows of a (d, block_n) tile a lone CTA stages: all that fit kLoneBudget
// (0: not even the center and the chains fit)
int lone_cap(int d, int block_n) {
  const size_t fixed = smem_bytes(d, 0);
  if (fixed >= (size_t)kLoneBudget) return 0;
  return (int)min((size_t)block_n, (kLoneBudget - fixed) / (4 * (size_t)d));
}

// the route of (d, block_n) tiles: 1 (the lone route) where its CTA holds
// the center and the chains beside at least one staged row, else 0 (the
// wide route)
int route(int d, int block_n) { return lone_cap(d, block_n) >= 1 ? 1 : 0; }

int pieces_of(int rows, int d) {
  return (int)max(1LL, min((long long)kMaxPieces,
                           (long long)rows * d * 4 / kPieceBytes));
}

template <int V, int G>
int launch_as(const float* points, float* norms, float* centers,
              float* radii, float* center_d, long long tiles, int n, int d,
              int block_n, cudaStream_t s) {
  const int cap = lone_cap(d, block_n);
  const size_t smem = smem_bytes(d, cap);
  auto kern = cap == block_n ? lone_kernel<V, G, true>
                             : lone_kernel<V, G, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)tiles, kThreads, smem, s>>>(
      points, norms, centers, radii, center_d, n, d, block_n, cap,
      pieces_of(cap, d));
  return (int)cudaGetLastError();
}

int launch(const float* points, float* norms, float* centers, float* radii,
           float* center_d, long long tiles, int n, int d, int block_n,
           cudaStream_t s) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(points);
  if (d % 4 == 0 && at % 16 == 0) {
    const int chunks = d / 4;
    const int g = chunks & -chunks;
    if (g >= 8)
      return launch_as<4, 8>(points, norms, centers, radii, center_d, tiles,
                             n, d, block_n, s);
    if (g == 4)
      return launch_as<4, 4>(points, norms, centers, radii, center_d, tiles,
                             n, d, block_n, s);
    if (g == 2)
      return launch_as<4, 2>(points, norms, centers, radii, center_d, tiles,
                             n, d, block_n, s);
    return launch_as<4, 1>(points, norms, centers, radii, center_d, tiles, n,
                           d, block_n, s);
  }
  if (d % 2 == 0 && at % 8 == 0)
    return launch_as<2, 1>(points, norms, centers, radii, center_d, tiles, n,
                           d, block_n, s);
  return launch_as<1, 1>(points, norms, centers, radii, center_d, tiles, n, d,
                         block_n, s);
}

}  // namespace staged

// the template's kernel over `batch` problems; kWide: the wide route
template <bool kWide>
int launch_template(const float* points, float* norms, float* centers,
                    float* radii, float* center_d, int batch, int n, int d,
                    int block_n, cudaStream_t s) {
  const long long blocks = (long long)batch * ((n + block_n - 1) / block_n);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (kThreads + (kWide ? 0 : (size_t)d));
  cudaFuncSetAttribute(seed_prologue_kernel<kWide>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  seed_prologue_kernel<kWide><<<(unsigned)blocks, kThreads, smem, s>>>(
      points, norms, centers, radii, center_d, n, d, block_n);
  return (int)cudaGetLastError();
}

}  // namespace

// The route K1 takes for (d, block_n) tiles: 1 (the lone route) or 0 (the
// wide route).
extern "C" int seed_prologue_route(int d, int block_n) {
  return staged::route(d, block_n);
}

// Launches the prologue of `batch` problems on `stream` (the single K1 is
// batch 1) on the route seed_prologue_route names; returns
// cudaGetLastError(). points (batch, n, d), norms / center_d (batch, n),
// centers (batch, n_tiles, d), radii (batch, n_tiles), contiguous.
extern "C" int seed_prologue_batched_launch(const float* points, float* norms,
                                            float* centers, float* radii,
                                            float* center_d, int batch, int n,
                                            int d, int block_n,
                                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles = (long long)batch * ((n + block_n - 1) / block_n);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (staged::route(d, block_n) == 0)
    return launch_template<true>(points, norms, centers, radii, center_d,
                                 batch, n, d, block_n, s);
  return staged::launch(points, norms, centers, radii, center_d, tiles, n, d,
                        block_n, s);
}

// The template kernel (K1 before its redesign) on the same arguments: the
// bits K1 is held to on the card. It stages the center in shared memory and
// refuses past d = 57,856.
extern "C" int seed_prologue_template_launch(const float* points, float* norms,
                                             float* centers, float* radii,
                                             float* center_d, int batch, int n,
                                             int d, int block_n,
                                             void* stream) {
  return launch_template<false>(points, norms, centers, radii, center_d,
                                batch, n, d, block_n,
                                static_cast<cudaStream_t>(stream));
}

// K15: online-softmax attention on Hopper, the score matrix kept on chip.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (line 87,
// pallas_call at 121). q (B, Sq, H, hd), k/v (B, Skv, KH, hd), fp32 or
// bf16; query head h reads kv head h / G. For query row i at position
// qp = q_offset + i and key j:
//   valid = j < Skv && i < Sq && (!causal || j <= qp)
//                              && (window <= 0 || j > qp - window),
//   s = (q . k) * scale, s = cap * tanh(s / cap) when cap > 0,
//   s = valid ? s : -1e30,
// and per key tile the online softmax
//   m' = max(m, max_j s), p = valid ? e^(s - m') : 0, c = e^(m - m'),
//   l = l c + sum_j p, acc = acc c + p V, m = m',
// then o = acc / max(l, 1e-30): a row with no valid key gives 0. bf16
// results are rounded once, at the store.
//
// What bounds it: operations. A valid pair costs 4*hd flops (q.k and
// p v); at gemma2-2b's prefill (8 heads, 8,192 positions, hd 256, causal)
// that is 2.75e11 flops: 4.10 ms at fp32's 67 TFLOP/s, 0.278 ms at bf16's
// 989 TFLOP/s on the tensor cores, against 0.1 GB of bf16 q, k, v and o
// (0.03 ms at 3.35 TB/s). Each score also costs the softmax's exp (and
// the softcap's tanh) on the CUDA cores, which the tensor-core path has to
// hide. Only the key tiles that meet a query tile's band are visited:
// [max(0, qp0 - window + 1), min(Skv, qp1 + 1)) under a window and
// causality, the work the TPU kernel's skip of fully masked tiles leaves;
// a tile skipped would change nothing. No atomics: two launches give the
// same bits.
//
// fp32 (flash_kernel): on the CUDA cores. One block of 256 threads takes
// 64 query rows of one (b, h), warp w rows 8w .. 8w+7, keys in tiles of
// 32, one per lane; the accumulator in registers (lane l of warp w holds
// dims l, l+32, ..); the query, key (odd row stride), value and p tiles in
// shared memory (139,392 bytes at hd 256). A lane's score is an fmaf chain
// over d; row max and sum are xor-butterfly shuffles.
//
// bf16 (flash_bf16_kernel): on the tensor cores, fed by TMA. P.V runs as
// P_hi.V + P_lo.V with p_hi = bf16(p), p_lo = bf16(p - p_hi): one bf16 p
// breaks the fp32 reference's tolerance, the two halves keep p to about
// 2^-16. That executes 6*hd tensor-core flops a pair, 1.5x the bound: 0.417
// ms at peak. A block of 384 threads takes 128 query rows of one (b, h):
// warpgroups 0 and 1 each own 64 rows and compute, warpgroup 2 loads
// (setmaxnreg gives its registers to the other two: 40 / 232). One
// producer thread issues TMA loads, the query tile once, then K and V tiles
// of 64 keys into a ring of two stages, with a "full" and an "empty"
// mbarrier a stage for K and for V. Tiles are (rows x 64 columns) chunks in
// the 128-byte swizzle; a head dim that is no multiple of 64 reads zeros
// past hd (TMA's fill), which add nothing to q.k and make output columns
// that are not stored. A consumer warpgroup runs S = Q K^T as wgmma
// m64n64k16 (both operands K-major in shared memory; fp32 accumulate, and
// products of bf16 values are exact in fp32), then on S's fragments the
// softcap (accurate tanhf), the band mask (only on tiles that straddle the
// band's edge) and the online softmax in log2 units (m and l in fp32, the
// row max over the 4 lanes of a quad by xor shuffles 1 and 2, l from the
// fp32 p), and O += P_hi V + P_lo V as wgmma m64n(hd)k16 with A (p's
// halves) in registers, in S's fragment layout, and B (the V tile)
// MN-major in shared memory. The O accumulator (64 x hd fp32 a
// warpgroup, 128 registers a thread at hd 256) is rescaled between tiles,
// by a warp only when a row's max moved. S(i) is issued with
// P(i - 1) V(i - 1), so the softmax of tile i runs while the tensor cores
// work. Shared memory at hd 256: Q 64 KB and two stages of K and V at 64
// KB each, 192 KB of the 227 KB. The grid is (head, batch, query tile)
// with the query tiles in reverse, so under causality the heaviest tiles
// of every head start first. The sums run in another order than the
// twin's matmuls, so kernel and twin agree to a tolerance.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // 64 query rows per block
constexpr int kBK = 32;                  // keys per tile, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, KH, hd, causal, window, q_offset;
  float cap, scale;
};

// dynamic shared memory of one block, in floats
__host__ __device__ inline int smem_floats(int hd) {
  return kBQ * hd + kBK * (hd | 1) + kBK * hd + kWarps * kBK * kRows;
}

template <typename T, int kDpt>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int hd = a.hd, ks = hd | 1;
  float* qs = smem;                // (kBQ, hd)
  float* kt = qs + kBQ * hd;       // (kBK, ks)
  float* vs = kt + kBK * ks;       // (kBK, hd)
  float* ps = vs + kBK * hd;       // (kWarps, kBK, kRows)
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KH);
  const int q0 = blockIdx.x * kBQ;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i % hd;
    qs[i] = q0 + r < a.Sq
                ? load_f(q + (((size_t)b * a.Sq + q0 + r) * a.H + h) * hd + d)
                : 0.f;
  }
  float m[kRows], l[kRows], acc[kRows][kDpt];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDpt; ++j) acc[i][j] = 0.f;
  }

  // the key tiles that meet this query tile's band
  const int qp0 = a.q_offset + q0;
  const int qp1 = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int lo = 0, hi = a.Skv;
  if (a.window > 0) lo = max(lo, qp0 - a.window + 1);
  if (a.causal) hi = min(hi, qp1 + 1);
  const int t0 = lo / kBK;
  const int t1 = hi > lo ? (hi + kBK - 1) / kBK : t0;

  float* pw = ps + warp * kBK * kRows;
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile is read (and the query staged)
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      const bool in = k0 + r < a.Skv;
      const size_t at = (((size_t)b * a.Skv + k0 + r) * a.KH + kvh) * hd + d;
      kt[r * ks + d] = in ? load_f(k + at) : 0.f;
      vs[r * hd + d] = in ? load_f(v + at) : 0.f;
    }
    __syncthreads();

    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float* krow = kt + lane * ks;
    const float* qrow = qs + warp * kRows * hd;
    for (int d = 0; d < hd; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = fmaf(qrow[i * hd + d], kv, s[i]);
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = q0 + warp * kRows + i;
      const int qp = a.q_offset + r;
      bool valid = kp < a.Skv && r < a.Sq;
      if (a.causal) valid = valid && kp <= qp;
      if (a.window > 0) valid = valid && kp > qp - a.window;
      float x = s[i] * a.scale;
      if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
      x = valid ? x : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = valid ? expf(x - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDpt; ++j) acc[i][j] *= corr;
      pw[lane * kRows + i] = p;
    }
    __syncwarp();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = pw[kk * kRows + i];
#pragma unroll
      for (int j = 0; j < kDpt; ++j) {
        const int d = lane + 32 * j;
        const float vv = d < hd ? vs[kk * hd + d] : 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncwarp();  // the p tile is read before the next tile rewrites it
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + warp * kRows + i;
    if (r >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDpt; ++j) {
      const int d = lane + 32 * j;
      if (d < hd)
        store_f(o + (((size_t)b * a.Sq + r) * a.H + h) * hd + d,
                acc[i][j] / den);
    }
  }
}

template <typename T, int kDpt>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, kDpt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, B);
  flash_kernel<T, kDpt><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  const int dpt = (a.hd + 31) / 32;
  if (dpt <= 1) return launch<T, 1>(a, B, stream);
  if (dpt <= 2) return launch<T, 2>(a, B, stream);
  if (dpt <= 4) return launch<T, 4>(a, B, stream);
  if (dpt <= 8) return launch<T, 8>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace


namespace bf16k {


constexpr int kBQ = 128;         // query rows a block: 2 warpgroups x 64
constexpr int kBK = 64;          // keys a tile
constexpr int kStages = 2;       // the K/V ring
constexpr int kThreads = 384;    // warpgroups 0, 1 compute, 2 loads
constexpr int kConsumers = 256;
constexpr int kCols = 64;        // bf16 columns of one 128-byte swizzled row
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, byte offsets from a 1024-aligned base: the query tile,
// the K and V stages (each a tile of kChunks chunks of rows x 128 bytes),
// then the barriers: q_full, k_full[S], v_full[S], k_empty[S], v_empty[S]
template <int kChunks>
struct Smem {
  static constexpr int q_bytes = kChunks * kBQ * 128;
  static constexpr int kv_bytes = kChunks * kBK * 128;
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kStages * kv_bytes;
  static constexpr int bar_off = v_off + kStages * kv_bytes;
  static constexpr int bytes = bar_off + 8 * (1 + 4 * kStages) + 1024;
};

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

// one (64 columns, 1 head, rows, 1 batch) box of a (B, S, heads, hd) map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(head), "r"(row), "r"(batch) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// keeps the compiler from reading wgmma's registers before the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S (+)= A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += A B, m64n64k16, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n128k16, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += A B, m64n256k16, A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kHD>
__device__ __forceinline__ void wgmma_pv(float (&d)[kHD / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (kHD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (kHD == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// kChunks = ceil(hd / 64) column chunks; hd a multiple of 8
template <int kChunks>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Args a) {
  using L = Smem<kChunks>;
  constexpr int kHD = kChunks * kCols;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023)
      & ~1023u;
  const uint32_t q_s = base, k_s = base + L::k_off, v_s = base + L::v_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  const int tid = threadIdx.x, wg = tid / 128;
  // the grid is (head, batch, query tile), the query tiles last and in
  // reverse: under causality every head's heaviest tiles start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (a.H / a.KH);
  // the key tiles that meet this query tile's band
  const int qp0 = a.q_offset + q0;
  const int qp1 = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int lo = 0, hi = a.Skv;
  if (a.window > 0) lo = max(lo, qp0 - a.window + 1);
  if (a.causal) hi = min(hi, qp1 + 1);
  const int t0 = lo / kBK;
  const int t1 = hi > lo ? (hi + kBK - 1) / kBK : t0;

  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(k_full + 8 * s, 1);
      bar_init(v_full + 8 * s, 1);
      bar_init(k_empty + 8 * s, kConsumers);
      bar_init(v_empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 2 * 128) {
      bar_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < kChunks; ++c)
        tma_load(q_s + c * kBQ * 128, &qmap, q_full, c * kCols, h, q0, b);
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % kStages;
        const uint32_t ph = (i / kStages) & 1;
        bar_wait(k_empty + 8 * s, ph ^ 1);
        bar_expect_tx(k_full + 8 * s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(k_s + s * L::kv_bytes + c * kBK * 128, &kmap,
                   k_full + 8 * s, c * kCols, kvh, t * kBK, b);
        bar_wait(v_empty + 8 * s, ph ^ 1);
        bar_expect_tx(v_full + 8 * s, L::kv_bytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load(v_s + s * L::kv_bytes + c * kBK * 128, &vmap,
                   v_full + 8 * s, c * kCols, kvh, t * kBK, b);
      }
    }
  } else {
    // a consumer warpgroup: 64 query rows. Thread (warp w, lane) holds
    // rows 16w + lane/4 and 16w + lane/4 + 8 of the warpgroup's 64, and of
    // each 8-column block n columns 8n + 2(lane%4) + {0, 1}: element i of
    // a fragment is row half (i >> 1) & 1, column 8(i / 4) + 2(lane%4) +
    // (i & 1) (wgmma's accumulator layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
    const int row0 = q0 + wg * 64 + warp * 16 + lane / 4;   // and row0 + 8
    const int qpos0 = a.q_offset + row0;
    const int wq0 = a.q_offset + q0 + wg * 64, wq1 = wq0 + 63;
    // scores in log2 units: s scale log2(e), or under the softcap
    // cap log2(e) tanh(s scale / cap)
    const float pre = a.cap > 0.f ? a.scale / a.cap : a.scale * kLog2e;
    const float post = a.cap * kLog2e;
    float o[kHD / 2];
#pragma unroll
    for (int i = 0; i < kHD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[kBK / 2];
    uint32_t p_hi[kBK / 4], p_lo[kBK / 4];
    // Q (K-major): the warpgroup's 64 rows of each 128-row chunk
    const uint64_t q_desc = sw128_desc(q_s + wg * 64 * 128, 16, 1024);

    // S = Q K^T over hd / 16 steps of 16 columns (32 bytes)
    const auto issue_s = [&](int s) {
      const uint32_t kt = k_s + s * L::kv_bytes;
#pragma unroll
      for (int kk = 0; kk < kHD / 16; ++kk) {
        const uint32_t qo = (kk / 4) * kBQ * 128 + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * kBK * 128 + (kk % 4) * 32;
        wgmma_ss_n64(sc, q_desc + (qo >> 4), sw128_desc(kt + ko, 16, 1024),
                     kk > 0);
      }
    };
    // O += P_hi V + P_lo V; V (MN-major): 64-column chunks kBK * 128
    // bytes apart, 8-key groups 1024 bytes apart
    const auto issue_pv = [&](int s) {
      const uint32_t vt = v_s + s * L::kv_bytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<kHD>(o, p_hi + 4 * kk,
                      sw128_desc(vt + kk * 16 * 128, kBK * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<kHD>(o, p_lo + 4 * kk,
                      sw128_desc(vt + kk * 16 * 128, kBK * 128, 1024));
    };
    // the tile's scores to p (in place, fp32), the row max over the quad's
    // 4 lanes, the rescale factor and this thread's share of the row sums
    const auto softmax = [&](int k0, float (&corr)[2], float (&sum)[2]) {
      if (a.cap > 0.f) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) sc[e] = post * tanhf(sc[e] * pre);
      } else {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) sc[e] *= pre;
      }
      uint32_t valid = 0xffffffffu;   // bit e for element e
      if (k0 + kBK > a.Skv || (a.causal && k0 + kBK - 1 > wq0)
          || (a.window > 0 && k0 <= wq1 - a.window)) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int kp = k0 + (e / 4) * 8 + 2 * tq + (e & 1);
          const int qp = qpos0 + ((e >> 1) & 1) * 8;
          bool ok = kp < a.Skv;
          if (a.causal) ok = ok && kp <= qp;
          if (a.window > 0) ok = ok && kp > qp - a.window;
          if (!ok) {
            valid &= ~(1u << e);
            sc[e] = kNegInf;
          }
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        sum[r] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        sc[e] = (valid >> e) & 1 ? ex2(sc[e] - m[(e >> 1) & 1]) : 0.f;
        sum[(e >> 1) & 1] += sc[e];
      }
    };
    // rescale O (a warp skips it when no row's max moved: o * 1 == o)
    const auto rescale = [&](const float (&corr)[2], const float (&sum)[2]) {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int e = 0; e < kHD / 2; ++e) o[e] *= corr[(e >> 1) & 1];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    };
    // p's two bf16 halves in the A fragment layout: register j of k-step
    // kk is elements 8kk + 2j, 8kk + 2j + 1 of S's fragment
    const auto split = [&]() {
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * j],
                                                         sc[2 * j + 1]);
        p_hi[j] = bits(hi);
        p_lo[j] = bits(__floats2bfloat162_rn(sc[2 * j] - __low2float(hi),
                                             sc[2 * j + 1] - __high2float(hi)));
      }
    };

    bar_wait(q_full, 0);
    const int n = t1 - t0;
    float corr[2], sum[2];
    // S(i) is issued with P(i - 1) V(i - 1), and the softmax of tile i runs
    // on the CUDA cores while P(i - 1) V(i - 1) runs on the tensor cores
    if (n > 0) {
      bar_wait(k_full, 0);
      wg_fence();
      issue_s(0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      bar_arrive(k_empty);
      softmax(t0 * kBK, corr, sum);
      rescale(corr, sum);
      split();
    }
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages;
      bar_wait(k_full + 8 * s, (i / kStages) & 1);
      bar_wait(v_full + 8 * sp, ((i - 1) / kStages) & 1);
      wg_fence();
      issue_s(s);
      wg_commit();
      issue_pv(sp);
      wg_commit();
      wg_wait<1>();
      fence_regs(sc);
      bar_arrive(k_empty + 8 * s);
      softmax((t0 + i) * kBK, corr, sum);
      wg_wait<0>();
      fence_regs(o);
      bar_arrive(v_empty + 8 * sp);
      rescale(corr, sum);
      split();
    }
    if (n > 0) {
      const int sp = (n - 1) % kStages;
      bar_wait(v_full + 8 * sp, ((n - 1) / kStages) & 1);
      wg_fence();
      issue_pv(sp);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      bar_arrive(v_empty + 8 * sp);
    }

    // l over the quad (every lane the same bits), then the store
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = row0 + 8 * r;
      if (row >= a.Sq) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * a.Sq + row) * a.H + h) * a.hd;
#pragma unroll
      for (int j = 0; j < kHD / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < a.hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                    o[4 * j + 2 * r + 1] / den);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda the process has already loaded
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a (B, S, heads, hd) bf16 tensor, boxes of 64 columns x `rows` positions
// of one head, 128-byte swizzle, zeros outside the tensor
bool encode(EncodeTiled enc, CUtensorMap* map, const void* p, int B, int S,
            int heads, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = 2ull * hd;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * S};
  const cuuint32_t box[4] = {kCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kChunks>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // with no keys no K/V tile is loaded (and a map cannot have a 0 extent)
  CUtensorMap qm, km = {}, vm = {};
  if (!encode(enc, &qm, a.q, B, a.Sq, a.H, a.hd, kBQ)
      || (a.Skv > 0 && (!encode(enc, &km, a.k, B, a.Skv, a.KH, a.hd, kBK)
                        || !encode(enc, &vm, a.v, B, a.Skv, a.KH, a.hd,
                                   kBK))))
    return cudaErrorInvalidValue;
  const int smem = Smem<kChunks>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<kChunks>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.Sq + kBQ - 1) / kBQ);
  flash_bf16_kernel<kChunks><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

// hd a multiple of 8 and every pointer 16-byte aligned (TMA's strides and
// addresses); the wrapper pads the head dim otherwise
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (a.hd % 8 || !aligned(a.q) || !aligned(a.k) || !aligned(a.v)
      || !aligned(a.o))
    return cudaErrorInvalidValue;
  if (a.hd <= 64) return launch<1>(a, B, stream);
  if (a.hd <= 128) return launch<2>(a, B, stream);
  if (a.hd <= 256) return launch<4>(a, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace bf16k

// q/o (B, Sq, H, hd), k/v (B, Skv, KH, hd), all fp32 or all bf16
// (bf16 != 0), contiguous; hd <= 256, and for bf16 a multiple of 8 with
// 16-byte aligned pointers. Returns the launch's CUDA error.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      int causal, float cap, float scale,
                                      int window, int q_offset, int bf16,
                                      void* stream) {
  Args a{q, k, v, o, Sq, Skv, H, KH, hd, causal, window, q_offset, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? bf16k::dispatch(a, B, st)
                               : dispatch<float>(a, B, st));
}

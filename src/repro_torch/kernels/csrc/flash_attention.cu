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
// fp32 (tf32k::flash_tf32_kernel): on the tensor cores in split TF32
// (3xTF32). Every fp32 operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (cvt.rna: round to nearest, ties away), so hi + lo keeps
// about 22 of x's 24 bits, and a product runs as three TF32 wgmma
// products into one fp32 accumulator:
//   S = Qh Kh^T + Qh Kl^T + Ql Kh^T,   O += Ph Vh + Ph Vl + Pl Vh
// (the lo.lo term is below fp32's rounding of the sum). That executes
// 3 * 4*hd flops a pair at TF32's 495 TFLOP/s: 1.67 ms on the global
// layer at peak. TF32 wgmma takes both operands K-major, and for P.V the
// K dimension is the keys, so V must reach shared memory keys-contiguous,
// which TMA cannot do for 4-byte elements. A pre-pass (split_rows,
// split_vt) therefore writes the hi and lo planes of q and k, zero-padded
// to 64, 128 or 256 columns, and of V transposed to (hd, keys), into
// scratch the wrapper allocates; within each group of 8 keys the V copy
// stores key 2s at slot s and key 2s + 1 at slot s + 4, so that P's
// TF32 A fragment (rows g, g + 8; k-slots t, t + 4) is S's accumulator
// fragment (columns 2t, 2t + 1) with no shuffle. A block of 384 threads
// takes 64 query rows of one (b, h) (the hi and lo Q planes take 128 KB
// at hd 256, so one 64-row tile is all that fits): warpgroup 2 loads
// (one thread issues TMA), warpgroups 0 and 1 compute, each over every
// other key tile of 64 keys with its own m, l and O, so one warpgroup's
// softmax runs while the other's products keep the tensor cores busy;
// at the end they merge (m, l, O) through shared memory in a fixed order.
// Each consumer has a ring of its own (3 stages of 16 KB at hd 256: Q 128
// KB + 96 KB), each stage the hi and lo planes of one 64 x 32 fp32
// sub-tile with a "full" and an "empty" mbarrier: a tile's K in sub-tiles
// of 32 head dims, then its V in sub-tiles of 64 output dims x 32 keys.
// One ring shared by both consumers would not do: a consumer could wait on
// a stage by parity while the previous lap's load into it, for the other
// consumer, is still in flight (TMA completions are not ordered), and
// pass early. S(64 x 64) is hd / 8 x 3 m64n64k8 products from shared
// memory; O += P V is 8 x 3 m64n64k8 products a chunk of 64 output
// columns, A (P's halves) in registers. The softmax is the fp32 one above
// (accurate tanhf, the mask only on tiles that straddle the band's edge,
// p as e^x computed as ex2(x log2 e)). setmaxnreg gives the producer's
// registers to the consumers (40 / 232).
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Skv, H, KH, hd, causal, window, q_offset;
  float cap, scale;
};

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


namespace tf32k {

using bf16k::bar_arrive;
using bf16k::bar_expect_tx;
using bf16k::bar_init;
using bf16k::bar_wait;
using bf16k::encoder;
using bf16k::EncodeTiled;
using bf16k::ex2;
using bf16k::fence_regs;
using bf16k::sw128_desc;
using bf16k::tma_load;
using bf16k::wg_commit;
using bf16k::wg_fence;
using bf16k::wg_wait;

constexpr int kBQ = 64;           // query rows a block, both consumers'
constexpr int kBK = 64;           // keys a tile
constexpr int kThreads = 384;     // warpgroups 0, 1 compute, 2 loads
constexpr int kConsumer = 128;    // threads of a consumer warpgroup
constexpr int kCols = 32;         // fp32 columns of one 128-byte swizzled row
constexpr int kSub = 64 * 128;    // 64 rows x 128 bytes
constexpr int kStage = 2 * kSub;  // a ring stage: a sub-tile's hi and lo
constexpr int kSmemMax = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// shared memory, byte offsets from a 1024-aligned base: the Q tile (hi
// plane, then lo plane, 2 kC sub-tiles of 32 columns each), two rings of R
// stages (one per consumer warpgroup), then the barriers: q_full, full[2R],
// empty[2R]
template <int kC>
struct Smem {
  static constexpr int q_bytes = 2 * 2 * kC * kSub;
  static constexpr int ring_off = q_bytes;
  static constexpr int R = (kSmemMax - 1280 - q_bytes) / (2 * kStage);
  static constexpr int bar_off = ring_off + 2 * R * kStage;
  static constexpr int bytes = bar_off + 8 * (1 + 4 * R) + 1024;
  static_assert(R >= 2 && bytes <= kSmemMax, "shared memory");
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// S = A B (the first product of a tile: the accumulator is only written),
// m64n64k8, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]),
        "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]),
        "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// S += A B, m64n64k8, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// O += A B, m64n64k8, A in registers, B K-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// hi and lo planes of rows (rows, hd) into out (2, rows, hdp), zeros past hd
__global__ void split_rows(const float* x, float* out, size_t rows, int hd,
                           int hdp) {
  const size_t n = rows * hdp;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / hdp;
    const int c = static_cast<int>(i - r * hdp);
    const float v = c < hd ? x[r * hd + c] : 0.f;
    const uint32_t hi = to_tf32(v);
    out[i] = __uint_as_float(hi);
    out[n + i] = __uint_as_float(to_tf32(v - __uint_as_float(hi)));
  }
}

// V (B, Skv, KH, hd) into hi and lo planes (2, B, KH, hdp, Sp): the key
// axis contiguous, key 8g + 2s at slot 8g + s and 8g + 2s + 1 at slot
// 8g + s + 4 (s < 4), zeros past Skv and hd. A block transposes 32 keys x
// 32 dims through shared memory.
__global__ void split_vt(const float* v, float* out, int B, int Skv, int KH,
                         int hd, int hdp, int Sp) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int b = blockIdx.z / KH, kvh = blockIdx.z % KH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < 32; r += 8) {
    const int key = k0 + r, d = d0 + tx;
    tile[r][tx] = key < Skv && d < hd
                      ? v[((static_cast<size_t>(b) * Skv + key) * KH + kvh)
                          * hd + d]
                      : 0.f;
  }
  __syncthreads();
  const int s = tx & 7;
  const int key = (tx & ~7) + (s < 4 ? 2 * s : 2 * (s - 4) + 1);
  const size_t plane = static_cast<size_t>(B) * KH * hdp * Sp;
  for (int r = ty; r < 32; r += 8) {
    const float x = tile[key][r];
    const size_t at =
        ((static_cast<size_t>(b) * KH + kvh) * hdp + d0 + r) * Sp + k0 + tx;
    const uint32_t hi = to_tf32(x);
    out[at] = __uint_as_float(hi);
    out[plane + at] = __uint_as_float(to_tf32(x - __uint_as_float(hi)));
  }
}

// kC = hdp / 64 chunks of 64 head dims
template <int kC>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tf32_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Args a) {
  using L = Smem<kC>;
  constexpr int R = L::R;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, ring = base + L::ring_off;
  const uint32_t q_full = base + L::bar_off;
  const uint32_t full = q_full + 8, empty = full + 8 * 2 * R;

  const int tid = threadIdx.x, wg = tid / 128;
  // the grid is (head, batch, query tile), the query tiles in reverse:
  // under causality every head's heaviest tiles start first
  const int h = blockIdx.x, b = blockIdx.y, B = gridDim.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;
  const int kvh = h / (a.H / a.KH);
  // the key tiles that meet this query tile's band
  const int qp0 = a.q_offset + q0;
  const int qp1 = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int lo = 0, hi = a.Skv;
  if (a.window > 0) lo = max(lo, qp0 - a.window + 1);
  if (a.causal) hi = min(hi, qp1 + 1);
  const int t0 = lo / kBK;
  const int n = hi > lo ? (hi + kBK - 1) / kBK - t0 : 0;

  if (tid == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < 2 * R; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kConsumer);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread keeps the ring full, in stream order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (tid == 2 * 128) {
      bar_expect_tx(q_full, L::q_bytes);
      for (int p = 0; p < 2; ++p)
        for (int j = 0; j < 2 * kC; ++j)
          tma_load(q_s + (p * 2 * kC + j) * kSub, &qmap, q_full, j * kCols,
                   h, q0, p * B + b);
      // tile i goes to ring i % 2; a tile's stages: K sub-tiles of 32
      // columns j < 2 kC, then V stage j - 2 kC = (64-column chunk c, half
      // of the keys h) as 2c + h; the two tiles of a pair alternate
      int pos[2] = {0, 0};
      for (int i = 0; i < n; i += 2)
        for (int j = 0; j < 4 * kC; ++j)
          for (int ii = i; ii < min(i + 2, n); ++ii) {
            const int w = ii & 1, s = w * R + pos[w] % R;
            bar_wait(empty + 8 * s, ((pos[w] / R) & 1) ^ 1);
            ++pos[w];
            bar_expect_tx(full + 8 * s, kStage);
            const uint32_t dst = ring + s * kStage;
            const int t = t0 + ii;
            for (int p = 0; p < 2; ++p) {
              if (j < 2 * kC)
                tma_load(dst + p * kSub, &kmap, full + 8 * s, j * kCols, kvh,
                         t * kBK, p * B + b);
              else
                tma_load(dst + p * kSub, &vmap, full + 8 * s,
                         t * kBK + ((j - 2 * kC) & 1) * kCols,
                         64 * ((j - 2 * kC) >> 1), kvh, p * B + b);
            }
          }
    }
  } else {
    // a consumer warpgroup: the block's 64 rows over key tiles wg, wg + 2,
    // ... Thread (warp w, lane) holds rows 16w + lane/4 and 16w + lane/4 +
    // 8, and of each 8-column block n columns 8n + 2(lane%4) + {0, 1}:
    // element i of a fragment is row half (i >> 1) & 1, column 8(i / 4) +
    // 2(lane%4) + (i & 1) (wgmma's accumulator layout).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
    const int row0 = q0 + warp * 16 + lane / 4;   // and row0 + 8
    const int qpos0 = a.q_offset + row0;
    const int wq0 = a.q_offset + q0, wq1 = wq0 + kBQ - 1;
    const float pre = a.cap > 0.f ? a.scale / a.cap : a.scale;
    float o[kC][32];
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[32];
    uint32_t ph[32], pl[32];

    // S (+)= Q K^T over sub-tile j, 32 head dims: 4 steps of 8 columns.
    // The Q tile's address comes through an opaque move each call, so that
    // nvcc does not hoist the Q descriptors out of the loop and hold them
    // in registers (which serializes the wgmma pipeline)
    const auto issue_s = [&](uint32_t st, int j) {
      uint32_t qb;
      asm volatile("mov.b32 %0, %1;" : "=r"(qb) : "r"(q_s));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t qa = qb + j * kSub + kk * 32;
        const uint64_t qh = sw128_desc(qa, 16, 1024);
        const uint64_t ql = sw128_desc(qa + 2 * kC * kSub, 16, 1024);
        const uint64_t kh = sw128_desc(st + kk * 32, 16, 1024);
        const uint64_t kl = sw128_desc(st + kSub + kk * 32, 16, 1024);
        if (j == 0 && kk == 0) wgmma_ss_first(sc, qh, kh);
        else wgmma_ss(sc, qh, kh);
        wgmma_ss(sc, qh, kl);
        wgmma_ss(sc, ql, kh);
      }
    };
    // O[:, 64c .. 64c + 63] += P V over the keys' half h: 4 steps of 8
    const auto issue_pv = [&](uint32_t st, int h, float (&oc)[32]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vh = sw128_desc(st + kk * 32, 16, 1024);
        const uint64_t vl = sw128_desc(st + kSub + kk * 32, 16, 1024);
        wgmma_rs(oc, ph + 4 * (4 * h + kk), vh);
        wgmma_rs(oc, ph + 4 * (4 * h + kk), vl);
        wgmma_rs(oc, pl + 4 * (4 * h + kk), vh);
      }
    };
    // the tile's scores to p (in place, fp32), the row max over the quad's
    // 4 lanes, the rescale factor and this thread's share of the row sums
    const auto softmax = [&](int k0, float (&corr)[2], float (&sum)[2]) {
      if (a.cap > 0.f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = a.cap * tanhf(sc[e] * pre);
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] *= pre;
      }
      uint32_t valid = 0xffffffffu;   // bit e for element e
      if (k0 + kBK > a.Skv || (a.causal && k0 + kBK - 1 > wq0)
          || (a.window > 0 && k0 <= wq1 - a.window)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
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
      for (int e = 0; e < 32; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = ex2((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        sum[r] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = (valid >> e) & 1 ? ex2((sc[e] - m[(e >> 1) & 1]) * kLog2e)
                                 : 0.f;
        sum[(e >> 1) & 1] += sc[e];
      }
    };
    // rescale O (a warp skips it when no row's max moved: o * 1 == o)
    const auto rescale = [&](const float (&corr)[2], const float (&sum)[2]) {
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int e = 0; e < 32; ++e) o[c][e] *= corr[(e >> 1) & 1];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    };
    // p's TF32 halves in the A fragment layout: register 4kk + {0, 1, 2,
    // 3} of k-step kk is elements 4kk + {0, 2, 1, 3} of S's fragment (the
    // V copy's slot order)
    const auto split = [&]() {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int from[4] = {4 * kk, 4 * kk + 2, 4 * kk + 1, 4 * kk + 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t h_ = to_tf32(sc[from[e]]);
          ph[4 * kk + e] = h_;
          pl[4 * kk + e] = to_tf32(sc[from[e]] - __uint_as_float(h_));
        }
      }
    };

    // this warpgroup's ring, consumed in order: stage x at slot x % R
    const uint32_t ring_w = ring + wg * R * kStage;
    const uint32_t full_w = full + 8 * wg * R, empty_w = empty + 8 * wg * R;
    int x = 0;
    const auto acquire = [&]() {
      bar_wait(full_w + 8 * (x % R), (x / R) & 1);
      return ring_w + (x % R) * kStage;
    };
    const auto release = [&](int y) { bar_arrive(empty_w + 8 * (y % R)); };
    bar_wait(q_full, 0);
    for (int i = wg; i < n; i += 2) {
      // S over the 2 kC sub-tiles of K, one group each; a stage is released
      // once the group after it is issued and it is complete
#pragma unroll
      for (int j = 0; j < 2 * kC; ++j, ++x) {
        const uint32_t st = acquire();
        wg_fence();
        issue_s(st, j);
        wg_commit();
        if (j > 0) {
          wg_wait<1>();
          release(x - 1);
        }
      }
      wg_wait<0>();
      fence_regs(sc);
      release(x - 1);
      float corr[2], sum[2];
      softmax((t0 + i) * kBK, corr, sum);
      rescale(corr, sum);
      split();
#pragma unroll
      for (int j = 0; j < 2 * kC; ++j, ++x) {
        const uint32_t st = acquire();
        wg_fence();
        issue_pv(st, j & 1, o[j >> 1]);
        wg_commit();
        if (j > 0) {
          wg_wait<1>();
          release(x - 1);
        }
      }
      wg_wait<0>();
#pragma unroll
      for (int c = 0; c < kC; ++c) fence_regs(o[c]);
      release(x - 1);
    }

    // l over the quad (every lane the same bits); then warpgroup 1 hands
    // (m, l, O) to warpgroup 0 through the Q tile's space, fragment by
    // fragment, and warpgroup 0 merges and stores
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float* xo = reinterpret_cast<float*>(smem_raw + (base - raw));
    const int ct = tid % 128;
    asm volatile("bar.sync 1, 256;" ::: "memory");   // Q and the ring read
    if (wg == 1) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) xo[(c * 32 + e) * kConsumer + ct] = o[c][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xo[(kC * 32 + r) * kConsumer + ct] = m[r];
        xo[(kC * 32 + 2 + r) * kConsumer + ct] = l[r];
      }
    }
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (wg == 0) {
      float* out = static_cast<float*>(a.o);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xo[(kC * 32 + r) * kConsumer + ct];
        const float l1 = xo[(kC * 32 + 2 + r) * kConsumer + ct];
        const float mm = fmaxf(m[r], m1);
        const float c0 = ex2((m[r] - mm) * kLog2e);
        const float c1 = ex2((m1 - mm) * kLog2e);
        const float den = fmaxf(l[r] * c0 + l1 * c1, 1e-30f);
        const int row = row0 + 8 * r;
        if (row >= a.Sq) continue;
        float* orow =
            out + ((static_cast<size_t>(b) * a.Sq + row) * a.H + h) * a.hd;
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int e = 4 * j + 2 * r + x;
              const int col = 64 * c + 8 * j + 2 * tq + x;
              if (col < a.hd)
                orow[col] = (o[c][e] * c0
                             + xo[(c * 32 + e) * kConsumer + ct] * c1) / den;
            }
      }
    }
  }
}

// a 4-D fp32 tensor of extents dims (innermost first), boxes of 32 x box1
// x box2 x 1 elements, 128-byte swizzle, zeros outside the tensor
bool encode(EncodeTiled enc, CUtensorMap* map, const void* p,
            const cuuint64_t (&dims)[4], cuuint32_t box1, cuuint32_t box2) {
  const cuuint64_t strides[3] = {4 * dims[0], 4 * dims[0] * dims[1],
                                 4 * dims[0] * dims[1] * dims[2]};
  const cuuint32_t box[4] = {kCols, box1, box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kC>
cudaError_t launch(const Args& a, int B, const float* qs, const float* ks,
                   const float* vs, int hdp, int Sp, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  // with no keys no K/V tile is loaded (and a map cannot have a 0 extent)
  CUtensorMap qm, km = {}, vm = {};
  const cuuint64_t qd[4] = {static_cast<cuuint64_t>(hdp),
                            static_cast<cuuint64_t>(a.H),
                            static_cast<cuuint64_t>(a.Sq),
                            static_cast<cuuint64_t>(2 * B)};
  const cuuint64_t kd[4] = {static_cast<cuuint64_t>(hdp),
                            static_cast<cuuint64_t>(a.KH),
                            static_cast<cuuint64_t>(a.Skv),
                            static_cast<cuuint64_t>(2 * B)};
  const cuuint64_t vd[4] = {static_cast<cuuint64_t>(Sp),
                            static_cast<cuuint64_t>(hdp),
                            static_cast<cuuint64_t>(a.KH),
                            static_cast<cuuint64_t>(2 * B)};
  if (!encode(enc, &qm, qs, qd, 1, kBQ)
      || (a.Skv > 0 && (!encode(enc, &km, ks, kd, 1, kBK)
                        || !encode(enc, &vm, vs, vd, 64, 1))))
    return cudaErrorInvalidValue;
  const int smem = Smem<kC>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32_kernel<kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.H, B, (a.Sq + kBQ - 1) / kBQ);
  flash_tf32_kernel<kC><<<grid, kThreads, smem, stream>>>(qm, km, vm, a);
  return cudaGetLastError();
}

// the hi/lo pre-pass into `scratch` (2 (B Sq H + B Skv KH) hdp + 2 B KH hdp
// Sp floats; hdp 64, 128 or 256, Sp rounded up to 64), then the kernel. A
// head dim past 128 takes the 4-chunk kernel: the 3-chunk one spilled
cudaError_t dispatch(const Args& a, int B, float* scratch,
                     size_t scratch_bytes, cudaStream_t stream) {
  const int hdp = a.hd <= 64 ? 64 : a.hd <= 128 ? 128 : 256;
  const int Sp = (a.Skv + 63) / 64 * 64;
  const size_t nq = static_cast<size_t>(B) * a.Sq * a.H * hdp;
  const size_t nk = static_cast<size_t>(B) * a.Skv * a.KH * hdp;
  const size_t nv = static_cast<size_t>(B) * a.KH * hdp * Sp;
  if (a.hd > 256 || scratch == nullptr
      || scratch_bytes < 2 * sizeof(float) * (nq + nk + nv))
    return cudaErrorInvalidValue;
  float* qs = scratch;
  float* ks = qs + 2 * nq;
  float* vs = ks + 2 * nk;
  split_rows<<<1024, 256, 0, stream>>>(static_cast<const float*>(a.q), qs,
                                       static_cast<size_t>(B) * a.Sq * a.H,
                                       a.hd, hdp);
  if (a.Skv > 0) {
    split_rows<<<1024, 256, 0, stream>>>(static_cast<const float*>(a.k), ks,
                                         static_cast<size_t>(B) * a.Skv * a.KH,
                                         a.hd, hdp);
    split_vt<<<dim3(Sp / 32, hdp / 32, B * a.KH), dim3(32, 8), 0, stream>>>(
        static_cast<const float*>(a.v), vs, B, a.Skv, a.KH, a.hd, hdp, Sp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (hdp == 64) return launch<1>(a, B, qs, ks, vs, hdp, Sp, stream);
  if (hdp == 128) return launch<2>(a, B, qs, ks, vs, hdp, Sp, stream);
  return launch<4>(a, B, qs, ks, vs, hdp, Sp, stream);
}

}  // namespace tf32k

// q/o (B, Sq, H, hd), k/v (B, Skv, KH, hd), all fp32 or all bf16
// (bf16 != 0), contiguous; hd <= 256, and for bf16 a multiple of 8 with
// 16-byte aligned pointers; fp32 takes `scratch` for its hi/lo pre-pass
// (tf32k::dispatch gives its size). Returns the launch's CUDA error.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      int causal, float cap, float scale,
                                      int window, int q_offset, int bf16,
                                      void* scratch, size_t scratch_bytes,
                                      void* stream) {
  Args a{q, k, v, o, Sq, Skv, H, KH, hd, causal, window, q_offset, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? bf16k::dispatch(a, B, st)
           : tf32k::dispatch(a, B, static_cast<float*>(scratch),
                             scratch_bytes, st));
}

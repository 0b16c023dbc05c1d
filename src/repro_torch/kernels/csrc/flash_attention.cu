// K15: online-softmax attention on Hopper, the score matrix kept on chip.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (line 87,
// pallas_call at 121). q (B, Sq, H, hd), k/v (B, Skv, KH, hd), fp32 or
// bf16 (loaded as bf16, computed in fp32, rounded once at the store);
// query head h reads kv head h / G. For query row i at position
// qp = q_offset + i and key j:
//   valid = j < Skv && i < Sq && (!causal || j <= qp)
//                              && (window <= 0 || j > qp - window),
//   s = (q . k) * scale, s = cap * tanh(s / cap) when cap > 0,
//   s = valid ? s : -1e30,
// and per key tile the online softmax
//   m' = max(m, max_j s), p = valid ? e^(s - m') : 0, c = e^(m - m'),
//   l = l c + sum_j p, acc = acc c + p V, m = m',
// then o = acc / max(l, 1e-30): a row with no valid key gives 0.
//
// What bounds it: operations. A valid pair costs 4*hd flops (q.k and
// p v); at gemma2-2b's prefill (8 heads, 8,192 positions, hd 256, causal)
// that is 2.75e11 flops, 4.1 ms at fp32's 67 TFLOP/s, against 0.2 GB of
// q, k, v and o (0.06 ms at 3.35 TB/s).
//
// Design. The TPU tile (512 query rows at hd 256) is a 512 KiB fp32
// accumulator; here one block of 256 threads takes kBQ = 64 query rows of
// one (b, h), warp w owns rows 8w .. 8w+7, and the keys stream in tiles of
// kBK = 32, one key per lane. The accumulator lives in registers: lane l of
// warp w holds rows 8w.. x dims l, l+32, .. (kDpt = ceil(hd/32) <= 8, so
// at most 64 floats). Shared memory holds the query tile (64 x hd), the
// key tile with an odd row stride (the lanes' column reads fall in
// distinct banks), the value tile and each warp's p tile: 139,392 bytes at
// hd 256, set through cudaFuncSetAttribute. A lane computes its key's
// score for the warp's 8 rows (an fmaf chain over d, the query values
// broadcast from shared memory); the row max and sum are xor-butterfly
// shuffles, the same bits in every lane; p goes through the warp's p tile
// into the P V update, keys in ascending order. The block visits only the
// key tiles that meet its query tile's band: [max(0, qp0 - window + 1),
// min(Skv, qp1 + 1)) under a window and causality, which is the work the
// TPU kernel's skip of fully masked tiles leaves; a tile it skips would
// change nothing. No atomics: two launches give the same bits. The sums
// run in another order than the twin's matmuls, so kernel and twin agree
// to a tolerance. fp32 on the CUDA cores; tensor cores (wgmma) and TMA
// staging are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                 // query rows per warp
constexpr int kBQ = kWarps * kRows;      // 64 query rows per block
constexpr int kBK = 32;                  // keys per tile, one per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

// q/o (B, Sq, H, hd), k/v (B, Skv, KH, hd), all fp32 or all bf16
// (bf16 != 0), contiguous; hd <= 256. Returns the launch's CUDA error.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KH, int hd,
                                      int causal, float cap, float scale,
                                      int window, int q_offset, int bf16,
                                      void* stream) {
  Args a{q, k, v, o, Sq, Skv, H, KH, hd, causal, window, q_offset, cap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? dispatch<__nv_bfloat16>(a, B, st)
                               : dispatch<float>(a, B, st));
}

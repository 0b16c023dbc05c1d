// K16: single-token decode attention over a product-quantized KV cache on
// Hopper.
//
// Replaces src/repro/kernels/pq_decode.py::pq_decode_attention (line 89,
// pallas_call at 119). For batch b, kv head kh and query head
// h = kh*G + g, over the positions p < cache_len of the cache,
//   s_p = (q_h . k_p) * hd^-0.5,   k_p = concat_s k_cb[kh, s, kcode[p, s]],
//   o_h = sum_p softmax(s)_p v_p,  v_p = concat_s v_cb[kh, s, vcode[p, s]],
// with o_h = 0 when no position is valid (l clamped to 1e-30, acc 0).
//
// What bounds it: bytes and launch latency. One layer at gemma2-2b's
// width reads 2 bytes x n_sub codes per position and kv head (1 MiB at
// 8,192 positions) and both codebooks (2 MiB): about 1 us at 3.35 TB/s,
// under the latency of one launch. The work is as small: per position and
// query head n_sub table lookups and hd multiply-adds.
//
// Design. The TPU kernel keeps one kv head's codebooks resident in VMEM;
// at hd 256, n_sub 16 they are 512 KiB, past a block's 227 KB. So
//  1. pq_lut_kernel scores K through a table instead of reconstructing it:
//     lut[b, kh, g, s, c] = q_(kh*G+g), sub-space s . k_cb[kh, s, c], one
//     thread per code (n_codes = 256), an ascending fmaf chain over the
//     dsub coordinates; G*n_sub*256 floats a kv head (32 KiB at G = 2).
//  2. pq_split_kernel splits the sequence: one block per (chunk of kChunk
//     positions, kv head, batch), so B*KH = 4 blocks become 128 at 8,192
//     positions. It stages the LUT and the chunk's codes in shared memory,
//     scores position p0 + tid (lut sums in ascending s, then * scale),
//     takes the chunk's max m_c and l_c = sum exp(s - m_c) by a fixed
//     shared-memory tree, and accumulates acc_c = sum_p p_p v_p for the
//     output dims a thread owns (dim j = tid, tid + 256, ...), positions in
//     ascending order, reading V's codebook rows from device memory, where
//     a layer's 1 MiB of them stays in the 50 MB L2. Chunks at or past
//     cache_len exit at once.
//  3. pq_combine_kernel merges the chunks below cache_len in ascending
//     order: M = max m_c, L = sum l_c e^(m_c - M), o = sum acc_c e^(m_c - M)
//     / max(L, 1e-30), stored in q's dtype.
// Every sum has one order and no atomics, so two launches give the same
// bits. The order differs from the twin's reconstruct-then-dot (and the
// TPU kernel's), so kernel and twin agree to a tolerance, not bitwise.
// cache_len is read on the device (from len_ptr when given), so a decode
// step never waits for the host; a length past S counts S positions, a
// negative one none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;   // positions per split block, one per thread
constexpr int kCodes = 256;   // uint8 codes
constexpr int kGroup = 8;     // query heads accumulated per pass over V
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int valid_len(const int* len_ptr, int len_val,
                                         int S) {
  const int len = len_ptr ? *len_ptr : len_val;
  return len < 0 ? 0 : (len > S ? S : len);
}

// a fixed tree over kThreads values in shared memory (max or sum); every
// thread gets the result
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w)
      red[tid] = kMax ? fmaxf(red[tid], red[tid + w]) : red[tid] + red[tid + w];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pq_lut_kernel(const T* q, const float* k_cb, float* lut, int KH, int G,
                  int hd, int n_sub) {
  extern __shared__ float qs[];  // (G, dsub) sub-space s of each query head
  const int s = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int c = threadIdx.x;
  const int dsub = hd / n_sub;
  for (int i = threadIdx.x; i < G * dsub; i += kThreads) {
    const int g = i / dsub, e = i % dsub;
    qs[i] = load_f(q + (((size_t)b * KH + kh) * G + g) * hd + s * dsub + e);
  }
  __syncthreads();
  const float* row = k_cb + (((size_t)kh * n_sub + s) * kCodes + c) * dsub;
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
    for (int e = 0; e < dsub; ++e) acc = fmaf(qs[g * dsub + e], row[e], acc);
    lut[((((size_t)b * KH + kh) * G + g) * n_sub + s) * kCodes + c] = acc;
  }
}

struct SplitArgs {
  const uint8_t* k_codes;  // (B, S, KH, n_sub)
  const uint8_t* v_codes;
  const float* v_cb;       // (KH, n_sub, 256, dsub)
  const float* lut;        // (B, KH, G, n_sub, 256)
  const int* len_ptr;      // device cache_len, or null: len_val
  float* part_m;           // (B, KH, nc, G)
  float* part_l;           // (B, KH, nc, G)
  float* part_acc;         // (B, KH, nc, G, hd)
  int S, KH, G, hd, n_sub, len_val;
  float scale;
};

__global__ void __launch_bounds__(kThreads) pq_split_kernel(SplitArgs a) {
  const int chunk = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int len = valid_len(a.len_ptr, a.len_val, a.S);
  const int p0 = chunk * kChunk;
  if (p0 >= len) return;  // the combine reads only chunks below len
  const int count = min(kChunk, len - p0);
  const int G = a.G, hd = a.hd, n_sub = a.n_sub, tid = threadIdx.x;
  const int dsub = hd / n_sub;
  extern __shared__ float smem[];
  float* lut = smem;                          // (G, n_sub, 256)
  float* ps = lut + G * n_sub * kCodes;       // (G, kChunk) scores, then p
  float* red = ps + G * kChunk;               // (kThreads,)
  uint8_t* kc = reinterpret_cast<uint8_t*>(red + kThreads);  // (kChunk, n_sub)
  uint8_t* vc = kc + kChunk * n_sub;                         // (kChunk, n_sub)

  const float* lut_g = a.lut + ((size_t)b * a.KH + kh) * G * n_sub * kCodes;
  for (int i = tid; i < G * n_sub * kCodes; i += kThreads) lut[i] = lut_g[i];
  for (int i = tid; i < count * n_sub; i += kThreads) {
    const int p = i / n_sub, s = i % n_sub;
    const size_t at = (((size_t)b * a.S + p0 + p) * a.KH + kh) * n_sub + s;
    kc[i] = a.k_codes[at];
    vc[i] = a.v_codes[at];
  }
  __syncthreads();

  const size_t part = (((size_t)b * a.KH + kh) * nc + chunk) * G;
  for (int g = 0; g < G; ++g) {
    float sc = kNegInf;
    if (tid < count) {
      const float* lg = lut + g * n_sub * kCodes;
      float acc = 0.f;
      for (int s = 0; s < n_sub; ++s) acc += lg[s * kCodes + kc[tid * n_sub + s]];
      sc = acc * a.scale;
    }
    const float m = block_reduce<true>(sc, red);
    const float p = tid < count ? expf(sc - m) : 0.f;
    const float l = block_reduce<false>(p, red);
    ps[g * kChunk + tid] = p;
    if (tid == 0) {
      a.part_m[part + g] = m;
      a.part_l[part + g] = l;
    }
  }
  __syncthreads();

  for (int j = tid; j < hd; j += kThreads) {
    const int s = j / dsub, e = j % dsub;
    const float* cb = a.v_cb + (((size_t)kh * n_sub + s) * kCodes) * dsub + e;
    for (int g0 = 0; g0 < G; g0 += kGroup) {
      const int ng = min(kGroup, G - g0);
      float acc[kGroup];
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg) acc[gg] = 0.f;
      // unrolled so that several codebook reads are in flight at once;
      // each acc still adds the positions in ascending order
#pragma unroll 8
      for (int p = 0; p < count; ++p) {
        const float v = __ldg(cb + (size_t)vc[p * n_sub + s] * dsub);
#pragma unroll
        for (int gg = 0; gg < kGroup; ++gg)
          if (gg < ng) acc[gg] = fmaf(ps[(g0 + gg) * kChunk + p], v, acc[gg]);
      }
      for (int gg = 0; gg < ng; ++gg)
        a.part_acc[(part + g0 + gg) * hd + j] = acc[gg];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pq_combine_kernel(const float* part_m, const float* part_l,
                      const float* part_acc, const int* len_ptr, int len_val,
                      T* out, int S, int KH, int G, int hd, int nc) {
  extern __shared__ float w[];  // (nc,) e^(m_c - M) of one query head
  __shared__ float l_s;
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int len = valid_len(len_ptr, len_val, S);
  const int active = (len + kChunk - 1) / kChunk;
  const size_t base = ((size_t)b * KH + kh) * nc;
  for (int g = 0; g < G; ++g) {
    if (tid == 0) {
      float M = kNegInf;
      for (int c = 0; c < active; ++c) M = fmaxf(M, part_m[(base + c) * G + g]);
      float L = 0.f;
      for (int c = 0; c < active; ++c) {
        w[c] = expf(part_m[(base + c) * G + g] - M);
        L += part_l[(base + c) * G + g] * w[c];
      }
      l_s = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int j = tid; j < hd; j += kThreads) {
      float o = 0.f;
      for (int c = 0; c < active; ++c)
        o = fmaf(part_acc[((base + c) * G + g) * hd + j], w[c], o);
      store_f(out + (((size_t)b * KH + kh) * G + g) * hd + j, o / l_s);
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* q, const SplitArgs& a, const float* k_cb,
                   float* lut, void* out, int B, cudaStream_t stream) {
  const int dsub = a.hd / a.n_sub;
  pq_lut_kernel<T><<<dim3(a.n_sub, a.KH, B), kThreads,
                     sizeof(float) * a.G * dsub, stream>>>(
      static_cast<const T*>(q), k_cb, lut, a.KH, a.G, a.hd, a.n_sub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int nc = a.S > 0 ? (a.S + kChunk - 1) / kChunk : 1;
  const size_t smem = sizeof(float) * (a.G * a.n_sub * kCodes + a.G * kChunk +
                                       kThreads) +
                      2 * kChunk * a.n_sub;
  err = cudaFuncSetAttribute(pq_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  pq_split_kernel<<<dim3(nc, a.KH, B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t wsmem = sizeof(float) * nc;
  err = cudaFuncSetAttribute(pq_combine_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
  if (err != cudaSuccess) return err;
  pq_combine_kernel<T><<<dim3(a.KH, B), kThreads, wsmem, stream>>>(
      a.part_m, a.part_l, a.part_acc, a.len_ptr, a.len_val,
      static_cast<T*>(out), a.S, a.KH, a.G, a.hd, nc);
  return cudaGetLastError();
}

}  // namespace

// q (B, 1, H, hd) fp32 or bf16 (bf16 != 0), H = KH*G; the codes and
// codebooks as above; len_ptr a device int32 or null (then len_val);
// lut, part_m, part_l and part_acc scratch the caller allocates; out like
// q. Returns the first CUDA error of the three launches.
extern "C" int pq_decode_launch(const void* q, const void* k_codes,
                                const void* v_codes, const void* k_cb,
                                const void* v_cb, const void* len_ptr,
                                void* lut, void* part_m, void* part_l,
                                void* part_acc, void* out, int B, int S,
                                int KH, int G, int hd, int n_sub, int len_val,
                                int bf16, float scale, void* stream) {
  SplitArgs a;
  a.k_codes = static_cast<const uint8_t*>(k_codes);
  a.v_codes = static_cast<const uint8_t*>(v_codes);
  a.v_cb = static_cast<const float*>(v_cb);
  a.lut = static_cast<const float*>(lut);
  a.len_ptr = static_cast<const int*>(len_ptr);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.S = S;
  a.KH = KH;
  a.G = G;
  a.hd = hd;
  a.n_sub = n_sub;
  a.len_val = len_val;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kcb = static_cast<const float*>(k_cb);
  float* lt = static_cast<float*>(lut);
  return static_cast<int>(
      bf16 ? launch<__nv_bfloat16>(q, a, kcb, lt, out, B, st)
           : launch<float>(q, a, kcb, lt, out, B, st));
}

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
// What bounds it: launch latency. One layer at gemma2-2b's width reads
// 2 bytes x n_sub codes per position and kv head (1 MiB at 8,192
// positions) and both codebooks (2 MiB): about 1 us at 3.35 TB/s, under
// the latency of one launch. The work is as small: per position and query
// head n_sub table lookups and hd multiply-adds.
//
// Design (decode_kernel, two launches a call). The TPU kernel keeps one kv
// head's codebooks resident in VMEM; at hd 256, n_sub 16 they are 512 KiB,
// past a block's 227 KB. So
//  1. pq_lut_kernel scores K through a table instead of reconstructing it:
//     lut[b, kh, g, s, c] = q_(kh*G+g), sub-space s . k_cb[kh, s, c], one
//     thread per code (256), an ascending fmaf chain over the dsub
//     coordinates. It lets the next launch start at once (programmatic
//     dependent launch).
//  2. decode_kernel: one block per (chunk of `chunk` positions, slice of
//     `dims` <= 64 head dims, kv head, batch), about one block an SM (128
//     blocks of 1,024 positions and 64 dims at gemma2-2b's 8,192
//     positions). Gathering V's code rows from device memory would cross
//     L2 once a position (32 MiB a layer there: an L2-bound 7.5 us); a
//     block instead stages its slice's codebook rows (256 x dims floats,
//     64 KiB) with its codes before it waits for the table
//     (griddepcontrol.wait), and reads V from shared memory. Then for
//     each group of query heads whose table rows fit (all of them at
//     gemma2-2b; the rows are read from device memory where not even one
//     head's (n_sub, 256) rows fit): it stages the rows, scores each
//     position (lookups added in ascending s, then * scale), takes the
//     chunk's max m and l = sum exp(s - m) by a warp per head (lanes over
//     positions in ascending order, then a fixed xor-shuffle tree), and
//     accumulates acc = sum_p p_p v_p over its dims: a thread owns V
//     consecutive dims of one sub-space row, the block's threads split the
//     positions into interleaved lanes, each lane adds its positions in
//     ascending order and the lanes are added in order 0, 1, ... It writes
//     the chunk's (m, l, acc), fences, and counts its arrival for (b, kh,
//     slice); the last block to arrive merges the chunks below cache_len
//     in ascending chunk order: M = max m_c, w_c = e^(m_c - M), L = sum
//     l_c w_c (lanes and a fixed tree), o = sum_c acc_c w_c (one fmaf chain
//     in ascending c) / max(L, 1e-30), in q's dtype. The arrival counter
//     wraps to 0 as the last block counts (atomicInc at active - 1), so no
//     launch resets it; its wrap value comes from the same read of
//     cache_len as the chunks' own. Every slice's blocks score the chunk
//     (the lookups are cheap beside the V rows).
// Every sum has one order and the only atomics are integer ones, so two
// launches give the same bits. The order differs from the twin's
// reconstruct-then-dot (and the TPU kernel's), so kernel and twin agree to
// a tolerance (2e-4), not bitwise. cache_len is read on the device (from
// len_ptr when given), so a decode step never waits for the host; a length
// past S counts S positions, a negative one none.
//
// pq_decode_template_launch keeps the kernel before (three launches: the
// table, a split over 256-position chunks with the whole (G, n_sub, 256)
// table staged, and an ordered combine) for the card's comparisons; it
// refuses what its staging does not hold.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the table kernel's and the template's
constexpr int kChunk = 256;   // template: positions per split block
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
  // the dependent launch (decode_kernel) may start now: it waits for this
  // grid's table before it reads it
  asm volatile("griddepcontrol.launch_dependents;");
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
cudaError_t launch_template(const void* q, const SplitArgs& a,
                            const float* k_cb, float* lut, void* out, int B,
                            cudaStream_t stream) {
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
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // the refusal is this call's, not the next's
    return err;
  }
  pq_split_kernel<<<dim3(nc, a.KH, B), kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t wsmem = sizeof(float) * nc;
  err = cudaFuncSetAttribute(pq_combine_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)wsmem);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return err;
  }
  pq_combine_kernel<T><<<dim3(a.KH, B), kThreads, wsmem, stream>>>(
      a.part_m, a.part_l, a.part_acc, a.len_ptr, a.len_val,
      static_cast<T*>(out), a.S, a.KH, a.G, a.hd, nc);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// decode_kernel: a block per (chunk of positions, slice of head dims, kv
// head); the last block of a (slice, kv head) to finish merges its chunks
// ---------------------------------------------------------------------------

constexpr int kDecodeThreads = 512;
constexpr int kDecodeWarps = kDecodeThreads / 32;
// one block an SM: all of its shared memory but the static part
constexpr int kDecodeSmem = 232448 - 1024;

struct DecodeArgs {
  const void* q;           // (B, KH*G, hd), T
  const uint8_t* k_codes;  // (B, S, KH, n_sub)
  const uint8_t* v_codes;
  const float* k_cb;       // (KH, n_sub, 256, dsub)
  const float* v_cb;       // (KH, n_sub, 256, dsub)
  const float* lut;        // (B, KH, G, n_sub, 256), pq_lut_kernel's
  const int* len_ptr;      // device cache_len, or null: len_val
  float* part_m;           // (B, KH, Q, nc, G): m, then the merge's weights
  float* part_l;           // (B, KH, Q, nc, G)
  float* part_acc;         // (B, KH, nc, G, hd)
  unsigned* arrivals;      // (B*KH*Q,) all 0 between launches
  void* out;               // like q
  int S, KH, G, hd, n_sub, len_val;
  int chunk;               // positions a block
  int dims;                // head dims a block (hd / dims = Q slices)
  int gh;                  // query heads a group
  int staged;              // the group's table rows in shared memory
  float scale;
};

// sub-spaces a slice of `dims` head dims can touch, at most
__host__ __device__ inline int max_subspaces(int dims, int dsub, int n_sub) {
  const int ns = (dims - 1) / dsub + 2;
  return ns < n_sub ? ns : n_sub;
}

// byte offsets of decode_kernel's shared memory, on host and device alike
struct Layout {
  int cbs, lut, ps, red, codes, bytes;
  __host__ __device__ Layout(int gh, int n_sub, int hd, int dims, int chunk,
                             int V, bool staged) {
    const int lanes = kDecodeThreads / (dims / V);
    const int vg = gh < kGroup ? gh : kGroup;
    const int ns = max_subspaces(dims, hd / n_sub, n_sub);
    int at = 0;
    cbs = at;    // (256, dims) the slice's codebook rows
    at += 4 * kCodes * dims;
    lut = at;    // (gh, n_sub, 256) table rows
    at += staged ? 4 * gh * n_sub * kCodes : 0;
    ps = at;     // (gh, chunk) scores, then p; the merge's (gh,) L
    at += 4 * gh * chunk;
    red = at;    // (lanes, vg, dims) the lanes' sums
    at += 4 * lanes * vg * dims;
    codes = at;  // (chunk, n_sub) K codes, then (chunk, ns) V codes
    at += chunk * (n_sub + ns);
    bytes = (at + 15) & ~15;
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a fixed xor tree: every lane ends with the same bits (a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int V>
struct Vec { float v[V]; };

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r.v[0] = x.x; r.v[1] = x.y;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const Vec<V>& r) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(r.v[0], r.v[1]);
  else
    *p = r.v[0];
}

template <typename T, int V>
__global__ void __launch_bounds__(kDecodeThreads, 1)
    decode_kernel(DecodeArgs a) {
  const int G = a.G, hd = a.hd, n_sub = a.n_sub, C = a.chunk, D = a.dims;
  const int Q = hd / D, chunk = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / Q, qi = blockIdx.y - kh * Q;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane32 = tid % 32;
  const int dsub = hd / n_sub, d0 = qi * D, s_lo = d0 / dsub;
  const int ns = max_subspaces(D, dsub, n_sub);
  const size_t bk = (size_t)b * a.KH + kh, bkq = bk * Q + qi;
  T* out = static_cast<T*>(a.out) + bk * G * hd + d0;
  const int len = valid_len(a.len_ptr, a.len_val, a.S);
  const int active = (len + C - 1) / C;
  if (active == 0) {  // no valid position: zeros, no merge
    if (chunk == 0)
      for (int i = tid; i < G * D; i += kDecodeThreads)
        store_f(out + (size_t)(i / D) * hd + i % D, 0.f);
    return;
  }
  if (chunk >= active) return;  // the merge reads only chunks below len
  const int p0 = chunk * C, count = min(C, len - p0);
  const int cols = D / V, lanes = kDecodeThreads / cols;
  const int lane = tid / cols, jj0 = (tid - lane * cols) * V;
  const Layout lay(a.gh, n_sub, hd, D, C, V, a.staged);
  extern __shared__ __align__(16) unsigned char dsmem[];
  float* cbs = reinterpret_cast<float*>(dsmem + lay.cbs);
  float* lut_s = reinterpret_cast<float*>(dsmem + lay.lut);
  float* ps = reinterpret_cast<float*>(dsmem + lay.ps);
  float* red = reinterpret_cast<float*>(dsmem + lay.red);
  uint8_t* kc = dsmem + lay.codes;
  uint8_t* vc = kc + C * n_sub;
  __shared__ int last;
  __shared__ float st[2 * kDecodeWarps];  // the warps' partial m and l

  // the slice's codebook rows, cbs[c, jj] = v_cb[kh, s, c, e] at head dim
  // d0 + jj = s*dsub + e, V floats of one sub-space a copy
  for (int i = tid; i < kCodes * cols; i += kDecodeThreads) {
    const int c = i / cols, jj = (i - c * cols) * V, j = d0 + jj;
    const int s = j / dsub, e = j - s * dsub;
    store_vec<V>(cbs + c * D + jj,
                 load_vec<V>(a.v_cb + ((size_t)(kh * n_sub + s) * kCodes + c)
                                          * dsub + e));
  }
  // the chunk's K codes (whole rows, in 16-byte or 4-byte words where
  // they allow) and the V codes of the slice's sub-spaces s_lo, s_lo + 1,
  const size_t row0 = ((size_t)b * a.S + p0) * a.KH + kh;  // position p0
  const size_t stride = (size_t)a.KH * n_sub;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.k_codes);
  if (n_sub % 16 == 0 && (base & 15) == 0 && (lay.codes & 15) == 0) {
    const int nw = n_sub / 16;
    for (int i = tid; i < count * nw; i += kDecodeThreads) {
      const int p = i / nw, w = i - p * nw;
      reinterpret_cast<uint4*>(kc)[i] = reinterpret_cast<const uint4*>(
          a.k_codes + (row0 * n_sub + p * stride))[w];
    }
  } else if (n_sub % 4 == 0 && (base & 3) == 0) {
    const int nw = n_sub / 4;
    for (int i = tid; i < count * nw; i += kDecodeThreads) {
      const int p = i / nw, w = i - p * nw;
      reinterpret_cast<uint32_t*>(kc)[i] = reinterpret_cast<const uint32_t*>(
          a.k_codes + (row0 * n_sub + p * stride))[w];
    }
  } else {
    for (int i = tid; i < count * n_sub; i += kDecodeThreads) {
      const int p = i / n_sub, s = i - p * n_sub;
      kc[i] = a.k_codes[row0 * n_sub + p * stride + s];
    }
  }
  const int ns_here = min(ns, n_sub - s_lo);
  for (int i = tid; i < count * ns_here; i += kDecodeThreads) {
    const int p = i / ns_here, s = i - p * ns_here;
    vc[p * ns + s] = a.v_codes[row0 * n_sub + p * stride + s_lo + s];
  }
  // pq_lut_kernel's table is complete and visible past this point
  asm volatile("griddepcontrol.wait;" ::: "memory");

  const size_t part0 = (bkq * nc + chunk) * G;   // m, l: (b, kh, qi, chunk)
  const size_t acc0 = (bk * nc + chunk) * G;     // acc: (b, kh, chunk)
  for (int g0 = 0; g0 < G; g0 += a.gh) {
    const int ng = min(a.gh, G - g0);
    const float* lut_g = a.lut + (bk * G + g0) * n_sub * kCodes;
    if (a.staged) {
      const float4* src = reinterpret_cast<const float4*>(lut_g);
      float4* dst = reinterpret_cast<float4*>(lut_s);
      for (int i = tid; i < ng * n_sub * kCodes / 4; i += kDecodeThreads)
        dst[i] = src[i];
    }
    __syncthreads();
    const float* lt = a.staged ? lut_s : lut_g;
    // scores: the lookups added in ascending s, then * scale
    for (int i = tid; i < ng * count; i += kDecodeThreads) {
      const int g = i / count, p = i - g * count;
      const float* lg = lt + (size_t)g * n_sub * kCodes;
      float acc = 0.f;
      if (n_sub % 4 == 0) {
        const uint32_t* kw =
            reinterpret_cast<const uint32_t*>(kc + p * n_sub);
        for (int s4 = 0; s4 < n_sub / 4; ++s4) {
          const uint32_t w = kw[s4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc += lg[(s4 * 4 + k) * kCodes + ((w >> (8 * k)) & 255u)];
        }
      } else {
        const uint8_t* kp = kc + p * n_sub;
        for (int s = 0; s < n_sub; ++s) acc += lg[s * kCodes + kp[s]];
      }
      ps[g * C + p] = acc * a.scale;
    }
    __syncthreads();
    // the chunk's m and l: kw warps a head (one where the heads are as
    // many as the warps), a warp's lanes over interleaved positions in
    // ascending order, then a fixed xor tree; the warps' sums added in
    // warp order
    const int kw = ng < kDecodeWarps ? kDecodeWarps / ng : 1;
    for (int wg = warp; wg < ng * kw; wg += kDecodeWarps) {
      const int g = wg / kw, k = wg - g * kw;
      const float* pg = ps + g * C;
      float m = -CUDART_INF_F;
      for (int p = k * 32 + lane32; p < count; p += kw * 32)
        m = fmaxf(m, pg[p]);
      m = warp_max(m);
      if (kw == 1) {
        float* pw = ps + g * C;
        float l = 0.f;
        for (int p = lane32; p < count; p += 32) {
          const float e = expf(pw[p] - m);
          pw[p] = e;
          l += e;
        }
        l = warp_sum(l);
        if (lane32 == 0) {
          a.part_m[part0 + g0 + g] = m;
          a.part_l[part0 + g0 + g] = l;
        }
      } else if (lane32 == 0) {
        st[wg] = m;
      }
    }
    if (kw > 1) {
      __syncthreads();
      if (warp < ng * kw) {
        const int g = warp / kw, k = warp - g * kw;
        float m = st[g * kw];
        for (int i = 1; i < kw; ++i) m = fmaxf(m, st[g * kw + i]);
        float* pg = ps + g * C;
        float l = 0.f;
        for (int p = k * 32 + lane32; p < count; p += kw * 32) {
          const float e = expf(pg[p] - m);
          pg[p] = e;
          l += e;
        }
        l = warp_sum(l);
        __syncwarp();
        if (lane32 == 0) st[kDecodeWarps + warp] = l;
        if (k == 0 && lane32 == 0) a.part_m[part0 + g0 + g] = m;
      }
      __syncthreads();
      if (tid < ng) {
        float l = st[kDecodeWarps + tid * kw];
        for (int i = 1; i < kw; ++i) l += st[kDecodeWarps + tid * kw + i];
        a.part_l[part0 + g0 + tid] = l;
      }
    }
    __syncthreads();
    // acc over the slice's dims, kGroup heads a pass: a thread owns V
    // dims (one sub-space's), the lanes take interleaved positions in
    // ascending order, then the lanes are added in order
    const int sv = (d0 + jj0) / dsub - s_lo;
    for (int r0 = 0; r0 < ng; r0 += kGroup) {
      const int nr = min(kGroup, ng - r0);
      float acc[kGroup][V] = {};
      const float* pr = ps + r0 * C;
#pragma unroll 4
      for (int p = lane < lanes ? lane : count; p < count; p += lanes) {
        const Vec<V> x = load_vec<V>(cbs + vc[p * ns + sv] * D + jj0);
#pragma unroll
        for (int gg = 0; gg < kGroup; ++gg) {
          if (gg < nr) {
            const float w = pr[gg * C + p];
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[gg][v] = fmaf(w, x.v[v], acc[gg][v]);
          }
        }
      }
#pragma unroll
      for (int gg = 0; gg < kGroup; ++gg)
        if (gg < nr && lane < lanes)
#pragma unroll
          for (int v = 0; v < V; ++v)
            red[(lane * nr + gg) * D + jj0 + v] = acc[gg][v];
      __syncthreads();
      // the lanes' sums: `parts` threads an output (a power of two), each
      // adding lanes part, part + parts, ... in order, then a fixed xor
      // tree over the parts
      int parts = 1;
      while (parts * 2 <= 32 && parts * 2 <= lanes &&
             parts * 2 * nr * D <= kDecodeThreads)
        parts *= 2;
      for (int t0 = 0; t0 < nr * D * parts; t0 += kDecodeThreads) {
        const int t = t0 + tid, i = t / parts, part = t - i * parts;
        const bool valid = i < nr * D;  // whole groups of parts threads
        float s = 0.f;
        if (valid) {
          s = red[part * nr * D + i];
          for (int l = part + parts; l < lanes; l += parts)
            s += red[l * nr * D + i];
        }
        for (int off = parts / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off, parts);
        const int gg = i / D;
        if (valid && part == 0)
          a.part_acc[(acc0 + g0 + r0 + gg) * hd + d0 + i - gg * D] = s;
      }
      __syncthreads();
    }
  }

  // count this block's arrival; the last of the active chunks merges
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(a.arrivals + bkq, (unsigned)(active - 1)) ==
           (unsigned)(active - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t mbase = bkq * nc * G;   // (b, kh, qi, chunk 0)
  const size_t abase = bk * nc * G;    // (b, kh, chunk 0)
  for (int g0 = 0; g0 < G; g0 += a.gh) {
    const int ng = min(a.gh, G - g0);
    for (int g = warp; g < ng; g += kDecodeWarps) {
      const size_t at = mbase + g0 + g;
      float M = -CUDART_INF_F;
      for (int c = lane32; c < active; c += 32)
        M = fmaxf(M, __ldcg(a.part_m + at + (size_t)c * G));
      M = warp_max(M);
      float L = 0.f;
      for (int c = lane32; c < active; c += 32) {
        const float l = __ldcg(a.part_l + at + (size_t)c * G);
        const float w = expf(__ldcg(a.part_m + at + (size_t)c * G) - M);
        a.part_m[at + (size_t)c * G] = w;  // read back below
        L += l * w;
      }
      L = warp_sum(L);
      if (lane32 == 0) ps[g] = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int i = tid; i < ng * D; i += kDecodeThreads) {
      const int g = i / D, jj = i - g * D;
      float o = 0.f;
#pragma unroll 8
      for (int c = 0; c < active; ++c)
        o = fmaf(__ldcg(a.part_acc + (abase + (size_t)c * G + g0 + g) * hd
                        + d0 + jj),
                 __ldcg(a.part_m + mbase + (size_t)c * G + g0 + g), o);
      store_f(out + (size_t)(g0 + g) * hd + jj, o / ps[g]);
    }
    __syncthreads();
  }
}

// raises decode_kernel<T, V>'s dynamic shared memory limit to `bytes` where
// it is below, once per device
template <typename T, int V>
cudaError_t allow_smem(int bytes) {
  static int allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (bytes <= 48 * 1024 || (dev < 64 && bytes <= allowed[dev]))
    return cudaSuccess;
  err = cudaFuncSetAttribute(decode_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();  // the refusal is this call's, not the next's
    return err;
  }
  if (dev < 64) allowed[dev] = bytes;
  return err;
}

template <typename T, int V>
cudaError_t launch_decode(DecodeArgs a, int B, cudaStream_t stream) {
  // the most query heads a group whose table rows fit; where not even one
  // head's do, the rows are read from device memory
  a.staged = 1;
  a.gh = a.G;
  while (a.gh > 0 && Layout(a.gh, a.n_sub, a.hd, a.dims, a.chunk, V, true)
                             .bytes > kDecodeSmem)
    --a.gh;
  if (a.gh == 0) {
    a.staged = 0;
    a.gh = a.G;
    while (a.gh > 1 && Layout(a.gh, a.n_sub, a.hd, a.dims, a.chunk, V, false)
                               .bytes > kDecodeSmem)
      --a.gh;
  }
  const int smem =
      Layout(a.gh, a.n_sub, a.hd, a.dims, a.chunk, V, a.staged).bytes;
  if (smem > kDecodeSmem) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem<T, V>(smem);
  if (err != cudaSuccess) return err;
  const int dsub = a.hd / a.n_sub;
  pq_lut_kernel<T><<<dim3(a.n_sub, a.KH, B), kThreads,
                     sizeof(float) * a.G * dsub, stream>>>(
      static_cast<const T*>(a.q), a.k_cb, const_cast<float*>(a.lut),
      a.KH, a.G, a.hd, a.n_sub);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nc = a.S > 0 ? (a.S + a.chunk - 1) / a.chunk : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc, a.KH * (a.hd / a.dims), B);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_kernel<T, V>, a);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode_v(const DecodeArgs& a, int B, int vec,
                            cudaStream_t stream) {
  if (vec == 4) return launch_decode<T, 4>(a, B, stream);
  if (vec == 2) return launch_decode<T, 2>(a, B, stream);
  return launch_decode<T, 1>(a, B, stream);
}

}  // namespace

// The kernel before: q (B, 1, H, hd) fp32 or bf16 (bf16 != 0), H = KH*G;
// the codes and codebooks as above; len_ptr a device int32 or null (then
// len_val); lut, part_m, part_l and part_acc (nc = ceil(S / 256) chunks)
// scratch the caller allocates; out like q. Returns the first CUDA error of
// the three launches.
extern "C" int pq_decode_template_launch(const void* q, const void* k_codes,
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
      bf16 ? launch_template<__nv_bfloat16>(q, a, kcb, lt, out, B, st)
           : launch_template<float>(q, a, kcb, lt, out, B, st));
}

// K16: q (B, 1, H, hd) fp32 or bf16 (bf16 != 0), H = KH*G; the codes and
// codebooks as above; len_ptr a device int32 or null (then len_val); lut
// (B, KH, G, n_sub, 256), part_m, part_l (B, KH, Q, nc, G) and part_acc
// (B, KH, nc, G, hd), nc = ceil(S / chunk) and Q = hd / dims, scratch the
// caller allocates; arrivals (B*KH*Q,) uint32, all 0 (the kernel leaves
// them 0); out like q. chunk: positions a block; dims: head dims a block
// (it divides hd, at most 64); vec: floats a thread copies and reads at
// once (4, 2 or 1; it divides dsub and dims, and v_cb is aligned to it).
// The decode kernel is launched as the table kernel's programmatic
// dependent. Returns the first CUDA error of the launches.
extern "C" int pq_decode_launch(const void* q, const void* k_codes,
                                const void* v_codes, const void* k_cb,
                                const void* v_cb, const void* len_ptr,
                                void* lut, void* part_m, void* part_l,
                                void* part_acc, void* arrivals, void* out,
                                int B, int S, int KH, int G, int hd,
                                int n_sub, int len_val, int bf16, float scale,
                                int chunk, int dims, int vec,
                                void* stream) {
  if (chunk < 1 || dims < 1 || dims > 64 || hd % dims || dims % vec)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.q = q;
  a.k_codes = static_cast<const uint8_t*>(k_codes);
  a.v_codes = static_cast<const uint8_t*>(v_codes);
  a.k_cb = static_cast<const float*>(k_cb);
  a.v_cb = static_cast<const float*>(v_cb);
  a.lut = static_cast<const float*>(lut);
  a.len_ptr = static_cast<const int*>(len_ptr);
  a.part_m = static_cast<float*>(part_m);
  a.part_l = static_cast<float*>(part_l);
  a.part_acc = static_cast<float*>(part_acc);
  a.arrivals = static_cast<unsigned*>(arrivals);
  a.out = out;
  a.S = S;
  a.KH = KH;
  a.G = G;
  a.hd = hd;
  a.n_sub = n_sub;
  a.len_val = len_val;
  a.chunk = chunk;
  a.dims = dims;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bf16 ? launch_decode_v<__nv_bfloat16>(a, B, vec, st)
           : launch_decode_v<float>(a, B, vec, st));
}

// Flash attention on Hopper (sm_90a): softmax(q k^T * d^-1/2) v with
// causal and sliding-window masks, an optional tanh softcap and grouped KV
// heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel) and computes what the plain
// version (kernels/flash_attention/ref.py) computes: query t sees key s when
// s < S, s <= t (causal) and s > t - window (window > 0); scores, softmax
// and the product with v are float32; o is written in q's type (float32 or
// bf16, one template).
//
// Where it runs: every layer of the prefill forward (self-attention over the
// whole prompt, no cache), 4 x 1024 tokens x 16 heads x 128 dims at
// qwen3-0.6b's width.
//
// What bounds it on this card: with bf16 inputs, the least time is the
// multiply-adds of the visible (t, s) pairs at the tensor-core rate, just
// above the bytes of q, k, v and o. This first kernel does its math on the
// CUDA cores from shared memory, so it stays well above that bound; wgmma
// and TMA are later work.
//
// Design (not the Pallas grid carried over block by block):
//  * One block per (b * H + h, 64-query tile); the Pallas kernel's
//    sequential KV grid axis becomes a loop inside the block, carrying the
//    running max m, denominator l and the 64 x HD output accumulator (in
//    registers) across KV tiles: an online softmax in float32.
//  * KV tiles that no query of the tile can see under the causal or window
//    mask are never loaded: the loop runs only over the visible range.
//  * GQA: the block reads KV head h / (H / KV) directly. q, k, v and o keep
//    the (B, T, heads, HD) layout and are addressed by strides, so there is
//    no transposing copy and no broadcast of KV over the group.
//  * Keys at or beyond S are masked inside the kernel for every mask mode
//    (the Pallas wrapper pads S and leaves padded keys visible when
//    non-causal).
//  * The q, k and v tiles are staged in shared memory as float32; the q and
//    k rows are padded to HD + 1 words so the score loop reads them without
//    bank conflicts. 256 threads: each computes 4 x 4 scores, then 4 threads
//    per query row reduce max and sum with warp shuffles, then each thread
//    updates 4 rows x HD / 16 columns of the accumulator.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // queries per block
constexpr int kBK = 64;   // keys per KV tile
constexpr float kMaskInit = -1.0e30f;  // running max before any key

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {  // in elements; the head-dim stride is 1
  int64_t b, t, h;
};

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1) +
         3 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int T_len, int S_len,
             int H, int KV, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, float softcap, float scale) {
  static_assert(HD % 16 == 0, "HD must be a multiple of 16");
  constexpr int QS = HD + 1;       // padded row stride of the q and k tiles
  constexpr int PS = kBK + 1;      // row stride of the score tile
  constexpr int NJ = HD / 16;      // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // kBQ x QS
  float* k_s = q_s + kBQ * QS;         // kBK x QS
  float* v_s = k_s + kBK * QS;         // kBK x HD
  float* p_s = v_s + kBK * HD;         // kBQ x PS
  float* m_s = p_s + kBQ * PS;         // kBQ running max
  float* l_s = m_s + kBQ;              // kBQ running denominator
  float* c_s = l_s + kBQ;              // kBQ correction of this tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int t = q0 + r;
    q_s[r * QS + d] = t < T_len ? to_f32(qb[t * qs.t + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kMaskInit;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // KV tiles visible to some query of [q0, q_last]
  const int q_last = min(q0 + kBQ, T_len) - 1;
  int kt_end = (S_len + kBK - 1) / kBK;
  if (causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;  // first key the first query can see
    kt_begin = lo > 0 ? lo / kBK : 0;
  }
  __syncthreads();

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int s = k0 + r;
      const bool in = s < S_len;
      k_s[r * QS + d] = in ? to_f32(kb[s * ks.t + d]) : 0.f;
      v_s[r * HD + d] = in ? to_f32(vb[s * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i, keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int t = q0 + r, s = k0 + c;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = s < S_len;
        if (causal) ok = ok && s <= t;
        if (window > 0) ok = ok && s > t - window;
        p_s[r * PS + c] = ok ? x : -INFINITY;
      }
    __syncthreads();

    // online softmax: 4 threads per row, 16 keys each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = p_s + r * PS + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float x = row[c];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int t = q0 + r;
    if (t < T_len) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        ob[t * os.t + tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int T_len, int S_len, int H, int KV, Strides qs, Strides ks,
              Strides vs, Strides os, int causal, int window, float softcap,
              cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * static_cast<int>(sizeof(float));
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((T_len + kBQ - 1) / kBQ, B * H);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), T_len, S_len, H, KV, qs,
      ks, vs, os, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T_len, int S_len, int H, int KV, int HD, const int64_t* st,
           int causal, int window, float softcap, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S_len <= 0) return cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  switch (HD) {
#define REPRO_FLASH_HD(N)                                                    \
  case N:                                                                    \
    return launch_hd<T, N>(q, k, v, o, B, T_len, S_len, H, KV, qs, ks, vs, \
                           os, causal, window, softcap, s);
    REPRO_FLASH_HD(16)
    REPRO_FLASH_HD(32)
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, H, HD), k and v (B, S, KV, HD), o (B, T, H, HD) on the current
// device, each with unit stride along HD; strides holds the (b, t, head)
// strides in elements of q, k, v and o, in that order (12 values). HD is
// 16, 32, 64, 128 or 256. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int T,
                                   int S, int H, int KV, int HD,
                                   const int64_t* strides, int causal,
                                   int window, float softcap, void* stream) {
  return launch<float>(q, k, v, o, B, T, S, H, KV, HD, strides, causal,
                       window, softcap, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int T,
                                    int S, int H, int KV, int HD,
                                    const int64_t* strides, int causal,
                                    int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, T, S, H, KV, HD, strides,
                               causal, window, softcap, stream);
}

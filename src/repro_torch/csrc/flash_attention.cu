// Flash attention on Hopper (sm_90a): softmax(q k^T * d^-1/2) v with
// causal and sliding-window masks, an optional tanh softcap and grouped KV
// heads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel) and computes what the plain
// version (kernels/flash_attention/ref.py) computes: query t sees key s when
// s < S, s <= t (causal) and s > t - window (window > 0); scores, softmax
// and the sums of the product with v are float32; o is written in q's type.
//
// Where it runs: every layer of the prefill forward (self-attention over the
// whole prompt, no cache), 4 x 1024 tokens x 16 heads x 128 dims at
// qwen3-0.6b's width.
//
// The log-sum-exp: both bodies optionally write lse (B, H, T) float32,
// lse[b, h, t] = log sum_s exp(x_ts) over the keys row t sees, in natural
// log units of the scaled and softcapped score x_ts = softcap(q_t . k_s
// d^-1/2), the units the backward kernel (flash_attention_bwd.cu) reads.
// The wgmma body keeps its running max in the log2 domain, so it writes
// (m + log2 l) ln 2. A row that sees no key gets +inf, so the backward's
// exp(x - lse) is 0 there. A null pointer writes nothing (the serve and
// prefill launches).
//
// What bounds it on this card: with bf16 inputs, the multiply-adds of the
// visible (t, s) pairs at the tensor-core rate, just above the bytes of q,
// k, v and o.
//
// Two bodies, one entry point each; the wrapper (kernels/flash_attention/
// ops.py) picks by type, head_dim and alignment, never by a failure:
//
// 1. The wgmma body (flash_wgmma_kernel): bf16 inputs at head_dim 64, 128,
//    192 and 256 whose (b, t, head) strides are multiples of 8 elements and
//    whose pointers are 16-byte aligned, as TMA requires. Every bf16 model
//    config takes it (qwen3 hd 128; nemotron-4-340b hd 192; gemma, gemma2,
//    recurrentgemma hd 256).
//  * The pieces this body shares with the backward's (mbarriers, TMA loads,
//    descriptors, the two m64n64k16 products, the tensor maps) live in
//    wgmma.cuh.
//  * One block per (b * H + h, 128-query tile), two warpgroups of 64 query
//    rows. The grid is ordered so that the last query tiles, which see the
//    most keys under the causal mask, start first.
//  * Q is loaded once by TMA, K and V tiles of 64 keys by TMA into a ring of
//    two stages; each stage's completion is an mbarrier with a transaction
//    count, and tile j + 1 is in flight while tile j is computed. One
//    __syncthreads a tile frees the stage that the next load refills.
//  * 128-byte swizzle: a TMA box's inner extent is then at most 128 bytes
//    (64 bf16), so a row of hd = 128, 192 or 256 comes as 2, 3 or 4 boxes,
//    each its own 1024-byte aligned region (8 rows of 128 bytes form one
//    swizzle atom). The wgmma shared-memory descriptors say the same:
//    swizzle mode 1 (128 B) in bits 62-63, stride byte offset 1024 between
//    8-row groups, and for a k16 step the start address advanced 32 bytes
//    inside the swizzled row (q, k: K-major) or 2048 bytes, two 8-key
//    groups (v).
//  * S = Q K^T: wgmma m64n64k16 with both operands from shared memory, q
//    rows and k rows K-major as stored, f32 accumulators in registers.
//  * Softmax on the accumulator fragment, in the log2 domain (exp2f): a
//    thread holds 2 rows x 16 keys; row maxima across the 4 lanes of a quad
//    by shuffles; the row sums stay per thread until the epilogue (the
//    correction factor is uniform over a quad). Scale, softcap and masks
//    are applied there; the masks only on tiles that straddle a boundary
//    (causal diagonal, window edge, s >= S). Zero-filled keys beyond S give
//    a score of 0, so s >= S is masked explicitly. The running max starts
//    at the finite kMaskInit, so a row whose first tiles are all masked
//    never computes exp(-inf - (-inf)).
//  * O += P V: the S fragment of keys 16 j .. 16 j + 15, packed pairwise to
//    bf16x2, is the A-register fragment of a k16 step (the PTX ISA's
//    m64nNk16 D and A layouts agree: rows lane / 4 and + 8, columns
//    2 (lane % 4) + {0, 1} and + 8). V is the B operand from shared memory
//    as stored, (keys x hd), MN-major, read through wgmma's transpose bit;
//    one m64n64k16 per 64 columns of hd, so no descriptor spans two boxes.
//    P is rounded to bf16 here, as in every tensor-core flash attention;
//    the denominator sums the unrounded float32 p. That rounding is what
//    flash_attention_tolerance's bf16-P term covers.
//  * wgmma ordering: wgmma.fence before each group (the accumulators and P
//    were written by ordinary code), commit_group / wait_group 0 before the
//    softmax or the epilogue reads an accumulator. Only TMA and wgmma touch
//    the staged tiles, both in the async proxy, so no proxy fence is needed
//    after the barrier init's.
//  * Tensor maps: encoded on the host for every call (the pointers change)
//    through cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint so
//    the library needs no -lcuda; three 4-D maps (hd, heads, len, batch).
//    Their host cost lies inside the eager time chip_smoke.py prints beside
//    the device time (not measured apart). They are passed by value as
//    __grid_constant__ kernel parameters, so a CUDA graph captures them.
//  * GQA: the k and v maps' head coordinate is h / (H / KV); nothing is
//    broadcast. Rows t >= T are zero-filled by TMA and not written.
//  * Registers: at hd = 256 the O accumulator is 128 floats a thread; with
//    256 threads and one block an SM a thread may hold 255. Shared memory at
//    hd = 256: Q 64 KB + 2 stages x (K + V) 128 KB. hd = 192 (3 boxes) needs
//    three quarters of both: 96 floats of O a thread, 144 KB.
//
// 2. The CUDA-core body (flash_kernel), for everything else: float32 inputs
//    (the tests, the float32 configs), head_dim 16 and 32 (no config uses
//    them), and bf16 views whose strides TMA cannot take. It is the first
//    port of the kernel, kept as it was:
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

#include "wgmma.cuh"

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
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int T_len, int S_len,
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
  if (lse != nullptr && tid < kBQ && q0 + tid < T_len) {
    const float l = l_s[tid];
    lse[static_cast<int64_t>(bh) * T_len + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(l) : INFINITY;
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_len, int S_len, int H, int KV,
              Strides qs, Strides ks, Strides vs, Strides os, int causal,
              int window, float softcap, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, T_len, S_len, H, KV,
      qs, ks, vs, os, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_len, int S_len, int H, int KV, int HD,
           const int64_t* st, int causal, int window, float softcap,
           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S_len <= 0) return cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  switch (HD) {
#define REPRO_FLASH_HD(N)                                                    \
  case N:                                                                    \
    return launch_hd<T, N>(q, k, v, o, lse, B, T_len, S_len, H, KV, qs, ks, \
                           vs, os, causal, window, softcap, s);
    REPRO_FLASH_HD(16)
    REPRO_FLASH_HD(32)
    REPRO_FLASH_HD(64)
    REPRO_FLASH_HD(128)
    REPRO_FLASH_HD(192)
    REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The wgmma body
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kThreads = 256;      // two consumer warpgroups
constexpr int kBQ = 128;           // queries per block, 64 per warpgroup
constexpr int kBK = 64;            // keys per KV tile
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// KV tiles [begin, end) that some query of [first, last] sees
__device__ __forceinline__ void visible_tiles(int first, int last, int S_len,
                                              int causal, int window,
                                              int& begin, int& end) {
  end = (S_len + kBK - 1) / kBK;
  if (causal) end = min(end, last / kBK + 1);
  begin = 0;
  if (window > 0) {
    const int lo = first - window + 1;
    begin = lo > 0 ? lo / kBK : 0;
  }
}

template <int HD>
constexpr int smem_bytes() {
  // Q, then kStages x (K, V), then 3 mbarriers; 1024 bytes of slack to
  // align the base
  return (HD / 64) * (kBQ * 128 + 2 * kStages * kBK * 128) + 64 + 1024;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int T_len, int S_len, int H,
                   int KV, int BH, int n_qt, Strides os, int causal,
                   int window, float softcap, float scale) {
  constexpr int NB = HD / 64;               // 64-column boxes of a row
  constexpr int kQBox = kBQ * 128;          // bytes of a 128-row box
  constexpr int kKVBox = kBK * 128;         // bytes of a 64-row box
  constexpr int kQBytes = NB * kQBox;
  constexpr int kKVBytes = NB * kKVBox;     // one K (or V) tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + kQBytes;                  // + stage * kKVBytes
  const uint32_t sv = sk + kStages * kKVBytes;       // + stage * kKVBytes
  const uint32_t bar_q = sv + kStages * kKVBytes;
  const uint32_t bar_kv = bar_q + 8;                 // + stage * 8

  const int tid = threadIdx.x;
  const int wgi = tid / 128;                // warpgroup
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // last first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBQ;
  const int qw = q0 + 64 * wgi;             // first row of this warpgroup
  const int row0 = qw + 16 * warp + lane / 4;   // this thread's rows: row0,
                                                // row0 + 8
  int kt_begin, kt_end, w_begin, w_end;
  visible_tiles(q0, min(q0 + kBQ, T_len) - 1, S_len, causal, window,
                kt_begin, kt_end);
  const bool active = qw < T_len;
  const int w_last = min(qw + 63, T_len - 1);
  visible_tiles(qw, w_last, S_len, causal, window, w_begin, w_end);
  const int n_tiles = kt_end - kt_begin;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int stage, int kt) {
    const uint32_t bar = bar_kv + 8 * stage;
    mbar_expect_tx(bar, 2 * kKVBytes);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sk + stage * kKVBytes + j * kKVBox, &tk, bar, 64 * j, kvh,
               kt * kBK, b);
      tma_load(sv + stage * kKVBytes + j * kKVBox, &tv, bar, 64 * j, kvh,
               kt * kBK, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, kQBytes);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load(sq + j * kQBox, &tq, bar_q, 64 * j, h, q0, b);
    if (n_tiles > 0) load_kv(0, kt_begin);
  }
  __syncwarp();

  float oacc[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[j][i] = 0.f;
  float m_run[2] = {kMaskInit, kMaskInit};
  float l_part[2] = {0.f, 0.f};      // this thread's share of the row sums
  const float scale_log2 = scale * kLog2e;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt_begin + it, st = it % kStages;
    if (tid == 0 && it + 1 < n_tiles) load_kv((it + 1) % kStages, kt + 1);
    __syncwarp();
    mbar_wait(bar_kv + 8 * st, (it / kStages) & 1);
    if (active && kt >= w_begin && kt < w_end) {
      // S = Q K^T over HD / 16 k16 steps
      float s[32];
      fence_regs(s);
      fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 bf16 along the row
        const uint64_t da =
            desc_sw128(sq + (kk / 4) * kQBox + wgi * 64 * 128 + off);
        const uint64_t db =
            desc_sw128(sk + st * kKVBytes + (kk / 4) * kKVBox + off);
        mma_ss(s, da, db, kk > 0);
      }
      commit();
      wait_all();
      fence_regs(s);

      // scale, softcap and masks, in the log2 domain
      const int k0 = kt * kBK;
      const bool edge = k0 + kBK > S_len || (causal && k0 + kBK - 1 > qw) ||
                        (window > 0 && k0 <= w_last - window);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * i + e];
          if (softcap > 0.f)
            x = tanhf(x * scale / softcap) * softcap * kLog2e;
          else
            x *= scale_log2;
          if (edge) {
            const int col = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
            const int t = row0 + 8 * (e >> 1);
            bool ok = col < S_len;
            if (causal) ok = ok && col <= t;
            if (window > 0) ok = ok && col > t - window;
            if (!ok) x = -INFINITY;
          }
          s[4 * i + e] = x;
        }
      // online softmax: row r holds s[4 i + 2 r], s[4 i + 2 r + 1]
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          mx = fmaxf(mx, fmaxf(s[4 * i + 2 * r], s[4 * i + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[r], mx);
        corr[r] = exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(s[4 * i + 2 * r + c] - m_new);
            s[4 * i + 2 * r + c] = p;
            sum += p;
          }
        l_part[r] = l_part[r] * corr[r] + sum;
      }
      // P in bf16 as the A fragments of the four k16 steps
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          oacc[j][4 * i + 0] *= corr[0];
          oacc[j][4 * i + 1] *= corr[0];
          oacc[j][4 * i + 2] *= corr[1];
          oacc[j][4 * i + 3] *= corr[1];
        }
      // O += P V: per k16 step (16 keys, 2 x 8-row groups = 2048 bytes of
      // the V box) one product per 64 columns of hd
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_regs(oacc[j]);
      fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          mma_rs(oacc[j], pa[kk],
                 desc_sw128(sv + st * kKVBytes + j * kKVBox + kk * 2048));
      commit();
      wait_all();
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_regs(oacc[j]);
    }
    __syncthreads();   // both warpgroups are done with stage st
  }

  if (!active) return;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
    // the log2-domain max and sum, written in natural log units
    const int t = row0 + 8 * r;
    if (lse != nullptr && lane % 4 == 0 && t < T_len)
      lse[static_cast<int64_t>(bh) * T_len + t] =
          l > 0.f ? (m_run[r] + log2f(l)) * 0.6931471805599453f : INFINITY;
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(ob + t * os.t + col) =
            __floats2bfloat162_rn(oacc[j][4 * i + 2 * r] * inv[r],
                                  oacc[j][4 * i + 2 * r + 1] * inv[r]);
      }
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int T_len, int S_len, int H, int KV,
              Strides qs, Strides ks, Strides vs, Strides os, int causal,
              int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left for the next call to report
      return static_cast<int>(e);
    }
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, HD, H, T_len, B, qs.b, qs.t, qs.h, kBQ) ||
      !encode(&tk, k, HD, KV, S_len, B, ks.b, ks.t, ks.h, kBK) ||
      !encode(&tv, v, HD, KV, S_len, B, vs.b, vs.t, vs.h, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (T_len + kBQ - 1) / kBQ;
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_wgmma_kernel<HD><<<n_qt * B * H, kThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, T_len, S_len, H, KV,
      B * H,
      n_qt, os, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int T_len, int S_len, int H, int KV, int HD,
           const int64_t* st, int causal, int window, float softcap,
           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S_len <= 0) return cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  switch (HD) {
    case 64:
      return launch_hd<64>(q, k, v, o, lse, B, T_len, S_len, H, KV, qs, ks,
                           vs, os, causal, window, softcap, s);
    case 128:
      return launch_hd<128>(q, k, v, o, lse, B, T_len, S_len, H, KV, qs, ks,
                            vs, os, causal, window, softcap, s);
    case 192:
      return launch_hd<192>(q, k, v, o, lse, B, T_len, S_len, H, KV, qs, ks,
                            vs, os, causal, window, softcap, s);
    case 256:
      return launch_hd<256>(q, k, v, o, lse, B, T_len, S_len, H, KV, qs, ks,
                            vs, os, causal, window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

// q (B, T, H, HD), k and v (B, S, KV, HD), o (B, T, H, HD) on the current
// device, each with unit stride along HD; strides holds the (b, t, head)
// strides in elements of q, k, v and o, in that order (12 values). HD is
// 16, 32, 64, 128, 192 or 256. lse, when not null, receives (B, H, T)
// float32 contiguous (see the note at the top). Returns the CUDA error of
// the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, float* lse, int B,
                                   int T, int S, int H, int KV, int HD,
                                   const int64_t* strides, int causal,
                                   int window, float softcap, void* stream) {
  return launch<float>(q, k, v, o, lse, B, T, S, H, KV, HD, strides, causal,
                       window, softcap, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, float* lse, int B,
                                    int T, int S, int H, int KV, int HD,
                                    const int64_t* strides, int causal,
                                    int window, float softcap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, T, S, H, KV, HD, strides,
                               causal, window, softcap, stream);
}

// The wgmma body: bf16 q, k, v, o as above, HD 64, 128, 192 or 256, every
// (b, t, head) stride a multiple of 8 elements and q, k, v 16-byte aligned
// (TMA's terms). Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue also when a tensor map does not encode.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* o, float* lse,
                                          int B, int T, int S, int H, int KV,
                                          int HD, const int64_t* strides,
                                          int causal, int window,
                                          float softcap, void* stream) {
  return wg::launch(q, k, v, o, lse, B, T, S, H, KV, HD, strides, causal,
                    window, softcap, stream);
}

// Backward of flash attention on Hopper (sm_90a): dq, dk and dv of
// o = softmax(x) v, x_ts = softcap(q_t . k_s d^-1/2), with causal and
// sliding-window masks, an optional tanh softcap and grouped KV heads.
//
// Backs the hand-written forward (flash_attention.cu), which replaces the
// TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas. The reference has no backward kernel: it
// differentiates its jnp attention (src/repro/nn/attention.py). Where the
// port runs K5's forward, this kernel stands where that gradient stands,
// and it computes what the plain version flash_attention_bwd_plain
// (kernels/flash_attention/ref.py) computes:
//
//   P_ts  = exp(x_ts - lse_t)           (0 where row t does not see key s)
//   D_t   = sum_d do_td o_td
//   dS_ts = P_ts (do_t . v_s - D_t) (1 - tanh^2(raw_ts / cap))  [softcap]
//   dv_s  = sum_t P_ts do_t,   dk_s = d^-1/2 sum_t dS_ts q_t,
//   dq_t  = d^-1/2 sum_s dS_ts k_s
//
// lse is the forward's log-sum-exp in natural log units of x (see
// flash_attention.cu); P is recomputed from it in float32 with expf, never
// stored. Every sum is float32; dq, dk, dv are written once in the inputs'
// type. Keys at or beyond S and queries at or beyond T weigh 0 in every
// mask mode, as in the forward.
//
// Where it runs: the backward of every attention layer of the training step
// (28 launches a qwen3-0.6b step, at B 4, T 1024, H 16, KV 8, hd 128, bf16).
//
// What bounds it on this card: the multiply-adds of the visible (t, s)
// pairs, 10 hd flops a pair a head at the tensor-core rate (S, dP, dv, dk,
// dq). This first version runs them on the CUDA cores in float32 and
// recomputes S and dP in the dq pass (14 hd a pair), so it runs far above
// that bound; a tensor-core version is a later step.
//
// Design:
//  * Three kernels, launched in order on the caller's stream:
//    1. delta_kernel: D = rowsum(do * o), one warp a (b, h, t) row, the
//       lanes' partial sums added by a fixed xor tree.
//    2. dkdv_kernel: one block a (KV tile of BT keys, b, KV head). It keeps
//       the tile's k and v and its dk and dv accumulators and loops over the
//       G query heads of the group and, for each, over the query tiles that
//       see some key of the tile. So dk and dv sum over the group's heads
//       in one fixed order, with no atomics: a rerun gives the same bits.
//    3. dq_kernel: one block a (query tile of BT rows, b, head), looping over
//       the KV tiles the tile sees, as the forward's CUDA-core body does.
//  * Tiles: BT = 64 rows and keys for head_dim up to 128, 32 for 192 and
//    256, so that four float32 tiles of BT x (hd + 1) (rows padded by one
//    word against bank conflicts) and the BT x (BT + 1) tiles of P and dS
//    fit the 227 KB of a block (165 KB at hd 128, 140 KB at hd 256).
//  * 256 threads: each computes a (BT/16) x (BT/16) patch of S and dP
//    (rows ty + 16 i, keys tx + 16 j), then a (BT/16) x (hd/16) patch of
//    its accumulators.
//  * The heaviest blocks start first: under the causal mask the first KV
//    tiles (dkdv) and the last query tiles (dq) see the most pairs.
//  * q, k, v, o and do are read by (b, t, head) strides with unit stride
//    along hd, as the forward reads them; dq, dk, dv are written contiguous.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, T)
  float* delta;       // (B, H, T) scratch
  void* dq;           // (B, T, H, HD) contiguous
  void* dk;           // (B, S, KV, HD) contiguous
  void* dv;
  int B, T, S, H, KV;
  Strides qs, ks, vs, os, dos;
  int causal, window;
  float softcap, scale;
};

__host__ __device__ constexpr int tile_of(int hd) {
  return hd <= 128 ? 64 : 32;
}

template <int HD>
constexpr int smem_bytes() {
  constexpr int BT = tile_of(HD);
  return (4 * BT * (HD + 1) + 2 * BT * (BT + 1) + 2 * BT) *
         static_cast<int>(sizeof(float));
}

// rows [r0, r0 + BT) of a (batch, len, heads, HD) tensor at (b, head) into
// dst[BT][HD + 1] as float32, zeros past len
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          Strides st, int r0, int len) {
  for (int i = threadIdx.x; i < BT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int t = r0 + r;
    dst[r * (HD + 1) + d] = t < len ? to_f32(base[t * st.t + d]) : 0.f;
  }
}

// P and dS of query rows [q0, q0 + BT) against keys [k0, k0 + BT): this
// thread's patch (rows ty + 16 i, keys tx + 16 j) from the staged q, do, k,
// v tiles, lse and D; written to p_s (if not null) and ds_s, BT + 1 a row
template <int HD, int BT>
__device__ __forceinline__ void p_and_ds(const float* q_s, const float* do_s,
                                         const float* k_s, const float* v_s,
                                         const float* lse_s, const float* d_s,
                                         float* p_s, float* ds_s, int q0,
                                         int k0, const Args& a) {
  constexpr int QS = HD + 1, PS = BT + 1, RI = BT / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float sc[RI][RI], dp[RI][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[RI], dov[RI], kv[RI], vv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qv[i] = q_s[(ty + 16 * i) * QS + d];
      dov[i] = do_s[(ty + 16 * i) * QS + d];
      kv[i] = k_s[(tx + 16 * i) * QS + d];
      vv[i] = v_s[(tx + 16 * i) * QS + d];
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      const int t = q0 + r, s = k0 + c;
      const float raw = sc[i][j] * a.scale;
      float x = raw, fac = 1.f;
      if (a.softcap > 0.f) {
        const float th = tanhf(raw / a.softcap);
        x = th * a.softcap;
        fac = 1.f - th * th;
      }
      bool ok = s < a.S && t < a.T;
      if (a.causal) ok = ok && s <= t;
      if (a.window > 0) ok = ok && s > t - a.window;
      const float p = ok ? expf(x - lse_s[r]) : 0.f;
      if (p_s != nullptr) p_s[r * PS + c] = p;
      ds_s[r * PS + c] = p * (dp[i][j] - d_s[r]) * fac;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(Args a, int HD) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.B) * a.H * a.T) return;
  const int t = static_cast<int>(row % a.T);
  const int bh = static_cast<int>(row / a.T);
  const int b = bh / a.H, h = bh % a.H;
  const T* o = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h +
               t * a.os.t;
  const T* g = static_cast<const T*>(a.dout) + b * a.dos.b + h * a.dos.h +
               t * a.dos.t;
  float sum = 0.f;
  for (int d = lane; d < HD; d += 32)
    sum = fmaf(to_f32(g[d]), to_f32(o[d]), sum);
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (lane == 0) a.delta[row] = sum;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(Args a) {
  constexpr int BT = tile_of(HD);
  constexpr int QS = HD + 1, PS = BT + 1, RI = BT / 16, NJ = HD / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * QS;
  float* q_s = v_s + BT * QS;
  float* do_s = q_s + BT * QS;
  float* p_s = do_s + BT * QS;
  float* ds_s = p_s + BT * PS;
  float* lse_s = ds_s + BT * PS;
  float* d_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int BKV = a.B * a.KV;
  const int kt = static_cast<int>(blockIdx.x) / BKV;   // first tiles first
  const int bkv = static_cast<int>(blockIdx.x) % BKV;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int G = a.H / a.KV;
  const int k0 = kt * BT;
  const int k_last = min(k0 + BT, a.S) - 1;

  load_tile<T, HD, BT>(k_s, static_cast<const T*>(a.k) + b * a.ks.b +
                                kvh * a.ks.h, a.ks, k0, a.S);
  load_tile<T, HD, BT>(v_s, static_cast<const T*>(a.v) + b * a.vs.b +
                                kvh * a.vs.h, a.vs, k0, a.S);

  // query tiles with a row that sees a key of [k0, k_last]
  const int n_qt = (a.T + BT - 1) / BT;
  const int qt_begin = a.causal ? k0 / BT : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(qt_end, (k_last + a.window - 1) / BT + 1);

  float dk[RI][NJ], dv[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t bh = static_cast<int64_t>(b) * a.H + h;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();   // the previous tile's q, do, P, dS are consumed
      load_tile<T, HD, BT>(q_s, static_cast<const T*>(a.q) + b * a.qs.b +
                                    h * a.qs.h, a.qs, q0, a.T);
      load_tile<T, HD, BT>(do_s, static_cast<const T*>(a.dout) +
                                     b * a.dos.b + h * a.dos.h, a.dos, q0,
                           a.T);
      for (int r = tid; r < BT; r += kThreads) {
        const int t = q0 + r;
        lse_s[r] = t < a.T ? a.lse[bh * a.T + t] : INFINITY;
        d_s[r] = t < a.T ? a.delta[bh * a.T + t] : 0.f;
      }
      __syncthreads();
      p_and_ds<HD, BT>(q_s, do_s, k_s, v_s, lse_s, d_s, p_s, ds_s, q0, k0,
                       a);
      __syncthreads();
      // dv[key] += P[row][key] do[row], dk[key] += dS[row][key] q[row]
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pk[RI], sk[RI], dov[NJ], qv[NJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pk[i] = p_s[r * PS + ty + 16 * i];
          sk[i] = ds_s[r * PS + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dov[j] = do_s[r * QS + tx + 16 * j];
          qv[j] = q_s[r * QS + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(pk[i], dov[j], dv[i][j]);
            dk[i][j] = fmaf(sk[i], qv[j], dk[i][j]);
          }
      }
    }
  }
  T* dkb = static_cast<T*>(a.dk);
  T* dvb = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int s = k0 + ty + 16 * i;
    if (s >= a.S) continue;
    const int64_t base = ((static_cast<int64_t>(b) * a.S + s) * a.KV + kvh) *
                         HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkb[base + tx + 16 * j] = from_f32<T>(dk[i][j] * a.scale);
      dvb[base + tx + 16 * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
dq_kernel(Args a) {
  constexpr int BT = tile_of(HD);
  constexpr int QS = HD + 1, PS = BT + 1, RI = BT / 16, NJ = HD / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BT * QS;
  float* k_s = do_s + BT * QS;
  float* v_s = k_s + BT * QS;
  float* ds_s = v_s + BT * QS;
  float* lse_s = ds_s + BT * PS + BT * PS;   // the layout of dkdv_kernel
  float* d_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int BH = a.B * a.H;
  const int n_qt = (a.T + BT - 1) / BT;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // last first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H, kvh = h / (a.H / a.KV);
  const int q0 = qt * BT;
  const int q_last = min(q0 + BT, a.T) - 1;

  load_tile<T, HD, BT>(q_s, static_cast<const T*>(a.q) + b * a.qs.b +
                                h * a.qs.h, a.qs, q0, a.T);
  load_tile<T, HD, BT>(do_s, static_cast<const T*>(a.dout) + b * a.dos.b +
                                 h * a.dos.h, a.dos, q0, a.T);
  for (int r = tid; r < BT; r += kThreads) {
    const int t = q0 + r;
    lse_s[r] = t < a.T ? a.lse[static_cast<int64_t>(bh) * a.T + t]
                       : INFINITY;
    d_s[r] = t < a.T ? a.delta[static_cast<int64_t>(bh) * a.T + t] : 0.f;
  }
  // KV tiles some row of [q0, q_last] sees
  int kt_end = (a.S + BT - 1) / BT;
  if (a.causal) kt_end = min(kt_end, q_last / BT + 1);
  int kt_begin = 0;
  if (a.window > 0) {
    const int lo = q0 - a.window + 1;
    kt_begin = lo > 0 ? lo / BT : 0;
  }

  float dq[RI][NJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[i][j] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the previous tile's k and dS are consumed
    load_tile<T, HD, BT>(k_s, static_cast<const T*>(a.k) + b * a.ks.b +
                                  kvh * a.ks.h, a.ks, k0, a.S);
    load_tile<T, HD, BT>(v_s, static_cast<const T*>(a.v) + b * a.vs.b +
                                  kvh * a.vs.h, a.vs, k0, a.S);
    __syncthreads();
    p_and_ds<HD, BT>(q_s, do_s, k_s, v_s, lse_s, d_s, nullptr, ds_s, q0, k0,
                     a);
    __syncthreads();
    // dq[row] += dS[row][key] k[key]
#pragma unroll 2
    for (int c = 0; c < BT; ++c) {
      float sv[RI], kv[NJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = ds_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kv[j] = k_s[c * QS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) dq[i][j] = fmaf(sv[i], kv[j], dq[i][j]);
    }
  }
  T* dqb = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= a.T) continue;
    const int64_t base = ((static_cast<int64_t>(b) * a.T + t) * a.H + h) *
                         HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dqb[base + tx + 16 * j] = from_f32<T>(dq[i][j] * a.scale);
  }
}

template <typename T, int HD>
int launch_hd(const Args& a, cudaStream_t stream) {
  constexpr int BT = tile_of(HD);
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left for the next call to report
      return static_cast<int>(e);
    }
    configured = true;
  }
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.T;
  delta_kernel<T><<<static_cast<unsigned>((rows + 7) / 8), kThreads, 0,
                    stream>>>(a, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kt = (a.S + BT - 1) / BT;
  dkdv_kernel<T, HD><<<n_kt * a.B * a.KV, kThreads, bytes, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (a.T + BT - 1) / BT;
  dq_kernel<T, HD><<<n_qt * a.B * a.H, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int B, int T_len, int S_len, int H, int KV,
           int HD, const int64_t* st, int causal, int window, float softcap,
           void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || S_len <= 0) return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T_len; a.S = S_len; a.H = H; a.KV = KV;
  a.qs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.os = {st[9], st[10], st[11]};
  a.dos = {st[12], st[13], st[14]};
  a.causal = causal; a.window = window; a.softcap = softcap;
  a.scale = 1.0f / sqrtf(static_cast<float>(HD));
  auto s = static_cast<cudaStream_t>(stream);
  switch (HD) {
#define REPRO_FLASH_BWD_HD(N) \
  case N:                     \
    return launch_hd<T, N>(a, s);
    REPRO_FLASH_BWD_HD(16)
    REPRO_FLASH_BWD_HD(32)
    REPRO_FLASH_BWD_HD(64)
    REPRO_FLASH_BWD_HD(128)
    REPRO_FLASH_BWD_HD(192)
    REPRO_FLASH_BWD_HD(256)
#undef REPRO_FLASH_BWD_HD
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, do (B, T, H, HD), k and v (B, S, KV, HD) on the current device,
// each with unit stride along HD; strides holds the (b, t, head) strides in
// elements of q, k, v, o and do, in that order (15 values). lse (B, H, T)
// float32 as the forward writes it; delta (B, H, T) float32 scratch; dq
// (B, T, H, HD), dk and dv (B, S, KV, HD) contiguous, of the inputs' type.
// HD is 16, 32, 64, 128, 192 or 256. Returns the CUDA error of the launches
// (0 on success).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KV, int HD,
    const int64_t* strides, int causal, int window, float softcap,
    void* stream) {
  return launch<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, S, H,
                       KV, HD, strides, causal, window, softcap, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int T, int S, int H, int KV, int HD,
    const int64_t* strides, int causal, int window, float softcap,
    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B,
                               T, S, H, KV, HD, strides, causal, window,
                               softcap, stream);
}

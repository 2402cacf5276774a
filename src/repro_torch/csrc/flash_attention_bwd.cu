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
// flash_attention.cu); P is recomputed from it, never stored. Every sum is
// float32; dq, dk, dv are written once in the inputs' type. Keys at or
// beyond S and queries at or beyond T weigh 0 in every mask mode, as in the
// forward.
//
// Where it runs: the backward of every attention layer of the training step
// (28 launches a qwen3-0.6b step, at B 4, T 1024, H 16, KV 8, hd 128, bf16;
// 26 a gemma2-2b step at hd 256, 2 of recurrentgemma-9b at hd 256 and 2 of
// deepseek-v2 at hd 192 with the depths chip_smoke.py trains).
//
// What bounds it on this card: the multiply-adds of the visible (t, s)
// pairs, 10 hd flops a pair a head (S, dP, dv, dk, dq) at the bf16
// tensor-core rate; the bytes of q, k, v, o, do and the three gradients lie
// far below. The wgmma body recomputes S and dP in its dq kernel, 14 hd
// flops a pair on the tensor cores, 1.4x the bound's.
//
// Every call runs three kernels in order on the caller's stream (four with
// the head split below):
// delta_kernel (D = rowsum(do * o), one warp a (b, h, t) row, the lanes'
// partial sums added by a fixed xor tree), then a dk/dv kernel, one block a
// (KV tile, b, KV head) that loops over the G query heads of the group and,
// for each, over the query tiles that see some key of the tile, so dk and dv
// sum over the group's heads in one fixed order with no atomics, then a dq
// kernel, one block a (query tile, b, head) looping over the KV tiles the
// tile sees. A rerun gives the same bits. The heaviest blocks start first:
// under the causal mask the first KV tiles (dk/dv) and the last query tiles
// (dq) see the most pairs. q, k, v, o and do are read by (b, t, head)
// strides with unit stride along hd, as the forward reads them; dq, dk, dv
// are written contiguous. Two bodies, one entry point each; the wrapper
// (kernels/flash_attention/ops.py, takes_wgmma_bwd) picks by type, head_dim
// and alignment, never by a failure:
//
// 1. The wgmma body: bf16 inputs at head_dim 64, 128, 192 and 256 whose
//    five tensors TMA can read (every (b, t, head) stride a multiple of 8
//    elements, 16-byte aligned starts). It is built on the forward's wgmma
//    skeleton (wgmma.cuh): TMA boxes of 64 rows x 64 bf16 with 128-byte
//    swizzle, a 2-stage mbarrier ring, m64n64k16 products with float32
//    accumulators in registers.
//  * dk/dv kernel: the block's 64 keys of K and V stay in shared memory;
//    Q, dO and the rows' lse and D of each (head, query tile) stream
//    through the ring, the next tile in flight while one is computed. The
//    scores are computed transposed, so every operand takes a form the
//    forward uses: S^T = K Q^T and dP^T = V dO^T with both operands
//    K-major (the forward's Q K^T); P^T = exp2(S^T d^-1/2 log2 e - lse
//    log2 e) and dS^T = P^T (dP^T - D) on the accumulator fragments,
//    masks only on tiles that straddle the causal diagonal or the window's
//    edge; then dV += P^T dO and dK += dS^T Q with A from registers (the
//    fragments packed to bf16) and B = dO or Q through the transpose bit
//    (the forward's P V).
//  * dq kernel: Q, dO and the rows' lse and D stay (in registers for lse
//    and D); K and V tiles stream through the ring. S = Q K^T, dP = dO V^T,
//    dS as above (keys past S masked), dQ += dS K with K through the
//    transpose bit. Recomputing S and dP keeps every sum in one order; the
//    other way, dS written by the dk/dv kernel and read back, would move
//    64 MB at the qwen3-0.6b shape.
//  * delta_kernel also writes lse log2 e beside D, both padded to a
//    multiple of 64 rows (+inf and 0 past T), so a tile's 64 values of each
//    come by one bulk copy on the tile's mbarrier, and a query row past T
//    gets P = 0. Rows past T and keys past S are zero-filled by TMA.
//  * Numerics beside the CUDA-core body: P is rounded to bf16 before
//    dV += P^T dO, dS to bf16 before the dK and dQ products, and P is
//    exp2f of an argument in the log2 domain (lse log2 e and d^-1/2 log2 e
//    each rounded once, the argument by one fma). flash_attention_bwd_
//    tolerance's bf16 terms cover these; a CPU emulation of this body
//    (tests/test_torch_grad_kernels.py) stays inside it.
//  * head_dim 64 and 128 (bwg: dkdv_wgmma_kernel, dq_wgmma_kernel): one
//    warpgroup (128 threads) a block, 64 rows; two blocks an SM (96 KB of
//    shared memory each at hd 128, at most 255 registers a thread).
//  * head_dim 192 and 256 (bwg2: dkdv_wgmma2_kernel, dq_wgmma2_kernel): dK
//    and dV would take 2 x 96 or 2 x 128 accumulator floats a thread on one
//    warpgroup, past the 255 registers with S^T beside them. So a block is
//    two warpgroups (256 threads, one block an SM) that split the work.
//    dk/dv: warpgroup 0 holds dV and computes S^T -> P^T, warpgroup 1 holds
//    dK and computes dP^T; P^T goes through shared memory (float32, a float
//    a fragment element a thread, 16 KB, conflict-free) behind a named
//    barrier, with the softcap's factor 1 - tanh^2 beside it (16 KB more
//    written and read a tile: cheaper than warpgroup 1 computing S^T again,
//    HD / 16 more k16 products a tile), so dS^T = P^T (dP^T - D) f is the
//    one-warpgroup body's expression on the same values. dq: warpgroup 0
//    computes S -> P, warpgroup 1 dP and dS, which goes back as bf16 behind
//    a second barrier; each warpgroup adds dS K to half of dQ's boxes (1 +
//    2 at 192, 2 + 2 at 256). Shared memory: K, V (or Q, dO), the ring and
//    the exchange, 178 KB at 192 and 226 KB at 256 for dk/dv.
//  * Enough blocks with few KV heads (recurrentgemma-9b: one KV head, 64
//    key tiles at T 4096, under half of 132 SMs): where n_kt B KV falls
//    short of the SM count, the wrapper splits the group's G query heads
//    over n_split blocks (heads [j G / n, (j + 1) G / n) on block j;
//    ops.bwd_head_split, a function of the shape and the SM count). Each
//    writes float32 partial dK and dV; sum_split_kernel adds the partials
//    in split order and rounds once to bf16. No atomics: the bits repeat.
//
// 2. The CUDA-core body (dkdv_kernel, dq_kernel), for everything else:
//    float32 inputs, head_dim 16 and 32, and views TMA cannot read. P =
//    expf(x - lse) and every product in float32 from tiles converted to
//    float32 in shared memory.
//  * Tiles: BT = 64 rows and keys for head_dim up to 128, 32 for 192 and
//    256, so that four float32 tiles of BT x (hd + 1) (rows padded by one
//    word against bank conflicts) and the BT x (BT + 1) tiles of P and dS
//    fit the 227 KB of a block (165 KB at hd 128, 140 KB at hd 256).
//  * 256 threads: each computes a (BT/16) x (BT/16) patch of S and dP
//    (rows ty + 16 i, keys tx + 16 j), then a (BT/16) x (hd/16) patch of
//    its accumulators. Its dq kernel recomputes S and dP too.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

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
  float* delta;       // (B, H, T_pad) scratch
  float* lse2;        // (B, H, T_pad) scratch, lse log2 e; null: not written
  void* dq;           // (B, T, H, HD) contiguous
  void* dk;           // (B, S, KV, HD) contiguous
  void* dv;
  int B, T, S, H, KV, T_pad;
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

// D of rows t < T_pad of each (b, h), 0 past T; with lse2, lse log2 e
// beside it (+inf past T)
template <typename T>
__global__ void __launch_bounds__(kThreads)
delta_kernel(Args a, int HD) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.B) * a.H * a.T_pad) return;
  const int t = static_cast<int>(row % a.T_pad);
  const int bh = static_cast<int>(row / a.T_pad);
  const int b = bh / a.H, h = bh % a.H;
  float sum = 0.f;
  if (t < a.T) {
    const T* o = static_cast<const T*>(a.o) + b * a.os.b + h * a.os.h +
                 t * a.os.t;
    const T* g = static_cast<const T*>(a.dout) + b * a.dos.b +
                 h * a.dos.h + t * a.dos.t;
    for (int d = lane; d < HD; d += 32)
      sum = fmaf(to_f32(g[d]), to_f32(o[d]), sum);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, m);
  }
  if (lane == 0) {
    a.delta[row] = sum;
    if (a.lse2 != nullptr)
      a.lse2[row] = t < a.T ? a.lse[static_cast<int64_t>(bh) * a.T + t] *
                                  1.4426950408889634f
                            : INFINITY;
  }
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

// the arguments of every kernel of a call; false when the shapes are
// refused (the caller returns 0 for an empty call)
bool make_args(Args& a, const void* q, const void* k, const void* v,
               const void* o, const void* dout, const float* lse,
               float* delta, void* dq, void* dk, void* dv, int B, int T_len,
               int S_len, int H, int KV, int HD, const int64_t* st,
               int causal, int window, float softcap) {
  if (KV <= 0 || H % KV != 0 || S_len <= 0) return false;
  a.q = q; a.k = k; a.v = v; a.o = o; a.dout = dout;
  a.lse = lse; a.delta = delta; a.dq = dq; a.dk = dk; a.dv = dv;
  a.B = B; a.T = T_len; a.S = S_len; a.H = H; a.KV = KV; a.T_pad = T_len;
  a.lse2 = nullptr;
  a.qs = {st[0], st[1], st[2]};
  a.ks = {st[3], st[4], st[5]};
  a.vs = {st[6], st[7], st[8]};
  a.os = {st[9], st[10], st[11]};
  a.dos = {st[12], st[13], st[14]};
  a.causal = causal; a.window = window; a.softcap = softcap;
  a.scale = 1.0f / sqrtf(static_cast<float>(HD));
  return true;
}

template <typename T>
int launch(const Args& a, int HD, int n_split, float*, cudaStream_t s) {
  if (n_split != 1) return cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// The wgmma body
// ---------------------------------------------------------------------------
namespace bwg {
using namespace wg;

constexpr int kWG = 128;      // threads a block: one warpgroup
constexpr int kRows = 64;     // rows of a block's tile and of a streamed one
constexpr int kStages = 2;
constexpr int kBox = kRows * 128;   // bytes of a 64-row box of 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
constexpr int smem_bytes() {
  // two tiles that stay, kStages x two streamed tiles (each HD / 64 boxes),
  // kStages x the 64 lse log2 e and D values of a query tile, 3 mbarriers,
  // 1024 bytes of slack to align the base
  return (HD / 64) * (2 + 2 * kStages) * kBox + kStages * 2 * kRows * 4 +
         64 + 1024;
}

// S^T (keys x queries) = K Q^T and dP^T = V dO^T of one (KV tile, query
// tile), then dV += P^T dO and dK += dS^T Q, for the block's 64 keys over
// its group's heads and their query tiles
template <int HD>
__global__ void __launch_bounds__(kWG, 2)
dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo,
                  const float* __restrict__ lse2,
                  const float* __restrict__ dlt,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int T_len, int S_len,
                  int H, int KV, int BKV, int T_pad, int causal, int window,
                  float softcap, float scale) {
  constexpr int NB = HD / 64;
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + kTile;
  const uint32_t sq = sv + kTile;                 // + stage * kTile
  const uint32_t sdo = sq + kStages * kTile;      // + stage * kTile
  const uint32_t srow = sdo + kStages * kTile;    // + stage * 2 * kRows * 4
  const uint32_t bar_kv = srow + kStages * 2 * kRows * 4;
  const uint32_t bar_st = bar_kv + 8;             // + stage * 8
  const float* rows = reinterpret_cast<const float*>(smem_raw + (srow - base));

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int kt = static_cast<int>(blockIdx.x) / BKV;   // first tiles first
  const int bkv = static_cast<int>(blockIdx.x) % BKV;
  const int b = bkv / KV, kvh = bkv % KV;
  const int G = H / KV;
  const int k0 = kt * kRows;
  const int k_last = min(k0 + kRows, S_len) - 1;
  // query tiles with a row that sees a key of [k0, k_last]
  const int n_qt = (T_len + kRows - 1) / kRows;
  const int qt_begin = causal ? k0 / kRows : 0;
  int qt_end = n_qt;
  if (window > 0) qt_end = min(qt_end, (k_last + window - 1) / kRows + 1);
  const int n_per = max(qt_end - qt_begin, 0);
  const int n_iter = G * n_per;          // (head of the group, query tile)

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_q = [&](int stage, int it) {
    const int h = kvh * G + it / n_per;
    const int q0 = (qt_begin + it % n_per) * kRows;
    const uint32_t bar = bar_st + 8 * stage;
    mbar_expect_tx(bar, 2 * kTile + 2 * kRows * 4);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sq + stage * kTile + j * kBox, &tq, bar, 64 * j, h, q0, b);
      tma_load(sdo + stage * kTile + j * kBox, &tdo, bar, 64 * j, h, q0, b);
    }
    const int64_t row = (static_cast<int64_t>(b) * H + h) * T_pad + q0;
    const uint32_t dst = srow + stage * 2 * kRows * 4;
    bulk_load(dst, lse2 + row, kRows * 4, bar);
    bulk_load(dst + kRows * 4, dlt + row, kRows * 4, bar);
  };
  if (tid == 0 && n_iter > 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sk + j * kBox, &tk, bar_kv, 64 * j, kvh, k0, b);
      tma_load(sv + j * kBox, &tv, bar_kv, 64 * j, kvh, k0, b);
    }
    load_q(0, 0);
  }
  __syncwarp();

  float dka[NB][32], dva[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[j][i] = dva[j][i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int r0 = 16 * warp + lane / 4;   // this thread's keys: k0 + r0, + 8

  if (n_iter > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (qt_begin + it % n_per) * kRows;
    if (tid == 0 && it + 1 < n_iter) load_q((it + 1) % kStages, it + 1);
    __syncwarp();
    mbar_wait(bar_st + 8 * st, (it / kStages) & 1);
    // S^T = K Q^T and dP^T = V dO^T over HD / 16 k16 steps
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      mma_ss(s, desc_sw128(sk + off), desc_sw128(sq + st * kTile + off),
             kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      mma_ss(dp, desc_sw128(sv + off), desc_sw128(sdo + st * kTile + off),
             kk > 0);
    }
    commit();
    wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T on the fragments: element 4 i + e is key k0 + r0 +
    // 8 (e >> 1), query q0 + 8 i + 2 (lane % 4) + (e & 1)
    const float* l2 = rows + st * 2 * kRows;
    const float* dd = l2 + kRows;
    const bool edge = (causal && k0 + kRows - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kRows - 1 - window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * i + 2 * (lane % 4) + (e & 1);
        float fac = 1.f, y;
        if (softcap > 0.f) {
          const float th = tanhf(s[4 * i + e] * scale / softcap);
          fac = 1.f - th * th;
          y = fmaf(th * softcap, kLog2e, -l2[col]);
        } else {
          y = fmaf(s[4 * i + e], scale_log2, -l2[col]);
        }
        float p = exp2f(y);
        if (edge) {
          const int key = k0 + r0 + 8 * (e >> 1), t = q0 + col;
          bool ok = true;
          if (causal) ok = key <= t;
          if (window > 0) ok = ok && key > t - window;
          if (!ok) p = 0.f;
        }
        s[4 * i + e] = p;
        dp[4 * i + e] = p * (dp[4 * i + e] - dd[col]) * fac;
      }
    // P^T and dS^T in bf16 as the A fragments of the four k16 steps
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pa[kk][q] = pack_bf16(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
        da[kk][q] = pack_bf16(dp[8 * kk + 2 * q], dp[8 * kk + 2 * q + 1]);
      }
    // dV += P^T dO, dK += dS^T Q: per k16 step (16 queries, 2048 bytes of
    // a box) one product per 64 columns of hd
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fence_regs(dva[j]);
      fence_regs(dka[j]);
    }
    fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mma_rs(dva[j], pa[kk],
               desc_sw128(sdo + st * kTile + j * kBox + kk * 2048));
        mma_rs(dka[j], da[kk],
               desc_sw128(sq + st * kTile + j * kBox + kk * 2048));
      }
    commit();
    wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      fence_regs(dva[j]);
      fence_regs(dka[j]);
    }
    __syncthreads();   // stage st is free for the load of it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= S_len) continue;
    const int64_t at = ((static_cast<int64_t>(b) * S_len + key) * KV + kvh) *
                       HD;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(dka[j][4 * i + 2 * r] * scale,
                                  dka[j][4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(dva[j][4 * i + 2 * r],
                                  dva[j][4 * i + 2 * r + 1]);
      }
  }
}

// S = Q K^T and dP = dO V^T of one (query tile, KV tile), then dQ += dS K,
// for the block's 64 queries over the KV tiles they see
template <int HD>
__global__ void __launch_bounds__(kWG, 2)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const float* __restrict__ lse2,
                const float* __restrict__ dlt,
                __nv_bfloat16* __restrict__ dq, int T_len, int S_len, int H,
                int KV, int BH, int n_qt, int T_pad, int causal, int window,
                float softcap, float scale) {
  constexpr int NB = HD / 64;
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + kTile;
  const uint32_t sk = sdo + kTile;                // + stage * kTile
  const uint32_t sv = sk + kStages * kTile;       // + stage * kTile
  const uint32_t bar_q = sv + kStages * kTile;
  const uint32_t bar_kv = bar_q + 8;              // + stage * 8

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // last first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int r0 = 16 * warp + lane / 4;   // this thread's rows: q0 + r0, + 8
  // KV tiles some row of [q0, q_last] sees
  const int q_last = min(q0 + kRows, T_len) - 1;
  int kt_end = (S_len + kRows - 1) / kRows;
  if (causal) kt_end = min(kt_end, q_last / kRows + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_begin = lo > 0 ? lo / kRows : 0;
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int stage, int kt) {
    const uint32_t bar = bar_kv + 8 * stage;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sk + stage * kTile + j * kBox, &tk, bar, 64 * j, kvh,
               kt * kRows, b);
      tma_load(sv + stage * kTile + j * kBox, &tv, bar, 64 * j, kvh,
               kt * kRows, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sq + j * kBox, &tq, bar_q, 64 * j, h, q0, b);
      tma_load(sdo + j * kBox, &tdo, bar_q, 64 * j, h, q0, b);
    }
    if (n_tiles > 0) load_kv(0, kt_begin);
  }
  __syncwarp();

  // the rows' lse log2 e and D (padded: +inf and 0 past T)
  const int64_t row = static_cast<int64_t>(bh) * T_pad + q0 + r0;
  const float l2[2] = {lse2[row], lse2[row + 8]};
  const float dd[2] = {dlt[row], dlt[row + 8]};
  float dqa[NB][32];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[j][i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt_begin + it, st = it % kStages;
    if (tid == 0 && it + 1 < n_tiles) load_kv((it + 1) % kStages, kt + 1);
    __syncwarp();
    mbar_wait(bar_kv + 8 * st, (it / kStages) & 1);
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      mma_ss(s, desc_sw128(sq + off), desc_sw128(sk + st * kTile + off),
             kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      mma_ss(dp, desc_sw128(sdo + off), desc_sw128(sv + st * kTile + off),
             kk > 0);
    }
    commit();
    wait_all();
    fence_regs(s);
    fence_regs(dp);

    // element 4 i + e is query q0 + r0 + 8 (e >> 1), key k0 + 8 i +
    // 2 (lane % 4) + (e & 1)
    const int k0 = kt * kRows;
    const bool edge = k0 + kRows > S_len ||
                      (causal && k0 + kRows - 1 > q0) ||
                      (window > 0 && k0 <= q0 + kRows - 1 - window);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float fac = 1.f, y;
        if (softcap > 0.f) {
          const float th = tanhf(s[4 * i + e] * scale / softcap);
          fac = 1.f - th * th;
          y = fmaf(th * softcap, kLog2e, -l2[r]);
        } else {
          y = fmaf(s[4 * i + e], scale_log2, -l2[r]);
        }
        float p = exp2f(y);
        if (edge) {
          const int key = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
          const int t = q0 + r0 + 8 * r;
          bool ok = key < S_len;
          if (causal) ok = ok && key <= t;
          if (window > 0) ok = ok && key > t - window;
          if (!ok) p = 0.f;
        }
        dp[4 * i + e] = p * (dp[4 * i + e] - dd[r]) * fac;
      }
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        da[kk][q] = pack_bf16(dp[8 * kk + 2 * q], dp[8 * kk + 2 * q + 1]);
    // dQ += dS K: K (keys x hd) through the transpose bit
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(dqa[j]);
    fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mma_rs(dqa[j], da[kk],
               desc_sw128(sk + st * kTile + j * kBox + kk * 2048));
    commit();
    wait_all();
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_regs(dqa[j]);
    __syncthreads();   // stage st is free for the load of it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + r0 + 8 * r;
    if (t >= T_len) continue;
    const int64_t at = ((static_cast<int64_t>(b) * T_len + t) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dq + at + col) =
            __floats2bfloat162_rn(dqa[j][4 * i + 2 * r] * scale,
                                  dqa[j][4 * i + 2 * r + 1] * scale);
      }
  }
}

template <int HD>
int launch_hd(const Args& a, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left for the next call to report
      return static_cast<int>(e);
    }
    configured = true;
  }
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, a.q, HD, a.H, a.T, a.B, a.qs.b, a.qs.t, a.qs.h, kRows) ||
      !encode(&tk, a.k, HD, a.KV, a.S, a.B, a.ks.b, a.ks.t, a.ks.h, kRows) ||
      !encode(&tv, a.v, HD, a.KV, a.S, a.B, a.vs.b, a.vs.t, a.vs.h, kRows) ||
      !encode(&tdo, a.dout, HD, a.H, a.T, a.B, a.dos.b, a.dos.t, a.dos.h,
              kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.T_pad;
  delta_kernel<__nv_bfloat16><<<static_cast<unsigned>((rows + 7) / 8),
                                kThreads, 0, stream>>>(a, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kt = (a.S + kRows - 1) / kRows;
  dkdv_wgmma_kernel<HD><<<n_kt * a.B * a.KV, kWG, bytes, stream>>>(
      tq, tk, tv, tdo, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.T, a.S, a.H, a.KV, a.B * a.KV,
      a.T_pad, a.causal, a.window, a.softcap, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_qt = (a.T + kRows - 1) / kRows;
  dq_wgmma_kernel<HD><<<n_qt * a.B * a.H, kWG, bytes, stream>>>(
      tq, tk, tv, tdo, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.T, a.S, a.H, a.KV, a.B * a.H, n_qt, a.T_pad, a.causal, a.window,
      a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwg

// ---------------------------------------------------------------------------
// The two-warpgroup wgmma body (head_dim 192 and 256)
// ---------------------------------------------------------------------------
namespace bwg2 {
using namespace wg;
using bwg::kBox;
using bwg::kLog2e;
using bwg::kRows;
using bwg::kStages;

constexpr int kThreads2 = 256;          // two warpgroups a block
constexpr int kXchg = 32 * 128 * 4;     // a float a fragment element a thread

// named barriers (0 is __syncthreads'), each over both warpgroups
constexpr int kBarP = 1;     // warpgroup 0's P (and factor) are in shared
constexpr int kBarDS = 2;    // warpgroup 1's dS is in shared (dq kernel)

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// K and V (dk/dv) or Q and dO (dq) stay, kStages x the two streamed tiles,
// kStages x the 64 lse log2 e and D values of a query tile (dk/dv only),
// the exchange (P and the softcap factor, float32, 16 KB each), 3
// mbarriers, 1024 bytes of slack to align the base
template <int HD>
constexpr int dkdv_smem_bytes() {
  return (HD / 64) * (2 + 2 * kStages) * kBox + kStages * 2 * kRows * 4 +
         2 * kXchg + 64 + 1024;
}
template <int HD>
constexpr int dq_smem_bytes() {
  return (HD / 64) * (2 + 2 * kStages) * kBox + 2 * kXchg + 64 + 1024;
}
static_assert(dkdv_smem_bytes<256>() <= 232448, "past a block's 227 KB");
static_assert(dq_smem_bytes<256>() <= 232448, "past a block's 227 KB");

// P, or P^T, of one 64 x 64 tile on the accumulator fragments of S (S^T),
// in place and, for the other warpgroup, to the exchange xp (with a
// softcap, its factor 1 - tanh^2 to xf), element x at x * 128 (the caller
// adds its thread's index), as bwg's kernels compute them. Element 4 i + e
// of a fragment sits at row r0 + 8 (e >> 1), column 8 i + 2 (lane % 4) +
// (e & 1); l2(i, e) is that element's lse log2 e; ok(i, e) says whether the
// pair is seen, asked only on an edge tile.
template <typename L2, typename Ok>
__device__ __forceinline__ void p_tile(float (&s)[32], float* xp, float* xf,
                                       L2 l2, bool edge, Ok ok,
                                       float softcap, float scale) {
  const float scale_log2 = scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * i + e;
      float y;
      if (softcap > 0.f) {
        const float th = tanhf(s[x] * scale / softcap);
        xf[x * 128] = 1.f - th * th;
        y = fmaf(th * softcap, kLog2e, -l2(i, e));
      } else {
        y = fmaf(s[x], scale_log2, -l2(i, e));
      }
      float p = exp2f(y);
      if (edge && !ok(i, e)) p = 0.f;
      s[x] = p;
      xp[x * 128] = p;
    }
}

// the fragments (32 floats) packed pairwise to bf16 as the A operands of
// four k16 steps
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      a[kk][q] = pack_bf16(x[8 * kk + 2 * q], x[8 * kk + 2 * q + 1]);
}

// HD / 16 k16 steps of a (64 x 64) = A B^T, both K-major, NB boxes each
template <int HD>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
  fence_regs(s);
  fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    mma_ss(s, desc_sw128(a + off), desc_sw128(b + off), kk > 0);
  }
  commit();
  wait_all();
  fence_regs(s);
}

// acc[j] += A (64 x 64, the four k16 steps' fragments) B[box j0 + j]
// (64 x 64, MN-major), for the first M of acc's N boxes
template <int M, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b, int j0) {
  static_assert(M <= N, "more boxes than accumulators");
#pragma unroll
  for (int j = 0; j < M; ++j) fence_regs(acc[j]);
  fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < M; ++j)
      mma_rs(acc[j], a[kk], desc_sw128(b + (j0 + j) * kBox + kk * 2048));
  commit();
  wait_all();
#pragma unroll
  for (int j = 0; j < M; ++j) fence_regs(acc[j]);
}

// the arguments of a dk/dv launch beside the tensor maps
struct DkdvArgs {
  const float* lse2;
  const float* dlt;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;   // n_split > 1: (2, n_split, B, S, KV, HD), dv's, then dk's
  int T, S, H, KV, BKV, n_split, T_pad, causal, window;
  float softcap, scale;
};

// One block: 64 keys of one (b, KV head) over the query tiles of heads
// [g_lo, g_hi) of the group (all G unless the wrapper splits the heads,
// see the note at the top). Warpgroup 0 computes S^T = K Q^T, P^T (written to
// shared memory with the softcap's factor) and dV += P^T dO; warpgroup 1
// computes dP^T = V dO^T, then, behind a named barrier, dS^T = P^T (dP^T -
// D) from warpgroup 0's P^T, and dK += dS^T Q. Each keeps its HD / 64 x 32
// accumulator floats, half of what one warpgroup would need for both.
template <int HD>
__global__ void __launch_bounds__(kThreads2, 1)
dkdv_wgmma2_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const DkdvArgs a) {
  constexpr int NB = HD / 64;
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sk = (base + 1023u) & ~1023u;
  const uint32_t sv = sk + kTile;
  const uint32_t sq = sv + kTile;                 // + stage * kTile
  const uint32_t sdo = sq + kStages * kTile;      // + stage * kTile
  const uint32_t srow = sdo + kStages * kTile;    // + stage * 2 * kRows * 4
  const uint32_t sx = srow + kStages * 2 * kRows * 4;
  const uint32_t bar_kv = sx + 2 * kXchg;
  const uint32_t bar_st = bar_kv + 8;             // + stage * 8
  const float* rows = reinterpret_cast<const float*>(smem_raw + (srow - base));
  float* xp = reinterpret_cast<float*>(smem_raw + (sx - base));  // P^T
  float* xf = xp + kXchg / 4;                     // the softcap's factor

  const int tid = threadIdx.x;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int per_kt = a.BKV * a.n_split;
  const int kt = static_cast<int>(blockIdx.x) / per_kt;   // first tiles first
  const int bkv = static_cast<int>(blockIdx.x) % per_kt / a.n_split;
  const int sp = static_cast<int>(blockIdx.x) % a.n_split;
  const int b = bkv / a.KV, kvh = bkv % a.KV;
  const int G = a.H / a.KV;
  const int g_lo = sp * G / a.n_split, g_hi = (sp + 1) * G / a.n_split;
  const int k0 = kt * kRows;
  const int k_last = min(k0 + kRows, a.S) - 1;
  // query tiles with a row that sees a key of [k0, k_last]
  const int n_qt = (a.T + kRows - 1) / kRows;
  const int qt_begin = a.causal ? k0 / kRows : 0;
  int qt_end = n_qt;
  if (a.window > 0) qt_end = min(qt_end, (k_last + a.window - 1) / kRows + 1);
  const int n_per = max(qt_end - qt_begin, 0);
  const int n_iter = (g_hi - g_lo) * n_per;   // (head, query tile)

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_st + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_q = [&](int stage, int it) {
    const int h = kvh * G + g_lo + it / n_per;
    const int q0 = (qt_begin + it % n_per) * kRows;
    const uint32_t bar = bar_st + 8 * stage;
    mbar_expect_tx(bar, 2 * kTile + 2 * kRows * 4);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sq + stage * kTile + j * kBox, &tq, bar, 64 * j, h, q0, b);
      tma_load(sdo + stage * kTile + j * kBox, &tdo, bar, 64 * j, h, q0, b);
    }
    const int64_t row = (static_cast<int64_t>(b) * a.H + h) * a.T_pad + q0;
    const uint32_t dst = srow + stage * 2 * kRows * 4;
    bulk_load(dst, a.lse2 + row, kRows * 4, bar);
    bulk_load(dst + kRows * 4, a.dlt + row, kRows * 4, bar);
  };
  if (tid == 0 && n_iter > 0) {
    mbar_expect_tx(bar_kv, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sk + j * kBox, &tk, bar_kv, 64 * j, kvh, k0, b);
      tma_load(sv + j * kBox, &tv, bar_kv, 64 * j, kvh, k0, b);
    }
    load_q(0, 0);
  }
  __syncwarp();

  const bool p_side = tid < 128;           // warpgroup 0: P^T and dV
  const int r0 = 16 * warp + lane / 4;     // this thread's keys: k0 + r0, + 8
  float acc[NB][32];                       // dV (warpgroup 0) or dK
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  if (n_iter > 0) mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iter; ++it) {
    const int st = it % kStages;
    const int q0 = (qt_begin + it % n_per) * kRows;
    if (tid == 0 && it + 1 < n_iter) load_q((it + 1) % kStages, it + 1);
    __syncwarp();
    mbar_wait(bar_st + 8 * st, (it / kStages) & 1);
    // element 4 i + e of a fragment is key k0 + r0 + 8 (e >> 1), query
    // q0 + 8 i + 2 (lane % 4) + (e & 1)
    const float* l2 = rows + st * 2 * kRows;
    const float* dd = l2 + kRows;
    float s[32];
    uint32_t pa[4][4];
    if (p_side) {
      scores<HD>(s, sk, sq + st * kTile);
      const bool edge = (a.causal && k0 + kRows - 1 > q0) ||
                        (a.window > 0 && k0 <= q0 + kRows - 1 - a.window);
      p_tile(
          s, xp + t, xf + t,
          [&](int i, int e) { return l2[8 * i + 2 * (lane % 4) + (e & 1)]; },
          edge,
          [&](int i, int e) {
            const int key = k0 + r0 + 8 * (e >> 1);
            const int tq_ = q0 + 8 * i + 2 * (lane % 4) + (e & 1);
            bool ok = true;
            if (a.causal) ok = key <= tq_;
            if (a.window > 0) ok = ok && key > tq_ - a.window;
            return ok;
          },
          a.softcap, a.scale);
      bar_arrive(kBarP);
      pack_a(s, pa);
      accumulate<NB>(acc, pa, sdo + st * kTile, 0);
    } else {
      scores<HD>(s, sv, sdo + st * kTile);
      bar_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          const float fac = a.softcap > 0.f ? xf[x * 128 + t] : 1.f;
          s[x] = xp[x * 128 + t] *
                 (s[x] - dd[8 * i + 2 * (lane % 4) + (e & 1)]) * fac;
        }
      pack_a(s, pa);
      accumulate<NB>(acc, pa, sq + st * kTile, 0);
    }
    __syncthreads();   // stage st and the exchange are free
  }

  const int64_t n_out = static_cast<int64_t>(a.BKV) * a.S * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= a.S) continue;
    const int64_t at = ((static_cast<int64_t>(b) * a.S + key) * a.KV + kvh) *
                       HD;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * j + 8 * i + 2 * (lane % 4);
        const float x0 = acc[j][4 * i + 2 * r], x1 = acc[j][4 * i + 2 * r + 1];
        if (a.n_split > 1) {
          float* dst = a.part + (static_cast<int64_t>(p_side ? 0 : 1) *
                                     a.n_split + sp) * n_out + at + col;
          *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
        } else if (p_side) {
          *reinterpret_cast<__nv_bfloat162*>(a.dv + at + col) =
              __floats2bfloat162_rn(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(a.dk + at + col) =
              __floats2bfloat162_rn(x0 * a.scale, x1 * a.scale);
        }
      }
  }
}

// dk and dv of a split launch: the n_split float32 partials of each element
// summed in split order, dk scaled by d^-1/2, both rounded once to bf16
__global__ void __launch_bounds__(kThreads)
sum_split_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int64_t n, int n_split,
                 float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= 2 * n) return;
  const int which = static_cast<int>(i / n);   // 0: dv, 1: dk
  const int64_t e = i % n;
  const float* p = part + static_cast<int64_t>(which) * n_split * n + e;
  float sum = p[0];
  for (int sp = 1; sp < n_split; ++sp) sum += p[sp * n];
  if (which == 0)
    dv[e] = __float2bfloat16(sum);
  else
    dk[e] = __float2bfloat16(sum * scale);
}

// One block: 64 queries of one (b, head) over the KV tiles they see.
// Warpgroup 0 computes S = Q K^T and P (to shared memory with the softcap's
// factor); warpgroup 1 computes dP = dO V^T, then, behind a named barrier,
// dS = P (dP - D), packs it to bf16 and hands it back through shared
// memory behind a second; each warpgroup then adds dS K to its share of
// dQ's HD / 64 boxes (warpgroup 0 the first NB / 2).
template <int HD>
__global__ void __launch_bounds__(kThreads2, 1)
dq_wgmma2_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ lse2,
                 const float* __restrict__ dlt,
                 __nv_bfloat16* __restrict__ dq, int T_len, int S_len, int H,
                 int KV, int BH, int n_qt, int T_pad, int causal, int window,
                 float softcap, float scale) {
  constexpr int NB = HD / 64;
  constexpr int NB0 = NB / 2;        // dQ's boxes [0, NB0) on warpgroup 0
  constexpr int NB1 = NB - NB0;      // [NB0, NB) on warpgroup 1
  constexpr int kTile = NB * kBox;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sq = (base + 1023u) & ~1023u;
  const uint32_t sdo = sq + kTile;
  const uint32_t sk = sdo + kTile;                // + stage * kTile
  const uint32_t sv = sk + kStages * kTile;       // + stage * kTile
  const uint32_t sx = sv + kStages * kTile;
  const uint32_t bar_q = sx + 2 * kXchg;
  const uint32_t bar_kv = bar_q + 8;              // + stage * 8
  float* xp = reinterpret_cast<float*>(smem_raw + (sx - base));  // P, dS
  float* xf = xp + kXchg / 4;                     // the softcap's factor

  const int tid = threadIdx.x;
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // last first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int r0 = 16 * warp + lane / 4;   // this thread's rows: q0 + r0, + 8
  // KV tiles some row of [q0, q_last] sees
  const int q_last = min(q0 + kRows, T_len) - 1;
  int kt_end = (S_len + kRows - 1) / kRows;
  if (causal) kt_end = min(kt_end, q_last / kRows + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q0 - window + 1;
    kt_begin = lo > 0 ? lo / kRows : 0;
  }
  const int n_tiles = max(kt_end - kt_begin, 0);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  auto load_kv = [&](int stage, int kt) {
    const uint32_t bar = bar_kv + 8 * stage;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sk + stage * kTile + j * kBox, &tk, bar, 64 * j, kvh,
               kt * kRows, b);
      tma_load(sv + stage * kTile + j * kBox, &tv, bar, 64 * j, kvh,
               kt * kRows, b);
    }
  };
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * kTile);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      tma_load(sq + j * kBox, &tq, bar_q, 64 * j, h, q0, b);
      tma_load(sdo + j * kBox, &tdo, bar_q, 64 * j, h, q0, b);
    }
    if (n_tiles > 0) load_kv(0, kt_begin);
  }
  __syncwarp();

  const bool p_side = tid < 128;   // warpgroup 0: P
  // the rows' lse log2 e and D (padded: +inf and 0 past T)
  const int64_t row = static_cast<int64_t>(bh) * T_pad + q0 + r0;
  const float l2[2] = {lse2[row], lse2[row + 8]};
  const float dd[2] = {dlt[row], dlt[row + 8]};
  float acc[NB1][32];              // this warpgroup's boxes of dQ
#pragma unroll
  for (int j = 0; j < NB1; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int kt = kt_begin + it, st = it % kStages;
    if (tid == 0 && it + 1 < n_tiles) load_kv((it + 1) % kStages, kt + 1);
    __syncwarp();
    mbar_wait(bar_kv + 8 * st, (it / kStages) & 1);
    // element 4 i + e is query q0 + r0 + 8 (e >> 1), key k0 + 8 i +
    // 2 (lane % 4) + (e & 1)
    const int k0 = kt * kRows;
    float s[32];
    uint32_t da[4][4];
    if (p_side) {
      scores<HD>(s, sq, sk + st * kTile);
      const bool edge = k0 + kRows > S_len ||
                        (causal && k0 + kRows - 1 > q0) ||
                        (window > 0 && k0 <= q0 + kRows - 1 - window);
      p_tile(
          s, xp + t, xf + t, [&](int, int e) { return l2[e >> 1]; }, edge,
          [&](int i, int e) {
            const int key = k0 + 8 * i + 2 * (lane % 4) + (e & 1);
            const int tq_ = q0 + r0 + 8 * (e >> 1);
            bool ok = key < S_len;
            if (causal) ok = ok && key <= tq_;
            if (window > 0) ok = ok && key > tq_ - window;
            return ok;
          },
          softcap, scale);
      bar_arrive(kBarP);
      bar_sync(kBarDS);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          da[kk][q] = __float_as_uint(xp[(4 * kk + q) * 128 + t]);
      accumulate<NB0>(acc, da, sk + st * kTile, 0);
    } else {
      scores<HD>(s, sdo, sv + st * kTile);
      bar_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * i + e;
          const float fac = softcap > 0.f ? xf[x * 128 + t] : 1.f;
          s[x] = xp[x * 128 + t] * (s[x] - dd[e >> 1]) * fac;
        }
      pack_a(s, da);
      // this thread's dS over its own P: it read them all above
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xp[(4 * kk + q) * 128 + t] = __uint_as_float(da[kk][q]);
      bar_arrive(kBarDS);
      accumulate<NB1>(acc, da, sk + st * kTile, NB0);
    }
    __syncthreads();   // stage st and the exchange are free
  }

  const int j0 = p_side ? 0 : NB0, nj = p_side ? NB0 : NB1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = q0 + r0 + 8 * r;
    if (tr >= T_len) continue;
    const int64_t at = ((static_cast<int64_t>(b) * T_len + tr) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < NB1; ++j) {
      if (j >= nj) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = 64 * (j0 + j) + 8 * i + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(dq + at + col) =
            __floats2bfloat162_rn(acc[j][4 * i + 2 * r] * scale,
                                  acc[j][4 * i + 2 * r + 1] * scale);
      }
    }
  }
}

template <int HD>
int launch_hd(const Args& a, int n_split, float* part, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_smem_bytes<HD>();
  constexpr int dq_bytes = dq_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        dkdv_wgmma2_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dkdv_bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(dq_wgmma2_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dq_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();   // not left for the next call to report
      return static_cast<int>(e);
    }
    configured = true;
  }
  const int G = a.H / a.KV;
  if (n_split < 1 || n_split > G || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, a.q, HD, a.H, a.T, a.B, a.qs.b, a.qs.t, a.qs.h, kRows) ||
      !encode(&tk, a.k, HD, a.KV, a.S, a.B, a.ks.b, a.ks.t, a.ks.h, kRows) ||
      !encode(&tv, a.v, HD, a.KV, a.S, a.B, a.vs.b, a.vs.t, a.vs.h, kRows) ||
      !encode(&tdo, a.dout, HD, a.H, a.T, a.B, a.dos.b, a.dos.t, a.dos.h,
              kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(a.B) * a.H * a.T_pad;
  delta_kernel<__nv_bfloat16><<<static_cast<unsigned>((rows + 7) / 8),
                                kThreads, 0, stream>>>(a, HD);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kt = (a.S + kRows - 1) / kRows;
  DkdvArgs d;
  d.lse2 = a.lse2; d.dlt = a.delta;
  d.dk = static_cast<__nv_bfloat16*>(a.dk);
  d.dv = static_cast<__nv_bfloat16*>(a.dv);
  d.part = part;
  d.T = a.T; d.S = a.S; d.H = a.H; d.KV = a.KV; d.BKV = a.B * a.KV;
  d.n_split = n_split; d.T_pad = a.T_pad; d.causal = a.causal;
  d.window = a.window; d.softcap = a.softcap; d.scale = a.scale;
  dkdv_wgmma2_kernel<HD><<<n_kt * a.B * a.KV * n_split, kThreads2,
                           dkdv_bytes, stream>>>(tq, tk, tv, tdo, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_split > 1) {
    const int64_t n = static_cast<int64_t>(a.B) * a.S * a.KV * HD;
    sum_split_kernel<<<static_cast<unsigned>((2 * n + kThreads - 1) /
                                             kThreads),
                       kThreads, 0, stream>>>(part, d.dk, d.dv, n, n_split,
                                              a.scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_qt = (a.T + kRows - 1) / kRows;
  dq_wgmma2_kernel<HD><<<n_qt * a.B * a.H, kThreads2, dq_bytes, stream>>>(
      tq, tk, tv, tdo, a.lse2, a.delta, static_cast<__nv_bfloat16*>(a.dq),
      a.T, a.S, a.H, a.KV, a.B * a.H, n_qt, a.T_pad, a.causal, a.window,
      a.softcap, a.scale);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace bwg2

namespace bwg {
// delta holds 2 B H T_pad floats, T_pad = T rounded up to 64: D, then
// lse log2 e. At head_dim 192 and 256, n_split blocks share a (KV tile, b,
// KV head) of the dk/dv kernel, their float32 partials in part; 64 and 128
// take n_split 1
int launch(Args a, int HD, int n_split, float* part, cudaStream_t s) {
  a.T_pad = (a.T + kRows - 1) / kRows * kRows;
  a.lse2 = a.delta + static_cast<int64_t>(a.B) * a.H * a.T_pad;
  if ((HD == 64 || HD == 128) && n_split != 1) return cudaErrorInvalidValue;
  switch (HD) {
    case 64:
      return launch_hd<64>(a, s);
    case 128:
      return launch_hd<128>(a, s);
    case 192:
      return bwg2::launch_hd<192>(a, n_split, part, s);
    case 256:
      return bwg2::launch_hd<256>(a, n_split, part, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace bwg

}  // namespace

// q, o, do (B, T, H, HD), k and v (B, S, KV, HD) on the current device,
// each with unit stride along HD; strides holds the (b, t, head) strides in
// elements of q, k, v, o and do, in that order (15 values). lse (B, H, T)
// float32 as the forward writes it; delta (B, H, T) float32 scratch; dq
// (B, T, H, HD), dk and dv (B, S, KV, HD) contiguous, of the inputs' type.
// HD is 16, 32, 64, 128, 192 or 256. n_split is 1 and part null but for
// the wgmma body below. Returns the CUDA error of the launches (0 on
// success).
#define REPRO_FLASH_BWD_ENTRY(NAME, BODY)                                    \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const void* o, const void* dout, const float* lse,    \
                      float* delta, void* dq, void* dk, void* dv, int B,    \
                      int T, int S, int H, int KV, int HD,                  \
                      const int64_t* strides, int causal, int window,       \
                      float softcap, int n_split, float* part,              \
                      void* stream) {                                       \
    if (B <= 0 || T <= 0 || H <= 0) return 0;                              \
    Args a;                                                                 \
    if (!make_args(a, q, k, v, o, dout, lse, delta, dq, dk, dv, B, T, S, H, \
                   KV, HD, strides, causal, window, softcap))               \
      return cudaErrorInvalidValue;                                         \
    return BODY(a, HD, n_split, part, static_cast<cudaStream_t>(stream));   \
  }

REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_f32, launch<float>)
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_bf16, launch<__nv_bfloat16>)
// The wgmma body: bf16 as above at HD 64, 128, 192 or 256, every (b, t,
// head) stride of q, k, v and do a multiple of 8 elements and their starts
// 16-byte aligned (TMA's terms); delta holds 2 B H T_pad floats, T_pad = T
// rounded up to a multiple of 64. At HD 192 and 256, n_split (1 to H / KV)
// blocks share each (KV tile, b, KV head) of the dk/dv kernel, and for
// n_split > 1 part holds 2 n_split B S KV HD floats of scratch.
// cudaErrorInvalidValue also when a tensor map does not encode.
REPRO_FLASH_BWD_ENTRY(flash_attention_bwd_bf16_wgmma, bwg::launch)
#undef REPRO_FLASH_BWD_ENTRY

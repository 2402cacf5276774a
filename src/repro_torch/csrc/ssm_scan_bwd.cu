// Backward of the Mamba-1 selective scan on Hopper (sm_90a). The forward
// (ssm_scan.cu) computes, per (batch, channel c) and state n, from h_{-1} = 0:
//   h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t ;  y_t = C_t . h_t + D u_t
// Given dy, this kernel writes du, ddt, dB_, dC_, dA and dD:
//   dh_t  = dy_t C_t + exp(dt_{t+1} A) dh_{t+1}        (reverse in t)
//   du_t  = dy_t D + dt_t sum_n dh_t B_t
//   ddt_t = sum_n dh_t (A exp(dt_t A) h_{t-1} + u_t B_t)
//   dA    = sum_{b,t} dh_t dt_t exp(dt_t A) h_{t-1}
//   dD    = sum_{b,t} dy_t u_t
//   dB_t  = sum_c dh_t dt_t u_t ;  dC_t = sum_c dy_t h_t
//
// Backs the hand-written forward, which replaces the TPU kernel
// src/repro/kernels/ssm_scan/kernel.py: ssm_scan_pallas. The reference has
// no backward kernel: it differentiates its jnp scan
// (src/repro/nn/ssm.py:_selective_scan). Where the port runs K6's forward,
// this kernel stands where that gradient stands, and it computes what the
// plain version ssm_scan_bwd_plain (kernels/ssm_scan/ref.py) computes. Types
// as in the forward: u, B_, C_, dy, du, dB_, dC_ of one type (bf16 or
// float32), dt, A, D, ddt, dA, dD float32, every sum float32.
//
// Where it runs: the backward of every Mamba layer of the training step, at
// falcon-mamba-7b's B 2, T 1024, d 8192, N 16.
//
// What bounds it on this card: the bytes of its inputs and outputs (236 MB
// at that shape), just above the B T d N exps of exp(dt A) that the
// gradient needs at the special-function units' rate. The kernel takes
// 2 B T d N exps (each chunk's states rebuilt, then exp(dt A) again on the
// reverse walk) and reads the forward's chunk-start states (B T d 16 / 16
// floats, 67 MB at that shape) beside the bound's bytes.
//
// Design:
//  * The chunk-start states come from the forward: when autograd runs K6 it
//    passes hck, and the forward stores the state at the start of every
//    chunk of kTC = 16 steps, (B, chunks, d, 16) float32, with the
//    instructions this kernel's rebuild repeats, so the rebuilt states
//    continue them bit for bit.
//  * scan_kernel: a channel's 16 state values are split over kG = 4
//    neighbouring lanes, as in the forward: a lane holds N/4 values of A,
//    of the carried g = exp(dt_{t+1} A) dh_{t+1} and of dA in registers, a
//    block of 256 threads owns 64 channels of a batch row, so B 2, d 8192
//    gives 256 blocks of 8 warps, two an SM. The block walks the chunks in
//    reverse; u, dt and dy of the next chunk (earlier in time) x the block's
//    channels are staged in shared memory through a ring of two buffers
//    filled by 16-byte cp.async copies while this chunk is computed; B_ and
//    C_ of the next chunk are loaded into registers a chunk ahead, its start
//    state too.
//  * A chunk: its 16 states are rebuilt from the start state into registers
//    (16 x 4 a lane, indexed by unrolled loops), then the steps are walked
//    in reverse 4 at a time. du_t and ddt_t sum over the channel's 4 lanes:
//    the group's 4 x 4 partial sums (each lane's fma over its N/4 values)
//    are reduced by recursive halving of __shfl_xor_sync, the forward's
//    fixed xor tree (p_0 + p_1) + (p_2 + p_3), after which lane j holds
//    step j's sums and writes du over the staged u and ddt over the staged
//    dt; the chunk leaves in 16-byte stores.
//  * dB_ and dC_ sum over channels: a step's 2 x 4 values a lane are summed
//    over the warp's 8 channels by recursive halving of __shfl_xor_sync over
//    lanes ^4, ^8, ^16 (7 shuffles; every add one of a fixed tree), then
//    over the block's 8 warps in order in shared memory, and written as
//    per-block partials (B, blocks, T, 32); dA and dD accumulate in
//    registers over t and are written per batch row. reduce_kernel sums the
//    partials over the blocks, and dA and dD over the batch, each in one
//    fixed order: no floating atomics anywhere, so a rerun gives the same
//    bits.
//  * exp(dt A) is 2^(dt (A log2 e)) by ex2.approx.ftz.f32 with A log2 e
//    taken once a lane, as in the forward; ssm_scan_bwd_tolerance counts
//    its error, and its bound holds for any order of the sums over n and
//    over channels. A CPU emulation of this walk (tests/
//    test_torch_grad_kernels.py) repeats its order.
//  * Steps past T (the last chunk's ragged end) and channels past d compute
//    on zeros, which changes no state and adds 0 to every sum; state slots
//    past N hold A = B = C = 0 and stay 0. Where d or a pointer is not
//    16-byte aligned the staging and the stores take one element a copy
//    (chosen by shape, the same arithmetic).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kG = 4;          // lanes a channel
constexpr int kCH = kThreads / kG;     // channels a block
constexpr int kWarps = kThreads / 32;
constexpr int kTC = 16;        // steps a chunk: the forward's kTCB
constexpr int kStages = 2;     // ring depth
constexpr int kMaxN = 16;      // state values a channel
constexpr int kS = kMaxN / kG;         // state values a lane
constexpr int kParts = 2 * kMaxN;      // dB_ and dC_ values a step
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x on the special-function unit; subnormal results flush to 0
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [t0, t0 + kTC) x channels [c0, c0 + kCH) of a (batch, L, d)
// tensor into dst[kTC][kCH], zeros outside [0, L) x [0, d).
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, const E* __restrict__ src,
                                           int64_t row0, int t0, int c0,
                                           int L, int d, bool vec) {
  if (vec) {   // 16-byte copies: d and the pointer 16-byte aligned
    constexpr int kEl = 16 / sizeof(E);
    constexpr int kSeg = kCH / kEl;            // copies a row
    for (int i = threadIdx.x; i < kTC * kSeg; i += kThreads) {
      const int tt = i / kSeg, c = c0 + (i % kSeg) * kEl;
      const bool ok = t0 + tt < L && c < d;
      const E* s = ok ? src + (row0 + t0 + tt) * d + c : src;
      cp_async16(dst + tt * kCH + (i % kSeg) * kEl, s, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kTC * kCH; i += kThreads) {
      const int tt = i / kCH, c = c0 + i % kCH;
      dst[i] = (t0 + tt < L && c < d) ? src[(row0 + t0 + tt) * d + c]
                                      : E(0.f);
    }
  }
}

// rows [t0, t0 + kTC) x the block's channels of src[kTC][kCH] into a
// (batch, L, d) tensor, inside [0, L) x [0, d)
template <typename E>
__device__ __forceinline__ void store_rows(E* __restrict__ dst, const E* src,
                                           int64_t row0, int t0, int c0,
                                           int L, int d, bool vec) {
  if (vec) {
    constexpr int kEl = 16 / sizeof(E);
    constexpr int kSeg = kCH / kEl;
    for (int i = threadIdx.x; i < kTC * kSeg; i += kThreads) {
      const int tt = i / kSeg, c = c0 + (i % kSeg) * kEl;
      if (t0 + tt < L && c < d)
        *reinterpret_cast<int4*>(dst + (row0 + t0 + tt) * d + c) =
            *reinterpret_cast<const int4*>(src + tt * kCH + (i % kSeg) * kEl);
    }
  } else {
    for (int i = threadIdx.x; i < kTC * kCH; i += kThreads) {
      const int tt = i / kCH, c = c0 + i % kCH;
      if (t0 + tt < L && c < d) dst[(row0 + t0 + tt) * d + c] = src[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const float* __restrict__ A, const float* __restrict__ D,
            const T* __restrict__ dy, const float* __restrict__ hck,
            T* __restrict__ du, float* __restrict__ ddt,
            float* __restrict__ part, float* __restrict__ dA_part,
            float* __restrict__ dD_part, int L, int d, int N, bool vec) {
  __shared__ __align__(16) unsigned char u_raw[kStages * kTC * kCH *
                                               sizeof(T)];
  __shared__ __align__(16) unsigned char dy_raw[kStages * kTC * kCH *
                                                sizeof(T)];
  __shared__ __align__(16) float dts[kStages][kTC][kCH];
  __shared__ __align__(16) float bs[kStages][kTC][kMaxN];
  __shared__ __align__(16) float cs[kStages][kTC][kMaxN];
  __shared__ float ps[kWarps][kTC][kParts];   // a warp's channel sums
  T* us = reinterpret_cast<T*>(u_raw);        // [kStages][kTC][kCH]
  T* dys = reinterpret_cast<T*>(dy_raw);

  const int g = threadIdx.x / kG;      // channel of the block
  const int j = threadIdx.x % kG;      // lane of the group
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * kCH;
  const int c = c0 + g;
  const bool live = c < d;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(b) * L;
  const int chunks = (L + kTC - 1) / kTC;
  const int64_t part0 =
      (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * L;
  // after the warp's halving over lanes ^4, ^8, ^16 this lane holds value
  // v = 4 bit2 + 2 bit3 + bit4 of its 8 (dB_ for v < 4, dC_ after), state
  // n = j kS + v % 4, summed over the warp's 8 channels
  const int v = 4 * ((lane >> 2) & 1) + 2 * ((lane >> 3) & 1) +
                ((lane >> 4) & 1);
  const int slot = (v < kS ? 0 : kMaxN) + j * kS + v % kS;

  float a2[kS], af[kS], gc[kS], dA[kS];
#pragma unroll
  for (int q = 0; q < kS; ++q) {
    const int n = j * kS + q;
    af[q] = (live && n < N) ? A[static_cast<int64_t>(c) * N + n] : 0.f;
    a2[q] = __fmul_rn(af[q], kLog2e);
    gc[q] = 0.f;
    dA[q] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  float dD = 0.f;

  float h0[kS], h0n[kS];               // this chunk's start state, the next
                                       // one's
  auto load_h0 = [&](int k, float (&h)[kS]) {
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live)
      r = *reinterpret_cast<const float4*>(
          hck + ((static_cast<int64_t>(b) * chunks + k) * d + c) * kMaxN +
          j * kS);
    h[0] = r.x; h[1] = r.y; h[2] = r.z; h[3] = r.w;
  };
  float pb, pc;                        // the next chunk's B_, C_ value
  const int bc_t = threadIdx.x / kMaxN, bc_n = threadIdx.x % kMaxN;
  auto load_bc = [&](int t0) {
    const bool ok = t0 + bc_t < L && bc_n < N;
    const int64_t off = (row0 + t0 + bc_t) * N + bc_n;
    pb = ok ? to_f32(bm[off]) : 0.f;
    pc = ok ? to_f32(cm[off]) : 0.f;
  };
  auto store_bc = [&](int st) {
    bs[st][bc_t][bc_n] = pb;
    cs[st][bc_t][bc_n] = pc;
  };
  auto stage = [&](int t0, int st) {
    stage_rows<T>(us + st * kTC * kCH, u, row0, t0, c0, L, d, vec);
    stage_rows<T>(dys + st * kTC * kCH, dy, row0, t0, c0, L, d, vec);
    stage_rows<float>(&dts[st][0][0], dt, row0, t0, c0, L, d, vec);
    cp_async_commit();
  };
  static_assert(kTC * kMaxN == kThreads, "one B_, C_ value a thread");

  stage((chunks - 1) * kTC, 0);
  load_bc((chunks - 1) * kTC);
  store_bc(0);
  load_h0(chunks - 1, h0);
  for (int i = 0; i < chunks; ++i) {
    const int k = chunks - 1 - i, st = i % kStages, t0 = k * kTC;
    cp_async_wait_all();
    __syncthreads();   // chunk k visible; the other stage's du, ddt and the
                       // warps' sums are stored
    const bool more = k > 0;
    if (more) {
      stage(t0 - kTC, st ^ 1);
      load_bc(t0 - kTC);
      load_h0(k - 1, h0n);
    }
    T* ur = us + st * kTC * kCH;
    const T* yr = dys + st * kTC * kCH;
    float* dr = &dts[st][0][0];

    // the chunk's states, as the forward computes them: hs[0] its start,
    // hs[tt + 1] the state after step tt
    float hs[kTC + 1][kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) hs[0][q] = h0[q];
#pragma unroll
    for (int tt = 0; tt < kTC; ++tt) {
      const float ut = to_f32(ur[tt * kCH + g]);
      const float dtt = dr[tt * kCH + g];
      const float dtu = __fmul_rn(dtt, ut);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[st][tt][j * kS]);
      const float bq[kS] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int q = 0; q < kS; ++q)
        hs[tt + 1][q] = fmaf(ex2_ftz(__fmul_rn(dtt, a2[q])), hs[tt][q],
                             __fmul_rn(dtu, bq[q]));
    }
    // the reverse walk, kG steps at a time
#pragma unroll
    for (int grp = kTC / kG - 1; grp >= 0; --grp) {
      float pdu[kG], pddt[kG];
#pragma unroll
      for (int s4 = kG - 1; s4 >= 0; --s4) {
        const int tt = grp * kG + s4;
        const float ut = to_f32(ur[tt * kCH + g]);
        const float dtt = dr[tt * kCH + g];
        const float dyt = to_f32(yr[tt * kCH + g]);
        const float dtu = __fmul_rn(dtt, ut);
        const float4 bv =
            *reinterpret_cast<const float4*>(&bs[st][tt][j * kS]);
        const float4 cv =
            *reinterpret_cast<const float4*>(&cs[st][tt][j * kS]);
        const float bq[kS] = {bv.x, bv.y, bv.z, bv.w};
        const float cq[kS] = {cv.x, cv.y, cv.z, cv.w};
        float vals[2 * kS];
        float du_acc = 0.f, ddt_acc = 0.f;
#pragma unroll
        for (int q = 0; q < kS; ++q) {
          const float hprev = hs[tt][q];
          const float e = ex2_ftz(__fmul_rn(dtt, a2[q]));
          const float dh = fmaf(dyt, cq[q], gc[q]);
          const float eh = __fmul_rn(e, hprev);
          ddt_acc = fmaf(dh, fmaf(af[q], eh, __fmul_rn(ut, bq[q])), ddt_acc);
          dA[q] = fmaf(__fmul_rn(dh, dtt), eh, dA[q]);
          du_acc = fmaf(dh, bq[q], du_acc);
          vals[q] = __fmul_rn(dh, dtu);
          vals[kS + q] = __fmul_rn(dyt, hs[tt + 1][q]);
          gc[q] = __fmul_rn(e, dh);
        }
        pdu[s4] = du_acc;
        pddt[s4] = ddt_acc;
        dD = fmaf(dyt, ut, dD);
        // the warp's 8 channels: in the round of offset o a lane keeps the
        // half of its m values whose index has the bit of o in its lane,
        // sends the other half to lane ^ o and adds what it receives
#pragma unroll
        for (int o = kG, m = 2 * kS; o < 32; o <<= 1, m >>= 1) {
          const bool hi = lane & o;
#pragma unroll
          for (int q = 0; q < m / 2; ++q) {
            const float keep = hi ? vals[q + m / 2] : vals[q];
            const float send = hi ? vals[q] : vals[q + m / 2];
            vals[q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
          }
        }
        ps[warp][tt][slot] = vals[0];
      }
      // the channel's 4 lanes: recursive halving over lanes ^1, ^2, so that
      // lane j ends with step grp kG + j's sums, (p_0 + p_1) + (p_2 + p_3)
#pragma unroll
      for (int o = 1, n = kG; o < kG; o <<= 1, n >>= 1) {
        const bool hi = j & o;
#pragma unroll
        for (int q = 0; q < n / 2; ++q) {
          const float keep_u = hi ? pdu[2 * q + 1] : pdu[2 * q];
          const float send_u = hi ? pdu[2 * q] : pdu[2 * q + 1];
          const float keep_t = hi ? pddt[2 * q + 1] : pddt[2 * q];
          const float send_t = hi ? pddt[2 * q] : pddt[2 * q + 1];
          pdu[q] = __fadd_rn(keep_u, __shfl_xor_sync(0xffffffffu, send_u, o));
          pddt[q] =
              __fadd_rn(keep_t, __shfl_xor_sync(0xffffffffu, send_t, o));
        }
      }
      // du and ddt of step grp kG + j over its u and dt, which every lane
      // of the channel has read
      const int tt = grp * kG + j;
      const float dtt = dr[tt * kCH + g];
      const float dyt = to_f32(yr[tt * kCH + g]);
      ur[tt * kCH + g] = from_f32<T>(fmaf(dtt, pdu[0], __fmul_rn(dyt, dd)));
      dr[tt * kCH + g] = pddt[0];
    }
    if (more) store_bc(st ^ 1);
    __syncthreads();   // the chunk's du, ddt and the warps' sums are stored
    store_rows<T>(du, ur, row0, t0, c0, L, d, vec);
    store_rows<float>(ddt, dr, row0, t0, c0, L, d, vec);
    for (int idx = threadIdx.x; idx < kTC * kParts; idx += kThreads) {
      const int tt = idx / kParts, jj = idx % kParts;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += ps[w][tt][jj];
      if (t0 + tt < L) part[(part0 + t0 + tt) * kParts + jj] = sum;
    }
    if (more) {
#pragma unroll
      for (int q = 0; q < kS; ++q) h0[q] = h0n[q];
    }
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      const int n = j * kS + q;
      if (n < N) dA_part[(static_cast<int64_t>(b) * d + c) * N + n] = dA[q];
    }
    if (j == 0) dD_part[static_cast<int64_t>(b) * d + c] = dD;
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
reduce_kernel(const float* __restrict__ part,
              const float* __restrict__ dA_part,
              const float* __restrict__ dD_part, T* __restrict__ dB,
              T* __restrict__ dC, float* __restrict__ dA,
              float* __restrict__ dD, int batch, int L, int d, int N,
              int blocks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t n_bc = static_cast<int64_t>(batch) * L * kParts;
  const int64_t n_a = static_cast<int64_t>(d) * N;
  if (i < n_bc) {
    const int j = static_cast<int>(i % kParts);
    const int64_t bt = i / kParts;           // b * L + t
    const int b = static_cast<int>(bt / L);
    const int t = static_cast<int>(bt % L);
    const int n = j % kMaxN;
    if (n >= N) return;
    float s = 0.f;
    for (int blk = 0; blk < blocks; ++blk)
      s += part[((static_cast<int64_t>(b) * blocks + blk) * L + t) * kParts +
                j];
    (j < kMaxN ? dB : dC)[bt * N + n] = from_f32<T>(s);
  } else if (i < n_bc + n_a) {
    const int64_t cn = i - n_bc;             // c * N + n
    float s = 0.f;
    for (int b = 0; b < batch; ++b) s += dA_part[b * n_a + cn];
    dA[cn] = s;
  } else if (i < n_bc + n_a + d) {
    const int64_t c = i - n_bc - n_a;
    float s = 0.f;
    for (int b = 0; b < batch; ++b)
      s += dD_part[static_cast<int64_t>(b) * d + c];
    dD[c] = s;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* u, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, const void* dy, const float* hck,
           float* part, float* dA_part, float* dD_part, void* du, void* ddt,
           void* dB, void* dC, void* dA, void* dD, int batch, int L, int d,
           int N, void* stream) {
  if (N < 1 || N > kMaxN || batch > 65535) return cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned16(u) && aligned16(dt) && aligned16(dy) &&
                   aligned16(du) && aligned16(ddt) &&
                   d % (16 / sizeof(T)) == 0 && d % 4 == 0;
  const dim3 grid((d + kCH - 1) / kCH, batch);
  scan_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const T*>(dy), hck, static_cast<T*>(du),
      static_cast<float*>(ddt), part, dA_part, dD_part, L, d, N, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(batch) * L * kParts +
                        static_cast<int64_t>(d) * N + d;
  reduce_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                     s>>>(part, dA_part, dD_part, static_cast<T*>(dB),
                          static_cast<T*>(dC), static_cast<float*>(dA),
                          static_cast<float*>(dD), batch, L, d, N,
                          static_cast<int>(grid.x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, dt, dy, du, ddt (batch, L, d); B_, C_, dB_, dC_ (batch, L, N); A, dA
// (d, N); D, dD (d,): all contiguous on the current device; u, B_, C_, dy,
// du, dB_, dC_ of the suffix's type, dt, A, D, ddt, dA, dD float32;
// 1 <= N <= 16. hck (batch, ceil(L / 16), d, 16) float32: the states at
// chunk starts as the forward stores them. Scratch, float32: part (batch,
// ceil(d / 64), L, 32), dA_part (batch, d, N), dD_part (batch, d). Returns
// the CUDA error of the launches (0 on success).
extern "C" int ssm_scan_bwd_f32(const void* u, const void* dt,
                                const void* bm, const void* cm,
                                const void* A, const void* D, const void* dy,
                                const float* hck, float* part,
                                float* dA_part, float* dD_part, void* du,
                                void* ddt, void* dB, void* dC, void* dA,
                                void* dD, int batch, int L, int d, int N,
                                void* stream) {
  return launch<float>(u, dt, bm, cm, A, D, dy, hck, part, dA_part, dD_part,
                       du, ddt, dB, dC, dA, dD, batch, L, d, N, stream);
}

extern "C" int ssm_scan_bwd_bf16(const void* u, const void* dt,
                                 const void* bm, const void* cm,
                                 const void* A, const void* D, const void* dy,
                                 const float* hck, float* part,
                                 float* dA_part, float* dD_part, void* du,
                                 void* ddt, void* dB, void* dC, void* dA,
                                 void* dD, int batch, int L, int d, int N,
                                 void* stream) {
  return launch<__nv_bfloat16>(u, dt, bm, cm, A, D, dy, hck, part, dA_part,
                               dD_part, du, ddt, dB, dC, dA, dD, batch, L, d,
                               N, stream);
}

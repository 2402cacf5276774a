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
// What bounds it on this card: as in the forward, the exps. The forward
// keeps no states (only y leaves it, as in the TPU kernel), so the backward
// runs the recurrence twice more: B T d N exps to find the states at chunk
// starts and B T d N again to rebuild each chunk's states, beside the
// B T d N of exp(dt A) that the reverse walk needs. The bound counts the
// B T d N exps the gradient itself needs, at the special-function units'
// rate, or the bytes if larger.
//
// Design:
//  * Three kernels, launched in order on the caller's stream, one thread a
//    (batch, channel) with its N <= 16 state values in registers, a block a
//    warp of 32 channels:
//    1. states_kernel walks t forward and writes h at the start of every
//       chunk of kTC steps but the first into scratch (B, chunks, N, d).
//    2. scan_kernel walks the chunks in reverse. For a chunk it reloads the
//       start state, rebuilds the chunk's kTC states into shared memory
//       ([step][n][lane], conflict-free), then walks the steps in reverse
//       carrying g = exp(dt_{t+1} A) dh_{t+1} in registers, and writes du
//       and ddt. dA and dD accumulate in registers over t and are written
//       once a thread, per batch row. dB_ and dC_ are sums over the d
//       channels: a step's 2 x 16 per-lane values are reduced over the
//       warp's 32 lanes by recursive halving of __shfl_xor_sync (31
//       shuffles; lane j ends with value j's sum, every add one of a fixed
//       tree), and lane j writes it to per-block partials (B, blocks, T, 32).
//    3. reduce_kernel sums the partials over the blocks, and dA and dD over
//       the batch, each in one fixed order: no floating atomics anywhere, so
//       a rerun gives the same bits.
//  * exp(dt A) is 2^(dt (A log2 e)) by ex2.approx.ftz.f32 with A log2 e
//    taken once a thread, as in the forward; ssm_scan_bwd_tolerance counts
//    its error. Kernels 1 and 2 rebuild the states with the same
//    instructions, so the states of a chunk continue those at its start.
//  * Steps past T (the last chunk's ragged end) and channels past d compute
//    on zeros, which changes no state and adds 0 to every sum; state slots
//    past N hold A = B = C = 0 and stay 0.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCH = 32;        // channels a block: one warp
constexpr int kTC = 16;        // steps a chunk
constexpr int kMaxN = 16;      // state values a channel
constexpr int kParts = 2 * kMaxN;   // dB_ and dC_ values a step
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

// rows [t0, t0 + kTC) of a (batch, L, N) tensor into dst[kTC][kMaxN] as
// float32, zeros past L and N
template <typename T>
__device__ __forceinline__ void stage_bc(float (*dst)[kMaxN],
                                         const T* __restrict__ src,
                                         int64_t row0, int t0, int L, int N) {
  for (int i = threadIdx.x; i < kTC * kMaxN; i += kCH) {
    const int tt = i / kMaxN, n = i % kMaxN;
    dst[tt][n] = (t0 + tt < L && n < N)
                     ? to_f32(src[(row0 + t0 + tt) * N + n])
                     : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kCH)
states_kernel(const T* __restrict__ u, const float* __restrict__ dt,
              const T* __restrict__ bm, const float* __restrict__ A,
              float* __restrict__ hck, int L, int d, int N) {
  __shared__ float bs[kTC][kMaxN];
  const int c = blockIdx.x * kCH + threadIdx.x;
  const bool live = c < d;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(b) * L;
  const int chunks = (L + kTC - 1) / kTC;
  float a2[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a2[n] = (live && n < N)
                ? __fmul_rn(A[static_cast<int64_t>(c) * N + n], kLog2e)
                : 0.f;
    h[n] = 0.f;
  }
  for (int k = 0; k < chunks; ++k) {
    const int t0 = k * kTC;
    if (k > 0 && live) {
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        if (n < N)
          hck[((static_cast<int64_t>(b) * chunks + k) * N + n) * d + c] =
              h[n];
    }
    __syncwarp();
    stage_bc<T>(bs, bm, row0, t0, L, N);
    __syncwarp();
    const int tc = min(kTC, L - t0);
    for (int tt = 0; tt < tc; ++tt) {
      const int64_t i = (row0 + t0 + tt) * d + c;
      const float ut = live ? to_f32(u[i]) : 0.f;
      const float dtt = live ? dt[i] : 0.f;
      const float dtu = __fmul_rn(dtt, ut);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n)
        h[n] = fmaf(ex2_ftz(__fmul_rn(dtt, a2[n])), h[n],
                    __fmul_rn(dtu, bs[tt][n]));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCH)
scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const float* __restrict__ A, const float* __restrict__ D,
            const T* __restrict__ dy, const float* __restrict__ hck,
            T* __restrict__ du, float* __restrict__ ddt,
            float* __restrict__ part, float* __restrict__ dA_part,
            float* __restrict__ dD_part, int L, int d, int N) {
  __shared__ float hs[kTC][kMaxN][kCH];
  __shared__ float bs[kTC][kMaxN];
  __shared__ float cs[kTC][kMaxN];
  const int lane = threadIdx.x;
  const int c = blockIdx.x * kCH + lane;
  const bool live = c < d;
  const int b = blockIdx.y;
  const int64_t row0 = static_cast<int64_t>(b) * L;
  const int chunks = (L + kTC - 1) / kTC;
  const int64_t part0 =
      (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * L;

  float a2[kMaxN], af[kMaxN], g[kMaxN], dA[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    af[n] = (live && n < N) ? A[static_cast<int64_t>(c) * N + n] : 0.f;
    a2[n] = __fmul_rn(af[n], kLog2e);
    g[n] = 0.f;
    dA[n] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  float dD = 0.f;

  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kTC;
    const int tc = min(kTC, L - t0);
    __syncwarp();   // the previous chunk is done with bs, cs and hs
    stage_bc<T>(bs, bm, row0, t0, L, N);
    stage_bc<T>(cs, cm, row0, t0, L, N);
    float h0[kMaxN], h[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      h0[n] = (k > 0 && live && n < N)
                  ? hck[((static_cast<int64_t>(b) * chunks + k) * N + n) * d +
                        c]
                  : 0.f;
      h[n] = h0[n];
    }
    __syncwarp();
    // the chunk's states, as states_kernel computes them
    for (int tt = 0; tt < tc; ++tt) {
      const int64_t i = (row0 + t0 + tt) * d + c;
      const float ut = live ? to_f32(u[i]) : 0.f;
      const float dtt = live ? dt[i] : 0.f;
      const float dtu = __fmul_rn(dtt, ut);
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        h[n] = fmaf(ex2_ftz(__fmul_rn(dtt, a2[n])), h[n],
                    __fmul_rn(dtu, bs[tt][n]));
        hs[tt][n][lane] = h[n];
      }
    }
    // reverse walk
    for (int tt = tc - 1; tt >= 0; --tt) {
      const int64_t i = (row0 + t0 + tt) * d + c;
      const float ut = live ? to_f32(u[i]) : 0.f;
      const float dtt = live ? dt[i] : 0.f;
      const float dyt = live ? to_f32(dy[i]) : 0.f;
      const float dtu = __fmul_rn(dtt, ut);
      float vals[kParts];
      float ddt_acc = 0.f, du_acc = 0.f;
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        const float hprev = tt > 0 ? hs[tt - 1][n][lane] : h0[n];
        const float e = ex2_ftz(__fmul_rn(dtt, a2[n]));
        const float dh = fmaf(dyt, cs[tt][n], g[n]);
        const float eh = __fmul_rn(e, hprev);
        ddt_acc = fmaf(dh, fmaf(af[n], eh, __fmul_rn(ut, bs[tt][n])),
                       ddt_acc);
        dA[n] = fmaf(__fmul_rn(dh, dtt), eh, dA[n]);
        du_acc = fmaf(dh, bs[tt][n], du_acc);
        vals[n] = __fmul_rn(dh, dtu);
        vals[kMaxN + n] = __fmul_rn(dyt, hs[tt][n][lane]);
        g[n] = __fmul_rn(e, dh);
      }
      if (live) {
        du[i] = from_f32<T>(fmaf(dtt, du_acc, __fmul_rn(dyt, dd)));
        ddt[i] = ddt_acc;
      }
      dD = fmaf(dyt, ut, dD);
      // recursive halving over the warp: in the round of offset o a lane
      // keeps the half of its m values whose index has bit o of its lane,
      // sends the other half to lane ^ o and adds what it receives; lane j
      // ends with value j summed over all 32 lanes
#pragma unroll
      for (int o = kCH / 2, m = kParts; o >= 1; o >>= 1, m >>= 1) {
        const bool hi = lane & o;
#pragma unroll
        for (int q = 0; q < m / 2; ++q) {
          const float keep = hi ? vals[q + m / 2] : vals[q];
          const float send = hi ? vals[q] : vals[q + m / 2];
          vals[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      part[(part0 + t0 + tt) * kParts + lane] = vals[0];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kMaxN; ++n)
      if (n < N) dA_part[(static_cast<int64_t>(b) * d + c) * N + n] = dA[n];
    dD_part[static_cast<int64_t>(b) * d + c] = dD;
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

template <typename T>
int launch(const void* u, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, const void* dy, float* hck,
           float* part, float* dA_part, float* dD_part, void* du, void* ddt,
           void* dB, void* dC, void* dA, void* dD, int batch, int L, int d,
           int N, void* stream) {
  if (N < 1 || N > kMaxN || batch > 65535) return cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((d + kCH - 1) / kCH, batch);
  states_kernel<T><<<grid, kCH, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const float*>(A), hck, L, d, N);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_kernel<T><<<grid, kCH, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const T*>(dy), hck, static_cast<T*>(du),
      static_cast<float*>(ddt), part, dA_part, dD_part, L, d, N);
  e = cudaGetLastError();
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
// 1 <= N <= 16. Scratch, float32: hck (batch, ceil(L / 16), N, d), part
// (batch, ceil(d / 32), L, 32), dA_part (batch, d, N), dD_part (batch, d).
// Returns the CUDA error of the launches (0 on success).
extern "C" int ssm_scan_bwd_f32(const void* u, const void* dt,
                                const void* bm, const void* cm,
                                const void* A, const void* D, const void* dy,
                                float* hck, float* part, float* dA_part,
                                float* dD_part, void* du, void* ddt, void* dB,
                                void* dC, void* dA, void* dD, int batch,
                                int L, int d, int N, void* stream) {
  return launch<float>(u, dt, bm, cm, A, D, dy, hck, part, dA_part, dD_part,
                       du, ddt, dB, dC, dA, dD, batch, L, d, N, stream);
}

extern "C" int ssm_scan_bwd_bf16(const void* u, const void* dt,
                                 const void* bm, const void* cm,
                                 const void* A, const void* D, const void* dy,
                                 float* hck, float* part, float* dA_part,
                                 float* dD_part, void* du, void* ddt,
                                 void* dB, void* dC, void* dA, void* dD,
                                 int batch, int L, int d, int N,
                                 void* stream) {
  return launch<__nv_bfloat16>(u, dt, bm, cm, A, D, dy, hck, part, dA_part,
                               dD_part, du, ddt, dB, dC, dA, dD, batch, L, d,
                               N, stream);
}

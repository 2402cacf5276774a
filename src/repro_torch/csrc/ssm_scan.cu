// Mamba-1 selective scan on Hopper (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) B_t
//   y_t = h_t . C_t + D u_t
// per (batch, channel), with a state of N values per channel, h_0 = 0.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan/kernel.py:
// ssm_scan_pallas (body _ssm_kernel) and computes what it and the plain
// version (kernels/ssm_scan/ref.py) compute: u, B_ and C_ in one type (bf16
// or float32, one template), dt, A and D in float32, the state and every
// sum in float32, y written once in u's type. Only y leaves the kernel, as
// in the TPU kernel (no h_last).
//
// Where it runs: every layer of the prefill forward (64 launches a call for
// falcon-mamba-7b), at B 4, T 1024, d 8192, N 16.
//
// What bounds it on this card: bytes. Each (b, t, c) reads u (2 bytes) and
// dt (4 bytes) and writes y (2 bytes) once: about 269 MB at the prefill
// shape, 0.080 ms at 3.35 TB/s. The arithmetic (7 N + 2 operations per
// (b, t, c): N state updates of 5 and N multiply-adds into y) is 0.057 ms
// at the float32 rate, besides N exps on the special-function units, whose
// rate the card's data sheet does not give.
//
// Design:
//  * The TPU kernel keeps a (bd, N) state in VMEM across a sequential time
//    grid. Blocks here run in no order, so nothing carries between them:
//    one thread owns one (batch, channel), holds its N state values and its
//    row of A in registers, and walks all of T in a loop inside the kernel.
//  * Neighbouring threads take neighbouring channels, so the loads of u and
//    dt and the store of y are coalesced, one element a thread per step.
//  * B_t and C_t are shared by every channel of a batch row: a chunk of
//    kTC time steps of both is staged in shared memory as float32 and read
//    as broadcasts.
//  * Ragged edges are masked in the kernel (channels beyond d idle, the
//    last chunk is short, state slots beyond N hold A = B = C = 0 and stay
//    0), so the wrapper pads and copies nothing.
//  * exp is the accurate expf (no fast math), as the plain version's exp.
//  * Parallelism is B * d threads: 32768 at the prefill shape, 256 blocks
//    of 128, two a SM, so the loop is bound by latency more than by the
//    HBM rate. A later version would split N across lanes of a warp with a
//    shuffle reduction for y, or chunk T with a second pass that carries
//    the state between chunks, to put more threads in flight.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kTC = 64;        // time steps of B_ and C_ staged at a time
constexpr int kMaxN = 16;      // state size held in registers

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ A, const float* __restrict__ D,
                T* __restrict__ y, int L, int d, int N) {
  __shared__ float bs[kTC][kMaxN];
  __shared__ float cs[kTC][kMaxN];

  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const bool live = c < d;

  float a[kMaxN], h[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    a[n] = (live && n < N) ? A[static_cast<int64_t>(c) * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  const int64_t row0 = static_cast<int64_t>(b) * L;  // first time row

  for (int t0 = 0; t0 < L; t0 += kTC) {
    const int tc = min(kTC, L - t0);
    __syncthreads();  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < kTC * kMaxN; i += kThreads) {
      const int tt = i / kMaxN, n = i % kMaxN;
      float bv = 0.f, cv = 0.f;
      if (tt < tc && n < N) {
        const int64_t off = (row0 + t0 + tt) * N + n;
        bv = to_f32(bm[off]);
        cv = to_f32(cm[off]);
      }
      bs[tt][n] = bv;
      cs[tt][n] = cv;
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int tt = 0; tt < tc; ++tt) {
        const int64_t off = (row0 + t0 + tt) * d + c;
        const float ut = to_f32(u[off]);
        const float dtt = dt[off];
        const float dtu = dtt * ut;
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          h[n] = expf(dtt * a[n]) * h[n] + dtu * bs[tt][n];
          acc += h[n] * cs[tt][n];
        }
        y[off] = from_f32<T>(acc + dd * ut);
      }
    }
  }
}

template <typename T>
int launch(const void* u, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, void* y, int batch, int L, int d,
           int N, void* stream) {
  if (N < 1 || N > kMaxN || batch > 65535) return cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  const dim3 grid((d + kThreads - 1) / kThreads, batch);
  ssm_scan_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<T*>(y), L, d, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, dt, y (batch, L, d); B_, C_ (batch, L, N); A (d, N); D (d,): all
// contiguous on the current device; u, B_, C_ and y of the suffix's type,
// dt, A and D float32; 1 <= N <= 16. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* bm,
                            const void* cm, const void* A, const void* D,
                            void* y, int batch, int L, int d, int N,
                            void* stream) {
  return launch<float>(u, dt, bm, cm, A, D, y, batch, L, d, N, stream);
}

extern "C" int ssm_scan_bf16(const void* u, const void* dt, const void* bm,
                             const void* cm, const void* A, const void* D,
                             void* y, int batch, int L, int d, int N,
                             void* stream) {
  return launch<__nv_bfloat16>(u, dt, bm, cm, A, D, y, batch, L, d, N,
                               stream);
}

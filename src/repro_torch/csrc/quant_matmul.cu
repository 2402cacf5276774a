// Quantized matmul on Hopper (sm_90a): y = x @ (w_q * scales[None, :]).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py:
// quant_matmul_pallas (body _qmm_kernel) and computes what it and the plain
// version (kernels/quant_matmul/ref.py) compute: every int8 weight (on an
// 8-bit or 4-bit grid) is dequantized in float32 against its output
// column's scale, products accumulate in float32, and y is written in x's
// type (float32 or bf16, one template).
//
// Where it runs: the quantized decode step, 7 products per layer (q, k, v,
// o, gate, up, down) with M = batch rows (8), K and N of 1024 to 3072.
//
// What bounds it on this card: bytes. At M = 8 each weight byte feeds 8
// multiply-adds, far below the ~295 operations per byte at which the
// tensor cores would become the limit, so the least time is the int8
// weight over the HBM rate. The TPU kernel's (128, 128, 128) grid with an
// MXU dot per tile would waste 120 of 128 rows at this M.
//
// Design:
//  * One block owns a strip of BN = 32 output columns for MT = 8 rows (the
//    whole decode batch) and walks all of K: no cross-block reduction and
//    no workspace. A grid row of blocks takes each further 8 rows of x.
//  * 256 threads = 8 column threads x 32 k lanes. A column thread loads 4
//    neighbouring int8 weights as one 32-bit word, so a warp reads four
//    full 32-byte sectors per instruction; it dequantizes them in registers
//    against the 4 scales it loaded once, and accumulates 8 x 4 partial
//    sums. The x tile (8 rows x 128 k) is staged in shared memory as
//    float32 and read as broadcasts.
//  * The 32 k lanes are summed by two warp shuffles and one pass through
//    shared memory; each of the 256 threads then writes one output.
//  * Ragged edges: rows beyond M and k beyond K read zeros; columns beyond
//    N are neither loaded nor written. When N is not a multiple of 4 (or
//    the weight is not 4-byte aligned) the loads are single bytes.
//
// Not yet: tensor cores (int8 -> bf16 dequant feeding wgmma), TMA, split-K
// to give the card more than N / 32 blocks at small N.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;   // output columns per block
constexpr int kMT = 8;    // rows of x per block
constexpr int kBK = 128;  // k depth of one staged x tile
constexpr int kLanes = 32;  // k lanes

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

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, T* __restrict__ y, int M, int K,
           int N) {
  __shared__ float xs[kMT][kBK];
  __shared__ float red[kThreads / 32][kMT][kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cx = lane & 7;                  // column thread
  const int kl = warp * 4 + (lane >> 3);    // k lane, 0..31
  const int n0 = blockIdx.x * kBN + cx * 4;
  const int m0 = blockIdx.y * kMT;

  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = (n0 + j < N) ? scales[n0 + j] : 0.f;

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kt = 0; kt < K; kt += kBK) {
    for (int i = tid; i < kMT * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int m = m0 + r, kk = kt + c;
      xs[r][c] = (m < M && kk < K)
                     ? to_f32(x[static_cast<int64_t>(m) * K + kk])
                     : 0.f;
    }
    __syncthreads();
    const int kend = min(kBK, K - kt);
    for (int c = kl; c < kend; c += kLanes) {
      const int8_t* wr = w + static_cast<int64_t>(kt + c) * N + n0;
      float wv[4];
      if (kVec) {
        // N % 4 == 0, so n0 < N implies all four columns are in range
        if (n0 < N) {
          const char4 q = *reinterpret_cast<const char4*>(wr);
          wv[0] = static_cast<float>(q.x) * sc[0];
          wv[1] = static_cast<float>(q.y) * sc[1];
          wv[2] = static_cast<float>(q.z) * sc[2];
          wv[3] = static_cast<float>(q.w) * sc[3];
        } else {
          wv[0] = wv[1] = wv[2] = wv[3] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = (n0 + j < N) ? static_cast<float>(wr[j]) * sc[j] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float xv = xs[m][c];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xv, wv[j], acc[m][j]);
      }
    }
    __syncthreads();
  }

  // sum the 4 k lanes of a warp (lane bits 3 and 4), then the 8 warps
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
  if ((lane >> 3) == 0) {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][m][cx * 4 + j] = acc[m][j];
  }
  __syncthreads();
  const int m = tid / kBN, c = tid % kBN;   // kMT * kBN == kThreads
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) sum += red[i][m][c];
  const int gm = m0 + m, gn = blockIdx.x * kBN + c;
  if (gm < M && gn < N) y[static_cast<int64_t>(gm) * N + gn] = from_f32<T>(sum);
}

template <typename T>
int launch(const void* x, const void* w, const void* scales, void* y, int M,
           int K, int N, int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kMT - 1) / kMT);
  auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* sp = static_cast<const float*>(scales);
  T* yp = static_cast<T*>(y);
  if (vec)
    qmm_kernel<T, true><<<grid, kThreads, 0, s>>>(xp, wp, sp, yp, M, K, N);
  else
    qmm_kernel<T, false><<<grid, kThreads, 0, s>>>(xp, wp, sp, yp, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w (K, N) int8, scales (N,) float32, y (M, N): all contiguous on
// the current device. vec != 0 requires N % 4 == 0 and a 4-byte aligned w.
// Returns the CUDA error of the launch (0 on success).
extern "C" int quant_matmul_f32(const void* x, const void* w,
                                const void* scales, void* y, int M, int K,
                                int N, int vec, void* stream) {
  return launch<float>(x, w, scales, y, M, K, N, vec, stream);
}

extern "C" int quant_matmul_bf16(const void* x, const void* w,
                                 const void* scales, void* y, int M, int K,
                                 int N, int vec, void* stream) {
  return launch<__nv_bfloat16>(x, w, scales, y, M, K, N, vec, stream);
}

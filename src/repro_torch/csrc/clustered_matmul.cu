// Clustered (codebook) matmul on Hopper (sm_90a): y = x @ W with
// W[k, n] = codebook[k, idx[k, n]], one codebook of C float32 values per
// input row k (the paper's per-input multiplier sharing).
//
// Replaces the TPU kernel src/repro/kernels/clustered_matmul/kernel.py:
// clustered_matmul_pallas (body _cmm_kernel) and computes what it and the
// plain version (kernels/clustered_matmul/ref.py) compute: every weight is
// looked up in its row's codebook, products accumulate in float32, and y is
// written in x's type (float32 or bf16). The indices are read as the
// caller stores them, int8 (C <= 128) or int32, from one template; the TPU
// call widens them to int32 first, 4 bytes a weight on the wire.
//
// What bounds it on this card: at decode (M = 8) bytes. Each 1-byte index
// feeds 8 multiply-adds, far below the ~295 operations per byte at which
// the tensor cores would become the limit, so the least time is the int8
// indices (plus x, the codebooks and y) over the HBM rate: about one byte
// per weight, as for the int8 weights of quant_matmul. At M = 4096 it is
// operations (2 M K N at the tensor-core rate).
//
// Design:
//  * The TPU kernel rebuilds each weight tile with a one-hot contraction
//    against the codebook, which is how a TPU avoids lane gathers. Here a
//    block stages the codebook rows of its current k chunk in shared memory
//    (kc x C float32, 8 KB at kc = 128, C = 16) and each thread gathers its
//    weights from there.
//  * One block owns a strip of BN = 32 output columns for MT = 8 rows of x
//    and walks all of K (as quant_matmul.cu): no cross-block reduction and
//    no workspace. A grid row of blocks takes each further 8 rows of x.
//  * 256 threads = 8 column threads x 32 k lanes. A column thread loads 4
//    neighbouring indices in one load (one 32-bit word of int8, or one
//    16-byte word of int32), reads their 4 weights from the staged
//    codebook row, and accumulates 8 x 4 partial sums against the x tile
//    (8 rows x kc, float32, read as broadcasts).
//  * The 32 k lanes are summed by two warp shuffles and one pass through
//    shared memory; each of the 256 threads then writes one output.
//  * Ragged edges: rows beyond M and k beyond K read zeros; columns beyond
//    N are neither loaded nor written. When N is not a multiple of 4 (or
//    idx is not aligned for the wide load) the indices are loaded singly.
//  * The index range is the caller's contract: an index outside [0, C) is
//    clamped into it, so no read leaves the staged codebook.
//  * kc = min(128, 10000 / (8 + C)) keeps the staged x tile and codebook
//    within 40 KB of dynamic shared memory for any C up to 4096.
//
// Not yet: tensor cores (codebook gather into a bf16 tile feeding wgmma)
// for large M, split-K for small N, packed sub-byte indices.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;       // output columns per block
constexpr int kMT = 8;        // rows of x per block
constexpr int kMaxKC = 128;   // most k rows staged at once
constexpr int kLanes = 32;    // k lanes
constexpr int kStageFloats = 10000;  // dynamic shared memory, in floats

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

// four neighbouring indices in one load
__device__ __forceinline__ void load4(const int8_t* p, int v[4]) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const int32_t* p, int v[4]) {
  const int4 q = *reinterpret_cast<const int4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <typename T, typename I, bool kVec>
__global__ void __launch_bounds__(kThreads)
cmm_kernel(const T* __restrict__ x, const I* __restrict__ idx,
           const float* __restrict__ cb, T* __restrict__ y, int M, int K,
           int N, int C, int kc) {
  extern __shared__ float stage[];
  float* xs = stage;               // [kMT][kc]
  float* cbs = stage + kMT * kc;   // [kc][C]
  __shared__ float red[kThreads / 32][kMT][kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cx = lane & 7;                  // column thread
  const int kl = warp * 4 + (lane >> 3);    // k lane, 0..31
  const int n0 = blockIdx.x * kBN + cx * 4;
  const int m0 = blockIdx.y * kMT;
  const unsigned cmax = static_cast<unsigned>(C - 1);

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int kt = 0; kt < K; kt += kc) {
    const int kend = min(kc, K - kt);
    for (int i = tid; i < kMT * kc; i += kThreads) {
      const int r = i / kc, c = i % kc;
      const int m = m0 + r;
      xs[i] = (m < M && c < kend)
                  ? to_f32(x[static_cast<int64_t>(m) * K + kt + c])
                  : 0.f;
    }
    const float* cbg = cb + static_cast<int64_t>(kt) * C;
    for (int i = tid; i < kend * C; i += kThreads) cbs[i] = cbg[i];
    __syncthreads();
    for (int c = kl; c < kend; c += kLanes) {
      const I* ir = idx + static_cast<int64_t>(kt + c) * N + n0;
      const float* row = cbs + c * C;
      float wv[4];
      if (kVec) {
        // N % 4 == 0, so n0 < N implies all four columns are in range
        if (n0 < N) {
          int v[4];
          load4(ir, v);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = row[min(static_cast<unsigned>(v[j]), cmax)];
        } else {
          wv[0] = wv[1] = wv[2] = wv[3] = 0.f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = (n0 + j < N)
                      ? row[min(static_cast<unsigned>(
                                    static_cast<int>(ir[j])), cmax)]
                      : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const float xv = xs[m * kc + c];
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

template <typename T, typename I>
int launch(const void* x, const void* idx, const void* cb, void* y, int M,
           int K, int N, int C, int vec, void* stream) {
  if (C < 1 || kStageFloats / (kMT + C) < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const int kc = min(kMaxKC, kStageFloats / (kMT + C));
  const size_t smem = sizeof(float) * kc * (kMT + C);
  const dim3 grid((N + kBN - 1) / kBN, (M + kMT - 1) / kMT);
  auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const I* ip = static_cast<const I*>(idx);
  const float* cp = static_cast<const float*>(cb);
  T* yp = static_cast<T*>(y);
  if (vec)
    cmm_kernel<T, I, true><<<grid, kThreads, smem, s>>>(xp, ip, cp, yp, M, K,
                                                        N, C, kc);
  else
    cmm_kernel<T, I, false><<<grid, kThreads, smem, s>>>(xp, ip, cp, yp, M,
                                                         K, N, C, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), idx (K, N) int8 or int32, codebook (K, C) float32, y (M, N):
// all contiguous on the current device. vec != 0 requires N % 4 == 0 and
// idx aligned to four indices. Returns the CUDA error of the launch (0 on
// success).
#define CMM_ENTRY(NAME, T, I)                                               \
  extern "C" int NAME(const void* x, const void* idx, const void* cb,       \
                      void* y, int M, int K, int N, int C, int vec,         \
                      void* stream) {                                       \
    return launch<T, I>(x, idx, cb, y, M, K, N, C, vec, stream);            \
  }

CMM_ENTRY(clustered_matmul_f32_i8, float, int8_t)
CMM_ENTRY(clustered_matmul_f32_i32, float, int32_t)
CMM_ENTRY(clustered_matmul_bf16_i8, __nv_bfloat16, int8_t)
CMM_ENTRY(clustered_matmul_bf16_i32, __nv_bfloat16, int32_t)

// Block-sparse matmul on Hopper (sm_90a): y = x @ (w * expand(mask > 0)),
// where mask (K/bk, N/bn) marks each (bk, bn) weight tile live (> 0) or
// dead.
//
// Replaces the TPU kernel src/repro/kernels/block_sparse_matmul/kernel.py:
// block_sparse_matmul_pallas (body _bsmm_kernel) and computes what it and
// the plain version (kernels/block_sparse_matmul/ref.py) compute: the
// products of the live tiles accumulate in float32 and y is written in x's
// type; a dead tile contributes nothing, whatever its weights hold. x and w
// share one type (float32 or bf16); the mask is bool or int32, one template
// each.
//
// What bounds it on this card: at decode (M = 8) bytes, the live share of
// the weights (2 bytes a bf16 weight, feeding 8 multiply-adds) over the HBM
// rate; at M = 4096 operations, 2 M K N times the live share. The Pallas
// kernel skips only the matrix unit's work on a dead tile and still copies
// the tile into VMEM, so its bytes do not shrink with the sparsity.
//
// Design: the weight bytes of a dead tile are never read.
//  * A block owns a strip of BN = 32 output columns for MT = 8 rows of x
//    (as quant_matmul.cu), independent of the mask's tile: at decode with
//    N = 1024 and bn = 128 that gives the card 32 blocks, where one block
//    per mask column would give it 8. A grid row of blocks takes each
//    further 8 rows of x.
//  * The block reads the mask entries its strip touches (one mask column
//    when bn is a multiple of 32, more for smaller bn) for 256 k-tiles at a
//    time, one tile a thread, and turns each into a 32-bit word of the
//    strip's live columns. Tiles with any live column are compacted into
//    a list in shared memory by a warp ballot and a prefix over the 8
//    warps' counts: no host-side compaction, no sync of the card.
//  * It then walks only the rows of the listed tiles, 128 at a time: the x
//    values of those rows are staged in shared memory as float32, and each
//    k lane reads 4 neighbouring weights of a row in one load when all 4
//    columns are live (else only its live columns, one by one). A strip
//    with no live tile reads no weight and writes zeros.
//  * 256 threads = 8 column threads x 32 k lanes; the k lanes are summed by
//    two warp shuffles and one pass through shared memory.
//  * Ragged edges: rows beyond M read zeros; columns beyond N are neither
//    loaded nor written. K and N are multiples of the tile (the wrapper
//    checks it); M is free.
//
// Not yet: tensor cores (wgmma on the live tiles) for large M, split-K for
// small N.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;      // output columns per block
constexpr int kMT = 8;       // rows of x per block
constexpr int kBK = 128;     // live rows staged at once
constexpr int kLanes = 32;   // k lanes
constexpr int kRound = kThreads;  // k-tiles examined per compaction round

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

// four neighbouring weights in one load
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// bits a .. b-1 of a 32-bit word (0 <= a < b <= 32)
__device__ __forceinline__ unsigned bit_range(int a, int b) {
  const unsigned width = (b - a == 32) ? 0xffffffffu : ((1u << (b - a)) - 1u);
  return width << a;
}

template <typename T, typename Mk, bool kVec>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const Mk* __restrict__ mask, T* __restrict__ y, int M, int K,
            int N, int bk, int bn) {
  __shared__ float xs[kMT][kBK];
  __shared__ int row_k[kBK];             // k of each staged row
  __shared__ unsigned row_bits[kBK];     // the strip's live columns there
  __shared__ int live_tile[kRound];      // this round's live k-tiles
  __shared__ unsigned live_bits[kRound];
  __shared__ int warp_live[kThreads / 32];
  __shared__ float red[kThreads / 32][kMT][kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cx = lane & 7;                  // column thread
  const int kl = warp * 4 + (lane >> 3);    // k lane, 0..31
  const int s0 = blockIdx.x * kBN;          // the strip's first column
  const int s1 = min(s0 + kBN, N);          // one past its last
  const int n0 = s0 + cx * 4;
  const int m0 = blockIdx.y * kMT;
  const int mask_cols = N / bn;
  const int k_tiles = K / bk;
  const int j0 = s0 / bn, j1 = (s1 - 1) / bn;   // mask columns of the strip

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int t0 = 0; t0 < k_tiles; t0 += kRound) {
    // 1. one k-tile a thread: which of the strip's columns are live there
    const int t = t0 + tid;
    unsigned bits = 0;
    if (t < k_tiles) {
      const Mk* mrow = mask + static_cast<int64_t>(t) * mask_cols;
      for (int j = j0; j <= j1; ++j)
        if (mrow[j] > 0)
          bits |= bit_range(max(s0, j * bn) - s0, min(s1, (j + 1) * bn) - s0);
    }
    // 2. compact the live tiles, in k order, by ballot and prefix
    const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n_live = 0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) {
      before += (i < warp) ? warp_live[i] : 0;
      n_live += warp_live[i];
    }
    if (bits != 0) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      live_tile[pos] = t;
      live_bits[pos] = bits;
    }
    __syncthreads();
    // 3. walk the rows of the live tiles only, kBK at a time (n_live * bk
    //    <= K, so the row counts fit an int)
    const int n_rows = n_live * bk;
    for (int v0 = 0; v0 < n_rows; v0 += kBK) {
      const int vend = min(kBK, n_rows - v0);
      for (int i = tid; i < vend; i += kThreads) {
        const int li = (v0 + i) / bk;
        row_k[i] = live_tile[li] * bk + (v0 + i - li * bk);
        row_bits[i] = live_bits[li];
      }
      __syncthreads();
      for (int i = tid; i < kMT * kBK; i += kThreads) {
        const int r = i / kBK, c = i % kBK;
        const int m = m0 + r;
        xs[r][c] = (m < M && c < vend)
                       ? to_f32(x[static_cast<int64_t>(m) * K + row_k[c]])
                       : 0.f;
      }
      __syncthreads();
      for (int c = kl; c < vend; c += kLanes) {
        const unsigned live4 = (row_bits[c] >> (cx * 4)) & 0xfu;
        if (live4 == 0) continue;        // dead here: no weight is read
        const T* wr = w + static_cast<int64_t>(row_k[c]) * N + n0;
        float wv[4];
        if (kVec && live4 == 0xfu) {
          load4(wr, wv);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = ((live4 >> j) & 1u) ? to_f32(wr[j]) : 0.f;
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
  const int gm = m0 + m, gn = s0 + c;
  if (gm < M && gn < N) y[static_cast<int64_t>(gm) * N + gn] = from_f32<T>(sum);
}

template <typename T, typename Mk>
int launch(const void* x, const void* w, const void* mask, void* y, int M,
           int K, int N, int bk, int bn, int vec, void* stream) {
  if (bk < 1 || bn < 1 || K % bk || N % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kMT - 1) / kMT);
  auto s = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const Mk* mp = static_cast<const Mk*>(mask);
  T* yp = static_cast<T*>(y);
  if (vec)
    bsmm_kernel<T, Mk, true><<<grid, kThreads, 0, s>>>(xp, wp, mp, yp, M, K,
                                                       N, bk, bn);
  else
    bsmm_kernel<T, Mk, false><<<grid, kThreads, 0, s>>>(xp, wp, mp, yp, M, K,
                                                        N, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K), w (K, N) of one type, mask (K/bk, N/bn) bool (one byte) or
// int32, y (M, N): all contiguous on the current device. vec != 0 requires
// N % 4 == 0 and w aligned to four weights. Returns the CUDA error of the
// launch (0 on success).
#define BSMM_ENTRY(NAME, T, Mk)                                             \
  extern "C" int NAME(const void* x, const void* w, const void* mask,       \
                      void* y, int M, int K, int N, int bk, int bn,         \
                      int vec, void* stream) {                              \
    return launch<T, Mk>(x, w, mask, y, M, K, N, bk, bn, vec, stream);      \
  }

BSMM_ENTRY(block_sparse_matmul_f32_b8, float, uint8_t)
BSMM_ENTRY(block_sparse_matmul_f32_i32, float, int32_t)
BSMM_ENTRY(block_sparse_matmul_bf16_b8, __nv_bfloat16, uint8_t)
BSMM_ENTRY(block_sparse_matmul_bf16_i32, __nv_bfloat16, int32_t)

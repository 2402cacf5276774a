// Shared pieces of the skinny (decode-sized M) matmuls K2 (quant_matmul.cu)
// and K4 (block_sparse_matmul.cu) on Hopper (sm_90a); K3
// (clustered_matmul.cu) takes its copy, launch and type helpers.
//
// K2 and K4 have one skeleton:
//  * A block owns a strip of kBN = 16 output columns (one m16 tile of
//    mma.sync) for MB = 8 * NT rows of x (NT n-tiles of 8) and a share of
//    the strip's k16 steps. The S blocks of a strip form a thread-block
//    cluster (S <= 8, a launch attribute); every rank stores its partial
//    sums into rank 0's shared memory (distributed shared memory), and after
//    one cluster barrier rank 0 adds them in rank order and writes y. One
//    launch, a fixed summation order: results are deterministic.
//  * Staging by cp.async, 16 bytes a copy, in pieces of kPieceSteps k16
//    steps (128 k rows) into a ring of 3 to 8 slots (ring_for): all but
//    one are in flight while one is computed. A copy whose bytes must not
//    be read (a dead tile, a row past K or past the rank's chunk, a row of
//    x past M) uses cp.async's src-size of 0, which writes 16 zero bytes
//    and reads nothing.
//  * bf16 x: tensor cores. y^T = W^T x^T by mma.sync.m16n8k16 (bf16 in,
//    float32 accumulate): A is the staged (k, n) weight tile transposed,
//    read with ldmatrix.x4.trans; B is x's rows, read as 32-bit pairs along
//    k from the staged x; C's rows are output columns, its columns rows of
//    x. The epilogue writes y transposed back into (M, N).
//  * float32 x: the CUDA cores over the same stage, no TF32.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16" with
// .bf16; g = lane / 4, t = lane % 4; each register holds two bf16, the
// lower k in the lower half):
//   A (16 x 16, row = m, col = k): a0 (g, 2t..2t+1), a1 (g + 8, 2t..),
//     a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B (16 x 8, row = k, col = n): b0 (2t..2t+1, g), b1 (2t + 8.., g)
//   C (16 x 8 float): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// ldmatrix.trans of an 8 x 8 b16 matrix whose rows (the 8 addresses) are
// k gives lane (g, t) the elements (k = 2t, col g) and (k = 2t + 1, col g):
// the A layout for W^T.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace skinny {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;         // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 16;               // output columns of a strip
constexpr int kStep = 16;             // k rows of a step (one k16 mma)
constexpr int kPieceSteps = 8;        // steps of a piece: 2 a warp
constexpr int kPieceRows = kStep * kPieceSteps;   // 128
// ring slots of staged pieces of ``slot`` bytes: as many as fit in
// kRingBytes, 3 to 8 (2 to 7 pieces in flight ahead of the one computed),
// so that several blocks share an SM
constexpr int kRingBytes = 48 * 1024;
__host__ __device__ constexpr int ring_for(int slot) {
  return kRingBytes / slot < 3 ? 3 : kRingBytes / slot > 8 ? 8
                                                           : kRingBytes / slot;
}
constexpr int kMaxSplit = 8;          // portable cluster size
constexpr int kWave = 132;            // blocks aimed at: one an SM
constexpr int kMinSteps = 8;          // k16 steps a block at least
constexpr int kMaxSteps = 128;        // k16 steps a block at most, if S allows

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; with fill false, 16 zero bytes
// are written and src is not read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most N of this thread's groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A B, m16n8k16, bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (bytes q0..q3 of r) as two bf16 pairs, exactly: (q0, q2) in
// ``even`` and (q1, q3) in ``odd``, the first of each pair in the lower
// half. A byte b + 128 placed under the exponent of 2^23 is the float
// 2^23 + b + 128; one subtraction leaves b, and |b| <= 128 fits bf16's
// 8-bit significand. Per 4 weights: 1 xor, 4 byte permutes, 4 adds and 2
// packed conversions (11 instructions), where one I2F a weight (16 a clock
// an SM in the CUDA programming guide's throughput table) would leave
// about as many conversions a clock as the HBM rate delivers weights
// (~14.5 bytes a clock an SM), with nothing to spare.
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t r, uint32_t& even,
                                               uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  constexpr uint32_t kMagic = 0x4B000000u;
  constexpr float kBias = 8388736.0f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - kBias;
  const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - kBias;
  const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - kBias;
  const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - kBias;
  const __nv_bfloat162 e = __floats2bfloat162_rn(f0, f2);
  const __nv_bfloat162 o = __floats2bfloat162_rn(f1, f3);
  even = *reinterpret_cast<const uint32_t*>(&e);
  odd = *reinterpret_cast<const uint32_t*>(&o);
}

// Programmatic dependent launch: wait for the grid before this one in the
// stream (and its memory) before any global access, then let the next one
// start launching. Only a next kernel launched the same way gains.
__device__ __forceinline__ void pdl_enter() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the n-tiles of x rows a block: 8 rows (the decode batch), 16, or 64
inline int n_tiles_for(int M) { return M <= 8 ? 1 : M <= 16 ? 2 : 8; }

// blocks of a strip's cluster: enough for kWave blocks and for chunks of
// at most kMaxSteps k16 steps, at most 8, and at least kMinSteps steps a
// block. One block an SM measured faster at qwen3-0.6b's decode shapes than
// two (a block's fixed latencies and the cluster's reduction cost more than
// the extra bytes in flight gain); long K wants more blocks in flight.
inline int split_for(int strips, int m_tiles, int steps) {
  const int want = (kWave + strips * m_tiles - 1) / (strips * m_tiles);
  const int need = (steps + kMaxSteps - 1) / kMaxSteps;
  int s = want > need ? want : need;
  if (s > kMaxSplit) s = kMaxSplit;
  const int most = steps / kMinSteps;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// The block's partial sums for its MB rows and BN columns, summed over the
// cluster: every rank stores its block's sums into
// rank 0's ``gathered`` (distributed shared memory, same offset in every
// rank); after the cluster barrier rank 0 adds them in rank order and calls
// out(m, c, sum) for each. ``red`` holds one partial a warp,
// red[warp][m][c].
template <int MB, int BN, typename Out>
__device__ __forceinline__ void cluster_reduce(const float* red,
                                               float* gathered, Out out) {
  constexpr int kOut = MB * BN;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  __syncthreads();
  float* dst = cluster.map_shared_rank(gathered, 0) + rank * kOut;
  for (int o = threadIdx.x; o < kOut; o += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w * kOut + o];
    dst[o] = v;
  }
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank != 0) return;
  for (int o = threadIdx.x; o < kOut; o += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < split; ++r) sum += gathered[r * kOut + o];
    out(o / BN, o % BN, sum);
  }
}

// Launches ``kernel`` on a grid of (strips * split, m_tiles) blocks in
// clusters of ``split`` along x, with programmatic stream serialization.
// Returns the CUDA error (0 on success); a refused launch's error is
// cleared so that the next call does not report it.
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int strips, int split,
                     int m_tiles, size_t smem, void* stream,
                     Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * split, m_tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// Raises a kernel's dynamic shared memory cap to ``bytes`` once per
// process (needed above 48 KB).
template <typename K>
int allow_smem(K kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  done = true;
  return 0;
}

}  // namespace skinny

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
// indices (plus x, the codebooks and y) over the HBM rate. At M = 4096 the
// bound is operations (2 M K N at the tensor-core rate); this kernel still
// runs there on the CUDA cores, 8 rows of x a block.
//
// Design (split-K over a thread-block cluster):
//  * A block covers a strip of BN output columns for 8 rows of x and one
//    K-chunk. The S K-chunks of a strip (S <= 8) form a thread-block
//    cluster, launched by cudaLaunchKernelEx with a cluster dimension: the
//    first version gave the card N / 32 blocks that each walked all of K
//    (32 blocks for N = 1024 on 132 SMs). S aims at two blocks an SM in one
//    wave with at least 128 k rows a block: every qwen3-0.6b decode shape
//    gets at least 256 blocks (N = 1024: 32 strips x 8 chunks; 2048: 64 x
//    5; 3072: 96 x 3). More, shorter blocks and fewer, longer ones both
//    measured slower: a block's fixed latencies (launch, first data under
//    the burst of every block's copies, reduction, cluster barrier) are
//    most of a product's time at these sizes, and a block of 2 x 8 rows x
//    16 columns of partial sums a thread fits two an SM.
//  * 128 threads: a warp holds 16 k rows x 2 column halves, a thread 16
//    columns (16 int8 or 4 int32 indices, one 16-byte word) x the 8 rows of
//    x: BN = 32 (int8) or 8 (int32), 32 bytes of indices a k row.
//  * Staging by cp.async, 16 bytes a copy: first the x chunk as it lies
//    ([8][rows] in x's type, read as it is), then the chunk in pieces of
//    128 k rows, each piece's indices and codebook rows (a contiguous
//    float32 run) one commit group. Piece p + 2 is issued before piece p is
//    computed, so copies and arithmetic overlap; every piece has its own
//    rows of the stage, so nothing is overwritten. A thread computes its 2
//    rows of a piece interleaved, so one row's gathers wait while the
//    other's multiply. The whole chunk is one stage whenever it fits in
//    64 KB (at C = 16 up to 576 rows); larger C stage fewer rows at a time.
//  * Each weight is gathered from the staged codebook row. A warp's 16
//    rows share the 32 banks, so random indices cost a few passes a
//    gather; copies of the codebook laid out for conflict-free gathers
//    measured slower, their index arithmetic costing more than the
//    conflicts, and so did gathers from L1 with no staging, and 4 rows of
//    x a thread (half the partial sums, twice the gathers).
//  * Reduction: the 16 k rows of a warp half are summed by 4 shuffle
//    rounds that halve the values each lane carries (128 to 8 for int8),
//    the 4 warps through shared memory; every rank then stores its block's
//    sums into rank 0's shared memory (distributed shared memory), and
//    after one cluster barrier rank 0 adds them in rank order and writes y.
//    One launch per call, and a fixed summation order, so results are
//    deterministic.
//  * Ragged edges: rows beyond M and k beyond K read zeros; columns beyond
//    N are neither loaded nor written; a block whose chunk starts beyond K
//    contributes zeros. When N is not a multiple of the 16-byte word or idx
//    is not aligned for it (the wrapper decides by alignment), the indices
//    are read singly from global memory; x and the codebook rows are read
//    by plain loads where they are not 16-byte aligned.
//  * An index outside [0, C) gives weight 0, as in the Pallas body (its
//    one-hot against iota(C) matches no entry) and the plain version, and
//    nothing outside the staged codebook is read. A thread tests its two
//    16-byte words of indices once a row (SIMD byte compares for int8);
//    only a word holding such an index takes the gathers that test each
//    one. A test and a select on every gather, and a zero entry padded
//    onto every staged codebook row (a 20-word pitch at C = 16), both
//    measured slower.
//  * Launch latency: a product's fixed latencies are most of its time, so
//    the kernel is launched with programmatic stream serialization. It
//    waits (griddepcontrol.wait) for the previous grid in the stream and
//    its memory before touching global memory, so stream order holds as
//    for any launch; the next grid's launch overlaps this one's run. Only
//    a next kernel launched the same way (another K3 call) gains: the
//    decode step's products back to back do, a kernel between them does
//    not.
//
// Not yet: tensor cores (codebook gather into a bf16 tile feeding wgmma)
// for large M, packed sub-byte indices.
#include <type_traits>

#include "skinny_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = skinny::kThreads;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 64;         // k rows in parallel: 16 a warp
constexpr int kPiece = 2 * kRowLanes;  // k rows of a piece: 2 a thread
constexpr int kMT = 8;                // rows of x a block (and a thread)
constexpr int kMinRows = 128;         // k rows a block at least
constexpr int kAhead = 2;             // pieces issued ahead of the one computed
constexpr int kMaxSplit = 8;          // portable cluster size
constexpr int kWave = 264;            // blocks aimed at: two an SM
// dynamic shared memory of a stage (opted in above 48 KB)
constexpr int kStageBytes = 64 * 1024;

using skinny::cp_async_commit;
using skinny::cp_async_wait;
using skinny::from_f32;
using skinny::to_f32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  skinny::cp_async16(dst, src, true);
}

template <typename I>
struct Vec {
  static constexpr int kN = 16 / sizeof(I);   // indices a 16-byte load
};

// index j of a 16-byte word of indices
__device__ __forceinline__ int lane_index(const int4& w, int j, int8_t) {
  const int word = j < 4 ? w.x : j < 8 ? w.y : j < 12 ? w.z : w.w;
  return static_cast<int>(static_cast<int8_t>(word >> (8 * (j & 3))));
}
__device__ __forceinline__ int lane_index(const int4& w, int j, int32_t) {
  return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
}

// whether every index of a 16-byte word lies in [0, C): int8 indices by
// four SIMD byte compares (a negative int8 is a byte >= 128)
__device__ __forceinline__ bool all_in_range(const int4& w, int C, int8_t) {
  const unsigned lim = static_cast<unsigned>(min(C, 128)) * 0x01010101u;
  return (__vcmpltu4(w.x, lim) & __vcmpltu4(w.y, lim) &
          __vcmpltu4(w.z, lim) & __vcmpltu4(w.w, lim)) == 0xffffffffu;
}
__device__ __forceinline__ bool all_in_range(const int4& w, int C, int32_t) {
  const unsigned n = static_cast<unsigned>(C);
  return static_cast<unsigned>(w.x) < n && static_cast<unsigned>(w.y) < n &&
         static_cast<unsigned>(w.z) < n && static_cast<unsigned>(w.w) < n;
}

// one round of the row reduction: lanes ``o`` apart exchange halves of
// their first n values; the lane with bit o set keeps the upper half
template <int NV, int n>
__device__ __forceinline__ void halve(float (&acc)[NV], int lane, int o) {
  const bool upper = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send = upper ? acc[i] : acc[i + n / 2];
    const float keep = upper ? acc[i + n / 2] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

template <typename T, typename I, bool kVecLoad>
__global__ void __launch_bounds__(kThreads, 3)
cmm_kernel(const T* __restrict__ x, const I* __restrict__ idx,
           const float* __restrict__ cb, T* __restrict__ y, int M, int K,
           int N, int C, int chunk, int stage_rows) {
  constexpr int V = Vec<I>::kN;
  constexpr int BN = 2 * V;
  constexpr int NV = kMT * V;     // partial sums a thread carries
  constexpr int kOut = kMT * BN;  // outputs of a block
  extern __shared__ __align__(16) float stage[];
  __shared__ float red[kWarps][kOut];
  __shared__ float gathered[kMaxSplit][kOut];   // rank 0's: every rank's sums

  skinny::pdl_enter();
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hf = lane >> 4;                 // column half
  const int rl = warp * 16 + (lane & 15);   // k row lane, 0..63
  const int nb = (static_cast<int>(blockIdx.x) / split) * BN;
  const int n0 = nb + hf * V;
  const int m0 = blockIdx.y * kMT;
  const int k_lo = rank * chunk;
  const int k_hi = min(K, k_lo + chunk);
  const unsigned n_cb = static_cast<unsigned>(C);
  // each part starts 16-byte aligned: a row of ids is 32 bytes
  I* ids = reinterpret_cast<I*>(stage);                          // [rows][BN]
  T* xs = reinterpret_cast<T*>(ids + stage_rows * BN);           // [kMT][rows]
  float* cbs = reinterpret_cast<float*>(xs + kMT * stage_rows);  // [rows][C]
  // x rows copy as they lie when every stage's are whole 16-byte words
  constexpr int kPer = 16 / sizeof(T);
  const bool x16 = K % kPer == 0 && stage_rows % kPer == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  for (int ks = k_lo; ks < k_hi; ks += stage_rows) {
    const int rows = min(stage_rows, k_hi - ks);
    const int pieces = (rows + kPiece - 1) / kPiece;
    // group 0: the x chunk, as it lies
    if (x16) {
      const int words = rows / kPer;          // rows % kPer == 0 here
      for (int i = tid; i < kMT * words; i += kThreads) {
        const int m = i / words, q = i % words;
        T* dst = xs + m * stage_rows + q * kPer;
        if (m0 + m < M)
          cp_async16(dst, x + static_cast<int64_t>(m0 + m) * K + ks + q * kPer);
        else
          *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
    // then a group a piece (128 k rows of indices and codebook rows), kAhead
    // pieces ahead of the one computed
    const float* cbg = cb + static_cast<int64_t>(ks) * C;
    const bool cb16 =
        C % 4 == 0 && reinterpret_cast<uintptr_t>(cbg) % 16 == 0;
    auto issue = [&](int p) {
      const int r_lo = p * kPiece, r_hi = min(rows, r_lo + kPiece);
      if (kVecLoad && nb < N)
        for (int i = r_lo * 2 + tid; i < r_hi * 2; i += kThreads) {
          const int r = i >> 1, h = i & 1;
          if (nb + h * V < N)
            cp_async16(ids + r * BN + h * V,
                       idx + static_cast<int64_t>(ks + r) * N + nb + h * V);
        }
      if (cb16)
        for (int i = r_lo * C / 4 + tid; i < r_hi * C / 4; i += kThreads)
          cp_async16(cbs + 4 * i, cbg + 4 * i);
      cp_async_commit();   // an empty group past the last piece
    };
    for (int p = 0; p < kAhead; ++p) issue(p);
    if (!x16)
      for (int r = tid; r < rows; r += kThreads)
#pragma unroll
        for (int m = 0; m < kMT; ++m)
          xs[m * stage_rows + r] =
              m0 + m < M ? x[static_cast<int64_t>(m0 + m) * K + ks + r]
                         : from_f32<T>(0.f);
    if (!cb16)
      for (int i = tid; i < rows * C; i += kThreads) cbs[i] = __ldg(cbg + i);
    // piece p (x with it: groups complete in order) is computed while the
    // next kAhead - 1 are in flight; each piece has its own rows of the
    // stage, so none is overwritten. A thread's two rows of a piece are
    // interleaved, so the latency of one's gathers hides the other's.
    for (int p = 0; p < pieces; ++p) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      issue(p + kAhead);
      const int r0 = p * kPiece + rl;
      if (r0 >= rows) continue;
      const bool two = r0 + kRowLanes < rows;
      const int r1 = two ? r0 + kRowLanes : r0;
      float xv[2][kMT];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        xv[0][m] = to_f32(xs[m * stage_rows + r0]);
        xv[1][m] = two ? to_f32(xs[m * stage_rows + r1]) : 0.f;
      }
      const float* row[2] = {cbs + r0 * C, cbs + r1 * C};
      int4 word[2] = {make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0)};
      if (kVecLoad && n0 < N) {
        word[0] = *reinterpret_cast<const int4*>(ids + r0 * BN + hf * V);
        word[1] = *reinterpret_cast<const int4*>(ids + r1 * BN + hf * V);
      }
      const I* ir[2] = {idx + static_cast<int64_t>(ks + r0) * N + n0,
                        idx + static_cast<int64_t>(ks + r1) * N + n0};
      // an index outside [0, C) weighs 0; the test per gather runs only
      // where the thread's words hold such an index
      auto gather = [&](auto checked) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          float w[2] = {0.f, 0.f};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && !two) break;
            if (kVecLoad) {
              if (n0 < N) {
                const unsigned c =
                    static_cast<unsigned>(lane_index(word[u], j, I{}));
                w[u] = (!decltype(checked)::value || c < n_cb) ? row[u][c]
                                                               : 0.f;
              }
            } else if (n0 + j < N) {
              const unsigned c =
                  static_cast<unsigned>(static_cast<int>(ir[u][j]));
              w[u] = c < n_cb ? row[u][c] : 0.f;
            }
          }
#pragma unroll
          for (int m = 0; m < kMT; ++m)
            acc[m * V + j] = fmaf(xv[1][m], w[1],
                                  fmaf(xv[0][m], w[0], acc[m * V + j]));
        }
      };
      if (kVecLoad && all_in_range(word[0], C, I{}) &&
          all_in_range(word[1], C, I{}))
        gather(std::false_type{});
      else
        gather(std::true_type{});
    }
    __syncthreads();   // the next stage overwrites the staged tiles
  }

  // sum the 16 k rows of a warp-half: after rounds (8, 4, 2, 1) lane bits
  // b3 b2 b1 b0 select the values kept, the sums of x row 4 b3 + 2 b2 + b1
  // and columns hf * V + b0 V / 2 + j, j < V / 2
  halve<NV, NV>(acc, lane, 8);
  halve<NV, NV / 2>(acc, lane, 4);
  halve<NV, NV / 4>(acc, lane, 2);
  halve<NV, NV / 8>(acc, lane, 1);
  {
    const int m = 4 * ((lane >> 3) & 1) + 2 * ((lane >> 2) & 1) +
                  ((lane >> 1) & 1);
    const int c0 = hf * V + (lane & 1) * (V / 2);
#pragma unroll
    for (int j = 0; j < V / 2; ++j) red[warp][m * BN + c0 + j] = acc[j];
  }
  __syncthreads();
  // every rank stores its block's sums into rank 0's shared memory; after
  // the cluster barrier rank 0 adds them in rank order and writes y
  float* dst = cluster.map_shared_rank(&gathered[0][0], 0) + rank * kOut;
  for (int o = tid; o < kOut; o += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w][o];
    dst[o] = v;
  }
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  if (rank != 0) return;
  for (int o = tid; o < kOut; o += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < split; ++r) sum += gathered[r][o];
    const int m = o / BN, c = o % BN;
    if (m0 + m < M && nb + c < N)
      y[static_cast<int64_t>(m0 + m) * N + nb + c] = from_f32<T>(sum);
  }
}

template <typename T, typename I>
int launch(const void* x, const void* idx, const void* cb, void* y, int M,
           int K, int N, int C, int vec, void* stream) {
  if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  constexpr int BN = 2 * Vec<I>::kN;
  const int strips = (N + BN - 1) / BN;
  const int m_tiles = (M + kMT - 1) / kMT;
  // K-chunks of whole 64-row steps: enough blocks for about one wave of
  // two an SM, at most 8 a cluster, and at least kMinRows k rows a block
  const int passes = (max(K, 1) + kRowLanes - 1) / kRowLanes;
  const int want = (kWave + strips * m_tiles - 1) / (strips * m_tiles);
  const int split =
      max(1, min(min(kMaxSplit, want), passes / (kMinRows / kRowLanes)));
  const int chunk = (passes + split - 1) / split * kRowLanes;
  // a staged k row: indices (32 B), x, codebook row
  const int row_bytes = 32 + kMT * static_cast<int>(sizeof(T)) +
                        static_cast<int>(sizeof(float)) * C;
  const int fit = kStageBytes / row_bytes;
  const int stage_rows =
      min(chunk, fit >= kRowLanes ? fit / kRowLanes * kRowLanes : fit);
  if (stage_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(row_bytes) * stage_rows;
  static bool allowed[2] = {false, false};
  for (int v = 0; v < 2; ++v) {
    const int rc = skinny::allow_smem(
        v ? cmm_kernel<T, I, true> : cmm_kernel<T, I, false>, kStageBytes,
        allowed[v]);
    if (rc != 0) return rc;
  }
  return skinny::launch_clustered(
      vec ? cmm_kernel<T, I, true> : cmm_kernel<T, I, false>, strips, split,
      m_tiles, smem, stream, static_cast<const T*>(x),
      static_cast<const I*>(idx), static_cast<const float*>(cb),
      static_cast<T*>(y), M, K, N, C, chunk, stage_rows);
}

}  // namespace

// x (M, K), idx (K, N) int8 or int32, codebook (K, C) float32, y (M, N):
// all contiguous on the current device. vec != 0 requires N to be a
// multiple of the indices in 16 bytes (16 int8, 4 int32) and idx aligned to
// 16 bytes. Returns the CUDA error of the launch (0 on success).
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

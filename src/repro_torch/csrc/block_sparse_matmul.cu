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
// Design (the skeleton of skinny_mma.cuh, shared with K2): the weight bytes
// of a dead tile are never read.
//  * A block owns a strip of 16 output columns for 8, 16 or 64 rows of x;
//    the S blocks of a strip are a thread-block cluster (S gives one block
//    an SM: 192-256 blocks for qwen3-0.6b's decode shapes, S = 1 for
//    N = 3072), reduced through distributed shared memory into rank 0 in
//    rank order.
//  * The ranks share the strip's live k16 steps, not equal slices of K:
//    every rank reads the mask entries of its strip on the device (no host
//    sync, no compaction on the host), 128 steps at a time, one a thread,
//    and turns each step into a word of live bits, one per (row, 16-byte
//    piece of the row). A step with any live bit is live; the live steps
//    are numbered in k order by a warp ballot and a prefix over the 4
//    warps, and rank r takes live steps r, r + S, ... So the time follows
//    ceil(live / S) steps, and a skewed mask costs what a uniform one of
//    the same live share does. When bk is a multiple of 16 and the copies
//    are whole (the 128 x 128 tiles of the decode step), a step lies in
//    one tile and its word takes one round of independent mask loads (the
//    general per-row walk, a dependent load per piece, cost more than the
//    copies at qwen3-0.6b's decode shapes). A step is skipped only when
//    all of its rows are dead; the rows of a dead tile inside a live step
//    (bk not a multiple of 16, or a step across two tiles) are zero-filled.
//    A rank keeps at most 512 steps at a time and walks the strip in
//    passes.
//  * Staging by cp.async, 16 bytes a copy: a piece is 8 of the rank's
//    steps (their rows of the strip, and x's 16 columns each), in a ring of
//    up to 48 KB (5 slots at M = 8): all but one piece in flight ahead of
//    the one computed. A dead piece of a
//    row writes zeros by cp.async's src-size of 0 and reads nothing. A
//    strip with no live step reads no weight and writes zeros.
//  * bf16, tensor cores: a warp takes 2 steps of a piece; one
//    ldmatrix.x4.trans of the staged (k, n) rows (48-byte pitch, so the 8
//    rows of each matrix fall on distinct banks) is the A fragment of W^T,
//    B is x's rows, and mma.sync.m16n8k16 accumulates in float32 (at M = 8
//    bound by bytes: one mma a 512 bytes of weight).
//  * float32: the CUDA cores over the same stage, a thread a column and 16
//    of the piece's rows; no TF32.
//  * Any tile the wrapper takes: when bn is a multiple of 16 bytes of w,
//    N too and w is 16-byte aligned, every 16-byte piece of a row lies in
//    one mask column and is copied whole or zero-filled; otherwise (bn of
//    1, 2 or 4 bf16, say, where a piece straddles a live and a dead tile)
//    the weights are staged by single loads with the mask read per
//    element. x is staged by single loads when K is not a multiple of 16
//    bytes or x is not 16-byte aligned. The wrapper decides by alignment.
//  * Launch latency: programmatic stream serialization (see pdl_enter); a
//    decode step's products run back to back.
#include "skinny_mma.cuh"

namespace {

using namespace skinny;

constexpr int kCap = 512;   // live steps a rank holds at a time

// bytes of a staged weight row: 16 columns, padded for bf16 so that the 8
// rows of an ldmatrix matrix fall on distinct banks
template <typename T>
__host__ __device__ constexpr int w_pitch() {
  return sizeof(T) == 2 ? 48 : 64;
}
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return kPieceRows + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int NT>
__host__ __device__ constexpr int slot_bytes() {
  return kPieceRows * w_pitch<T>() +
         8 * NT * x_pitch<T>() * static_cast<int>(sizeof(T));
}

template <typename T, int NT>
constexpr size_t smem_bytes(int split) {
  constexpr int slot = slot_bytes<T, NT>();
  return static_cast<size_t>(ring_for(slot)) * slot +
         static_cast<size_t>(kWarps + split) * 8 * NT * kBN * sizeof(float);
}

template <typename T, typename Mk, int NT>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const Mk* __restrict__ mask, T* __restrict__ y, int M, int K,
            int N, int bk, int bn, int flags) {
  constexpr int MB = 8 * NT;
  constexpr int WP = w_pitch<T>();
  constexpr int XP = x_pitch<T>();
  constexpr int kSlot = slot_bytes<T, NT>();
  constexpr int kRing = ring_for(kSlot), kAhead = kRing - 1;
  constexpr int PW = 16 / static_cast<int>(sizeof(T));   // values a copy
  constexpr int PPR = kBN / PW;                          // copies a row
  constexpr bool kMma = sizeof(T) == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + kRing * kSlot);
  float* gathered = red + kWarps * MB * kBN;
  __shared__ int lst_step[kCap];
  __shared__ unsigned long long lst_bits[kCap];
  __shared__ int warp_live[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (static_cast<int>(blockIdx.x) / split) * kBN;
  const int m0 = blockIdx.y * MB;
  const int mask_cols = N / bn;
  const int steps_total = (K + kStep - 1) / kStep;
  const bool wvec = flags & 1, xvec = flags & 2;

  pdl_enter();

  auto live = [&](int k, int n) {
    return mask[static_cast<int64_t>(k / bk) * mask_cols + n / bn] > 0;
  };
  // the mask column of each 16-byte piece of the strip's rows, when each
  // piece lies in one (wvec)
  int piece_col[PPR];
#pragma unroll
  for (int h = 0; h < PPR; ++h)
    piece_col[h] = n0 + h * PW < N ? (n0 + h * PW) / bn : -1;
  // bit i * PPR + h: piece h of row i of step s has a live column
  auto step_bits = [&](int s) {
    if (wvec && bk % kStep == 0) {
      // the step's 16 rows lie in one tile: PPR independent loads, one
      // round trip (K is then a multiple of 16: no row past K)
      const Mk* row = mask + static_cast<int64_t>(kStep * s / bk) * mask_cols;
      Mk v[PPR];
#pragma unroll
      for (int h = 0; h < PPR; ++h)
        v[h] = piece_col[h] >= 0 ? row[piece_col[h]] : Mk{0};
      unsigned long long tile_bits = 0;
#pragma unroll
      for (int h = 0; h < PPR; ++h)
        tile_bits |= static_cast<unsigned long long>(v[h] > 0) << h;
      unsigned long long bits = 0;
#pragma unroll
      for (int i = 0; i < kStep; ++i) bits |= tile_bits << (i * PPR);
      return bits;
    }
    unsigned long long bits = 0;
    int prev = -1;
    unsigned tile_bits = 0;
    for (int i = 0; i < kStep; ++i) {
      const int k = kStep * s + i;
      if (k >= K) break;
      if (k / bk != prev) {
        prev = k / bk;
        tile_bits = 0;
        for (int h = 0; h < PPR; ++h) {
          const int a = n0 + h * PW, b = min(N, a + PW);
          for (int j = a / bn; a < b && j <= (b - 1) / bn; ++j)
            if (live(k, j * bn)) {
              tile_bits |= 1u << h;
              break;
            }
        }
      }
      bits |= static_cast<unsigned long long>(tile_bits) << (i * PPR);
    }
    return bits;
  };
  // live steps numbered before x that fall to this rank
  auto owned = [&](int xx) { return (xx + split - 1 - rank) / split; };

  float acc[kMma ? NT : 1][kMma ? 4 : MB];
#pragma unroll
  for (int i = 0; i < (kMma ? NT : 1); ++i)
#pragma unroll
    for (int j = 0; j < (kMma ? 4 : MB); ++j) acc[i][j] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  int live_seen = 0, scan = 0;
  do {
    // 1. this rank's next live steps, in k order
    int cnt = 0;
    while (scan < steps_total && cnt <= kCap - kThreads) {
      const int s = scan + tid;
      const unsigned long long bits = s < steps_total ? step_bits(s) : 0ull;
      const unsigned ballot = __ballot_sync(0xffffffffu, bits != 0);
      if (lane == 0) warp_live[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, n_live = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) {
        before += i < warp ? warp_live[i] : 0;
        n_live += warp_live[i];
      }
      if (bits != 0) {
        const int gi = live_seen + before +
                       __popc(ballot & ((1u << lane) - 1u));
        if (gi % split == rank) {
          const int at = cnt + owned(gi) - owned(live_seen);
          lst_step[at] = s;
          lst_bits[at] = bits;
        }
      }
      cnt += owned(live_seen + n_live) - owned(live_seen);
      live_seen += n_live;
      scan += kThreads;
      __syncthreads();
    }

    // 2. the listed steps, kPieceSteps a piece
    const int n_pieces = (cnt + kPieceSteps - 1) / kPieceSteps;
    auto issue = [&](int p) {
      if (p < n_pieces) {
        uint8_t* slot = smem + (p % kRing) * kSlot;
        T* xs = reinterpret_cast<T*>(slot + kPieceRows * WP);
        const int e0 = p * kPieceSteps;
        const int ne = min(kPieceSteps, cnt - e0);
        if (wvec) {
          for (int i = tid; i < ne * kStep * PPR; i += kThreads) {
            const int js = i / (kStep * PPR), r = (i / PPR) % kStep;
            const int h = i % PPR;
            const bool in = (lst_bits[e0 + js] >> (r * PPR + h)) & 1ull;
            const int k = kStep * lst_step[e0 + js] + r;
            cp_async16(slot + (js * kStep + r) * WP + 16 * h,
                       in ? w + static_cast<int64_t>(k) * N + n0 + h * PW
                          : w, in);
          }
        } else {
          for (int i = tid; i < ne * kStep * kBN; i += kThreads) {
            const int js = i / (kStep * kBN), r = (i / kBN) % kStep;
            const int c = i % kBN;
            const int k = kStep * lst_step[e0 + js] + r, n = n0 + c;
            const bool in = k < K && n < N && live(k, n);
            reinterpret_cast<T*>(slot + (js * kStep + r) * WP)[c] =
                in ? w[static_cast<int64_t>(k) * N + n] : from_f32<T>(0.f);
          }
        }
        if (xvec) {
          constexpr int kWords = kStep / PW;   // copies of x a step and row
          for (int i = tid; i < ne * MB * kWords; i += kThreads) {
            const int js = i / (MB * kWords), m = (i / kWords) % MB;
            const int h = i % kWords;
            const int k = kStep * lst_step[e0 + js] + h * PW;
            const bool in = m0 + m < M && k < K;
            cp_async16(xs + m * XP + js * kStep + h * PW,
                       in ? x + static_cast<int64_t>(m0 + m) * K + k : x, in);
          }
        } else {
          for (int i = tid; i < ne * MB * kStep; i += kThreads) {
            const int js = i / (MB * kStep), m = (i / kStep) % MB;
            const int c = i % kStep;
            const int k = kStep * lst_step[e0 + js] + c;
            xs[m * XP + js * kStep + c] =
                (m0 + m < M && k < K)
                    ? x[static_cast<int64_t>(m0 + m) * K + k]
                    : from_f32<T>(0.f);
          }
        }
      }
      cp_async_commit();   // an empty group past the last piece
    };

    for (int p = 0; p < kAhead; ++p) issue(p);
    for (int p = 0; p < n_pieces; ++p) {
      cp_async_wait<kAhead - 1>();
      __syncthreads();
      issue(p + kAhead);   // refills the slot computed in the last iteration
      const uint8_t* slot = smem + (p % kRing) * kSlot;
      const T* xs = reinterpret_cast<const T*>(slot + kPieceRows * WP);
      const int ne = min(kPieceSteps, cnt - p * kPieceSteps);
      if constexpr (kMma) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int js = 2 * warp + s;
          if (js >= ne) break;
          // lanes 0-7: k 0-7, n 0-7; 8-15: k 0-7, n 8-15; 16-23: k 8-15,
          // n 0-7; 24-31: k 8-15, n 8-15 -> a0, a1, a2, a3
          uint32_t a[4];
          ldsm_x4_trans(a, smem_u32(slot + (js * kStep + (lane >> 4) * 8 +
                                            (lane & 7)) * WP +
                                    ((lane >> 3) & 1) * 16));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const T* xr = xs + (8 * nt + g) * XP + js * kStep + 2 * t;
            mma_bf16(acc[nt], a, *reinterpret_cast<const uint32_t*>(xr),
                     *reinterpret_cast<const uint32_t*>(xr + 8));
          }
        }
      } else {
        const int c = tid % kBN, L = tid / kBN;
#pragma unroll 4
        for (int i = 0; i < kPieceRows / 8; ++i) {
          const int r = L + 8 * i;
          if (r >= ne * kStep) break;
          const float wv =
              to_f32(reinterpret_cast<const T*>(slot + r * WP)[c]);
#pragma unroll
          for (int m = 0; m < MB; ++m)
            acc[0][m] = fmaf(to_f32(xs[m * XP + r]), wv, acc[0][m]);
        }
      }
    }
    __syncthreads();   // the next pass overwrites the list and the ring
  } while (scan < steps_total);

  // each warp's partial sums into red[warp][m][c]
  float* mine = red + warp * MB * kBN;
  if constexpr (kMma) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(8 * nt + 2 * t + (e & 1)) * kBN + g + 8 * (e >> 1)] =
            acc[nt][e];
  } else {
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float v = acc[0][m] + __shfl_xor_sync(0xffffffffu, acc[0][m], 16);
      if (lane < 16) mine[m * kBN + lane] = v;
    }
  }
  cluster_reduce<MB, kBN>(red, gathered, [&](int m, int c, float sum) {
    if (m0 + m < M && n0 + c < N)
      y[static_cast<int64_t>(m0 + m) * N + n0 + c] = from_f32<T>(sum);
  });
}

template <typename T, typename Mk, int NT>
int launch_nt(const void* x, const void* w, const void* mask, void* y, int M,
              int K, int N, int bk, int bn, int flags, void* stream) {
  constexpr int MB = 8 * NT;
  const int strips = (N + kBN - 1) / kBN;
  const int m_tiles = (M + MB - 1) / MB;
  const int split = split_for(strips, m_tiles, (K + kStep - 1) / kStep);
  static bool allowed = false;
  const int rc = allow_smem(bsmm_kernel<T, Mk, NT>,
                            smem_bytes<T, NT>(kMaxSplit), allowed);
  if (rc != 0) return rc;
  return launch_clustered(bsmm_kernel<T, Mk, NT>, strips, split, m_tiles,
                          smem_bytes<T, NT>(split), stream,
                          static_cast<const T*>(x), static_cast<const T*>(w),
                          static_cast<const Mk*>(mask), static_cast<T*>(y),
                          M, K, N, bk, bn, flags);
}

template <typename T, typename Mk>
int launch(const void* x, const void* w, const void* mask, void* y, int M,
           int K, int N, int bk, int bn, int flags, void* stream) {
  if (bk < 1 || bn < 1 || K % bk || N % bn)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || N <= 0) return 0;
  switch (n_tiles_for(M)) {
    case 1:
      return launch_nt<T, Mk, 1>(x, w, mask, y, M, K, N, bk, bn, flags,
                                 stream);
    case 2:
      return launch_nt<T, Mk, 2>(x, w, mask, y, M, K, N, bk, bn, flags,
                                 stream);
    default:
      return launch_nt<T, Mk, 8>(x, w, mask, y, M, K, N, bk, bn, flags,
                                 stream);
  }
}

}  // namespace

// x (M, K), w (K, N) of one type, mask (K/bk, N/bn) bool (one byte) or
// int32, y (M, N): all contiguous on the current device. flags bit 0: bn
// and N multiples of the values in 16 bytes and w 16-byte aligned (the
// weights are staged by 16-byte copies); bit 1: the same of K and x. The
// bf16 entries take the tensor-core body, the f32 ones the CUDA-core body.
// Returns the CUDA error of the launch (0 on success).
#define BSMM_ENTRY(NAME, T, Mk)                                             \
  extern "C" int NAME(const void* x, const void* w, const void* mask,       \
                      void* y, int M, int K, int N, int bk, int bn,         \
                      int flags, void* stream) {                            \
    return launch<T, Mk>(x, w, mask, y, M, K, N, bk, bn, flags, stream);    \
  }

BSMM_ENTRY(block_sparse_matmul_f32_b8, float, uint8_t)
BSMM_ENTRY(block_sparse_matmul_f32_i32, float, int32_t)
BSMM_ENTRY(block_sparse_matmul_bf16_b8, __nv_bfloat16, uint8_t)
BSMM_ENTRY(block_sparse_matmul_bf16_i32, __nv_bfloat16, int32_t)

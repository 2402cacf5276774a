// Quantized matmul on Hopper (sm_90a): y = x @ (w_q * scales[None, :]).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py:
// quant_matmul_pallas (body _qmm_kernel) and computes what it and the plain
// version (kernels/quant_matmul/ref.py) compute: int8 weights (on an 8-bit
// or 4-bit grid) with one float32 scale per output column, products
// accumulated in float32, y written in x's type (float32 or bf16).
//
// Where it runs: the quantized decode step. qwen3-0.6b: 7 products a layer
// (q, k, v, o, gate, up, down), K and N of 1024 to 3072; q, k and v run back
// to back, and so do gate and up. falcon-mamba-7b: in_proj, x_proj, dt_proj
// (float32 x), out_proj a layer and the LM head (4096 x 65024). M is the
// decode batch, 8.
//
// What bounds it on this card: bytes. At M = 8 each weight byte feeds 8
// multiply-adds, far below the ~295 operations a byte at which the tensor
// cores would become the limit; the least time is the int8 weight over the
// HBM rate. On the CUDA cores the work per weight (a conversion, 8 FMAs)
// would need ~80 % of the card's float32 FMA rate and ~80 % of its
// conversion rate at that byte rate, so bf16 x goes to the tensor cores.
//
// Design (the skeleton of skinny_mma.cuh, shared with K4):
//  * A block owns a strip of 16, 32 or 64 output columns for 8, 16 or 64
//    rows of x and one K-chunk of whole k16 steps; the S chunks of a strip
//    are a thread-block cluster, reduced through distributed shared memory
//    into rank 0 in rank order (deterministic). S gives one block an SM
//    (kWave) and chunks of at most 128 steps (split_for).
//  * Strip width: for bf16 x at M <= 16, the widest of 64, 32 and 16
//    columns (4, 2 or 1 m16 tiles) that still gives kWave blocks. A wide
//    strip reads whole 64-byte runs of each weight row, and x from L2 once
//    per 64 columns instead of per 16. Blocks a decode shape: qwen3-0.6b's
//    q and gate/up 160 and 144 (64 columns), k, v, o and down 160 (32);
//    falcon-mamba-7b's in_proj 512, out_proj 256, LM head 2032 (64), x_proj
//    (K 8192, N 288) 18 strips x 8 = 144 (16; narrow strips, not clusters
//    of 16, give it its blocks), dt_proj 512 (float32, 16).
//  * Staging by cp.async, 16 bytes a copy: a piece is 128 k rows of the
//    strip's int8 weights and of x (bf16 as it lies), in a ring of up to
//    48 KB (8 slots of a 16-column strip at M = 8, 3 of a 64-column one):
//    all but one piece in flight ahead of the one computed. Copies past
//    the chunk, K or M write zeros and read nothing.
//  * bf16 x, tensor cores: a warp takes 2 k16 steps of a piece. One
//    ldmatrix.x4.trans of the staged (k, n) int8 rows, read as b16 pairs,
//    gives lane (g, t) the bytes of columns 2g and 2g + 1 at k rows 2t and
//    2t + 1: the A fragment of W^T with its row g standing for column 2g and
//    row g + 8 for column 2g + 1 (the epilogue maps them back). The bytes
//    become bf16 exactly by i8x4_to_bf16x2. Instructions per warp and k16
//    step (256 weights): 22 for the conversion, half an ldmatrix, and per
//    n-tile 2 loads and 1 mma, ~26 at M = 8, or 0.10 a weight. At 4 warp
//    instructions a clock an SM that is ~39 weights a clock an SM, 2.7x
//    the ~14.5 that the HBM rate delivers (3.35e12 B/s over 132 SMs at
//    1.755 GHz): issue is not the limit. B is x's rows, two 32-bit loads a
//    step and n-tile.
//  * float32 x (falcon-mamba-7b's dt_proj, the tests): the CUDA cores over
//    the same stage, a thread a column and 16 of the piece's rows, one
//    conversion and MB FMAs a weight; no TF32.
//  * The scale is applied once per output column after the k-sum,
//    y = s_n (sum_k x_k q_kn); quant_matmul_tolerance covers the difference
//    from the plain version's rounded q * s (see its docstring).
//  * Ragged edges: when N is not a multiple of 16 or w_q not 16-byte
//    aligned, the weights are staged by single-byte loads, columns past N
//    as zeros; when K is not a multiple of 16 bytes of x or x is not
//    16-byte aligned, x is staged by single loads. The wrapper decides by
//    alignment, never by a failure.
//  * Launch latency: launched with programmatic stream serialization (see
//    pdl_enter), as K3 is; only back-to-back K2 launches overlap.
//
// Packed 4-bit payloads (quant_matmul_int4_{bf16,f32}): the reference
// stores w4 as jnp.int4, half a byte a weight, and so does the port: w is
// uint8 (K, ceil(N/2)), byte j of a row holding column 2j in its low nibble
// and 2j + 1 in its high nibble, two's complement (kernels/quant_matmul/
// ref.py has the layout). The same skeleton with kPacked set; what differs:
//  * A staged row of 16 MT bytes holds 32 MT columns, so a strip is 32, 64
//    or 128 columns wide and reads the same bytes a k row as the int8 body
//    at half the width; the strip's bytes start at n0 / 2 of each row.
//  * bf16 x: the ldmatrix.x4.trans of the int8 body still lands in the A
//    layout, now with 4 columns a b16: lane (g, t) holds, for k rows 2t and
//    2t + 1, the nibbles of columns 4g .. 4g + 3 of the 32-column chunk.
//    Two m16 tiles come out of one register pair: tile 2j stands for
//    columns 4g (row g) and 4g + 1 (row g + 8), tile 2j + 1 for 4g + 2 and
//    4g + 3. Each tile's bf16 pair is one shift, one lop3 ((r >> s) &
//    0x000F000F ^ 0x43084308: the nibble in offset binary under bf16's
//    exponent of 128, i.e. 136 + q) and one bf16x2 fma (- 136), exact on
//    [-8, 7]: 11 instructions a register of 8 weights, 0.043 a weight
//    (the int8 body's conversion is 0.086). No second copy of the weights
//    in another layout.
//  * float32 x: the CUDA cores, a thread a column of the 32 and a warp
//    every fourth k row of the piece; one byte load, a shift, a sign
//    extension and a conversion a weight, MB FMAs.
//  * Ragged edges: a row whose bytes (ceil(N/2)) are no multiple of 16 is
//    staged by single-byte loads; bytes past the row are zeros, and
//    columns past N (an odd N's last high nibble) are computed but never
//    written.
#include "skinny_mma.cuh"

namespace {

using namespace skinny;

// bytes of a staged weight row: 16 MT int8 columns, padded when MT > 1 so
// that the 8 rows of an ldmatrix matrix fall on distinct banks
__host__ __device__ constexpr int w_pitch(int MT) {
  return MT == 1 ? 16 : 16 * MT + 16;
}
// x row pitch in the stage, in elements: 128 k plus 16 bytes, so that the
// 8 rows of a B-fragment load fall on distinct banks (bf16: 68 words)
template <typename T>
__host__ __device__ constexpr int x_pitch() {
  return kPieceRows + 16 / static_cast<int>(sizeof(T));
}

template <typename T, int NT, int MT>
__host__ __device__ constexpr int slot_bytes() {
  return kPieceRows * w_pitch(MT) +
         8 * NT * x_pitch<T>() * static_cast<int>(sizeof(T));
}

// columns of a strip of MT 16-byte chunks a k row: 16 a chunk for int8,
// 32 for packed 4-bit payloads
__host__ __device__ constexpr int strip_cols(int MT, bool packed) {
  return (packed ? 32 : 16) * MT;
}

template <typename T, int NT, int MT, bool kPacked>
constexpr size_t smem_bytes(int split) {
  constexpr int slot = slot_bytes<T, NT, MT>();
  return static_cast<size_t>(ring_for(slot)) * slot +
         static_cast<size_t>(kWarps + split) * 8 * NT *
             strip_cols(MT, kPacked) * sizeof(float);
}

// Eight 4-bit values of r, nibble i at bits 4i, as the bf16 pair of nibbles
// s / 4 and s / 4 + 4 (the lower one in the lower half), exactly: the nibble
// in offset binary (q + 8) under bf16's exponent of 128 is 136 + q, and one
// fma subtracts 136.
template <int S>
__device__ __forceinline__ uint32_t i4x2_to_bf16x2(uint32_t r) {
  const uint32_t biased = ((r >> S) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // 1.0, -136
  return out;
}

template <typename T, int NT, int MT, bool kPacked>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, T* __restrict__ y, int M, int K,
           int N, int chunk_steps, int flags) {
  constexpr int MB = 8 * NT;
  constexpr int BN = strip_cols(MT, kPacked);   // columns of the strip
  constexpr int RB = 16 * MT;                   // staged bytes a k row
  constexpr int WP = w_pitch(MT);
  constexpr int XP = x_pitch<T>();
  constexpr int kWBytes = kPieceRows * WP;
  constexpr int kSlot = slot_bytes<T, NT, MT>();
  constexpr int kRing = ring_for(kSlot), kAhead = kRing - 1;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // x a copy
  constexpr bool kMma = sizeof(T) == 2;
  static_assert(kMma || MT == 1, "the CUDA-core body takes one chunk");
  extern __shared__ __align__(16) uint8_t smem[];
  float* red = reinterpret_cast<float*>(smem + kRing * kSlot);
  float* gathered = red + kWarps * MB * BN;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (static_cast<int>(blockIdx.x) / split) * BN;
  // the payload's bytes a row and the strip's first byte
  const int NB = kPacked ? (N + 1) / 2 : N;
  const int b0 = kPacked ? n0 / 2 : n0;
  const int m0 = blockIdx.y * MB;
  const int k_lo = min(K, rank * chunk_steps * kStep);
  const int k_hi = min(K, k_lo + chunk_steps * kStep);
  const int n_pieces = (k_hi - k_lo + kPieceRows - 1) / kPieceRows;
  const bool wvec = flags & 1, xvec = flags & 2;

  pdl_enter();

  auto issue = [&](int p) {
    if (p < n_pieces) {
      uint8_t* slot = smem + (p % kRing) * kSlot;
      int8_t* ws = reinterpret_cast<int8_t*>(slot);
      T* xs = reinterpret_cast<T*>(slot + kWBytes);
      const int kb = k_lo + p * kPieceRows;
      if (wvec) {   // MT 16-byte copies a row
        for (int i = tid; i < kPieceRows * MT; i += kThreads) {
          const int r = i / MT, h = i % MT, k = kb + r, b = b0 + 16 * h;
          const bool in = k < k_hi && b < NB;
          cp_async16(ws + r * WP + 16 * h,
                     in ? w + static_cast<int64_t>(k) * NB + b : w, in);
        }
      } else {
        for (int i = tid; i < kPieceRows * RB; i += kThreads) {
          const int r = i / RB, c = i % RB, k = kb + r, b = b0 + c;
          ws[r * WP + c] = (k < k_hi && b < NB)
                               ? w[static_cast<int64_t>(k) * NB + b]
                               : int8_t{0};
        }
      }
      if (xvec) {
        constexpr int kWords = kPieceRows / kPer;
        for (int i = tid; i < MB * kWords; i += kThreads) {
          const int m = i / kWords, k = kb + (i % kWords) * kPer;
          const bool in = m0 + m < M && k < k_hi;
          cp_async16(xs + m * XP + (i % kWords) * kPer,
                     in ? x + static_cast<int64_t>(m0 + m) * K + k : x, in);
        }
      } else {
        for (int i = tid; i < MB * kPieceRows; i += kThreads) {
          const int m = i / kPieceRows, c = i % kPieceRows, k = kb + c;
          xs[m * XP + c] = (m0 + m < M && k < k_hi)
                               ? x[static_cast<int64_t>(m0 + m) * K + k]
                               : from_f32<T>(0.f);
        }
      }
    }
    cp_async_commit();   // an empty group past the last piece
  };

  // bf16: acc[j * NT + nt][e], the C fragment of m-tile j and n-tile nt
  // (packed: 2 MT m-tiles); float32: acc[0][m] for this thread's column
  // over its rows
  constexpr int kTiles = kPacked ? 2 * MT : MT;
  constexpr int kAccRows = kMma ? kTiles * NT : 1;
  constexpr int kAccCols = kMma ? 4 : MB;
  float acc[kAccRows][kAccCols];
#pragma unroll
  for (int i = 0; i < kAccRows; ++i)
#pragma unroll
    for (int j = 0; j < kAccCols; ++j) acc[i][j] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  for (int p = 0; p < kAhead; ++p) issue(p);
  for (int p = 0; p < n_pieces; ++p) {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    issue(p + kAhead);   // refills the slot computed in the last iteration
    const uint8_t* slot = smem + (p % kRing) * kSlot;
    const int8_t* ws = reinterpret_cast<const int8_t*>(slot);
    const T* xs = reinterpret_cast<const T*>(slot + kWBytes);
    const int kb = k_lo + p * kPieceRows;
    if constexpr (kMma) {
      const int r0 = 32 * warp;   // this warp's 2 steps of the piece
      const int steps = kb + r0 >= k_hi ? 0 : kb + r0 + kStep >= k_hi ? 1 : 2;
      // x's B fragments of both steps, for every n-tile
      uint32_t b[2][NT][2];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const T* xr = xs + (8 * nt + g) * XP + r0 + kStep * s + 2 * t;
          b[s][nt][0] = *reinterpret_cast<const uint32_t*>(xr);
          b[s][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
        }
      if (steps > 0) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          uint32_t q[4];
          ldsm_x4_trans(q, smem_u32(ws + (r0 + lane) * WP + 16 * j));
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (s >= steps) break;
            if constexpr (kPacked) {
              // tile 2j: columns 4g (row g), 4g + 1 (row g + 8); tile
              // 2j + 1: columns 4g + 2, 4g + 3
              const uint32_t lo[4] = {i4x2_to_bf16x2<0>(q[2 * s]),
                                      i4x2_to_bf16x2<4>(q[2 * s]),
                                      i4x2_to_bf16x2<0>(q[2 * s + 1]),
                                      i4x2_to_bf16x2<4>(q[2 * s + 1])};
              const uint32_t hi[4] = {i4x2_to_bf16x2<8>(q[2 * s]),
                                      i4x2_to_bf16x2<12>(q[2 * s]),
                                      i4x2_to_bf16x2<8>(q[2 * s + 1]),
                                      i4x2_to_bf16x2<12>(q[2 * s + 1])};
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                mma_bf16(acc[2 * j * NT + nt], lo, b[s][nt][0], b[s][nt][1]);
                mma_bf16(acc[(2 * j + 1) * NT + nt], hi, b[s][nt][0],
                         b[s][nt][1]);
              }
            } else {
              uint32_t a[4];
              i8x4_to_bf16x2(q[2 * s], a[0], a[1]);
              i8x4_to_bf16x2(q[2 * s + 1], a[2], a[3]);
#pragma unroll
              for (int nt = 0; nt < NT; ++nt)
                mma_bf16(acc[j * NT + nt], a, b[s][nt][0], b[s][nt][1]);
            }
          }
        }
      }
    } else if constexpr (kPacked) {
      // a thread a column of the 32, a warp every fourth row of the piece
      const int c = lane, shift = 4 * (c & 1);
      const uint8_t* wb = reinterpret_cast<const uint8_t*>(ws) + (c >> 1);
#pragma unroll 4
      for (int i = 0; i < kPieceRows / kWarps; ++i) {
        const int r = warp + kWarps * i;
        if (kb + r >= k_hi) break;
        const int nib = (wb[r * WP] >> shift) & 0xF;
        const float wv = static_cast<float>((nib ^ 8) - 8);
#pragma unroll
        for (int m = 0; m < MB; ++m)
          acc[0][m] = fmaf(to_f32(xs[m * XP + r]), wv, acc[0][m]);
      }
    } else {
      const int c = tid % 16, L = tid / 16;
#pragma unroll 4
      for (int i = 0; i < kPieceRows / 8; ++i) {
        const int r = L + 8 * i;
        if (kb + r >= k_hi) break;
        const float wv = static_cast<float>(ws[r * WP + c]);
#pragma unroll
        for (int m = 0; m < MB; ++m)
          acc[0][m] = fmaf(to_f32(xs[m * XP + r]), wv, acc[0][m]);
      }
    }
  }

  // each warp's partial sums into red[warp][m][c]
  float* mine = red + warp * MB * BN;
  if constexpr (kMma && kPacked) {
    // C row g of m-tile 2j + h stands for column 32 j + 4 g + 2 h, row
    // g + 8 for the column after it
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(8 * nt + 2 * t + (e & 1)) * BN + 32 * (j >> 1) + 4 * g +
               2 * (j & 1) + (e >> 1)] = acc[j * NT + nt][e];
  } else if constexpr (kMma) {
    // C row g of m-tile j stands for column 16 j + 2 g, row g + 8 for
    // column 16 j + 2 g + 1
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mine[(8 * nt + 2 * t + (e & 1)) * BN + 16 * j + 2 * g + (e >> 1)] =
              acc[j * NT + nt][e];
  } else if constexpr (kPacked) {
#pragma unroll
    for (int m = 0; m < MB; ++m) mine[m * BN + lane] = acc[0][m];
  } else {
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float v = acc[0][m] + __shfl_xor_sync(0xffffffffu, acc[0][m], 16);
      if (lane < 16) mine[m * BN + lane] = v;
    }
  }
  cluster_reduce<MB, BN>(red, gathered, [&](int m, int c, float sum) {
    if (m0 + m < M && n0 + c < N)
      y[static_cast<int64_t>(m0 + m) * N + n0 + c] =
          from_f32<T>(scales[n0 + c] * sum);
  });
}

// grid of (strips x split, m_tiles) blocks for strips of BN columns
struct Grid {
  int strips, m_tiles, split, chunk;
};
inline Grid grid_for(int M, int K, int N, int MB, int BN) {
  Grid gr;
  gr.strips = (N + BN - 1) / BN;
  gr.m_tiles = (M + MB - 1) / MB;
  const int steps = (K + kStep - 1) / kStep;
  gr.split = split_for(gr.strips, gr.m_tiles, steps);
  gr.chunk = (steps + gr.split - 1) / gr.split;
  return gr;
}

template <typename T, int NT, int MT, bool kPacked>
int launch_mt(const void* x, const void* w, const void* scales, void* y,
              int M, int K, int N, int flags, const Grid& gr, void* stream) {
  static bool allowed = false;
  const int rc = allow_smem(qmm_kernel<T, NT, MT, kPacked>,
                            smem_bytes<T, NT, MT, kPacked>(kMaxSplit),
                            allowed);
  if (rc != 0) return rc;
  return launch_clustered(qmm_kernel<T, NT, MT, kPacked>, gr.strips,
                          gr.split, gr.m_tiles,
                          smem_bytes<T, NT, MT, kPacked>(gr.split), stream,
                          static_cast<const T*>(x),
                          static_cast<const int8_t*>(w),
                          static_cast<const float*>(scales),
                          static_cast<T*>(y), M, K, N, gr.chunk, flags);
}

// Strip width: for bf16 x at M <= 16 the widest of 4 and 2 16-byte chunks a
// k row (64 or 32 int8 columns, 128 or 64 packed ones) that still fills a
// wave of kWave blocks; one chunk otherwise.
template <typename T, int NT, bool kPacked>
int launch_nt(const void* x, const void* w, const void* scales, void* y,
              int M, int K, int N, int flags, void* stream) {
  if constexpr (sizeof(T) == 2 && NT <= 2) {
    for (int MT = 4; MT >= 2; MT /= 2) {
      const Grid gr = grid_for(M, K, N, 8 * NT, strip_cols(MT, kPacked));
      if (gr.strips * gr.m_tiles * gr.split < kWave) continue;
      return MT == 4 ? launch_mt<T, NT, 4, kPacked>(x, w, scales, y, M, K,
                                                    N, flags, gr, stream)
                     : launch_mt<T, NT, 2, kPacked>(x, w, scales, y, M, K,
                                                    N, flags, gr, stream);
    }
  }
  return launch_mt<T, NT, 1, kPacked>(
      x, w, scales, y, M, K, N, flags,
      grid_for(M, K, N, 8 * NT, strip_cols(1, kPacked)), stream);
}

template <typename T, bool kPacked>
int launch(const void* x, const void* w, const void* scales, void* y, int M,
           int K, int N, int flags, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  switch (n_tiles_for(M)) {
    case 1:
      return launch_nt<T, 1, kPacked>(x, w, scales, y, M, K, N, flags,
                                      stream);
    case 2:
      return launch_nt<T, 2, kPacked>(x, w, scales, y, M, K, N, flags,
                                      stream);
    default:
      return launch_nt<T, 8, kPacked>(x, w, scales, y, M, K, N, flags,
                                      stream);
  }
}

}  // namespace

// x (M, K), w (K, N) int8, scales (N,) float32, y (M, N): all contiguous on
// the current device. flags bit 0: N % 16 == 0 and w 16-byte aligned (the
// weights are staged by 16-byte copies); bit 1: K a multiple of the x
// values in 16 bytes and x 16-byte aligned. quant_matmul_bf16 takes the
// tensor-core body, quant_matmul_f32 the CUDA-core body. Returns the CUDA
// error of the launch (0 on success).
extern "C" int quant_matmul_f32(const void* x, const void* w,
                                const void* scales, void* y, int M, int K,
                                int N, int flags, void* stream) {
  return launch<float, false>(x, w, scales, y, M, K, N, flags, stream);
}

extern "C" int quant_matmul_bf16(const void* x, const void* w,
                                 const void* scales, void* y, int M, int K,
                                 int N, int flags, void* stream) {
  return launch<__nv_bfloat16, false>(x, w, scales, y, M, K, N, flags,
                                      stream);
}

// The packed 4-bit bodies: w uint8 (K, ceil(N/2)), two columns a byte; N is
// the number of output columns. flags bit 0: ceil(N/2) % 16 == 0 and w
// 16-byte aligned; bit 1 as above.
extern "C" int quant_matmul_int4_f32(const void* x, const void* w,
                                     const void* scales, void* y, int M,
                                     int K, int N, int flags, void* stream) {
  return launch<float, true>(x, w, scales, y, M, K, N, flags, stream);
}

extern "C" int quant_matmul_int4_bf16(const void* x, const void* w,
                                      const void* scales, void* y, int M,
                                      int K, int N, int flags,
                                      void* stream) {
  return launch<__nv_bfloat16, true>(x, w, scales, y, M, K, N, flags,
                                     stream);
}

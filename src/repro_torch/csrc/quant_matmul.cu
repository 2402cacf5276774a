// Quantized matmul on Hopper (sm_90a): y = x @ (w_q * scales[None, :]).
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py:
// quant_matmul_pallas (body _qmm_kernel) and computes what it and the plain
// version (kernels/quant_matmul/ref.py) compute: int8 weights (on an 8-bit
// or 4-bit grid) with one float32 scale per output column, products
// accumulated in float32, y written in x's type (float32 or bf16).
//
// Two bodies: the decode body (M up to a few hundred rows, float32 x, and
// shapes TMA cannot read) and the large-M body (bf16 x), at the end of the
// file. The wrapper names the body from the shape, type and alignment
// (kernels/quant_matmul/ops.py, body_for).
//
// Where the decode body runs: the quantized decode step. qwen3-0.6b: 7
// products a layer (q, k, v, o, gate, up, down), K and N of 1024 to 3072;
// q, k and v run back to back, and so do gate and up. falcon-mamba-7b:
// in_proj, x_proj, dt_proj (float32 x), out_proj a layer and the LM head
// (4096 x 65024). M is the decode batch, 8.
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
//
// The large-M body (quant_matmul_wide_{bf16,int4_bf16}, namespace wide).
//  * Where it runs: the w8 decode step's cross K and V projections, made
//    again at every step over the whole context: llama-3.2-vision's at
//    M = 8 x 1601 = 12808, K 4096, N 1024 and whisper-base's at
//    M = 8 x 1500 = 12000, K = N = 512, two products a cross layer; and
//    any bf16 product of wgmma_min_m rows or more (the wrapper's
//    threshold, measured against the decode body on the card).
//  * What bounds it: operations. At M = 12808 each weight byte feeds 12808
//    multiply-adds and each x byte 512: 2 M K N at the bf16 tensor-core
//    rate is 0.109 ms a vision product, its bytes 0.040 ms. Only wgmma
//    reaches that rate. The decode body there re-read x (105 MB, twice the
//    L2) once per 16-column strip, 64 times a product, on mma.sync.
//  * Operands swapped as in the decode body: y^T = W^T x^T. W^T is wgmma's
//    A, from registers: the ldmatrix.x4.trans of a staged (k, n) payload
//    row above is, per warp, the m16 A layout, and wgmma's m64nNk16 A
//    layout is that per warp (wgmma.cuh), so each warp converts its own 16
//    output columns (int8: one 16-byte chunk, i8x4_to_bf16x2; packed: the
//    lo or hi m16 tile of a 32-column chunk, one shift, lop3 and fma a
//    pair) and no bf16 copy of W passes through shared memory. x is B:
//    128 rows x 64 k, K-major, as TMA lays it out with the 128-byte
//    swizzle, read by the descriptor a k16 step 32 bytes further.
//  * Tile: a block computes 128 output columns (two consumer warpgroups
//    of one m64 tile each) by 128 or 160 rows of x (wgmma m64n128k16 or
//    m64n160k16, a float32 accumulator of 64 or 80 registers), over the
//    whole of K: no split-K, so the sum order is fixed and the bits
//    repeat. The wrapper's wgmma_rows picks the row count: the rounds of
//    blocks on 132 SMs times a block's time, a 160-row block spreading
//    its conversion over more rows (ops.ROW_COST). (Blocks of 256
//    columns, two m64 tiles a warpgroup, read x from L2 half as often but
//    measured slower at the cross shapes and most others.) The
//    accumulator's rows are output columns: s_n multiplies a row once
//    after the k-sum, as in the decode body, and quant_matmul_tolerance
//    covers it unchanged.
//  * Ring: 6 stages of 64 k, each the x tile (16 or 20 KB) and the
//    payload tile (64 k rows of the block's 128 columns: 8 KB int8 with
//    the 128-byte swizzle, 4 KB packed with the 64-byte one, so that the
//    8 rows of an ldmatrix fall on 8 bank groups), filled by TMA from one
//    thread of a producer warpgroup, whose registers the consumers take
//    (setmaxnreg); a full barrier (the transaction bytes) and an empty one
//    (one arrival a consumer warp) a stage. At most 173,152 bytes (int8,
//    160 rows) of 232,448 (static_assert).
//  * Overlap: a consumer warpgroup converts a stage's A fragments into
//    one of two register buffers while the products of the stage before
//    run (wgmma.wait_group 1), and releases a stage when its products are
//    done. No spill (ptxas -v).
//  * Order of blocks: the n-tiles of one m-tile are neighbours in the
//    block index, so an x tile comes from device memory about once and
//    from L2 for the others; the payload (4 MB int8 at vision's shape)
//    stays in L2.
//  * Ragged edges: TMA reads zeros past M, K and the payload's row; the
//    epilogue writes rows below M and columns below N, bf16 pairs where N
//    is even (4-byte aligned), single values where it is odd.
#include "skinny_mma.cuh"
#include "wgmma.cuh"

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
// fma subtracts 136. The large-M body's warps pass s in a register (they
// take the lo or the hi nibbles of one register by their parity).
__device__ __forceinline__ uint32_t i4x2_to_bf16x2_at(uint32_t r, int s) {
  const uint32_t biased = ((r >> s) & 0x000F000Fu) ^ 0x43084308u;
  uint32_t out;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(out)
      : "r"(biased), "r"(0x3F803F80u), "r"(0xC308C308u));  // 1.0, -136
  return out;
}
template <int S>
__device__ __forceinline__ uint32_t i4x2_to_bf16x2(uint32_t r) {
  return i4x2_to_bf16x2_at(r, S);
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

// ---------------------------------------------------------------------------
// The large-M body (bf16 x, int8 or packed 4-bit payloads)
// ---------------------------------------------------------------------------
namespace wide {

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup
// registers a thread after setmaxnreg, 40 x 128 + 232 x 256 of the SM's
// 65536: the producer gives up what the consumers may take (a producer
// warp beside consumers capped at 168 registers measured slower)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kCols = 128;                    // output columns a block
constexpr int kBK = 64;                       // k a stage: 128 bytes of x
constexpr int kStages = 6;
constexpr int kMaxSmem = 232448;              // a block's shared memory

// A stage: the x tile (BM rows, wgmma's N, of 128 bytes) and the payload
// tile (64 k rows of the block's 128 columns, 128 bytes a row int8 with
// the 128-byte swizzle, 64 packed with the 64-byte one).
template <bool kPacked, int BM>
struct Ring {
  static constexpr int kXBytes = BM * 128;
  static constexpr int kRowBytes = kPacked ? kCols / 2 : kCols;
  static constexpr int kStage = kXBytes + kBK * kRowBytes;
  // the stages, their full and empty barriers, 1024 bytes to align the
  // base
  static constexpr int kSmem = kStages * kStage + 16 * kStages + 1024;
  static_assert(kStage % 1024 == 0, "every tile 1024-byte aligned");
  static_assert(kSmem <= kMaxSmem, "the ring must fit a block");
};

// the 16-byte chunk c of payload row r as the TMA swizzle laid it out in
// rows of ``kRow`` bytes (128: chunk ^ row % 8; 64: chunk ^ (row / 2) % 4)
template <int kRow>
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * kRow + ((kRow == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3)) << 4);
}

template <bool kPacked, int BM>
__global__ void __launch_bounds__(kThreads, 1)
qmm_wide_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ y, int M, int K, int N,
                int n_tiles) {
  using Rg = Ring<kPacked, BM>;
  constexpr int kXBytes = Rg::kXBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + kStages * Rg::kStage;   // + 8 s
  const uint32_t empty = full + 8 * kStages;           // + 8 s
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the n-tiles of one m-tile are neighbours: its x tile comes from device
  // memory about once and from L2 for the others
  const int nt = static_cast<int>(blockIdx.x) % n_tiles;
  const int m0 = static_cast<int>(blockIdx.x) / n_tiles * BM;
  const int n0 = nt * kCols;
  const int steps = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full + 8 * s, 1);
      wg::mbar_init(empty + 8 * s, kConsumers / 32);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {   // the producer warpgroup: TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      const int b0 = n0 / (kPacked ? 2 : 1);
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages;
        if (it >= kStages) wg::mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        const uint32_t bar = full + 8 * s, st = base + s * Rg::kStage;
        wg::mbar_expect_tx(bar, Rg::kStage);
        wg::tma_load_2d(st, &tx, bar, it * kBK, m0);
        wg::tma_load_2d(st + kXBytes, &tw, bar, b0, it * kBK);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // consumers: warpgroup h of 2 (output columns 64 h to 64 h + 63), warp w
  // of 4 in it. This warp's 16-byte chunk of a payload row, and the output
  // column its A row g stands for (row g + 8: the column after it). int8:
  // 16 columns a chunk, row g column 2g; packed: 32 columns a chunk shared
  // by warps 2i and 2i + 1, which take its lo (4g, 4g + 1) and hi (4g + 2,
  // 4g + 3) m16 tiles
  const int h = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
  const int chunk = kPacked ? 32 * h + 16 * (w >> 1) : 64 * h + 16 * w;
  const int column = kPacked ? 64 * h + 32 * (w >> 1) + 4 * g + 2 * (w & 1)
                             : 64 * h + 16 * w + 2 * g;
  float acc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;

  // W^T's A fragments of a stage's 4 k16 steps: one ldmatrix.x4.trans a
  // tile and 32 k rows, as the decode body reads them; two buffers, so a
  // stage converts while the products of the one before run
  using Frags = uint32_t[4][4];
  uint32_t a[2][4][4];
  auto convert = [&](Frags& f, uint32_t st) {
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t q[4];
      ldsm_x4_trans(q, st + kXBytes + swizzled<Rg::kRowBytes>(
                                          32 * kp + lane, chunk / 16));
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        uint32_t(&e)[4] = f[2 * kp + s2];
        if constexpr (kPacked) {
          const int sh = 8 * (w & 1);
          e[0] = i4x2_to_bf16x2_at(q[2 * s2], sh);
          e[1] = i4x2_to_bf16x2_at(q[2 * s2], sh + 4);
          e[2] = i4x2_to_bf16x2_at(q[2 * s2 + 1], sh);
          e[3] = i4x2_to_bf16x2_at(q[2 * s2 + 1], sh + 4);
        } else {
          i8x4_to_bf16x2(q[2 * s2], e[0], e[1]);
          i8x4_to_bf16x2(q[2 * s2 + 1], e[2], e[3]);
        }
      }
    }
  };
  auto issue = [&](Frags& f, uint32_t st) {
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_rs_k<BM>(acc, f[kk], wg::desc_sw128(st + 32 * kk));
    wg::commit();
  };
  // keeps a buffer's registers live until the products reading them are
  // done (the compiler cannot see the asynchronous read)
  auto hold = [&](Frags& f) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(f[kk][e]));
  };
  auto stage = [&](int it) { return base + (it % kStages) * Rg::kStage; };
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * (it % kStages));
  };

  wg::mbar_wait(full, 0);
  convert(a[0], stage(0));
  issue(a[0], stage(0));
  for (int it = 1; it < steps; ++it) {
    wg::mbar_wait(full + 8 * (it % kStages), (it / kStages) & 1);
    if (it & 1) {
      convert(a[1], stage(it));
      issue(a[1], stage(it));
      wg::wait_one();
      hold(a[0]);
    } else {
      convert(a[0], stage(it));
      issue(a[0], stage(it));
      wg::wait_one();
      hold(a[1]);
    }
    release(it - 1);   // its products are done
  }
  wg::wait_all();
  hold(a[0]);
  hold(a[1]);
  wg::fence_regs(acc);
  release(steps - 1);

  // y[m][n] = s_n acc: accumulator row g (g + 8) is output column c0
  // (c0 + 1), column 8 i + 2 t + e row m0 + 8 i + 2 t + e of x
  const int c0 = n0 + column;
  if (c0 >= N) return;
  const bool pairs = (N & 1) == 0;
  const float s0 = scales[c0];
  const float s1 = c0 + 1 < N ? scales[c0 + 1] : 0.f;
#pragma unroll
  for (int i = 0; i < BM / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * i + 2 * t + e;
      if (m >= M) continue;
      __nv_bfloat16* out = y + static_cast<int64_t>(m) * N + c0;
      const float v0 = acc[4 * i + e] * s0;
      const float v1 = acc[4 * i + 2 + e] * s1;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(out) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        out[0] = __float2bfloat16(v0);
        if (c0 + 1 < N) out[1] = __float2bfloat16(v1);
      }
    }
}

template <bool kPacked, int BM>
int launch_rows(const void* x, const void* w, const void* scales, void* y,
                int M, int K, int N, void* stream) {
  using Rg = Ring<kPacked, BM>;
  static bool allowed = false;
  const int rc = allow_smem(qmm_wide_kernel<kPacked, BM>, Rg::kSmem,
                            allowed);
  if (rc != 0) return rc;
  const int NB = kPacked ? (N + 1) / 2 : N;
  CUtensorMap tx, tw;
  if (!wg::encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                     static_cast<int64_t>(K) * 2, kBK, BM,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !wg::encode_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, NB, K, NB,
                     Rg::kRowBytes, kBK,
                     kPacked ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (N + kCols - 1) / kCols;
  const int m_tiles = (M + BM - 1) / BM;
  qmm_wide_kernel<kPacked, BM><<<n_tiles * m_tiles, kThreads, Rg::kSmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      tx, tw, static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(y), M, K, N, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch(const void* x, const void* w, const void* scales, void* y, int M,
           int K, int N, int rows, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 != 0 ||
      (kPacked ? (N + 1) / 2 : N) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (rows) {
    case 128:
      return launch_rows<kPacked, 128>(x, w, scales, y, M, K, N, stream);
    case 160:
      return launch_rows<kPacked, 160>(x, w, scales, y, M, K, N, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wide

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

// The large-M body: x (M, K) bf16, w (K, N) int8 or (packed) uint8 (K,
// ceil(N/2)), scales (N,) float32, y (M, N) bf16, all contiguous on the
// current device; K a positive multiple of 8, the payload's row bytes a
// multiple of 16, x and w 16-byte aligned (TMA reads both). Returns the
// CUDA error of the launch, cudaErrorInvalidValue for a shape or
// alignment TMA cannot read or a tensor map that does not encode.
extern "C" int quant_matmul_wide_bf16(const void* x, const void* w,
                                      const void* scales, void* y, int M,
                                      int K, int N, int rows, void* stream) {
  return wide::launch<false>(x, w, scales, y, M, K, N, rows, stream);
}

extern "C" int quant_matmul_wide_int4_bf16(const void* x, const void* w,
                                           const void* scales, void* y,
                                           int M, int K, int N, int rows,
                                           void* stream) {
  return wide::launch<true>(x, w, scales, y, M, K, N, rows, stream);
}

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
// in the TPU kernel (no h_last), and, when the caller asks (autograd's
// forward), the states at the start of every chunk of kTCB = 16 steps for
// the backward (ssm_scan_bwd.cu), which would otherwise run the recurrence
// once more to find them.
//
// Where it runs: every layer of the prefill forward (64 launches a call for
// falcon-mamba-7b), at B 4, T 1024, d 8192, N 16.
//
// What bounds it on this card: not the bytes. Each (b, t, c) reads u (2
// bytes) and dt (4 bytes) and writes y (2 bytes) once: about 269 MB at the
// prefill shape, 0.080 ms at 3.35 TB/s. It also takes N exps, B*T*d*N =
// 537 M at that shape, on the special-function units: 16 results a clock on
// each SM for exp2 at compute capability 9.0 (CUDA C++ Programming Guide,
// throughput of native arithmetic instructions), 0.128 ms on 132 SMs at
// 1.98 GHz, the floor. Around each exp the scan issues four float32
// operations (dt A, the product with B, the state's fma, the fma into y),
// and a lane-step adds its loads and its share of the reduction, so the
// instruction stream of the scan, at 64 registers a thread (four blocks of
// 256 an SM), sets the time: the staging alone runs near the bytes bound.
//
// Design:
//  * The TPU kernel keeps a (bd, N) state in VMEM across a sequential time
//    grid. Blocks here run in no order, so nothing carries between them:
//    a block owns a batch row and a run of channels and walks all of T in a
//    loop inside the kernel.
//  * The state of a channel is split over a group of kG = 4 neighbouring
//    lanes: each lane holds N/4 state values and its slice of A in
//    registers, so a channel has 4 lanes in flight where it had one. At
//    the prefill shape 4 lanes ran faster than 8, which issue over twice
//    the reduction's shuffles an element (7 to 3).
//  * y is reduced kG steps at a time: the group's 4 x 4 partial sums go
//    through two rounds of __shfl_xor_sync (recursive halving), after
//    which lane j holds step j's sum and writes it. Every add is one of the
//    fixed xor tree's, y_t = (p_0 + p_1) + (p_2 + p_3) over the lanes'
//    partial sums, so the result does not depend on the schedule.
//  * Time is cut into chunks of kTC steps. u and dt of a chunk x the
//    block's channels are staged in shared memory through a ring of
//    kStages buffers filled by 16-byte cp.async copies: the next chunk's
//    copies are in flight while this one is scanned, and a step reads only
//    shared memory. B_t and C_t of the chunk (shared by every channel of a
//    batch row) are loaded into registers one chunk ahead and stored there
//    as float32, read by each lane as one vector of its N/G values.
//  * y_t overwrites u_t in the staged chunk once the group has read it, and
//    the whole chunk of y is written from shared memory in 16-byte stores.
//  * Choice of sizes: kTC = 32 steps and kStages = 2 give 32 KB (bf16) to
//    40 KB (float32) of static shared memory a block of 256 threads, so the
//    four blocks an SM that the registers allow fit, and the grid at the
//    prefill shape (512 blocks) is resident at once; a chunk's scan
//    outlasts a memory latency many times, so two stages suffice.
//  * exp is 2^(dt (A log2 e)) by ex2.approx.ftz.f32, with A log2 e taken
//    once a lane: within 2 ulp (the programming guide's exp2f, and its
//    __expf, which is this instruction on x log2 e), subnormal results
//    flushed to 0. ssm_scan_tolerance's derivation counts the extra
//    roundings and the flush; its bound is unchanged.
//  * The order of every rounding is written out (__fmul_rn, fmaf,
//    __fadd_rn) so that no contraction choice of the compiler changes it,
//    and a CPU emulation (tests/test_torch_ssm.py) repeats it.
//  * The chunk-start states: with a non-null hck, before steps t = 0, 16,
//    32, ... a lane stores its 4 state values (h_{t-1}; zeros at t = 0) as
//    one 16-byte store into hck (B, ceil(L / 16), d, 16) float32 (state
//    slots past N hold 0). They are the registers the scan carries, so the
//    backward's rebuild, which repeats this step's instructions, continues
//    them bit for bit. The serve and prefill launches pass null and take
//    an instance of the kernel compiled without the stores (a template
//    flag), whose registers and time are those of a scan that stores
//    nothing; y is the same either way.
//  * Ragged edges are masked in the kernel (channels beyond d compute on
//    zeros and store nothing, the last chunk is short, state slots beyond N
//    hold A = B = C = 0 and stay 0), so the wrapper pads and copies
//    nothing. Where d or a pointer is not 16-byte aligned the staging and
//    the y stores fall back to one element a copy (chosen by shape, the
//    same arithmetic).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block: kThreads / kG channels
constexpr int kG = 4;          // lanes a channel
constexpr int kTC = 32;        // time steps a chunk
constexpr int kTCB = 16;       // steps between the states saved for the
                               // backward (ssm_scan_bwd.cu's chunk)
constexpr int kStages = 2;     // ring depth
constexpr int kMaxN = 16;      // state values a channel
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

// a lane's 4 consecutive float32 values of a state row
__device__ __forceinline__ void load_state_row(float* v, const float* row) {
  const float4 r = *reinterpret_cast<const float4*>(row);
  v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [t0, t0 + kTC) x channels [c0, c0 + CH) of a (batch, L, d)
// tensor into dst[kTC][CH], zeros outside [0, L) x [0, d).
template <typename E, int CH>
__device__ __forceinline__ void stage_rows(E* dst, const E* __restrict__ src,
                                           int64_t row0, int t0, int c0,
                                           int L, int d, bool vec) {
  if (vec) {   // 16-byte copies: d and the pointer 16-byte aligned
    constexpr int kEl = 16 / sizeof(E);
    constexpr int kSeg = CH / kEl;             // copies a row
    for (int i = threadIdx.x; i < kTC * kSeg; i += kThreads) {
      const int tt = i / kSeg, c = c0 + (i % kSeg) * kEl;
      const bool ok = t0 + tt < L && c < d;
      const E* s = ok ? src + (row0 + t0 + tt) * d + c : src;
      cp_async16(dst + tt * CH + (i % kSeg) * kEl, s, ok);
    }
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < kTC * CH; i += kThreads) {
      const int tt = i / CH, c = c0 + i % CH;
      dst[i] = (t0 + tt < L && c < d) ? src[(row0 + t0 + tt) * d + c]
                                      : E(0.f);
    }
  }
}

template <typename T, bool kStates>
__global__ void __launch_bounds__(kThreads, 4)
ssm_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ A, const float* __restrict__ D,
                T* __restrict__ y, float* __restrict__ hck, int L, int d,
                int N, bool vec) {
  constexpr int G = kG;
  constexpr int CH = kThreads / G;     // channels a block
  constexpr int S = kMaxN / G;         // state values a lane
  constexpr int kBC = kTC * kMaxN / kThreads;   // B_, C_ values a thread
  static_assert(S == 4, "a lane holds 4 state values");
  __shared__ __align__(16) unsigned char
      u_raw[kStages * kTC * CH * sizeof(T)];
  __shared__ __align__(16) float dts[kStages][kTC][CH];
  __shared__ __align__(16) float bs[kStages][kTC][kMaxN];
  __shared__ __align__(16) float cs[kStages][kTC][kMaxN];
  T* us = reinterpret_cast<T*>(u_raw);   // [kStages][kTC][CH]

  const int g = threadIdx.x / G;       // channel of the block
  const int j = threadIdx.x % G;       // lane of the group
  const int c0 = blockIdx.x * CH;
  const int c = c0 + g;
  const bool live = c < d;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;

  float a2[S], h[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int n = j * S + k;
    a2[k] = (live && n < N)
                ? __fmul_rn(A[static_cast<int64_t>(c) * N + n], kLog2e)
                : 0.f;
    h[k] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;

  float pb[kBC], pc[kBC];              // the next chunk's B_, C_
  auto load_bc = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int tt = idx / kMaxN, n = idx % kMaxN;
      const bool ok = t0 + tt < L && n < N;
      const int64_t off = (row0 + t0 + tt) * N + n;
      pb[i] = ok ? to_f32(bm[off]) : 0.f;
      pc[i] = ok ? to_f32(cm[off]) : 0.f;
    }
  };
  auto store_bc = [&](int st) {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      bs[st][idx / kMaxN][idx % kMaxN] = pb[i];
      cs[st][idx / kMaxN][idx % kMaxN] = pc[i];
    }
  };
  auto stage = [&](int t0, int st) {
    stage_rows<T, CH>(us + st * kTC * CH, u, row0, t0, c0, L, d, vec);
    stage_rows<float, CH>(&dts[st][0][0], dt, row0, t0, c0, L, d, vec);
    cp_async_commit();
  };

  const int chunks = (L + kTC - 1) / kTC;
  stage(0, 0);
  load_bc(0);
  store_bc(0);
  for (int k = 0; k < chunks; ++k) {
    const int st = k % kStages, t0 = k * kTC;
    cp_async_wait_all();
    __syncthreads();   // chunk k visible; the other stage's y is stored
    const bool more = k + 1 < chunks;
    if (more) {
      stage(t0 + kTC, (k + 1) % kStages);
      load_bc(t0 + kTC);
    }
    T* ur = us + st * kTC * CH;
    const int tc = min(kTC, L - t0);
    // one time step: the lane's S state values, and its partial sum of y
    const T* up = ur + g;
    const float* dp = &dts[st][0][g];
    const float* bp = &bs[st][0][j * S];
    const float* cp = &cs[st][0][j * S];
    auto step = [=, &h](int tt) -> float {
      const float ut = to_f32(up[tt * CH]);
      const float dtt = dp[tt * CH];
      float bv[S], cv[S];
      load_state_row(bv, bp + tt * kMaxN);
      load_state_row(cv, cp + tt * kMaxN);
      const float dtu = __fmul_rn(dtt, ut);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const float e = ex2_ftz(__fmul_rn(dtt, a2[q]));
        h[q] = fmaf(e, h[q], __fmul_rn(dtu, bv[q]));
        acc = fmaf(h[q], cv[q], acc);
      }
      return acc;
    };
    // G steps at a time: the group's G x G partial sums are reduced by
    // recursive halving, so that lane j ends with step tt0 + j's sum:
    // in the round of offset o a lane keeps the half of its sums whose
    // step has bit o equal to its own, sends the other half to lane j ^ o
    // and adds what it receives. Each add is the xor tree's, so y_t =
    // (p_0 + p_1) + (p_2 + p_3) over the lanes' partial sums p.
    for (int tt0 = 0; tt0 < tc; tt0 += G) {
      if (kStates && (t0 + tt0) % kTCB == 0 && live) {
        const int64_t chunk = static_cast<int64_t>(blockIdx.y) *
                                  ((L + kTCB - 1) / kTCB) +
                              (t0 + tt0) / kTCB;
        *reinterpret_cast<float4*>(hck + (chunk * d + c) * kMaxN + j * S) =
            make_float4(h[0], h[1], h[2], h[3]);
      }
      float p[G];
      if (tt0 + G <= tc) {
#pragma unroll
        for (int q = 0; q < G; ++q) p[q] = step(tt0 + q);
      } else {   // the chunk's ragged end: steps past it change nothing
#pragma unroll
        for (int q = 0; q < G; ++q) p[q] = tt0 + q < tc ? step(tt0 + q) : 0.f;
      }
#pragma unroll
      for (int o = 1, n = G; o < G; o <<= 1, n >>= 1) {
        const bool hi = j & o;
#pragma unroll
        for (int i = 0; i < n / 2; ++i) {
          const float keep = hi ? p[2 * i + 1] : p[2 * i];
          const float send = hi ? p[2 * i] : p[2 * i + 1];
          p[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, o));
        }
      }
      if (tt0 + j < tc) {
        T* yt = ur + (tt0 + j) * CH + g;
        *yt = from_f32<T>(fmaf(dd, to_f32(*yt), p[0]));
      }
    }
    if (more) store_bc((k + 1) % kStages);
    __syncthreads();   // the chunk's y is in ur
    if (vec) {
      constexpr int kEl = 16 / sizeof(T);
      constexpr int kSeg = CH / kEl;
      for (int i = threadIdx.x; i < kTC * kSeg; i += kThreads) {
        const int tt = i / kSeg, cc = c0 + (i % kSeg) * kEl;
        if (t0 + tt < L && cc < d) {
          *reinterpret_cast<int4*>(y + (row0 + t0 + tt) * d + cc) =
              *reinterpret_cast<const int4*>(ur + tt * CH + (i % kSeg) * kEl);
        }
      }
    } else {
      for (int i = threadIdx.x; i < kTC * CH; i += kThreads) {
        const int tt = i / CH, cc = c0 + i % CH;
        if (t0 + tt < L && cc < d) y[(row0 + t0 + tt) * d + cc] = ur[i];
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* u, const void* dt, const void* bm, const void* cm,
           const void* A, const void* D, void* y, float* hck, int batch,
           int L, int d, int N, void* stream) {
  if (N < 1 || N > kMaxN || batch > 65535) return cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0 || d <= 0) return 0;
  const bool vec = aligned16(u) && aligned16(dt) && aligned16(y) &&
                   d % (16 / sizeof(T)) == 0 && d % 4 == 0;
  constexpr int ch = kThreads / kG;
  const dim3 grid((d + ch - 1) / ch, batch);
  auto kernel = hck != nullptr ? ssm_scan_kernel<T, true>
                                : ssm_scan_kernel<T, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<T*>(y), hck, L, d, N, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, dt, y (batch, L, d); B_, C_ (batch, L, N); A (d, N); D (d,): all
// contiguous on the current device; u, B_, C_ and y of the suffix's type,
// dt, A and D float32; 1 <= N <= 16. hck, when not null, receives the
// states at the start of every 16 steps, (batch, ceil(L / 16), d, 16)
// float32 contiguous, slots past N 0. Returns the CUDA error of the launch
// (0 on success).
extern "C" int ssm_scan_f32(const void* u, const void* dt, const void* bm,
                            const void* cm, const void* A, const void* D,
                            void* y, float* hck, int batch, int L, int d,
                            int N, void* stream) {
  return launch<float>(u, dt, bm, cm, A, D, y, hck, batch, L, d, N, stream);
}

extern "C" int ssm_scan_bf16(const void* u, const void* dt, const void* bm,
                             const void* cm, const void* A, const void* D,
                             void* y, float* hck, int batch, int L, int d,
                             int N, void* stream) {
  return launch<__nv_bfloat16>(u, dt, bm, cm, A, D, y, hck, batch, L, d, N,
                               stream);
}

// Population netlist simulation on Hopper (sm_90a): P candidates x B samples.
//
// Replaces the TPU kernel src/repro/kernels/netlist_sim/kernel.py:
// netlist_sim_pallas (body _sim_kernel) and computes what it and the numpy
// oracle (kernels/netlist_sim/ref.py) compute: seed CONST payloads and the
// ADC inputs, evaluate SHL/ADD/SUB/NEG/RELU/TRUNC level by level, gather
// the C comparator operands into amx (P, B, C), and take the argmax (first
// maximum, as np.argmax) into cls (P, B).
//
// Two bodies, chosen by shape in the wrapper (kernels/netlist_sim/ops.py,
// `smem_tile`), never by failure:
//
//  * The shared-memory body (netlist_sim_smem_*), which the search takes.
//    One block takes one (candidate, tile of bt samples). The candidate's
//    op/arg/shift rows are staged into shared memory as one 16-byte
//    descriptor a slot, and its slot values live there too, laid out
//    [slot][bt] so that neighbouring samples sit in neighbouring banks. The
//    block seeds the ADC inputs, then, for each level l, spreads the
//    (slot, sample) pairs of [level_ptr[l], level_ptr[l+1]) over its 512
//    threads, evaluates them without branches (every result formed, one
//    selected, so the two slots a warp holds at a tile of 16 never
//    diverge), and meets at one __syncthreads(). It relies on
//    the packing's invariant that every operand of a slot lies in a strictly
//    earlier level (the wrapper checks it on the host; a CPU test over
//    netlists of all four datasets guards it). Last it gathers the
//    comparator operands and takes the argmax. This is the TPU kernel's
//    level walk without its O(L*N) masked recompute: O(N) work a sample,
//    and the chain of dependent steps is L levels long, not N slots.
//  * The global-scratch body (netlist_sim_*), for a population whose table
//    does not fit in a block's shared memory (227 KB on the H100) even at
//    one sample a block: one thread per (candidate, sample) walks its candidate's slots in slot order (level
//    major, hence topological) through a (P, N, B) scratch buffer in device
//    memory, every access coalesced over the samples of a warp.
//
// Both: input seeding and the comparator gather are plain indexed loads
// (the Pallas body builds one-hot sums for them). The lane type is a
// template parameter: int32 when every word of the population fits 32 bits
// (the verifier's width bound), int64 otherwise; the TPU kernel had no int64
// lanes and sent such populations elsewhere. Wrap-around arithmetic goes
// through the unsigned type (a left shift of a negative signed value is
// undefined in C++17); the right shift of TRUNC is arithmetic on the signed
// type.
//
// What bounds it: not bytes or operations of its inputs and outputs (well
// under a megabyte and about ten million integer ops per GA generation), but
// latency: the global body's serial chain of scratch round trips through L2
// (one a slot); in the shared-memory body, each block's staging of its
// table, its walk of L levels (a pair is some twenty instructions between
// two shared-memory round trips) and the launch. Smaller tiles give more,
// shorter blocks; the wrapper takes at most 16 samples a block.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

enum : int {
  kConst = 0, kInput = 1, kShl = 2, kAdd = 3, kSub = 4,
  kNeg = 5, kRelu = 6, kArgmax = 7, kTrunc = 8,
};

// One slot's value from its operands (a = arg_a's value, b = arg_b's),
// without branches: every result formed, one selected (a shift count is 0
// for every op but SHL and TRUNC)
template <typename T>
__device__ __forceinline__ T select_op(int o, T a, T b, int k) {
  using U = typename std::make_unsigned<T>::type;
  const U ua = static_cast<U>(a), ub = static_cast<U>(b);
  T r = static_cast<T>(ua << k);                                  // kShl
  r = o == kAdd ? static_cast<T>(ua + ub) : r;
  r = o == kSub ? static_cast<T>(ua - ub) : r;
  r = o == kNeg ? static_cast<T>(U(0) - ua) : r;
  r = o == kRelu ? (a > T(0) ? a : T(0)) : r;
  r = o == kTrunc ? static_cast<T>(static_cast<U>(a >> k) << k) : r;
  return r;
}

template <typename T>
__global__ void netlist_sim_kernel(
    const int32_t* __restrict__ op, const int32_t* __restrict__ arg_a,
    const int32_t* __restrict__ arg_b, const int32_t* __restrict__ shift,
    const T* __restrict__ val, const int32_t* __restrict__ n_nodes,
    const int32_t* __restrict__ input_pos,
    const int32_t* __restrict__ argmax_pos, const T* __restrict__ x,
    T* __restrict__ scratch, T* __restrict__ amx, int64_t* __restrict__ cls,
    int N, int B, int n_in, int C) {
  const int p = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t row = static_cast<size_t>(p) * N;
  const size_t sB = static_cast<size_t>(B);
  T* v = scratch + row * sB + b;            // slot s of this sample: v[s * B]

  const T* xs = x + (static_cast<size_t>(p) * B + b) * n_in;
  for (int i = 0; i < n_in; ++i) {
    v[static_cast<size_t>(input_pos[p * n_in + i]) * sB] = xs[i];
  }

  const int n = n_nodes[p];
  for (int s = 0; s < n; ++s) {
    const int o = op[row + s];
    if (o == kInput || o == kArgmax || o < 0) continue;   // seeded / NOP
    T r;
    if (o == kConst) {
      r = val[row + s];
    } else {
      // arg_b is slot 0 where unused: a harmless read
      r = select_op<T>(o, v[static_cast<size_t>(arg_a[row + s]) * sB],
                       v[static_cast<size_t>(arg_b[row + s]) * sB],
                       shift[row + s]);
    }
    v[static_cast<size_t>(s) * sB] = r;
  }

  T* out = amx + (static_cast<size_t>(p) * B + b) * C;
  T best = T(0);
  int arg = 0;
  for (int c = 0; c < C; ++c) {
    const T w = v[static_cast<size_t>(argmax_pos[p * C + c]) * sB];
    out[c] = w;
    if (c == 0 || w > best) {
      best = w;
      arg = c;
    }
  }
  cls[static_cast<size_t>(p) * B + b] = arg;
}

template <typename T>
int launch(const void* op, const void* arg_a, const void* arg_b,
           const void* shift, const void* val, const void* n_nodes,
           const void* input_pos, const void* argmax_pos, const void* x,
           void* scratch, void* amx, void* cls, int P, int N, int B,
           int n_in, int C, int block, void* stream) {
  if (P <= 0 || B <= 0) return 0;
  const dim3 grid((B + block - 1) / block, P);
  netlist_sim_kernel<T><<<grid, block, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(arg_a),
      static_cast<const int32_t*>(arg_b), static_cast<const int32_t*>(shift),
      static_cast<const T*>(val), static_cast<const int32_t*>(n_nodes),
      static_cast<const int32_t*>(input_pos),
      static_cast<const int32_t*>(argmax_pos), static_cast<const T*>(x),
      static_cast<T*>(scratch), static_cast<T*>(amx),
      static_cast<int64_t*>(cls), N, B, n_in, C);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSmemThreads = 512;

// the most dynamic shared memory a block of the current device can take
// (227 KB on the H100)
cudaError_t smem_limit(int* bytes) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

// The shared-memory body: block (x, p) takes samples [x * bt, x * bt + bt)
// of candidate p, bt = 1 << bt_log2. Dynamic shared memory: N descriptors
// {op, arg_a, arg_b, shift} of 16 bytes (a CONST's payload in place of its
// two operands, so the level walk reads nothing but shared memory), then
// the values T[N][bt].
template <typename T>
__global__ void __launch_bounds__(kSmemThreads)
netlist_sim_smem_kernel(
    const int32_t* __restrict__ op, const int32_t* __restrict__ arg_a,
    const int32_t* __restrict__ arg_b, const int32_t* __restrict__ shift,
    const T* __restrict__ val, const int32_t* __restrict__ n_nodes,
    const int32_t* __restrict__ level_ptr,
    const int32_t* __restrict__ n_levels,
    const int32_t* __restrict__ input_pos,
    const int32_t* __restrict__ argmax_pos, const T* __restrict__ x,
    T* __restrict__ amx, int64_t* __restrict__ cls, int N, int L, int B,
    int n_in, int C, int bt_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  int4* desc = reinterpret_cast<int4*>(smem);
  T* v = reinterpret_cast<T*>(smem + static_cast<size_t>(N) * sizeof(int4));
  const int bt = 1 << bt_log2, mask = bt - 1;
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * bt;
  const size_t row = static_cast<size_t>(p) * N;
  const int n = n_nodes[p];

  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int o = op[row + s];
    if (o == kConst) {   // the payload rides in the operand words
      const int64_t c = static_cast<int64_t>(val[row + s]);
      desc[s] = make_int4(o, static_cast<int32_t>(c),
                          static_cast<int32_t>(c >> 32), 0);
    } else {
      desc[s] = make_int4(o, arg_a[row + s], arg_b[row + s], shift[row + s]);
    }
  }
  // inputs, sample-major as x lies in memory; samples past B take 0
  const T* xs = x + (static_cast<size_t>(p) * B + b0) * n_in;
  for (int i = threadIdx.x; i < n_in * bt; i += blockDim.x) {
    const int smp = i / n_in, k = i % n_in;
    v[(input_pos[p * n_in + k] << bt_log2) + smp] =
        b0 + smp < B ? xs[i] : T(0);
  }
  __syncthreads();

  const int32_t* lp = level_ptr + static_cast<size_t>(p) * (L + 1);
  const int levels = n_levels[p];
  for (int l = 0; l < levels; ++l) {
    const int lo = lp[l];
    const int pairs = (lp[l + 1] - lo) << bt_log2;
    T* vl = v + (lo << bt_log2);   // pair i is value vl[i]
#pragma unroll 2
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const int smp = i & mask;
      const int4 dsc = desc[lo + (i >> bt_log2)];
      const int o = dsc.x;
      // without branches, so that the slots of one warp never diverge:
      // a CONST's operand words hold its payload, and a slot that reads
      // no operand reads slot 0, a harmless read
      const bool cst = o == kConst;
      const bool run = o >= kShl && o != kArgmax;   // a computed slot
      const T a = v[((run ? dsc.y : 0) << bt_log2) + smp];
      const T b = v[((run ? dsc.z : 0) << bt_log2) + smp];
      const T c = static_cast<T>(
          (static_cast<uint64_t>(static_cast<uint32_t>(dsc.z)) << 32) |
          static_cast<uint32_t>(dsc.y));
      const T r = cst ? c : select_op<T>(o, a, b, dsc.w);
      if (cst || run) vl[i] = r;
    }
    __syncthreads();   // level l is complete before level l + 1 reads it
  }

  const int live = min(bt, B - b0);
  T* out = amx + (static_cast<size_t>(p) * B + b0) * C;
  for (int i = threadIdx.x; i < live * C; i += blockDim.x) {
    const int smp = i / C, c = i % C;
    out[i] = v[(argmax_pos[p * C + c] << bt_log2) + smp];
  }
  for (int smp = threadIdx.x; smp < live; smp += blockDim.x) {
    T best = T(0);
    int arg = 0;
    for (int c = 0; c < C; ++c) {
      const T w = v[(argmax_pos[p * C + c] << bt_log2) + smp];
      if (c == 0 || w > best) {
        best = w;
        arg = c;
      }
    }
    cls[static_cast<size_t>(p) * B + b0 + smp] = arg;
  }
}

template <typename T>
int launch_smem(const void* op, const void* arg_a, const void* arg_b,
                const void* shift, const void* val, const void* n_nodes,
                const void* level_ptr, const void* n_levels,
                const void* input_pos, const void* argmax_pos, const void* x,
                void* amx, void* cls, int P, int N, int L, int B, int n_in,
                int C, int bt_log2, void* stream) {
  if (P <= 0 || B <= 0) return 0;
  if (bt_log2 < 0 || bt_log2 > 10 || P > 65535) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(N) *
                       (sizeof(int4) + (sizeof(T) << bt_log2));
  // above 48 KB only after opting in: once a device, to the most a block
  // can take, so that a launch inside a CUDA graph capture calls nothing
  // but the launch
  static int opted_in[64] = {};   // the device's limit once opted in
  if (bytes > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
      int limit = 0;
      e = smem_limit(&limit);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaFuncSetAttribute(netlist_sim_smem_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
      if (e != cudaSuccess) return static_cast<int>(e);
      opted_in[dev] = limit;
    }
    if (bytes > static_cast<size_t>(opted_in[dev])) {
      return cudaErrorInvalidValue;
    }
  }
  const int bt = 1 << bt_log2;
  const dim3 grid((B + bt - 1) / bt, P);
  netlist_sim_smem_kernel<T><<<grid, kSmemThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(op), static_cast<const int32_t*>(arg_a),
      static_cast<const int32_t*>(arg_b), static_cast<const int32_t*>(shift),
      static_cast<const T*>(val), static_cast<const int32_t*>(n_nodes),
      static_cast<const int32_t*>(level_ptr),
      static_cast<const int32_t*>(n_levels),
      static_cast<const int32_t*>(input_pos),
      static_cast<const int32_t*>(argmax_pos), static_cast<const T*>(x),
      static_cast<T*>(amx), static_cast<int64_t*>(cls), N, L, B, n_in, C,
      bt_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int netlist_sim_i32(
    const void* op, const void* arg_a, const void* arg_b, const void* shift,
    const void* val, const void* n_nodes, const void* input_pos,
    const void* argmax_pos, const void* x, void* scratch, void* amx,
    void* cls, int P, int N, int B, int n_in, int C, int block,
    void* stream) {
  return launch<int32_t>(op, arg_a, arg_b, shift, val, n_nodes, input_pos,
                         argmax_pos, x, scratch, amx, cls, P, N, B, n_in, C,
                         block, stream);
}

extern "C" int netlist_sim_i64(
    const void* op, const void* arg_a, const void* arg_b, const void* shift,
    const void* val, const void* n_nodes, const void* input_pos,
    const void* argmax_pos, const void* x, void* scratch, void* amx,
    void* cls, int P, int N, int B, int n_in, int C, int block,
    void* stream) {
  return launch<int64_t>(op, arg_a, arg_b, shift, val, n_nodes, input_pos,
                         argmax_pos, x, scratch, amx, cls, P, N, B, n_in, C,
                         block, stream);
}

// The most dynamic shared memory a block of the current device can take,
// which bounds the shared-memory body's N * (16 + bt * sizeof(T)) bytes.
extern "C" int netlist_sim_smem_limit(int* bytes) {
  return static_cast<int>(smem_limit(bytes));
}

// The shared-memory body. level_ptr (P, L + 1) and n_levels (P,) int32 as
// the packing lays them out; bt_log2: log2 of the samples a block.
extern "C" int netlist_sim_smem_i32(
    const void* op, const void* arg_a, const void* arg_b, const void* shift,
    const void* val, const void* n_nodes, const void* level_ptr,
    const void* n_levels, const void* input_pos, const void* argmax_pos,
    const void* x, void* amx, void* cls, int P, int N, int L, int B,
    int n_in, int C, int bt_log2, void* stream) {
  return launch_smem<int32_t>(op, arg_a, arg_b, shift, val, n_nodes,
                              level_ptr, n_levels, input_pos, argmax_pos, x,
                              amx, cls, P, N, L, B, n_in, C, bt_log2, stream);
}

extern "C" int netlist_sim_smem_i64(
    const void* op, const void* arg_a, const void* arg_b, const void* shift,
    const void* val, const void* n_nodes, const void* level_ptr,
    const void* n_levels, const void* input_pos, const void* argmax_pos,
    const void* x, void* amx, void* cls, int P, int N, int L, int B,
    int n_in, int C, int bt_log2, void* stream) {
  return launch_smem<int64_t>(op, arg_a, arg_b, shift, val, n_nodes,
                              level_ptr, n_levels, input_pos, argmax_pos, x,
                              amx, cls, P, N, L, B, n_in, C, bt_log2, stream);
}

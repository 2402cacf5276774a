// Population netlist simulation on Hopper (sm_90a): P candidates x B samples.
//
// Replaces the TPU kernel src/repro/kernels/netlist_sim/kernel.py:
// netlist_sim_pallas (body _sim_kernel) and computes what it and the numpy
// oracle (kernels/netlist_sim/ref.py) compute: seed CONST payloads and the
// ADC inputs, evaluate SHL/ADD/SUB/NEG/RELU/TRUNC in slot order, gather the
// C comparator operands into amx (P, B, C), and take the argmax (first
// maximum, as np.argmax) into cls (P, B).
//
// Design for this card rather than a block-by-block copy of the Pallas body:
//  * One thread per (candidate, sample). A thread walks its candidate's real
//    slots [0, n_nodes[p]) once, in slot order. Slots are level-major, hence
//    topological, so the walk is dependency-safe with no barrier: O(N) work
//    per sample, where the Pallas body recomputes the whole N-slot table at
//    every level under a mask (O(L*N)).
//  * Input seeding and the comparator gather are plain indexed loads (the
//    Pallas body builds one-hot sums for them).
//  * Slot values live in a global scratch buffer laid out (P, N, B): the 32
//    threads of a warp touch 32 neighbouring words of one slot row, so every
//    scratch access is one coalesced transaction. The op tables are the same
//    for every thread of a block and are read as warp-uniform broadcasts.
//  * The lane type is a template parameter: int32 when every word of the
//    population fits 32 bits (the verifier's width bound), int64 otherwise;
//    the TPU kernel had no int64 lanes and sent such populations elsewhere.
//  * Wrap-around arithmetic goes through the unsigned type (a left shift of
//    a negative signed value is undefined in C++17); the right shift of
//    TRUNC is arithmetic on the signed type.
//
// What bounds it: not bytes or operations of its inputs and outputs (well
// under a megabyte and about ten million integer ops per GA generation), but
// the serial chain of scratch round trips in each thread: every slot is a
// dependent load-compute-store through L2, and one generation launches only
// about P*B/32 warps. Keeping the values in shared memory when
// N * block * lane bytes fits is the next step.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

enum : int {
  kConst = 0, kInput = 1, kShl = 2, kAdd = 3, kSub = 4,
  kNeg = 5, kRelu = 6, kArgmax = 7, kTrunc = 8,
};

template <typename T>
__global__ void netlist_sim_kernel(
    const int32_t* __restrict__ op, const int32_t* __restrict__ arg_a,
    const int32_t* __restrict__ arg_b, const int32_t* __restrict__ shift,
    const T* __restrict__ val, const int32_t* __restrict__ n_nodes,
    const int32_t* __restrict__ input_pos,
    const int32_t* __restrict__ argmax_pos, const T* __restrict__ x,
    T* __restrict__ scratch, T* __restrict__ amx, int64_t* __restrict__ cls,
    int N, int B, int n_in, int C) {
  using U = typename std::make_unsigned<T>::type;
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
      const T a = v[static_cast<size_t>(arg_a[row + s]) * sB];
      const int k = shift[row + s];
      switch (o) {
        case kShl: r = static_cast<T>(static_cast<U>(a) << k); break;
        case kAdd:
          r = static_cast<T>(static_cast<U>(a) + static_cast<U>(
                  v[static_cast<size_t>(arg_b[row + s]) * sB]));
          break;
        case kSub:
          r = static_cast<T>(static_cast<U>(a) - static_cast<U>(
                  v[static_cast<size_t>(arg_b[row + s]) * sB]));
          break;
        case kNeg: r = static_cast<T>(U(0) - static_cast<U>(a)); break;
        case kRelu: r = a > T(0) ? a : T(0); break;
        default:  // kTrunc: arithmetic floor-truncate of the low k bits
          r = static_cast<T>(static_cast<U>(a >> k) << k);
          break;
      }
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

// RANS64 rANS dense encode (K6) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/rans64_tpu.py::_encode_kernel (via
// encode_blocks).  Each coder lane walks its steps in reverse from
// x = 2^31 (rans64.h:59, L = 2^31) with a native 64-bit state.  Per step,
// with x_max = freq << (63 - prob_bits) (rans64.h:83), the lane writes the
// low word of x and shifts x right by 32 when x >= x_max (never twice: the
// state stays in [2^31, 2^63)); the dense cell is 1 << 32 | word, or 0.
// The test compares the high word with thr = freq << (31 - prob_bits),
// which is the same test (x_max is a multiple of 2^32) and fits a u32 even
// at 2^31, in the one-symbol model at prob_bits 31 (rans64_tpu.py:81).
// Then, with the reference's division-free step (Rans64EncPutSymbol,
// rans64.h:262-278; the reciprocal of rans64.h:167-247, exact for every
// x < 2^63; ops/host_prep.py rans64_enc_table):
//   q = mulhi64(x, rcp_freq) >> rcp_shift;  x += bias + q * cmpl_freq,
// i.e. (x / freq) << prob_bits + x % freq + start.  At freq 1 the table's
// rcp_freq = 2^64 - 1 and rcp_shift = 0 give q = x - 1, which bias =
// start + 2^prob_bits - 1 folds back.
//
// Layout: symbol i of a block is step i / N, lane i % N; the cells keep
// the [block, step, lane] order, which is stream order.
//
// Bound on this card: memory, 9 bytes per symbol (1 in, an 8-byte cell
// out).  The loop (CTAs of 512 lanes, one lane a thread, symbols staged in
// shared memory by cp.async tiles, the row a step ahead and the symbol two)
// is enc_tiles.cuh, shared with K2 and K4; this file gives the step.  The
// per-symbol row is 32 bytes in shared memory (8 KB for 256 symbols): one
// 16-byte and one 8-byte shared load.  Hopper has no 64-bit integer
// divide (native u64 `/` and `%` are a software routine of some tens of
// instructions with a branch); the step's chain is a 64-bit high multiply,
// a shift, a multiply and two adds.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_tiles.cuh"

namespace {

// One symbol's row: (rcp_freq lo, rcp_freq hi, bias, cmpl_freq),
// (rcp_shift, thr), padded to 32 bytes.
struct alignas(16) Rans64Row {
  uint4 a;
  uint2 b;
};

struct Args {
  enc_tiles::Io<uint64_t, uint64_t> io;
  const Rans64Row* table;  // [256] rows, see rans64_enc_table
};

struct Rans64Step {
  using State = uint64_t;
  using Cell = uint64_t;
  using Row = Rans64Row;
  static constexpr State kInit = 1ull << 31;

  const Rans64Row* table;
  const Rans64Row* s_tab = nullptr;

  __device__ __forceinline__ void stage(uint8_t* smem, int tid,
                                        int nthreads) {
    Rans64Row* t = reinterpret_cast<Rans64Row*>(smem);
    for (int i = tid; i < 256; i += nthreads) t[i] = table[i];
    s_tab = t;
  }

  __device__ __forceinline__ Row row(uint32_t s) const { return s_tab[s]; }

  __device__ __forceinline__ Cell operator()(uint64_t& x,
                                             const Rans64Row& e) const {
    const uint32_t hi = static_cast<uint32_t>(x >> 32);
    const bool m = hi >= e.b.y;  // x >= freq << (63 - prob_bits)
    const uint64_t cell = m ? (1ull << 32) | (x & 0xFFFFFFFFull) : 0ull;
    const uint64_t xs = m ? static_cast<uint64_t>(hi) : x;
    const uint64_t rcp = (static_cast<uint64_t>(e.a.y) << 32) | e.a.x;
    const uint64_t q = __umul64hi(xs, rcp) >> e.b.x;
    x = xs + e.a.z + q * e.a.w;
    return cell;
  }
};

__global__ void __launch_bounds__(enc_tiles::kMaxThreads)
rans64_encode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  Rans64Step step{a.table};
  enc_tiles::encode(step, a.io, smem);
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes], 16-byte aligned; table: int32
// [256, 8] (ops/host_prep.py rans64_enc_table); cells: u64 [n_blocks,
// n_steps * n_lanes]; states: u64 [n_blocks, n_lanes].  n_lanes is a power
// of two in [128, 16384] and prob_bits in [9, 31].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int rans64_encode(const void* syms, const void* table,
                             void* cells, void* states, int n_blocks,
                             int n_lanes, int n_steps, int prob_bits,
                             void* stream) {
  const int cta_lanes = enc_tiles::cta_lanes_for(syms, n_lanes, n_steps);
  if (cta_lanes == 0 || prob_bits < 9 || prob_bits > 31 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{{static_cast<const uint8_t*>(syms),
                static_cast<uint64_t*>(cells),
                static_cast<uint64_t*>(states), n_lanes, n_steps,
                cta_lanes},
               static_cast<const Rans64Row*>(table)};
  return enc_tiles::launch(rans64_encode_kernel, a, n_blocks, n_lanes,
                           cta_lanes, 256 * sizeof(Rans64Row), stream);
}

extern "C" const char* rans64_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

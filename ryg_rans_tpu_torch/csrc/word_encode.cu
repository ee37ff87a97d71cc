// WORD rANS dense encode (K2) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/word_tpu.py::_encode_kernel (via encode_blocks).
// Each coder lane walks its steps in reverse from x = 2^16 (rANS twist #1,
// rans_byte.h:22-23).  Per step it tests x >= x_max = freq << (32 -
// prob_bits) as x > x_max - 1 in 32 bits (x_max reaches 2^32 in the
// one-symbol model; word_tpu.py:330-331 keeps x_max - 1 too); on a hit it
// writes the dense cell (x & 0xFFFF) | 1<<16 and shifts x right by 16 (at
// most once: x_max >= 2^17), else it writes 0.  Then
// x = (x / freq) << prob_bits + x % freq + start (rans_word_sse41.h:85-93)
// as x += bias + q * cmpl_freq, with cmpl_freq = 2^prob_bits - freq and the
// quotient q = x / freq = mulhi64(x, ceil(2^64 / freq)) (ops/host_prep.py
// word_enc_table, models/tables.py), exact for every x < 2^32 at every freq
// in [2, 2^15].  The state after renorm reaches freq << (32 - prob_bits),
// past 2^31 when freq > 2^(prob_bits - 1), where rans_byte.h's 31-bit
// reciprocal is not exact.  At freq 1 the table's 2^64 - 1 gives
// q = x - 1, which bias = start + 2^prob_bits - 1 folds back (as
// rans_byte.h:199-228 does).  The Granlund-Montgomery form with a 32-bit
// multiplier and an add-back is exact too, and measured no faster on the
// H100 (decode_probe.py --part encode, PERF.md).
//
// Layout: symbol i of a block is step i / N, lane i % N.  Cells keep the
// [block, step, lane] order, which is stream order; compaction into the
// stream is glue on the card.
//
// Bound on this card: memory, 5 bytes per symbol (1 in, a 4-byte cell
// out).  The loop (CTAs of 512 lanes, one lane a thread, symbols staged in
// shared memory by cp.async tiles, the row a step ahead and the symbol two)
// is enc_tiles.cuh, shared with K4 and K6; this file gives the step.  The
// per-symbol row (x_max - 1, rcp lo, rcp hi, bias | cmpl_freq << 16) is
// one 16-byte shared load, and the step's chain is arithmetic with no
// divide.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_tiles.cuh"

namespace {

struct Args {
  enc_tiles::Io<int32_t, uint32_t> io;
  const uint4* table;  // [256] rows, see word_enc_table
};

struct WordStep {
  using State = uint32_t;
  using Cell = int32_t;
  using Row = uint4;
  static constexpr State kInit = 1u << 16;

  const uint4* table;
  const uint4* s_tab = nullptr;

  __device__ __forceinline__ void stage(uint8_t* smem, int tid,
                                        int nthreads) {
    uint4* t = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < 256; i += nthreads) t[i] = table[i];
    s_tab = t;
  }

  __device__ __forceinline__ Row row(uint32_t s) const { return s_tab[s]; }

  __device__ __forceinline__ Cell operator()(uint32_t& x,
                                             const uint4 e) const {
    const bool m = x > e.x;  // x >= freq << (32 - prob_bits)
    const uint32_t cell = m ? (x & 0xFFFFu) | 0x10000u : 0u;
    const uint32_t xs = m ? x >> 16 : x;
    const uint32_t q = static_cast<uint32_t>(
        __umul64hi(xs, (static_cast<uint64_t>(e.z) << 32) | e.y));
    x = xs + (e.w & 0xFFFFu) + q * (e.w >> 16);
    return static_cast<Cell>(cell);
  }
};

__global__ void __launch_bounds__(enc_tiles::kMaxThreads)
word_encode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  WordStep step{a.table};
  enc_tiles::encode(step, a.io, smem);
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes], 16-byte aligned; table: int32
// [256, 4] (ops/host_prep.py word_enc_table); cells: int32 [n_blocks,
// n_steps * n_lanes]; states: u32 [n_blocks, n_lanes].  n_lanes is a power
// of two in [128, 16384] and prob_bits in [9, 15].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int word_encode(const void* syms, const void* table, void* cells,
                           void* states, int n_blocks, int n_lanes,
                           int n_steps, int prob_bits, void* stream) {
  const int cta_lanes = enc_tiles::cta_lanes_for(syms, n_lanes, n_steps);
  if (cta_lanes == 0 || prob_bits < 9 || prob_bits > 15 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{{static_cast<const uint8_t*>(syms),
                static_cast<int32_t*>(cells),
                static_cast<uint32_t*>(states), n_lanes, n_steps,
                cta_lanes},
               static_cast<const uint4*>(table)};
  return enc_tiles::launch(word_encode_kernel, a, n_blocks, n_lanes,
                           cta_lanes, 256 * sizeof(uint4), stream);
}

extern "C" const char* word_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

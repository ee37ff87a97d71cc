// BYTE / ALIAS rANS dense encode (K4) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/byte_tpu.py::_encode_kernel (via encode_blocks),
// which encodes both variants.  Each coder lane walks its steps in reverse
// from x = 2^23 (rans_byte.h:22-23, L = 2^23).  Per step, with
// x_max = freq << (31 - prob_bits) (rans_byte.h:64; at most 2^31, in the
// one-symbol model at prob_bits 16), the renorm loop of rans_byte.h:62-74
// writes x & 0xFF and shifts x right by 8 while x >= x_max, which is at most
// twice: the state stays in [2^23, 2^31).  The dense cell holds those k
// bytes in forward (decoder) order: k << 16 | fwd0 << 8 | fwd1, with fwd0
// the byte written last, or 0 when k = 0.  Then, with the reference's
// reciprocal (RansEncSymbolInit, rans_byte.h:174-243; ops/host_prep.py
// byte_enc_table) q = mulhi(x, rcp_freq) >> rcp_shift = x / freq:
//   BYTE:  x += bias + q * cmpl_freq  (rans_byte.h:258-280), i.e.
//          (x / freq) << prob_bits + x % freq + start;
//   ALIAS: x = q << prob_bits | remap[x - q * freq + start]
//          (main_alias.cpp:241-250), with q = x where freq == 1 (the
//          table's q = x - 1 there is folded into BYTE's bias only).
//
// Layout: symbol i of a block is step i / N, lane i % N, so a step's
// symbols are N consecutive bytes.  Cells keep the [block, step, lane]
// order, which is stream order; compaction into the stream is glue on the
// card.
//
// Bound on this card: memory, 5 bytes per symbol (1 in, a 4-byte cell
// out).  The loop (CTAs of 512 lanes, one lane a thread, symbols staged in
// shared memory by cp.async tiles, the row a step ahead and the symbol two)
// is enc_tiles.cuh, shared with K2 and K6; this file gives the step.  The
// per-symbol row (x_max, rcp, bias or freq, cmpl_freq or start |
// rcp_shift << 24) is one 16-byte shared load; the ALIAS remap
// (2^prob_bits u16, at most 128 KB) sits in dynamic shared memory too.
// The chain from one step's state to the next is then arithmetic with no
// divide, and for ALIAS one shared read.

#include <cstdint>
#include <cuda_runtime.h>

#include "enc_tiles.cuh"

namespace {

struct Args {
  enc_tiles::Io<int32_t, uint32_t> io;
  const uint4* table;     // [256] rows, see byte_enc_table
  const uint16_t* remap;  // [2^prob_bits] for ALIAS, else null
  int prob_bits;
};

template <bool ALIAS>
struct ByteStep {
  using State = uint32_t;
  using Cell = int32_t;
  using Row = uint4;
  static constexpr State kInit = 1u << 23;  // rans_byte.h:22-23, L = 2^23

  const uint4* table;
  const uint16_t* remap;
  int pb;
  const uint4* s_tab = nullptr;
  const uint16_t* s_remap = nullptr;

  // table uint4[256] | ALIAS remap u16[2^pb]
  __device__ __forceinline__ void stage(uint8_t* smem, int tid,
                                        int nthreads) {
    uint4* t = reinterpret_cast<uint4*>(smem);
    for (int i = tid; i < 256; i += nthreads) t[i] = table[i];
    s_tab = t;
    if constexpr (ALIAS) {
      const uint4* g = reinterpret_cast<const uint4*>(remap);
      uint4* s = t + 256;
      for (int i = tid; i < (1 << pb) / 8; i += nthreads) s[i] = g[i];
      s_remap = reinterpret_cast<const uint16_t*>(s);
    }
  }

  __device__ __forceinline__ Row row(uint32_t s) const { return s_tab[s]; }

  // One lane's step: renormalise x against the symbol's row `e`, return the
  // dense cell, and encode the symbol into x.
  __device__ __forceinline__ Cell operator()(uint32_t& x,
                                             const uint4 e) const {
    const uint32_t x_max = e.x;
    const bool m1 = x >= x_max;
    const uint32_t x1 = m1 ? x >> 8 : x;
    const bool m2 = x1 >= x_max;  // only after m1: x1 <= x
    const uint32_t cell =
        m2 ? (2u << 16) | ((x1 & 0xFFu) << 8) | (x & 0xFFu)
           : (m1 ? (1u << 16) | ((x & 0xFFu) << 8) : 0u);
    const uint32_t xs = m2 ? x1 >> 8 : x1;
    const uint32_t shift = e.w >> 24;
    const uint32_t low = e.w & 0xFFFFFFu;
    if constexpr (ALIAS) {
      const uint32_t freq = e.z;
      const uint32_t q = freq == 1u ? xs : __umulhi(xs, e.y) >> shift;
      x = (q << pb) | s_remap[xs - q * freq + low];
    } else {
      x = xs + e.z + (__umulhi(xs, e.y) >> shift) * low;
    }
    return static_cast<Cell>(cell);
  }
};

template <bool ALIAS>
__global__ void __launch_bounds__(enc_tiles::kMaxThreads)
byte_encode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  ByteStep<ALIAS> step{a.table, a.remap, a.prob_bits};
  enc_tiles::encode(step, a.io, smem);
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes], 16-byte aligned; table: int32
// [256, 4] (ops/host_prep.py byte_enc_table, built for the variant); remap:
// u16 [2^prob_bits] for ALIAS, null for BYTE; cells: int32 [n_blocks,
// n_steps * n_lanes]; states: u32 [n_blocks, n_lanes].  n_lanes is a power
// of two in [128, 16384] and prob_bits in [9, 16].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int byte_encode(const void* syms, const void* table,
                           const void* remap, void* cells, void* states,
                           int n_blocks, int n_lanes, int n_steps,
                           int prob_bits, void* stream) {
  const int cta_lanes = enc_tiles::cta_lanes_for(syms, n_lanes, n_steps);
  if (cta_lanes == 0 || prob_bits < 9 || prob_bits > 16 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(remap) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{{static_cast<const uint8_t*>(syms),
                static_cast<int32_t*>(cells),
                static_cast<uint32_t*>(states), n_lanes, n_steps,
                cta_lanes},
               static_cast<const uint4*>(table),
               static_cast<const uint16_t*>(remap),
               prob_bits};
  const size_t table_bytes =
      256 * sizeof(uint4) + (remap ? sizeof(uint16_t) << prob_bits : 0);
  return remap ? enc_tiles::launch(byte_encode_kernel<true>, a, n_blocks,
                                   n_lanes, cta_lanes, table_bytes, stream)
               : enc_tiles::launch(byte_encode_kernel<false>, a, n_blocks,
                                   n_lanes, cta_lanes, table_bytes, stream);
}

extern "C" const char* byte_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

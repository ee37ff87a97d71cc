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
// the byte written last, or 0 when k = 0.  Then
//   BYTE:  x = (x / freq) << prob_bits + x % freq + start;
//   ALIAS: x = (x / freq) << prob_bits | remap[x % freq + start]
//          (main_alias.cpp:241-250).
//
// Layout: symbol i of a block is step i / N, lane i % N, so a step's
// symbols are N consecutive bytes and one thread per lane reads and writes
// neighbouring addresses.  Cells keep the [block, step, lane] order, which
// is stream order; compaction into the stream is glue on the card.
//
// Bound on this card: memory.  Per symbol it reads 1 byte and writes a
// 4-byte cell; the arithmetic (one native u32 divide and modulo) is small
// next to that.  (freq, start) live in shared memory.  The ALIAS remap (up
// to 2^16 u16 entries, 128 KB) stays in global memory, read through the
// read-only cache, where L1 and L2 hold it: in shared memory it would cap
// each SM at one 128-thread CTA.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <bool ALIAS>
__global__ void __launch_bounds__(kThreads)
byte_encode_kernel(const uint8_t* __restrict__ syms,
                   const int32_t* __restrict__ freq_g,
                   const int32_t* __restrict__ start_g,
                   const uint16_t* __restrict__ remap,
                   int32_t* __restrict__ cells,
                   uint32_t* __restrict__ states,
                   int n_lanes, int n_steps, int prob_bits) {
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_start[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_freq[i] = static_cast<uint32_t>(freq_g[i]);
    s_start[i] = static_cast<uint32_t>(start_g[i]);
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const size_t block_base =
      static_cast<size_t>(blockIdx.y) * n_steps * n_lanes + lane;
  const uint8_t* sp = syms + block_base;
  int32_t* cp = cells + block_base;
  const int shift = 31 - prob_bits;

  uint32_t x = 1u << 23;
#pragma unroll 4
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * n_lanes;
    const uint32_t s = sp[at];
    const uint32_t freq = s_freq[s];
    const uint32_t start = s_start[s];
    const uint32_t x_max = freq << shift;
    uint32_t cell = 0;
    if (x >= x_max) {
      const uint32_t first = x & 0xFFu;
      x >>= 8;
      if (x >= x_max) {
        cell = (2u << 16) | ((x & 0xFFu) << 8) | first;
        x >>= 8;
      } else {
        cell = (1u << 16) | (first << 8);
      }
    }
    cp[at] = static_cast<int32_t>(cell);
    const uint32_t q = x / freq;
    const uint32_t r = x % freq;
    if constexpr (ALIAS) {
      x = (q << prob_bits) | __ldg(remap + r + start);
    } else {
      x = (q << prob_bits) + r + start;
    }
  }
  states[static_cast<size_t>(blockIdx.y) * n_lanes + lane] = x;
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes]; freq, start: int32 [256];
// remap: u16 [2^prob_bits] for ALIAS, null for BYTE; cells: int32
// [n_blocks, n_steps * n_lanes]; states: u32 [n_blocks, n_lanes].
// prob_bits in [9, 16].  Returns cudaGetLastError() after the launch.
extern "C" int byte_encode(const void* syms, const void* freq,
                           const void* start, const void* remap, void* cells,
                           void* states, int n_blocks, int n_lanes,
                           int n_steps, int prob_bits, void* stream) {
  if (prob_bits < 9 || prob_bits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_lanes + kThreads - 1) / kThreads, n_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = remap ? byte_encode_kernel<true>
                            : byte_encode_kernel<false>;
  kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(freq),
      static_cast<const int32_t*>(start), static_cast<const uint16_t*>(remap),
      static_cast<int32_t*>(cells), static_cast<uint32_t*>(states), n_lanes,
      n_steps, prob_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* byte_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

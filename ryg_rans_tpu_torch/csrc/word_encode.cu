// WORD rANS dense encode (K2) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/word_tpu.py::_encode_kernel (via encode_blocks).
// Each coder lane walks its steps in reverse from x = 2^16 (rANS twist #1,
// rans_byte.h:22-23).  Per step it tests x >= freq << (32 - prob_bits) in
// 64 bits (freq may equal 2^prob_bits in the one-symbol model, where the
// 32-bit shift would wrap); on a hit it writes the dense cell
// (x & 0xFFFF) | 1<<16 and shifts x right by 16, else it writes 0.  Then
// x = (x / freq) << prob_bits + x % freq + start (rans_word_sse41.h:85-93).
//
// Layout: symbol i of a block is step i / N, lane i % N, so a step's
// symbols are N consecutive bytes and one thread per lane reads and writes
// neighbouring addresses.  Cells keep the [block, step, lane] order, which
// is stream order; compaction into the stream is glue on the card.
//
// Bound on this card: memory.  Per symbol it reads 1 byte and writes a
// 4-byte cell; the arithmetic (one native u32 divide and modulo) is small
// next to that.  The (freq, start) table lives in shared memory; the grid
// covers (lane chunk, block) so every block's lanes run in parallel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
word_encode_kernel(const uint8_t* __restrict__ syms,
                   const int32_t* __restrict__ freq_g,
                   const int32_t* __restrict__ start_g,
                   int32_t* __restrict__ cells,
                   uint32_t* __restrict__ states,
                   int n_lanes, int n_steps, int prob_bits) {
  __shared__ uint32_t s_fs[256];  // freq << 16 | start
  for (int i = threadIdx.x; i < 256; i += blockDim.x)
    s_fs[i] = (static_cast<uint32_t>(freq_g[i]) << 16) |
              static_cast<uint32_t>(start_g[i]);
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const size_t block_base =
      static_cast<size_t>(blockIdx.y) * n_steps * n_lanes + lane;
  const uint8_t* sp = syms + block_base;
  int32_t* cp = cells + block_base;
  const int shift = 32 - prob_bits;

  uint32_t x = 1u << 16;
#pragma unroll 4
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * n_lanes;
    const uint32_t fs = s_fs[sp[at]];
    const uint32_t freq = fs >> 16;
    const uint32_t start = fs & 0xFFFFu;
    int32_t cell = 0;
    if (static_cast<uint64_t>(x) >= (static_cast<uint64_t>(freq) << shift)) {
      cell = static_cast<int32_t>((x & 0xFFFFu) | 0x10000u);
      x >>= 16;
    }
    cp[at] = cell;
    x = ((x / freq) << prob_bits) + (x % freq) + start;
  }
  states[static_cast<size_t>(blockIdx.y) * n_lanes + lane] = x;
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes]; freq, start: int32 [256];
// cells: int32 [n_blocks, n_steps * n_lanes]; states: u32 [n_blocks, n_lanes].
// Returns cudaGetLastError() after the launch.
extern "C" int word_encode(const void* syms, const void* freq,
                           const void* start, void* cells, void* states,
                           int n_blocks, int n_lanes, int n_steps,
                           int prob_bits, void* stream) {
  const dim3 grid((n_lanes + kThreads - 1) / kThreads, n_blocks);
  word_encode_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(freq),
      static_cast<const int32_t*>(start), static_cast<int32_t*>(cells),
      static_cast<uint32_t*>(states), n_lanes, n_steps, prob_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* word_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// RANS64 rANS dense encode (K6) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/rans64_tpu.py::_encode_kernel (via
// encode_blocks).  Each coder lane walks its steps in reverse from
// x = 2^31 (rans64.h:59, L = 2^31) with a native 64-bit state.  Per step,
// with x_max = freq << (63 - prob_bits) (rans64.h:83; 2^63 in the
// one-symbol model at prob_bits 31, which u64 holds), the lane writes the
// low word of x and shifts x right by 32 when x >= x_max (never twice:
// the state stays in [2^31, 2^63)); the dense cell is 1 << 32 | word, or 0.
// Then x = (x / freq) << prob_bits + x % freq + start with native u64 `/`
// and `%` (rans64.h:77-93), the same quotient as the reference's Alverson
// reciprocal (rans64.h:167-247) at every prob_bits.
//
// Layout: symbol i of a block is step i / N, lane i % N; one thread per
// lane reads and writes neighbouring addresses, and the cells keep the
// [block, step, lane] order, which is stream order.
//
// Bound on this card: memory, 9 bytes per symbol (1 in, an 8-byte cell
// out).  Hopper has no 64-bit integer divide, so nvcc emits a software
// routine of some tens of instructions for the `/` and `%`; that, and not
// the bytes, may set the time (PERF.md has the measurement).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rans64_encode_kernel(const uint8_t* __restrict__ syms,
                     const uint32_t* __restrict__ freq_g,
                     const uint32_t* __restrict__ start_g,
                     uint64_t* __restrict__ cells,
                     uint64_t* __restrict__ states,
                     int n_lanes, int n_steps, int prob_bits) {
  __shared__ uint32_t s_freq[256];
  __shared__ uint32_t s_start[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    s_freq[i] = freq_g[i];
    s_start[i] = start_g[i];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const size_t block_base =
      static_cast<size_t>(blockIdx.y) * n_steps * n_lanes + lane;
  const uint8_t* sp = syms + block_base;
  uint64_t* cp = cells + block_base;
  const int shift = 63 - prob_bits;

  uint64_t x = 1ull << 31;
#pragma unroll 4
  for (int t = n_steps - 1; t >= 0; --t) {
    const size_t at = static_cast<size_t>(t) * n_lanes;
    const uint32_t s = sp[at];
    const uint64_t freq = s_freq[s];
    uint64_t cell = 0;
    if (x >= (freq << shift)) {
      cell = (1ull << 32) | (x & 0xFFFFFFFFull);
      x >>= 32;
    }
    cp[at] = cell;
    x = ((x / freq) << prob_bits) + (x % freq) + s_start[s];
  }
  states[static_cast<size_t>(blockIdx.y) * n_lanes + lane] = x;
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes]; freq, start: u32 [256];
// cells: u64 [n_blocks, n_steps * n_lanes]; states: u64 [n_blocks,
// n_lanes].  prob_bits in [9, 31].  Returns cudaGetLastError() after the
// launch.
extern "C" int rans64_encode(const void* syms, const void* freq,
                             const void* start, void* cells, void* states,
                             int n_blocks, int n_lanes, int n_steps,
                             int prob_bits, void* stream) {
  if (prob_bits < 9 || prob_bits > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_lanes + kThreads - 1) / kThreads, n_blocks);
  rans64_encode_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const uint32_t*>(freq),
      static_cast<const uint32_t*>(start), static_cast<uint64_t*>(cells),
      static_cast<uint64_t*>(states), n_lanes, n_steps, prob_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rans64_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

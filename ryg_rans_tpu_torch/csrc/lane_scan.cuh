// Pieces shared by the WORD (K1), BYTE/ALIAS (K3) and RANS64 (K5)
// decoders.
//
// A decoder CTA owns a contiguous run of a container block's lanes (the
// block is one thread-block cluster, cluster_stream.cuh); each of its
// threads owns L consecutive lanes.  Every step, a refilling lane's stream
// position is the CTA's base (the block's cursor plus what the lower CTAs
// of the cluster take) plus the number of refill units (bytes or words)
// that the CTA's lanes before it take this step, in ascending lane order.
// That is an exclusive CTA-wide prefix sum of per-thread counts: a
// warp-shuffle scan, then one shared array of warp totals.  The caller
// passes one of two such arrays by step parity, so one barrier per step
// suffices: a thread reads the array of step t before it arrives at the
// barrier of step t + 1, and nobody writes it again before step t + 2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lane_scan {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Exclusive prefix of `count` over the CTA's threads in thread order; sets
// `total` to the CTA's sum.  Every thread of the CTA must call it.
__device__ __forceinline__ int block_exclusive_scan(int count, int* warp_sums,
                                                    int& total) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int nwarps = blockDim.x >> 5;
  int inc = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, d);
    if (wl >= d) inc += v;
  }
  if (wl == 31) warp_sums[warp] = inc;
  __syncthreads();
  const int wv = wl < nwarps ? warp_sums[wl] : 0;
  int winc = wv;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, winc, d);
    if (wl >= d) winc += v;
  }
  total = __shfl_sync(kFull, winc, 31);
  return __shfl_sync(kFull, winc - wv, warp) + inc - count;
}

// Store a thread's L symbols of one step (packed four to a word) as one
// store of L bytes.
template <int L>
__device__ __forceinline__ void store_symbols(uint8_t* p,
                                              const uint32_t (&w)[(L + 3) / 4]) {
  if constexpr (L == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if constexpr (L == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (L == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (L == 2) {
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  } else {
    *p = static_cast<uint8_t>(w[0]);
  }
}

}  // namespace lane_scan

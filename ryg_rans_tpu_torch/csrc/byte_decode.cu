// BYTE / ALIAS rANS decode (K3) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/byte_tpu.py::_decode_kernel (via decode_blocks),
// which decodes both variants.  Per step and lane, from the u32 state x
// (L = 2^23, rans_byte.h):
//   BYTE:  slot = x & (M-1); sym = cum2sym[slot];
//          x = freq[sym] * (x >> prob_bits) + slot - cum[sym]
//          (rans_byte.h:125-149);
//   ALIAS: bucket = slot >> (prob_bits - 8);
//          h = 2*bucket + (slot < divider[bucket]); sym = sym_id[h];
//          x = freq[h] * (x >> prob_bits) + slot - adjust[h]
//          (RansDecGetAlias, main_alias.cpp:252-267).  adjust may be
//          negative; u32 arithmetic wraps to the right state, as the
//          reference's does.
// Then the lane refills k = (x < 2^23) + (x < 2^15) bytes, most significant
// first: x = x << 8 | byte, k times (the closed form of the loop at
// rans_byte.h:307-318).  The body is ordered step, then lane ascending, then
// the lane's k bytes, so a lane's first byte sits at the block's cursor plus
// the bytes that the lanes before it take this step.
//
// Design: as the WORD decoder (word_decode.cu).  One container block is one
// CTA of min(N, 1024) threads, each owning L = N / threads consecutive lanes
// in registers; the per-step ranks come from a block-wide exclusive scan of
// per-thread byte counts (up to 2 per lane, lane_scan.cuh).  The tables sit
// in dynamic shared memory: BYTE's cum2sym is 2^prob_bits bytes (64 KB at
// prob_bits 16, above the 48 KB of static shared memory), ALIAS's are 7 KB
// whatever prob_bits.  Byte reads are clamped to the block's byte count, so
// a corrupt container decodes to garbage that the CRC rejects and never
// reads past the buffer.
//
// Bound on this card: memory is ~1.5-3 bytes per symbol (1 out, the body
// in), but, as for K1, the per-step dependency chain of one CTA bounds it.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_scan.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr uint32_t kL = 1u << 23;  // rans_byte.h:50

struct Args {
  const uint32_t* x0;       // [n_blocks, n_lanes]
  const uint8_t* data;      // stream buffer
  const int64_t* body_off;  // [n_blocks]
  const int32_t* body_len;  // [n_blocks]
  // BYTE: t0 = cum2sym u8[M], t1 = freq[256], t2 = cum[256], t3 = null.
  // ALIAS: t0 = divider[256], t1 = sym[512], t2 = freq[512],
  // t3 = adjust[512].
  const void* t0;
  const int32_t* t1;
  const int32_t* t2;
  const int32_t* t3;
  uint8_t* out;             // [n_blocks, n_steps * n_lanes]
  int n_lanes, n_steps, prob_bits;
};

template <int L, bool ALIAS>
__global__ void __launch_bounds__(kMaxThreads)
byte_decode_kernel(const Args a) {
  // BYTE:  freq[256] | cum[256] | cum2sym bytes[M]
  // ALIAS: divider[256] | sym[512] | freq[512] | adjust[512]
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_wsum[2][32];  // warp totals, by step parity

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int pb = a.prob_bits;
  const int M = 1 << pb;
  if constexpr (ALIAS) {
    const int32_t* div_g = static_cast<const int32_t*>(a.t0);
    for (int i = tid; i < 256; i += nthreads) smem[i] = div_g[i];
    for (int i = tid; i < 512; i += nthreads) {
      smem[256 + i] = a.t1[i];
      smem[768 + i] = a.t2[i];
      smem[1280 + i] = a.t3[i];
    }
  } else {
    const uint32_t* c2s_g = static_cast<const uint32_t*>(a.t0);
    for (int i = tid; i < 256; i += nthreads) {
      smem[i] = a.t1[i];
      smem[256 + i] = a.t2[i];
    }
    for (int i = tid; i < M / 4; i += nthreads) smem[512 + i] = c2s_g[i];
  }
  const uint32_t* s_div = smem;
  const uint32_t* s_sym = smem + 256;
  const uint32_t* s_afreq = smem + 768;
  const uint32_t* s_adj = smem + 1280;
  const uint32_t* s_freq = smem;
  const uint32_t* s_cum = smem + 256;
  const uint8_t* s_c2s = reinterpret_cast<const uint8_t*>(smem + 512);

  const int b = blockIdx.x;
  const int lane0 = tid * L;
  uint32_t x[L];
  const uint32_t* xb = a.x0 + static_cast<size_t>(b) * a.n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const uint8_t* body = a.data + a.body_off[b];
  const long long blen = a.body_len[b];
  uint8_t* ob = a.out + static_cast<size_t>(b) * a.n_steps * a.n_lanes + lane0;
  const uint32_t mask = static_cast<uint32_t>(M - 1);
  long long cursor = 0;
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    uint32_t ks = 0;  // 2 bits of refill count per lane
    int cnt = 0;
    uint32_t packed[(L + 3) / 4];
#pragma unroll
    for (int k = 0; k < (L + 3) / 4; ++k) packed[k] = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t slot = x[j] & mask;
      uint32_t sym;
      if constexpr (ALIAS) {
        const uint32_t bucket = slot >> (pb - 8);
        const uint32_t h = 2 * bucket + (slot < s_div[bucket] ? 1u : 0u);
        sym = s_sym[h];
        x[j] = s_afreq[h] * (x[j] >> pb) + slot - s_adj[h];
      } else {
        sym = s_c2s[slot];
        x[j] = s_freq[sym] * (x[j] >> pb) + slot - s_cum[sym];
      }
      packed[j >> 2] |= sym << (8 * (j & 3));
      const uint32_t k = (x[j] < kL ? 1u : 0u) + (x[j] < (kL >> 8) ? 1u : 0u);
      ks |= k << (2 * j);
      cnt += static_cast<int>(k);
    }
    lane_scan::store_symbols<L>(ob + static_cast<size_t>(t) * a.n_lanes,
                                packed);

    int total;
    long long pos =
        cursor + lane_scan::block_exclusive_scan(cnt, s_wsum[t & 1], total);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t k = (ks >> (2 * j)) & 3u;
      for (uint32_t r = 0; r < k; ++r) {
        const long long at = pos < blen ? pos : blen - 1;
        const uint32_t byte = blen > 0 ? body[at] : 0u;
        x[j] = (x[j] << 8) | byte;
        ++pos;
      }
    }
    cursor += total;
  }
}

template <int L, bool ALIAS>
int launch(const Args& a, int n_blocks, size_t smem, cudaStream_t stream) {
  const auto kernel = byte_decode_kernel<L, ALIAS>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, a.n_lanes / L, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool ALIAS>
int launch_lanes(const Args& a, int n_blocks, size_t smem,
                 cudaStream_t stream) {
  switch (lane_scan::lanes_per_thread(a.n_lanes)) {
    case 1: return launch<1, ALIAS>(a, n_blocks, smem, stream);
    case 2: return launch<2, ALIAS>(a, n_blocks, smem, stream);
    case 4: return launch<4, ALIAS>(a, n_blocks, smem, stream);
    case 8: return launch<8, ALIAS>(a, n_blocks, smem, stream);
    case 16: return launch<16, ALIAS>(a, n_blocks, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x0: u32 [n_blocks, n_lanes]; data: u8 stream buffer, block b's body being
// data[body_off[b] : body_off[b] + body_len[b]] (int64 / int32 [n_blocks]);
// t0-t3: the variant's tables (see Args); out: u8 [n_blocks, n_steps *
// n_lanes].  n_lanes is a power of two in [128, 16384], prob_bits in
// [9, 16], alias 0 (BYTE) or 1 (ALIAS).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int byte_decode(const void* x0, const void* data,
                           const void* body_off, const void* body_len,
                           const void* t0, const void* t1, const void* t2,
                           const void* t3, void* out, int n_blocks,
                           int n_lanes, int n_steps, int prob_bits, int alias,
                           void* stream) {
  if (prob_bits < 9 || prob_bits > 16 || (alias != 0) != (t3 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint32_t*>(x0),
               static_cast<const uint8_t*>(data),
               static_cast<const int64_t*>(body_off),
               static_cast<const int32_t*>(body_len),
               t0,
               static_cast<const int32_t*>(t1),
               static_cast<const int32_t*>(t2),
               static_cast<const int32_t*>(t3),
               static_cast<uint8_t*>(out),
               n_lanes,
               n_steps,
               prob_bits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alias) return launch_lanes<true>(a, n_blocks, (256 + 3 * 512) * 4, s);
  return launch_lanes<false>(a, n_blocks, 512 * 4 + (size_t{1} << prob_bits),
                             s);
}

extern "C" const char* byte_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// RANS64 rANS decode (K5) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/rans64_tpu.py::_decode_kernel (via
// decode_blocks).  Per step and lane, from the native 64-bit state x
// (L = 2^31, rans64.h): slot = x & (M-1); sym is the symbol with
// cum[sym] <= slot < cum[sym+1]; x = freq[sym] * (x >> prob_bits) + slot -
// cum[sym] (rans64.h:126-133); if x < 2^31 the lane refills one u32 word,
// x = x << 32 | word (rans64.h:134-139).  The symbol comes from a cum2sym
// table up to prob_bits 16 and from an 8-step binary search on cum above
// (a table of 2^31 entries is impossible).  The body is ordered step first,
// then lane ascending, so a refilling lane's word sits at the block's
// cursor plus its exclusive rank among this step's refilling lanes.
//
// Design: as the WORD decoder (word_decode.cu).  One container block is one
// CTA of min(N, 1024) threads, each owning L = N / threads consecutive lanes
// with their states in registers; the ranks come from one block-wide scan
// per step (lane_scan.cuh).  freq, cum and cum2sym sit in dynamic shared
// memory (cum2sym is 64 KB at prob_bits 16, above the 48 KB of static
// shared memory).  Word reads are clamped to the block's word count, so a
// corrupt container decodes to garbage and never reads past the buffer.
//
// Bound on this card: memory is ~1.5-2 bytes per symbol (1 out, the body
// in), but, as for K1, the per-step dependency chain of one CTA bounds it.

#include <cstdint>
#include <cuda_runtime.h>

#include "lane_scan.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr uint64_t kL = 1ull << 31;  // rans64.h:59
constexpr int kCumWords = 260;       // cum[257], padded to 16 bytes

struct Args {
  const uint64_t* x0;       // [n_blocks, n_lanes]
  const uint32_t* words;    // stream buffer
  const int64_t* body_off;  // [n_blocks]
  const int32_t* body_len;  // [n_blocks]
  const uint8_t* c2s;       // [2^prob_bits], or null above prob_bits 16
  const uint32_t* freq;     // [256]
  const uint32_t* cum;      // [257]
  uint8_t* out;             // [n_blocks, n_steps * n_lanes]
  int n_lanes, n_steps, prob_bits;
};

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
rans64_decode_kernel(const Args a) {
  // freq[256] | cum[kCumWords] | cum2sym bytes[M] (when a.c2s)
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_wsum[2][32];  // warp totals, by step parity

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int pb = a.prob_bits;
  uint32_t* s_freq = smem;
  uint32_t* s_cum = smem + 256;
  uint32_t* s_c2s_words = smem + 256 + kCumWords;
  for (int i = tid; i < 256; i += nthreads) s_freq[i] = a.freq[i];
  for (int i = tid; i < 257; i += nthreads) s_cum[i] = a.cum[i];
  const bool table = a.c2s != nullptr;
  if (table) {
    const uint32_t* c2s_g = reinterpret_cast<const uint32_t*>(a.c2s);
    for (int i = tid; i < (1 << pb) / 4; i += nthreads)
      s_c2s_words[i] = c2s_g[i];
  }
  const uint8_t* s_c2s = reinterpret_cast<const uint8_t*>(s_c2s_words);

  const int b = blockIdx.x;
  const int lane0 = tid * L;
  uint64_t x[L];
  const uint64_t* xb = a.x0 + static_cast<size_t>(b) * a.n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const uint32_t* body = a.words + a.body_off[b];
  const long long blen = a.body_len[b];
  uint8_t* ob = a.out + static_cast<size_t>(b) * a.n_steps * a.n_lanes + lane0;
  const uint64_t mask = (1ull << pb) - 1;
  long long cursor = 0;
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    uint32_t need = 0;
    uint32_t packed[(L + 3) / 4];
#pragma unroll
    for (int k = 0; k < (L + 3) / 4; ++k) packed[k] = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t slot = static_cast<uint32_t>(x[j] & mask);
      uint32_t sym;
      if (table) {
        sym = s_c2s[slot];
      } else {
        // the largest sym in [0, 255] with cum[sym] <= slot: a symbol of
        // freq 0 is never it, since cum[sym + 1] would qualify too
        sym = 0;
#pragma unroll
        for (uint32_t step = 128; step; step >>= 1)
          if (s_cum[sym + step] <= slot) sym += step;
      }
      x[j] = static_cast<uint64_t>(s_freq[sym]) * (x[j] >> pb) +
             (slot - s_cum[sym]);
      packed[j >> 2] |= sym << (8 * (j & 3));
      need |= static_cast<uint32_t>(x[j] < kL) << j;
    }
    lane_scan::store_symbols<L>(ob + static_cast<size_t>(t) * a.n_lanes,
                                packed);

    int total;
    long long pos = cursor + lane_scan::block_exclusive_scan(
                                 __popc(need), s_wsum[t & 1], total);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if ((need >> j) & 1u) {
        const long long at = pos < blen ? pos : blen - 1;
        const uint64_t w = blen > 0 ? body[at] : 0u;
        x[j] = (x[j] << 32) | w;
        ++pos;
      }
    }
    cursor += total;
  }
}

template <int L>
int launch(const Args& a, int n_blocks, size_t smem, cudaStream_t stream) {
  const auto kernel = rans64_decode_kernel<L>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<n_blocks, a.n_lanes / L, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0: u64 [n_blocks, n_lanes]; words: u32 stream buffer, block b's body
// being words[body_off[b] : body_off[b] + body_len[b]] (int64 / int32
// [n_blocks]); c2s: u8 [2^prob_bits] for prob_bits <= 16, else null; freq:
// u32 [256]; cum: u32 [257]; out: u8 [n_blocks, n_steps * n_lanes].
// n_lanes is a power of two in [128, 16384] and prob_bits in [9, 31].
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape it does not take.
extern "C" int rans64_decode(const void* x0, const void* words,
                             const void* body_off, const void* body_len,
                             const void* c2s, const void* freq,
                             const void* cum, void* out, int n_blocks,
                             int n_lanes, int n_steps, int prob_bits,
                             void* stream) {
  if (prob_bits < 9 || prob_bits > 31 || (c2s != nullptr) != (prob_bits <= 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint64_t*>(x0),
               static_cast<const uint32_t*>(words),
               static_cast<const int64_t*>(body_off),
               static_cast<const int32_t*>(body_len),
               static_cast<const uint8_t*>(c2s),
               static_cast<const uint32_t*>(freq),
               static_cast<const uint32_t*>(cum),
               static_cast<uint8_t*>(out),
               n_lanes,
               n_steps,
               prob_bits};
  const size_t smem = (256 + kCumWords) * 4 +
                      (c2s ? size_t{1} << prob_bits : size_t{0});
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lane_scan::lanes_per_thread(n_lanes)) {
    case 1: return launch<1>(a, n_blocks, smem, s);
    case 2: return launch<2>(a, n_blocks, smem, s);
    case 4: return launch<4>(a, n_blocks, smem, s);
    case 8: return launch<8>(a, n_blocks, smem, s);
    case 16: return launch<16>(a, n_blocks, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* rans64_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// WORD rANS decode (K1) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/word_tpu.py::_decode_kernel (via decode_blocks).
// Per step and lane: slot = x & (M-1) -> (sym, freq, cum) through a cum2sym
// table in shared memory; x = freq * (x >> prob_bits) + slot - cum
// (rans_word_sse41.h:126); if x < 2^16 the lane refills one u16 word,
// x = x << 16 | word.  The stream body is ordered step first, then lane
// ascending, across the whole block (docs/FORMAT.md), so a refilling lane's
// word sits at the block's stream cursor plus its exclusive rank among this
// step's refilling lanes.
//
// Design: one container block is one CTA of min(N, 1024) threads, and each
// thread owns L = N / threads consecutive lanes (16 at N = 16384) with
// their states in registers.  Ranks then follow from one block-wide scan
// per step: per-thread popcount of its refilling lanes, a warp shuffle
// scan, and one shared array of warp totals (double-buffered by step
// parity, so one barrier per step suffices).  A thread writes its L
// symbols of a step as one L-byte store.  Word reads are clamped to the
// block's word count, so a corrupt container decodes to garbage that the
// CRC rejects and never reads past the buffer.
//
// Bound on this card: memory is ~1.3-2 bytes per symbol (1 out, the body
// in), but the kernel is held back by the per-step dependency chain and by
// parallelism: a block's steps are sequential and a block is one CTA, so a
// container of few blocks occupies few of the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxProbBits = 15;
constexpr unsigned kFull = 0xFFFFFFFFu;

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

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
word_decode_kernel(const uint32_t* __restrict__ x0,
                   const uint16_t* __restrict__ words,
                   const int64_t* __restrict__ body_off,
                   const int32_t* __restrict__ body_len,
                   const uint8_t* __restrict__ c2s_g,
                   const int32_t* __restrict__ freq_g,
                   const int32_t* __restrict__ cum_g,
                   uint8_t* __restrict__ out,
                   int n_lanes, int n_steps, int prob_bits) {
  __shared__ __align__(16) uint8_t s_c2s[1 << kMaxProbBits];
  __shared__ uint32_t s_fc[256];        // freq << 16 | cum
  __shared__ int s_wsum[2][32];         // warp totals, by step parity

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int M = 1 << prob_bits;
  for (int i = tid; i < M / 4; i += nthreads)
    reinterpret_cast<uint32_t*>(s_c2s)[i] =
        reinterpret_cast<const uint32_t*>(c2s_g)[i];
  for (int i = tid; i < 256; i += nthreads)
    s_fc[i] = (static_cast<uint32_t>(freq_g[i]) << 16) |
              static_cast<uint32_t>(cum_g[i]);

  const int b = blockIdx.x;
  const int lane0 = tid * L;
  uint32_t x[L];
  const uint32_t* xb = x0 + static_cast<size_t>(b) * n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const uint16_t* body = words + body_off[b];
  const long long blen = body_len[b];
  uint8_t* ob = out + static_cast<size_t>(b) * n_steps * n_lanes + lane0;
  const uint32_t mask = static_cast<uint32_t>(M - 1);
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int nwarps = nthreads >> 5;
  long long cursor = 0;
  __syncthreads();

  for (int t = 0; t < n_steps; ++t) {
    uint32_t need = 0;
    uint32_t packed[(L + 3) / 4];
#pragma unroll
    for (int k = 0; k < (L + 3) / 4; ++k) packed[k] = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t slot = x[j] & mask;
      const uint32_t sym = s_c2s[slot];
      const uint32_t fc = s_fc[sym];
      x[j] = (fc >> 16) * (x[j] >> prob_bits) + slot - (fc & 0xFFFFu);
      packed[j >> 2] |= sym << (8 * (j & 3));
      need |= static_cast<uint32_t>(x[j] < 0x10000u) << j;
    }
    store_symbols<L>(ob + static_cast<size_t>(t) * n_lanes, packed);

    // block-wide exclusive rank of this thread's first refilling lane
    const int cnt = __popc(need);
    int inc = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, d);
      if (wl >= d) inc += v;
    }
    int* ws = s_wsum[t & 1];
    if (wl == 31) ws[warp] = inc;
    __syncthreads();
    const int wv = wl < nwarps ? ws[wl] : 0;
    int winc = wv;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, winc, d);
      if (wl >= d) winc += v;
    }
    const int warp_excl = __shfl_sync(kFull, winc - wv, warp);
    const int total = __shfl_sync(kFull, winc, 31);

    long long pos = cursor + warp_excl + (inc - cnt);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if ((need >> j) & 1u) {
        const long long at = pos < blen ? pos : blen - 1;
        const uint32_t w = blen > 0 ? body[at] : 0u;
        x[j] = (x[j] << 16) | w;
        ++pos;
      }
    }
    cursor += total;
  }
}

template <int L>
int launch(const void* x0, const void* words, const void* body_off,
           const void* body_len, const void* c2s, const void* freq,
           const void* cum, void* out, int n_blocks, int n_lanes,
           int n_steps, int prob_bits, cudaStream_t stream) {
  word_decode_kernel<L><<<n_blocks, n_lanes / L, 0, stream>>>(
      static_cast<const uint32_t*>(x0), static_cast<const uint16_t*>(words),
      static_cast<const int64_t*>(body_off),
      static_cast<const int32_t*>(body_len),
      static_cast<const uint8_t*>(c2s), static_cast<const int32_t*>(freq),
      static_cast<const int32_t*>(cum), static_cast<uint8_t*>(out), n_lanes,
      n_steps, prob_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x0: u32 [n_blocks, n_lanes]; words: u16 stream buffer; block b's body is
// words[body_off[b] : body_off[b] + body_len[b]] (int64 / int32 [n_blocks]);
// c2s: uint8 [2^prob_bits]; freq, cum: int32 [256];
// out: uint8 [n_blocks, n_steps * n_lanes].  n_lanes is a power of two in
// [128, 16384] and prob_bits in [9, 15].  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int word_decode(const void* x0, const void* words,
                           const void* body_off, const void* body_len,
                           const void* c2s, const void* freq, const void* cum,
                           void* out, int n_blocks, int n_lanes, int n_steps,
                           int prob_bits, void* stream) {
  if (prob_bits < 9 || prob_bits > kMaxProbBits)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_lanes) {
    case 128: case 256: case 512: case 1024:
      return launch<1>(x0, words, body_off, body_len, c2s, freq, cum, out,
                       n_blocks, n_lanes, n_steps, prob_bits, s);
    case 2048:
      return launch<2>(x0, words, body_off, body_len, c2s, freq, cum, out,
                       n_blocks, n_lanes, n_steps, prob_bits, s);
    case 4096:
      return launch<4>(x0, words, body_off, body_len, c2s, freq, cum, out,
                       n_blocks, n_lanes, n_steps, prob_bits, s);
    case 8192:
      return launch<8>(x0, words, body_off, body_len, c2s, freq, cum, out,
                       n_blocks, n_lanes, n_steps, prob_bits, s);
    case 16384:
      return launch<16>(x0, words, body_off, body_len, c2s, freq, cum, out,
                        n_blocks, n_lanes, n_steps, prob_bits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* word_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

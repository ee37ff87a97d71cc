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
// Design: one container block is one thread-block cluster of C CTAs, as in
// K3 (byte_decode.cu, cluster_stream.cuh; the plan comes from
// ops/decode_plan.py).  CTA rank r owns lanes [r N / C, (r + 1) N / C),
// each thread L consecutive lanes with their states in registers.  Per step
// a CTA ranks its refilling lanes (one popcount per thread, a CTA-wide scan,
// lane_scan.cuh), posts its total, tagged with the step, to every CTA of
// the cluster through distributed shared memory, collects the totals of the
// lower ranks, and refills from the block's body, which each CTA stages
// ahead of use in a ring of 2.25 windows of N words in dynamic shared
// memory (cp.async).  freq, cum and cum2sym sit in dynamic shared memory
// after the ring.  Word reads are clamped to the block's word count, so a
// corrupt container decodes to garbage and never reads past the body.
//
// Bound on this card: memory is ~1.5-2 bytes per symbol (1 out, the body
// in), but the per-step dependency chain (lane update, CTA scan, exchange
// among the cluster's CTAs, refill) bounds it; the cluster cuts each CTA's
// lanes by C and the ring takes the body's device-memory latency off that
// chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_stream.cuh"
#include "lane_scan.cuh"

namespace {

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
  int ring_bytes, chunk_shift;  // the stream ring: 9 chunks of 2^shift words
};

template <int L>
__global__ void __launch_bounds__(cluster_stream::kMaxThreads)
rans64_decode_kernel(const Args a) {
  // ring[ring_bytes] | freq[256] | cum[kCumWords] | cum2sym bytes[M]
  // (when a.c2s)
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int s_wsum[2][32];  // warp totals, by step parity
  // CTA totals, tagged with the step, by step parity
  __shared__ unsigned long long s_tot[2][cluster_stream::kMaxCluster];

  cluster_stream::cg::cluster_group cluster =
      cluster_stream::cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int pb = a.prob_bits;
  uint32_t* s_freq = smem + a.ring_bytes / 4;
  uint32_t* s_cum = s_freq + 256;
  uint32_t* s_c2s_words = s_cum + kCumWords;
  for (int i = tid; i < 256; i += nthreads) s_freq[i] = a.freq[i];
  for (int i = tid; i < 257; i += nthreads) s_cum[i] = a.cum[i];
  const bool table = a.c2s != nullptr;
  if (table) {
    const uint32_t* c2s_g = reinterpret_cast<const uint32_t*>(a.c2s);
    for (int i = tid; i < (1 << pb) / 4; i += nthreads)
      s_c2s_words[i] = c2s_g[i];
  }
  const uint8_t* s_c2s = reinterpret_cast<const uint8_t*>(s_c2s_words);

  const int b = blockIdx.x / csize;
  const int lane0 = rank * (a.n_lanes / csize) + tid * L;
  uint64_t x[L];
  const uint64_t* xb = a.x0 + static_cast<size_t>(b) * a.n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const long long blen = a.body_len[b];
  cluster_stream::Ring<uint32_t> ring;
  ring.init(smem, a.words + a.body_off[b], blen, a.chunk_shift, a.n_lanes);
  const cluster_stream::Exchange ex{s_tot, rank, csize};
  ex.init();
  uint8_t* ob = a.out + static_cast<size_t>(b) * a.n_steps * a.n_lanes + lane0;
  const uint64_t mask = (1ull << pb) - 1;
  long long cursor = 0;
  cluster.sync();  // tables loaded; every CTA's slots exist

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

    ring.wait_for(cursor);  // this step's words
    int total;
    const int local =
        lane_scan::block_exclusive_scan(__popc(need), s_wsum[t & 1], total);
    ring.request_ahead(cursor);
    ex.post(total, t);
    lane_scan::store_symbols<L>(ob + static_cast<size_t>(t) * a.n_lanes,
                                packed);
    int sum;
    uint32_t p = ring.position(cursor + ex.collect(t, sum) + local);
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t refill = (need >> j) & 1u;
      const uint64_t w = ring.unit(p);
      if (refill) x[j] = (x[j] << 32) | w;
      p += refill;
    }
    cursor += sum;
  }
  ring.wait_all();  // no copy may land after the CTA exits
  cluster.sync();  // nor may a peer still write its slots
}

// Check the launch plan against the shape, then launch (or, with
// max_clusters, report the plan's cudaOccupancyMaxActiveClusters).
int dispatch(Args a, int n_blocks, int cluster, int threads, int chunk_bytes,
             int smem_bytes, cudaStream_t stream, int* max_clusters) {
  const int L = cluster_stream::lanes_per_thread(
      a.n_lanes, cluster, threads, 4LL * a.n_lanes, chunk_bytes);
  const long long tables = (256 + kCumWords) * 4 +
                           (a.prob_bits <= 16 ? 1LL << a.prob_bits : 0);
  const long long ring = cluster_stream::kRingChunks * 1LL * chunk_bytes;
  if (a.prob_bits < 9 || a.prob_bits > 31 || L == 0 ||
      ring + tables > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  a.ring_bytes = static_cast<int>(ring);
  a.chunk_shift = __builtin_ctz(static_cast<unsigned>(chunk_bytes / 4));
  const cluster_stream::Launch l{n_blocks, cluster, threads,
                                 static_cast<size_t>(smem_bytes), stream,
                                 max_clusters};
  using cluster_stream::launch_clusters;
  switch (L) {
    case 1: return launch_clusters(rans64_decode_kernel<1>, a, l);
    case 2: return launch_clusters(rans64_decode_kernel<2>, a, l);
    case 4: return launch_clusters(rans64_decode_kernel<4>, a, l);
    case 8: return launch_clusters(rans64_decode_kernel<8>, a, l);
    default: return launch_clusters(rans64_decode_kernel<16>, a, l);
  }
}

}  // namespace

// x0: u64 [n_blocks, n_lanes]; words: u32 stream buffer, block b's body
// being words[body_off[b] : body_off[b] + body_len[b]] (int64 / int32
// [n_blocks]); c2s: u8 [2^prob_bits] for prob_bits <= 16, else null; freq:
// u32 [256]; cum: u32 [257]; out: u8 [n_blocks, n_steps * n_lanes].
// n_lanes is a power of two in [128, 16384] and prob_bits in [9, 31].  The
// launch plan (ops/decode_plan.py): `cluster` CTAs of `threads` threads per
// block, a ring of 9 chunks of `chunk_bytes` (n_lanes words / 4) and
// `smem_bytes` of dynamic shared memory.  Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for a shape or plan it does not take,
// or cudaErrorLaunchOutOfResources when no cluster of the plan fits.
extern "C" int rans64_decode(const void* x0, const void* words,
                             const void* body_off, const void* body_len,
                             const void* c2s, const void* freq,
                             const void* cum, void* out, int n_blocks,
                             int n_lanes, int n_steps, int prob_bits,
                             int cluster, int threads, int chunk_bytes,
                             int smem_bytes, void* stream) {
  if ((c2s != nullptr) != (prob_bits <= 16))
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
               prob_bits,
               0,
               0};
  return dispatch(a, n_blocks, cluster, threads, chunk_bytes, smem_bytes,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The plan's cudaOccupancyMaxActiveClusters, written to *max_clusters;
// launches nothing.  Arguments as for rans64_decode.
extern "C" int rans64_decode_occupancy(int n_lanes, int prob_bits,
                                       int cluster, int threads,
                                       int chunk_bytes, int smem_bytes,
                                       int* max_clusters) {
  Args a{};
  a.n_lanes = n_lanes;
  a.prob_bits = prob_bits;
  return dispatch(a, 1, cluster, threads, chunk_bytes, smem_bytes, nullptr,
                  max_clusters);
}

extern "C" const char* rans64_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

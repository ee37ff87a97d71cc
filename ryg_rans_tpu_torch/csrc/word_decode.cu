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
// Design: one container block is one thread-block cluster of C CTAs, as in
// K3 and K5 (cluster_stream.cuh; C, the threads per CTA and the ring come
// from the launch plan of ops/decode_plan.py).  CTA rank r owns lanes
// [r N / C, (r + 1) N / C), each of its threads L consecutive lanes with
// their states in registers.  Per step a CTA ranks its refilling lanes (one
// popcount per thread, a CTA-wide scan, lane_scan.cuh), posts its total,
// tagged with the step, to every CTA of the cluster through distributed
// shared memory, stores the step's symbols, collects the totals of the
// lower ranks, and refills from the block's body, which each CTA stages
// ahead of use in a ring of 2.25 windows of N words in dynamic shared
// memory (cp.async).  freq << 16 | cum and cum2sym sit in dynamic shared
// memory after the ring.  Word reads are clamped to the block's word count,
// so a corrupt container decodes to garbage that the CRC rejects and never
// reads past the body.
//
// Bound on this card: memory is ~1.3-2 bytes per symbol (1 out, the body
// in), but the per-step dependency chain (lane update, CTA scan, exchange
// among the cluster's CTAs, refill) bounds it; the cluster cuts each CTA's
// lanes by C and the ring takes the body's device-memory latency off that
// chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_stream.cuh"
#include "lane_scan.cuh"

namespace {

constexpr int kMaxProbBits = 15;

struct Args {
  const uint32_t* x0;       // [n_blocks, n_lanes]
  const uint16_t* words;    // stream buffer
  const int64_t* body_off;  // [n_blocks]
  const int32_t* body_len;  // [n_blocks]
  const uint8_t* c2s;       // [2^prob_bits]
  const int32_t* freq;      // [256]
  const int32_t* cum;       // [256]
  uint8_t* out;             // [n_blocks, n_steps * n_lanes]
  int n_lanes, n_steps, prob_bits;
  int ring_bytes, chunk_shift;  // the stream ring: 9 chunks of 2^shift words
};

template <int L>
__global__ void __launch_bounds__(cluster_stream::kMaxThreads)
word_decode_kernel(const Args a) {
  // ring[ring_bytes] | freq << 16 | cum [256] | cum2sym bytes[M]
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
  uint32_t* s_fc = smem + a.ring_bytes / 4;
  uint32_t* s_c2s_words = s_fc + 256;
  for (int i = tid; i < 256; i += nthreads)
    s_fc[i] = (static_cast<uint32_t>(a.freq[i]) << 16) |
              static_cast<uint32_t>(a.cum[i]);
  const uint32_t* c2s_g = reinterpret_cast<const uint32_t*>(a.c2s);
  for (int i = tid; i < (1 << pb) / 4; i += nthreads)
    s_c2s_words[i] = c2s_g[i];
  const uint8_t* s_c2s = reinterpret_cast<const uint8_t*>(s_c2s_words);

  const int b = blockIdx.x / csize;
  const int lane0 = rank * (a.n_lanes / csize) + tid * L;
  uint32_t x[L];
  const uint32_t* xb = a.x0 + static_cast<size_t>(b) * a.n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const long long blen = a.body_len[b];
  cluster_stream::Ring<uint16_t> ring;
  ring.init(reinterpret_cast<uint16_t*>(smem), a.words + a.body_off[b], blen,
            a.chunk_shift, a.n_lanes);
  const cluster_stream::Exchange ex{s_tot, rank, csize};
  ex.init();
  uint8_t* ob = a.out + static_cast<size_t>(b) * a.n_steps * a.n_lanes + lane0;
  const uint32_t mask = (1u << pb) - 1;
  long long cursor = 0;
  cluster.sync();  // tables loaded; every CTA's slots exist

  for (int t = 0; t < a.n_steps; ++t) {
    uint32_t need = 0;
    uint32_t packed[(L + 3) / 4];
#pragma unroll
    for (int k = 0; k < (L + 3) / 4; ++k) packed[k] = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t slot = x[j] & mask;
      const uint32_t sym = s_c2s[slot];
      const uint32_t fc = s_fc[sym];
      x[j] = (fc >> 16) * (x[j] >> pb) + slot - (fc & 0xFFFFu);
      packed[j >> 2] |= sym << (8 * (j & 3));
      need |= static_cast<uint32_t>(x[j] < 0x10000u) << j;
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
      const uint32_t w = ring.unit(p);
      if (refill) x[j] = (x[j] << 16) | w;
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
      a.n_lanes, cluster, threads, 2LL * a.n_lanes, chunk_bytes);
  const long long tables = 256 * 4 + (1LL << a.prob_bits);
  const long long ring = cluster_stream::kRingChunks * 1LL * chunk_bytes;
  if (a.prob_bits < 9 || a.prob_bits > kMaxProbBits || L == 0 ||
      ring + tables > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  a.ring_bytes = static_cast<int>(ring);
  a.chunk_shift = __builtin_ctz(static_cast<unsigned>(chunk_bytes / 2));
  const cluster_stream::Launch l{n_blocks, cluster, threads,
                                 static_cast<size_t>(smem_bytes), stream,
                                 max_clusters};
  using cluster_stream::launch_clusters;
  switch (L) {
    case 1: return launch_clusters(word_decode_kernel<1>, a, l);
    case 2: return launch_clusters(word_decode_kernel<2>, a, l);
    case 4: return launch_clusters(word_decode_kernel<4>, a, l);
    case 8: return launch_clusters(word_decode_kernel<8>, a, l);
    default: return launch_clusters(word_decode_kernel<16>, a, l);
  }
}

}  // namespace

// x0: u32 [n_blocks, n_lanes]; words: u16 stream buffer, block b's body
// being words[body_off[b] : body_off[b] + body_len[b]] (int64 / int32
// [n_blocks]); c2s: uint8 [2^prob_bits]; freq, cum: int32 [256]; out: uint8
// [n_blocks, n_steps * n_lanes].  n_lanes is a power of two in [128, 16384]
// and prob_bits in [9, 15].  The launch plan (ops/decode_plan.py): `cluster`
// CTAs of `threads` threads per block, a ring of 9 chunks of `chunk_bytes`
// (n_lanes words / 4) and `smem_bytes` of dynamic shared memory.  Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a shape or
// plan it does not take, or cudaErrorLaunchOutOfResources when no cluster
// of the plan fits on the card.
extern "C" int word_decode(const void* x0, const void* words,
                           const void* body_off, const void* body_len,
                           const void* c2s, const void* freq, const void* cum,
                           void* out, int n_blocks, int n_lanes, int n_steps,
                           int prob_bits, int cluster, int threads,
                           int chunk_bytes, int smem_bytes, void* stream) {
  const Args a{static_cast<const uint32_t*>(x0),
               static_cast<const uint16_t*>(words),
               static_cast<const int64_t*>(body_off),
               static_cast<const int32_t*>(body_len),
               static_cast<const uint8_t*>(c2s),
               static_cast<const int32_t*>(freq),
               static_cast<const int32_t*>(cum),
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
// launches nothing.  Arguments as for word_decode.
extern "C" int word_decode_occupancy(int n_lanes, int prob_bits, int cluster,
                                     int threads, int chunk_bytes,
                                     int smem_bytes, int* max_clusters) {
  Args a{};
  a.n_lanes = n_lanes;
  a.prob_bits = prob_bits;
  return dispatch(a, 1, cluster, threads, chunk_bytes, smem_bytes, nullptr,
                  max_clusters);
}

extern "C" const char* word_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
// Design: one container block is one thread-block cluster of C CTAs
// (cluster_stream.cuh; C, the threads per CTA and the ring come from the
// launch plan of ops/decode_plan.py).  CTA rank r owns lanes
// [r N / C, (r + 1) N / C), each of its threads L consecutive lanes in
// registers.  Per step a CTA ranks its threads' byte counts (up to 2 per
// lane) with a CTA-wide scan (lane_scan.cuh), posts its total, tagged with
// the step, to every CTA of the cluster through distributed shared memory,
// stores the step's symbols, collects the totals of the lower ranks, and
// refills from the block's body, which each CTA stages ahead of use in a
// ring of 2.25 windows of 2N bytes in dynamic shared memory (cp.async).
// The tables sit in dynamic shared memory after the ring: BYTE's cum2sym
// is 2^prob_bits bytes, ALIAS's are 7 KB whatever prob_bits.  Byte reads
// are clamped to the block's byte count, so a corrupt container decodes to
// garbage that the CRC rejects and never reads past the body (the last
// copy of a body is zero-filled past its end).
//
// Bound on this card: memory is ~1.5-3 bytes per symbol (1 out, the body
// in), but the per-step dependency chain (lane update, CTA scan, exchange
// among the cluster's CTAs, refill) bounds it; the cluster cuts each CTA's
// lanes by C and the ring takes the body's device-memory latency off that
// chain.

#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_stream.cuh"
#include "lane_scan.cuh"

namespace {

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
  int ring_bytes, chunk_shift;  // the stream ring: 9 chunks of 2^shift B
};

template <int L, bool ALIAS>
__global__ void __launch_bounds__(cluster_stream::kMaxThreads)
byte_decode_kernel(const Args a) {
  // ring[ring_bytes] | BYTE:  freq[256] | cum[256] | cum2sym bytes[M]
  //                  | ALIAS: divider[256] | sym[512] | freq[512] | adjust[512]
  extern __shared__ __align__(16) uint8_t smem[];
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
  const int M = 1 << pb;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + a.ring_bytes);
  if constexpr (ALIAS) {
    const int32_t* div_g = static_cast<const int32_t*>(a.t0);
    for (int i = tid; i < 256; i += nthreads) tab[i] = div_g[i];
    for (int i = tid; i < 512; i += nthreads) {
      tab[256 + i] = a.t1[i];
      tab[768 + i] = a.t2[i];
      tab[1280 + i] = a.t3[i];
    }
  } else {
    const uint32_t* c2s_g = static_cast<const uint32_t*>(a.t0);
    for (int i = tid; i < 256; i += nthreads) {
      tab[i] = a.t1[i];
      tab[256 + i] = a.t2[i];
    }
    for (int i = tid; i < M / 4; i += nthreads) tab[512 + i] = c2s_g[i];
  }
  const uint32_t* s_div = tab;
  const uint32_t* s_sym = tab + 256;
  const uint32_t* s_afreq = tab + 768;
  const uint32_t* s_adj = tab + 1280;
  const uint32_t* s_freq = tab;
  const uint32_t* s_cum = tab + 256;
  const uint8_t* s_c2s = reinterpret_cast<const uint8_t*>(tab + 512);

  const int b = blockIdx.x / csize;
  const int lane0 = rank * (a.n_lanes / csize) + tid * L;
  uint32_t x[L];
  const uint32_t* xb = a.x0 + static_cast<size_t>(b) * a.n_lanes + lane0;
#pragma unroll
  for (int j = 0; j < L; ++j) x[j] = xb[j];
  const long long blen = a.body_len[b];
  cluster_stream::Ring<uint8_t> ring;
  ring.init(smem, a.data + a.body_off[b], blen, a.chunk_shift,
            2LL * a.n_lanes);
  const cluster_stream::Exchange ex{s_tot, rank, csize};
  ex.init();
  uint8_t* ob = a.out + static_cast<size_t>(b) * a.n_steps * a.n_lanes + lane0;
  const uint32_t mask = static_cast<uint32_t>(M - 1);
  long long cursor = 0;
  cluster.sync();  // tables loaded; every CTA's slots exist

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

    ring.wait_for(cursor);  // this step's bytes
    int total;
    const int local =
        lane_scan::block_exclusive_scan(cnt, s_wsum[t & 1], total);
    ring.request_ahead(cursor);
    ex.post(total, t);
    lane_scan::store_symbols<L>(ob + static_cast<size_t>(t) * a.n_lanes,
                                packed);
    int sum;
    uint32_t p = ring.position(cursor + ex.collect(t, sum) + local);
    // both candidate bytes, then select: the warp runs every path anyway
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t k = (ks >> (2 * j)) & 3u;
      const uint32_t b0 = ring.unit(p);
      const uint32_t b1 = ring.unit(p + 1);
      x[j] = k == 2 ? (x[j] << 16) | (b0 << 8) | b1
                    : (k == 1 ? (x[j] << 8) | b0 : x[j]);
      p += k;
    }
    cursor += sum;
  }
  ring.wait_all();  // no copy may land after the CTA exits
  cluster.sync();  // nor may a peer still write its slots
}

template <bool ALIAS>
int launch_lanes(const Args& a, int L, const cluster_stream::Launch& l) {
  using cluster_stream::launch_clusters;
  switch (L) {
    case 1: return launch_clusters(byte_decode_kernel<1, ALIAS>, a, l);
    case 2: return launch_clusters(byte_decode_kernel<2, ALIAS>, a, l);
    case 4: return launch_clusters(byte_decode_kernel<4, ALIAS>, a, l);
    case 8: return launch_clusters(byte_decode_kernel<8, ALIAS>, a, l);
    default: return launch_clusters(byte_decode_kernel<16, ALIAS>, a, l);
  }
}

// Check the launch plan against the shape, then launch (or, with
// max_clusters, report the plan's cudaOccupancyMaxActiveClusters).
int dispatch(Args a, int n_blocks, int alias, int cluster, int threads,
             int chunk_bytes, int smem_bytes, cudaStream_t stream,
             int* max_clusters) {
  const int L = cluster_stream::lanes_per_thread(
      a.n_lanes, cluster, threads, 2LL * a.n_lanes, chunk_bytes);
  const long long tables = alias ? (256 + 3 * 512) * 4
                                 : 512 * 4 + (1LL << a.prob_bits);
  const long long ring = cluster_stream::kRingChunks * 1LL * chunk_bytes;
  if (a.prob_bits < 9 || a.prob_bits > 16 || L == 0 ||
      ring + tables > smem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  a.ring_bytes = static_cast<int>(ring);
  a.chunk_shift = __builtin_ctz(static_cast<unsigned>(chunk_bytes));
  const cluster_stream::Launch l{n_blocks, cluster, threads,
                                 static_cast<size_t>(smem_bytes), stream,
                                 max_clusters};
  return alias ? launch_lanes<true>(a, L, l) : launch_lanes<false>(a, L, l);
}

}  // namespace

// x0: u32 [n_blocks, n_lanes]; data: u8 stream buffer, block b's body being
// data[body_off[b] : body_off[b] + body_len[b]] (int64 / int32 [n_blocks]);
// t0-t3: the variant's tables (see Args); out: u8 [n_blocks, n_steps *
// n_lanes].  n_lanes is a power of two in [128, 16384], prob_bits in
// [9, 16], alias 0 (BYTE) or 1 (ALIAS).  The launch plan (ops/decode_plan.py):
// `cluster` CTAs of `threads` threads per block, a ring of 9 chunks of
// `chunk_bytes` (n_lanes / 2) and `smem_bytes` of dynamic shared memory.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// shape or plan it does not take, or cudaErrorLaunchOutOfResources when no
// cluster of the plan fits on the card.
extern "C" int byte_decode(const void* x0, const void* data,
                           const void* body_off, const void* body_len,
                           const void* t0, const void* t1, const void* t2,
                           const void* t3, void* out, int n_blocks,
                           int n_lanes, int n_steps, int prob_bits, int alias,
                           int cluster, int threads, int chunk_bytes,
                           int smem_bytes, void* stream) {
  if ((alias != 0) != (t3 != nullptr))
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
               prob_bits,
               0,
               0};
  return dispatch(a, n_blocks, alias, cluster, threads, chunk_bytes,
                  smem_bytes, static_cast<cudaStream_t>(stream), nullptr);
}

// The plan's cudaOccupancyMaxActiveClusters, written to *max_clusters;
// launches nothing.  Arguments as for byte_decode.
extern "C" int byte_decode_occupancy(int n_lanes, int prob_bits, int alias,
                                     int cluster, int threads,
                                     int chunk_bytes, int smem_bytes,
                                     int* max_clusters) {
  Args a{};
  a.n_lanes = n_lanes;
  a.prob_bits = prob_bits;
  return dispatch(a, 1, alias, cluster, threads, chunk_bytes, smem_bytes,
                  nullptr, max_clusters);
}

extern "C" const char* byte_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

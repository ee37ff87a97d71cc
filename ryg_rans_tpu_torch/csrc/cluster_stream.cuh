// One container block per thread-block cluster: the pieces shared by the
// WORD (K1), BYTE/ALIAS (K3) and RANS64 (K5) decoders.
//
// A block's N lanes are split over a cluster of C CTAs; CTA rank r owns
// lanes [r N / C, (r + 1) N / C), so rank order is the format's lane order
// (docs/FORMAT.md).  Each step a CTA ranks its own refills with
// lane_scan::block_exclusive_scan, then posts its total, tagged with the
// step, to every CTA of the cluster through distributed shared memory (one
// slot per rank, by step parity), stores the step's symbols, and polls its
// own slots until every rank has posted; a CTA's first refill unit then
// sits at cursor + the totals of the lower ranks, and the cursor advances
// by the cluster's sum.  No cluster barrier runs per step: the tag is the
// only ordering the exchange needs.  The parity argument of lane_scan.cuh
// holds for the slots: every warp of a CTA reads its step-t slots before
// the CTA's scan barrier of step t + 1, after which it posts step t + 1;
// no peer can post step t + 2 (into the step-t slots) before it has that.
// Cluster barriers run only at the start (every CTA's slots exist) and at
// the end (no CTA exits while a peer may still write to it).
//
// The block's stream is staged in shared memory ahead of its use.  One
// step consumes at most `window` units (bytes, u16 or u32 words), all of
// them in [cursor, cursor + window).  Each CTA keeps a ring of kRingChunks = 9
// chunks of window / 4 units (2.25 windows) and, right after the scan's
// barrier of each step, requests with cp.async (16 bytes a piece,
// zero-filled past the body) every chunk up to 9 after the one that holds
// the cursor: all the ring can take, which always covers the next step's
// reads (cursor + 2 window) and, at a typical consumption well under a
// window, several steps more.  A new chunk reuses the slot of the chunk 9
// before it, which lies wholly below the cursor: its last reads were in an
// earlier step, before that barrier.  A thread waits for its own copies of
// the chunks a step reads before that step's barrier, which publishes them
// to the CTA; the copies requested one step earlier may stay in flight
// when the step needs none of them.  Reads clamp as the plain versions do:
// a position at or past the body's end reads its last unit (an empty body
// reads a zero that the CTA writes into the ring, where no copy lands),
// and the chunk that holds the last unit is never overwritten, because no
// chunk comes 9 after it.  The
// refill then reads shared memory, and device-memory latency leaves the
// step's dependency chain.

#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cluster_stream {

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;
// Threads a CTA may have: 512 leaves a thread up to 128 registers, so
// 16 lanes of 64-bit state do not spill.
constexpr int kMaxThreads = 512;
constexpr uint32_t kRingChunks = 9;  // chunks of window / 4: 2.25 windows

// The step's cluster-wide exchange of refill totals.  A CTA posts its
// total, tagged with the step, into slot [parity][rank] of every CTA of the
// cluster as one 64-bit store (thread j < size writes to CTA j); each warp
// then polls its own CTA's slots until every rank's tag is the step's.  The
// tag travels in the same word as the total, so no fence orders them.
struct Exchange {
  unsigned long long (*slots)[kMaxCluster];  // shared [2][kMaxCluster]
  int rank, size;

  // Zero this CTA's slots; a cluster barrier must follow before any post.
  __device__ void init() const {
    for (int i = threadIdx.x; i < 2 * kMaxCluster; i += blockDim.x)
      slots[i / kMaxCluster][i % kMaxCluster] = 0;
  }

  __device__ __forceinline__ void post(int total, int t) const {
    if (static_cast<int>(threadIdx.x) < size) {
      volatile unsigned long long* peer = cg::this_cluster().map_shared_rank(
          &slots[t & 1][rank], threadIdx.x);
      *peer = (static_cast<unsigned long long>(t + 1) << 32) |
              static_cast<uint32_t>(total);
    }
  }

  // Wait for every rank's post of step t; returns the totals of the lower
  // ranks and sets `sum` to the cluster's.  Warp-uniform.
  __device__ __forceinline__ int collect(int t, int& sum) const {
    const int lane = threadIdx.x & 31;
    uint32_t v = 0;
    if (lane < size) {
      const volatile unsigned long long* slot = &slots[t & 1][lane];
      unsigned long long s;
      do {
        s = *slot;
      } while ((s >> 32) != static_cast<unsigned long long>(t + 1));
      v = static_cast<uint32_t>(s);
    }
    sum = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, v));
    return static_cast<int>(
        __reduce_add_sync(0xFFFFFFFFu, lane < rank ? v : 0u));
  }
};

// The block's stream body staged in a shared-memory ring of 8-, 16- or
// 32-bit units.  Every member but `buf` is uniform across the CTA, and every
// thread calls request() and wait() at the same points.
template <typename T>
struct Ring {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4,
                "a ring unit is 1, 2 or 4 bytes");
  // log2(sizeof(T)): a chunk of 2^shift units is 2^(shift + kUnitShift) B
  static constexpr uint32_t kUnitShift =
      sizeof(T) == 4 ? 2u : (sizeof(T) == 2 ? 1u : 0u);
  T* buf;                // shared: kRingChunks chunks of 2^shift units
  const uint8_t* src;    // global: the body's start rounded down to 16 B
  uint32_t delta;        // units from src to the body's first unit
  uint32_t shift;        // log2 of a chunk's units
  uint32_t n_chunks;     // chunks that hold body units
  uint32_t issued;       // chunks requested so far
  uint32_t settled;      // chunks requested before the last request
  uint32_t last;         // ring position of the last body unit (of a zero
                         // unit when the body is empty)
  long long len;         // body units
  long long end_bytes;   // bytes from src to one past the body
  long long window;      // units one step consumes at most

  __device__ void init(T* ring, const T* body, long long blen, int chunk_shift,
                       long long step_window) {
    buf = ring;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(body);
    src = reinterpret_cast<const uint8_t*>(addr & ~uintptr_t{15});
    delta = static_cast<uint32_t>((addr & 15) / sizeof(T));
    shift = static_cast<uint32_t>(chunk_shift);
    const long long end = delta + blen;
    n_chunks = blen > 0 ? static_cast<uint32_t>(((end - 1) >> shift) + 1) : 0u;
    issued = 0;
    settled = 0;
    len = blen;
    if (blen > 0) {
      last = static_cast<uint32_t>(end - 1);
    } else {  // no copy ever lands in the ring: read a zero there instead
      last = delta;
      if (threadIdx.x == 0) buf[delta] = 0;
    }
    end_bytes = end * static_cast<long long>(sizeof(T));
    window = step_window;
    request(kRingChunks);
  }

  // Request chunks [issued, upto) (clipped to the body) and commit them as
  // one cp.async group.
  __device__ void request(long long upto) {
    const uint32_t hi = static_cast<uint32_t>(
        upto < static_cast<long long>(n_chunks) ? upto : n_chunks);
    if (hi > issued) {
      // a chunk is 2^pshift pieces of 16 bytes
      const uint32_t cbytes_shift = shift + kUnitShift;
      const uint32_t pshift = cbytes_shift - 4;
      const uint32_t total = (hi - issued) << pshift;
      const uint32_t base =
          static_cast<uint32_t>(__cvta_generic_to_shared(buf));
      for (uint32_t k = threadIdx.x; k < total; k += blockDim.x) {
        const uint32_t c = issued + (k >> pshift);
        const uint32_t piece = (k & ((1u << pshift) - 1)) << 4;
        const long long off = (static_cast<long long>(c) << cbytes_shift) +
                              piece;
        const long long left = end_bytes - off;
        if (left <= 0) continue;
        const uint32_t valid = left < 16 ? static_cast<uint32_t>(left) : 16u;
        const uint32_t dst = base + ((c % kRingChunks) << cbytes_shift) + piece;
        asm volatile(
            "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
            "l"(src + off), "r"(valid)
            : "memory");
      }
      issued = hi;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Before the scan's barrier of the step at `cursor`: wait for this
  // thread's copies of the chunks that step reads.  Those requested by the
  // step before may stay in flight when the step needs none of them.
  __device__ __forceinline__ void wait_for(long long cursor) const {
    const long long last = ((cursor + window - 1 + delta) >> shift) + 1;
    const long long need = last < n_chunks ? last : n_chunks;
    if (need <= static_cast<long long>(settled))
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // After the scan's barrier of the step at `cursor`: request every chunk
  // up to 9 after the one that holds the cursor, i.e. all the ring can take
  // (and at least all the next step can read).
  __device__ __forceinline__ void request_ahead(long long cursor) {
    settled = issued;
    request(((cursor + delta) >> shift) + kRingChunks);
  }

  // Wait for all of this thread's copies.
  __device__ __forceinline__ static void wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // The ring position of stream position `pos`, clamped to one past the
  // body (unit() clamps further), in 32 bits.
  __device__ __forceinline__ uint32_t position(long long pos) const {
    return static_cast<uint32_t>(pos < len ? pos : len) + delta;
  }

  // The unit at ring position `p`, clamped to the body's last unit.
  __device__ __forceinline__ uint32_t unit(uint32_t p) const {
    p = p < last ? p : last;
    const uint32_t c = p >> shift;
    return buf[((c % kRingChunks) << shift) | (p & ((1u << shift) - 1))];
  }
};

// How to launch a decoder: n_blocks clusters of `cluster` CTAs of
// `threads` threads with `smem` bytes of dynamic shared memory on `stream`;
// with `max_clusters` set, only report cudaOccupancyMaxActiveClusters there.
struct Launch {
  int n_blocks, cluster, threads;
  size_t smem;
  cudaStream_t stream;
  int* max_clusters;
};

// Configure and launch `kernel` as `l` says.  A cluster that cannot be
// scheduled returns cudaErrorLaunchOutOfResources instead of running
// smaller.
template <typename Kernel, typename Args>
int launch_clusters(Kernel kernel, const Args& a, const Launch& l) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (e == cudaSuccess && l.cluster > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(l.cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(l.n_blocks * l.cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(l.threads));
  cfg.dynamicSmemBytes = l.smem;
  cfg.stream = l.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (l.max_clusters) {
    *l.max_clusters = active;
    return 0;
  }
  if (active < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Checks of a launch plan that every cluster decoder makes: cluster a power of two
// up to kMaxCluster; whole warps, up to kMaxThreads; L = n_lanes /
// (cluster * threads) lanes a thread, a power of two up to 16; a chunk of
// window / 4 bytes, a power of two of at least one 16-byte piece.  Returns
// L, or 0 for a plan the decoders do not take.
inline int lanes_per_thread(int n_lanes, int cluster, int threads,
                            long long window_bytes, long long chunk_bytes) {
  const bool shape =
      cluster >= 1 && cluster <= kMaxCluster &&
      (cluster & (cluster - 1)) == 0 && threads >= 32 &&
      threads <= kMaxThreads && threads % 32 == 0 &&
      chunk_bytes * 4 == window_bytes && chunk_bytes >= 16 &&
      (chunk_bytes & (chunk_bytes - 1)) == 0;
  if (!shape || n_lanes % (cluster * threads) != 0) return 0;
  const int L = n_lanes / (cluster * threads);
  return L <= 16 && (L & (L - 1)) == 0 ? L : 0;
}

}  // namespace cluster_stream

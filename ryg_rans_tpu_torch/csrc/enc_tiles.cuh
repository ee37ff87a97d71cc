// The staged-symbol encoder loop that the dense encoders K2 (word_encode.cu),
// K4 (byte_encode.cu) and K6 (rans64_encode.cu) share, for Hopper (sm_90a).
//
// Every dense encoder walks each coder lane's steps in reverse, one state
// per lane, and writes one cell per symbol in the [block, step, lane] order
// of the input; the variants differ only in the step.  So the loop lives
// here once, templated on a step policy, and each source gives its policy:
//
//   using State = ...;   // the lane's state (uint32_t or uint64_t)
//   using Cell = ...;    // the dense cell it writes per symbol
//   using Row = ...;     // the per-symbol table row the step reads
//   static constexpr State kInit;  // the state before the last symbol
//   // copy the policy's tables into shared memory at `smem` (16-byte
//   // aligned), with the CTA's threads; the loop then waits on them
//   __device__ void stage(uint8_t* smem, int tid, int nthreads);
//   __device__ Row row(uint32_t symbol) const;   // a shared-memory read
//   __device__ Cell operator()(State& x, const Row& e) const;  // the step
//
// Bound on this card: memory.  Per symbol the loop reads 1 byte and writes
// a cell (4 or 8 bytes), so its work is to keep those bytes moving while
// every step's chain is arithmetic alone.  A CTA owns kCtaLanes lanes of
// one block (a full-width group of 4 blocks at 16384 lanes is 128 CTAs: one
// wave on the 132 SMs), one lane a thread, so 16 warps an SM hide each
// other's chains; a warp's cells are contiguous.  The CTA stages its lanes'
// symbols in shared memory ahead of use: tiles of kTileSteps steps, in
// reverse step order, double-buffered and filled by cp.async (16 bytes a
// piece), so no step waits on device memory for its symbol.  The table row
// of a step is read a step ahead of its use and the symbol two steps ahead
// (a software pipeline), so the chain from one step's state to the next
// holds the policy's arithmetic alone.  Measured on the H100 for K4
// (decode_probe.py --part encode): a symbol load from device memory on the
// chain cost more than the whole staged kernel; two or four lanes a thread
// and CTAs of 256 or 1024 lanes were slower.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace enc_tiles {

constexpr int kCtaLanes = 512;  // lanes a CTA, at most
// Lanes a thread: one.  Two or four (more chains a thread, fewer warps)
// measured slower on the H100 (decode_probe.py).
constexpr int kLanesPerThread = 1;
constexpr int kTileSteps = 32;  // steps a symbol tile holds
constexpr int kMaxThreads = kCtaLanes / kLanesPerThread;

template <class Cell, class State>
struct Io {
  const uint8_t* syms;  // [n_blocks, n_steps * n_lanes], 16-byte aligned
  Cell* cells;          // [n_blocks, n_steps * n_lanes]
  State* states;        // [n_blocks, n_lanes]
  int n_lanes, n_steps;
  int cta_lanes;        // min(n_lanes, kCtaLanes)
};

// The symbols of steps [lo, lo + rows) of this CTA's lanes into `tile`
// (rows of cta_lanes bytes), one cp.async group.
template <class Cell, class State>
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* src,
                                          int lo, int rows,
                                          const Io<Cell, State>& a) {
  const int per_row = a.cta_lanes >> 4;  // 16-byte pieces
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  for (int k = threadIdx.x; k < rows * per_row; k += blockDim.x) {
    const int row = k / per_row;
    const int piece = (k - row * per_row) << 4;
    const uint8_t* g =
        src + static_cast<size_t>(lo + row) * a.n_lanes + piece;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     base + row * a.cta_lanes + piece),
                 "l"(g)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The body of an encode kernel: CTA (blockIdx.x, blockIdx.y) codes lanes
// [blockIdx.x * cta_lanes, +cta_lanes) of block blockIdx.y.  `smem` is the
// kernel's dynamic shared memory: the two symbol tiles, then the policy's
// tables (smem_bytes).
template <class Step>
__device__ __forceinline__ void encode(
    Step& step, const Io<typename Step::Cell, typename Step::State>& a,
    uint8_t* smem) {
  using State = typename Step::State;
  using Cell = typename Step::Cell;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int tile_bytes = kTileSteps * a.cta_lanes;

  const int blk = blockIdx.y;
  const int lane_base = blockIdx.x * a.cta_lanes;
  const size_t block_base = static_cast<size_t>(blk) * a.n_steps * a.n_lanes;
  const uint8_t* src = a.syms + block_base + lane_base;
  const int T = a.n_steps;
  const int n_tiles = (T + kTileSteps - 1) / kTileSteps;
  // tile i holds steps [max(0, T - (i + 1) kTileSteps), T - i kTileSteps)
  auto tile_lo = [&](int i) {
    const int lo = T - (i + 1) * kTileSteps;
    return lo > 0 ? lo : 0;
  };
  load_tile(smem, src, tile_lo(0), T - tile_lo(0), a);
  step.stage(smem + 2 * tile_bytes, tid, nthreads);

  State x[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) x[k] = Step::kInit;
  // lane tid + k * nthreads of the CTA
  Cell* cp = a.cells + block_base + lane_base + tid;

  for (int i = 0; i < n_tiles; ++i) {
    const int lo = tile_lo(i);
    const int hi = T - i * kTileSteps;
    if (i + 1 < n_tiles) {
      const int nlo = tile_lo(i + 1);
      load_tile(smem + ((i + 1) & 1) * tile_bytes, src, nlo, lo - nlo, a);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();  // tile i (and, the first time, the tables) in place
    const uint8_t* tile = smem + (i & 1) * tile_bytes + tid;
    // lane k's symbol at step t of this tile (t clamped to the tile)
    auto symbol = [&](int t, int k) -> uint32_t {
      return tile[((t > lo ? t : lo) - lo) * a.cta_lanes + k * nthreads];
    };
    // Software pipeline: the row of step t and the symbol of step t - 1
    // are loaded before step t runs, so the chain from one step's state to
    // the next holds the step's arithmetic alone.
    typename Step::Row e[kLanesPerThread];
    uint32_t s1[kLanesPerThread];
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      e[k] = step.row(symbol(hi - 1, k));
      s1[k] = symbol(hi - 2, k);
    }
    for (int t = hi - 1; t >= lo; --t) {
      typename Step::Row en[kLanesPerThread];
#pragma unroll
      for (int k = 0; k < kLanesPerThread; ++k) {
        en[k] = step.row(s1[k]);
        s1[k] = symbol(t - 2, k);
      }
      Cell* crow = cp + static_cast<size_t>(t) * a.n_lanes;
#pragma unroll
      for (int k = 0; k < kLanesPerThread; ++k) {
        crow[k * nthreads] = step(x[k], e[k]);
        e[k] = en[k];
      }
    }
    __syncthreads();  // every read of tile i done before tile i + 2 lands
  }
  State* sp = a.states + static_cast<size_t>(blk) * a.n_lanes + lane_base + tid;
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) sp[k * nthreads] = x[k];
}

// Host side.  The CTA's lane count for a shape every encoder takes
// (n_lanes a power of two in [128, 16384], at least one step, symbols on a
// 16-byte boundary), or 0 for any other shape.
inline int cta_lanes_for(const void* syms, int n_lanes, int n_steps) {
  if (n_lanes < 128 || n_lanes > 16384 || (n_lanes & (n_lanes - 1)) != 0 ||
      n_steps < 1 || (reinterpret_cast<uintptr_t>(syms) & 15) != 0)
    return 0;
  return n_lanes < kCtaLanes ? n_lanes : kCtaLanes;
}

// Launch `kernel(a)` over n_blocks blocks of a.n_lanes lanes on `stream`,
// with the symbol tiles and `table_bytes` of the policy's tables in
// dynamic shared memory; returns cudaGetLastError() after the launch.
template <class Kernel, class Args>
inline int launch(Kernel kernel, const Args& a, int n_blocks, int n_lanes,
                  int cta_lanes, size_t table_bytes, void* stream) {
  const size_t smem =
      2 * static_cast<size_t>(kTileSteps) * cta_lanes + table_bytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_lanes / cta_lanes, n_blocks);
  kernel<<<grid, cta_lanes / kLanesPerThread, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace enc_tiles

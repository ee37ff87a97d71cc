// BYTE / ALIAS rANS dense encode (K4) for Hopper (sm_90a).
//
// Replaces ryg_rans_tpu/ops/byte_tpu.py::_encode_kernel (via encode_blocks),
// which encodes both variants.  Each coder lane walks its steps in reverse
// from x = 2^23 (rans_byte.h:22-23, L = 2^23).  Per step, with
// x_max = freq << (31 - prob_bits) (rans_byte.h:64; at most 2^31, in the
// one-symbol model at prob_bits 16), the renorm loop of rans_byte.h:62-74
// writes x & 0xFF and shifts x right by 8 while x >= x_max, which is at most
// twice: the state stays in [2^23, 2^31).  The dense cell holds those k
// bytes in forward (decoder) order: k << 16 | fwd0 << 8 | fwd1, with fwd0
// the byte written last, or 0 when k = 0.  Then, with the reference's
// reciprocal (RansEncSymbolInit, rans_byte.h:174-243; ops/host_prep.py
// byte_enc_table) q = mulhi(x, rcp_freq) >> rcp_shift = x / freq:
//   BYTE:  x += bias + q * cmpl_freq  (rans_byte.h:258-280), i.e.
//          (x / freq) << prob_bits + x % freq + start;
//   ALIAS: x = q << prob_bits | remap[x - q * freq + start]
//          (main_alias.cpp:241-250), with q = x where freq == 1 (the
//          table's q = x - 1 there is folded into BYTE's bias only).
//
// Layout: symbol i of a block is step i / N, lane i % N, so a step's
// symbols are N consecutive bytes.  Cells keep the [block, step, lane]
// order, which is stream order; compaction into the stream is glue on the
// card.
//
// Bound on this card: memory.  Per symbol it reads 1 byte and writes a
// 4-byte cell, so the kernel's work is to keep those bytes moving while
// every step's chain is arithmetic alone.  A CTA owns kCtaLanes lanes of
// one block (a full-width group of 4 blocks at 16384 lanes is 128 CTAs: one
// wave on the 132 SMs), one lane a thread, so 16 warps an SM hide each
// other's chains; a warp's cells are contiguous.  The CTA stages its lanes'
// symbols in shared memory ahead of use: tiles of kTileSteps steps, in reverse step
// order, double-buffered and filled by cp.async (16 bytes a piece), so no
// step waits on device memory for its symbol.  The per-symbol row
// (x_max, rcp, bias or freq, cmpl_freq or start | rcp_shift << 24) is one
// 16-byte shared load, made a step ahead of its use, as the symbol is two
// steps ahead; the ALIAS remap (2^prob_bits u16, at most 128 KB) sits in
// dynamic shared memory too.  The chain from one step's state to the next
// is then arithmetic with no divide, and for ALIAS one shared read.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCtaLanes = 512;       // lanes a CTA, at most
// Lanes a thread: one.  Two or four (more chains a thread, fewer warps)
// measured slower on the H100 (decode_probe.py).
constexpr int kLanesPerThread = 1;
constexpr int kTileSteps = 32;       // steps a symbol tile holds
constexpr int kMaxThreads = kCtaLanes / kLanesPerThread;

struct Args {
  const uint8_t* syms;    // [n_blocks, n_steps * n_lanes], 16-byte aligned
  const uint4* table;     // [256] rows, see byte_enc_table
  const uint16_t* remap;  // [2^prob_bits] for ALIAS, else null
  int32_t* cells;         // [n_blocks, n_steps * n_lanes]
  uint32_t* states;       // [n_blocks, n_lanes]
  int n_lanes, n_steps, prob_bits;
  int cta_lanes;          // min(n_lanes, kCtaLanes)
};

// The symbols of steps [lo, lo + rows) of this CTA's lanes into `tile`
// (rows of cta_lanes bytes), one cp.async group.
__device__ __forceinline__ void load_tile(uint8_t* tile, const uint8_t* src,
                                          int lo, int rows, const Args& a) {
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

// One lane's step: renormalise x against the symbol's row `e`, return the
// dense cell, and encode the symbol into x.
template <bool ALIAS>
__device__ __forceinline__ uint32_t step(uint32_t& x, const uint4 e,
                                         const uint16_t* s_remap, int pb) {
  const uint32_t x_max = e.x;
  const bool m1 = x >= x_max;
  const uint32_t x1 = m1 ? x >> 8 : x;
  const bool m2 = x1 >= x_max;  // only after m1: x1 <= x
  const uint32_t cell =
      m2 ? (2u << 16) | ((x1 & 0xFFu) << 8) | (x & 0xFFu)
         : (m1 ? (1u << 16) | ((x & 0xFFu) << 8) : 0u);
  const uint32_t xs = m2 ? x1 >> 8 : x1;
  const uint32_t shift = e.w >> 24;
  const uint32_t low = e.w & 0xFFFFFFu;
  if constexpr (ALIAS) {
    const uint32_t freq = e.z;
    const uint32_t q = freq == 1u ? xs : __umulhi(xs, e.y) >> shift;
    x = (q << pb) | s_remap[xs - q * freq + low];
  } else {
    x = xs + e.z + (__umulhi(xs, e.y) >> shift) * low;
  }
  return cell;
}

template <bool ALIAS>
__global__ void __launch_bounds__(kMaxThreads)
byte_encode_kernel(const Args a) {
  // tiles[2][kTileSteps * cta_lanes] | table uint4[256] | ALIAS remap u16[M]
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int pb = a.prob_bits;
  const int tile_bytes = kTileSteps * a.cta_lanes;
  uint4* s_tab = reinterpret_cast<uint4*>(smem + 2 * tile_bytes);
  uint16_t* s_remap = reinterpret_cast<uint16_t*>(s_tab + 256);

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
  for (int i = tid; i < 256; i += nthreads) s_tab[i] = a.table[i];
  if constexpr (ALIAS) {
    const uint4* g = reinterpret_cast<const uint4*>(a.remap);
    uint4* s = reinterpret_cast<uint4*>(s_remap);
    for (int i = tid; i < (1 << pb) / 8; i += nthreads) s[i] = g[i];
  }

  uint32_t x[kLanesPerThread];
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) x[k] = 1u << 23;
  // lane tid + k * nthreads of the CTA
  int32_t* cp = a.cells + block_base + lane_base + tid;

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
    // the next holds arithmetic (and, for ALIAS, the remap read) alone.
    uint4 e[kLanesPerThread];
    uint32_t s1[kLanesPerThread];
#pragma unroll
    for (int k = 0; k < kLanesPerThread; ++k) {
      e[k] = s_tab[symbol(hi - 1, k)];
      s1[k] = symbol(hi - 2, k);
    }
    for (int t = hi - 1; t >= lo; --t) {
      uint4 en[kLanesPerThread];
#pragma unroll
      for (int k = 0; k < kLanesPerThread; ++k) {
        en[k] = s_tab[s1[k]];
        s1[k] = symbol(t - 2, k);
      }
      int32_t* crow = cp + static_cast<size_t>(t) * a.n_lanes;
#pragma unroll
      for (int k = 0; k < kLanesPerThread; ++k) {
        crow[k * nthreads] =
            static_cast<int32_t>(step<ALIAS>(x[k], e[k], s_remap, pb));
        e[k] = en[k];
      }
    }
    __syncthreads();  // every read of tile i done before tile i + 2 lands
  }
  uint32_t* sp = a.states + static_cast<size_t>(blk) * a.n_lanes +
                 lane_base + tid;
#pragma unroll
  for (int k = 0; k < kLanesPerThread; ++k) sp[k * nthreads] = x[k];
}

}  // namespace

// syms: uint8 [n_blocks, n_steps * n_lanes], 16-byte aligned; table: int32
// [256, 4] (ops/host_prep.py byte_enc_table, built for the variant); remap:
// u16 [2^prob_bits] for ALIAS, null for BYTE; cells: int32 [n_blocks,
// n_steps * n_lanes]; states: u32 [n_blocks, n_lanes].  n_lanes is a power
// of two in [128, 16384] and prob_bits in [9, 16].  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int byte_encode(const void* syms, const void* table,
                           const void* remap, void* cells, void* states,
                           int n_blocks, int n_lanes, int n_steps,
                           int prob_bits, void* stream) {
  if (prob_bits < 9 || prob_bits > 16 || n_lanes < 128 || n_lanes > 16384 ||
      (n_lanes & (n_lanes - 1)) != 0 || n_steps < 1 ||
      (reinterpret_cast<uintptr_t>(syms) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(table) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(remap) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cta_lanes = n_lanes < kCtaLanes ? n_lanes : kCtaLanes;
  const Args a{static_cast<const uint8_t*>(syms),
               static_cast<const uint4*>(table),
               static_cast<const uint16_t*>(remap),
               static_cast<int32_t*>(cells),
               static_cast<uint32_t*>(states),
               n_lanes,
               n_steps,
               prob_bits,
               cta_lanes};
  const size_t smem = 2 * kTileSteps * cta_lanes + 256 * sizeof(uint4) +
                      (remap ? sizeof(uint16_t) << prob_bits : 0);
  const auto kernel = remap ? byte_encode_kernel<true>
                            : byte_encode_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(n_lanes / cta_lanes, n_blocks);
  kernel<<<grid, cta_lanes / kLanesPerThread, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* byte_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

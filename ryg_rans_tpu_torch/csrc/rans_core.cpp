// rans_core: native host codec for the lane-interleaved TRNS stream format.
//
// The port's own copy of the reference package's host core: host
// encode/decode for any (variant, prob_bits, n_lanes, lanes_per_stream)
// layout, behind ``backend="native"`` of ryg_rans_tpu_torch's API.  It codes
// the layouts the CUDA kernels do not take (several substreams per block,
// prob_bits 8, 1-64 or 32768 lanes), and with n_streams=1, N<=2 it
// reproduces the streams of the rygorous/ryg_rans demos byte for byte (see
// tests/test_torch_host_backends.py).  The stream bytes are the reference
// copy's; this copy differs in two places only: encode builds no cum2sym
// table (it needs none: 2 GB at prob_bits 31), and the scalar decoders read
// at most the variant's max renorm words a symbol, which a valid stream
// never exceeds, so a corrupt stream decodes to wrong symbols instead of
// looping past its buffer.
//
// This is an original implementation built from the rANS math as documented
// in the reference headers (state transition rans_byte.h:83-90, renorm
// thresholds rans_byte.h:64 / rans64.h:83 / rans_word_sse41.h:85, alias
// coding main_alias.cpp:241-267); it shares no code with the reference and
// is organized as variant-trait templates over a single lane engine rather
// than per-variant free functions.
//
// Exposed as a C ABI consumed via ctypes (ryg_rans_tpu_torch/native.py).

#include <cassert>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

constexpr int kNSyms = 256;

// ---------------------------------------------------------------------------
// Variant traits: all arithmetic runs in uint64 regardless of state width.
// ---------------------------------------------------------------------------

struct ByteTraits {
  using Word = uint8_t;
  static constexpr uint64_t kL = 1ull << 23;
  static constexpr int kWordBits = 8;
  static constexpr int kStateWords = 4;
};

struct WordTraits {
  using Word = uint16_t;
  static constexpr uint64_t kL = 1ull << 16;
  static constexpr int kWordBits = 16;
  static constexpr int kStateWords = 2;
};

struct R64Traits {
  using Word = uint32_t;
  static constexpr uint64_t kL = 1ull << 31;
  static constexpr int kWordBits = 32;
  static constexpr int kStateWords = 2;
};

// ---------------------------------------------------------------------------
// Alias tables (Vose sweep, semantics of main_alias.cpp:147-237; validated
// against the NumPy builder in tests).
// ---------------------------------------------------------------------------

struct AliasTables {
  std::vector<uint32_t> divider;      // [256]
  std::vector<uint32_t> slot_freqs;   // [512]
  std::vector<uint32_t> slot_adjust;  // [512]
  std::vector<uint8_t> sym_id;        // [512]
  std::vector<uint32_t> remap;        // [M]
};

bool build_alias(const uint32_t* freqs, const uint64_t* cum, int scale_bits,
                 AliasTables* out) {
  const uint32_t M = 1u << scale_bits;
  if (M % kNSyms) return false;
  const uint32_t tgt = M / kNSyms;

  out->divider.assign(kNSyms, tgt);
  out->sym_id.resize(2 * kNSyms);
  out->slot_freqs.assign(2 * kNSyms, 0);
  out->slot_adjust.assign(2 * kNSyms, 0);
  out->remap.assign(M, 0);

  std::vector<int64_t> remaining(kNSyms);
  for (int i = 0; i < kNSyms; i++) {
    remaining[i] = freqs[i];
    out->sym_id[2 * i] = out->sym_id[2 * i + 1] = (uint8_t)i;
  }

  int large = 0, small = 0;
  while (large < kNSyms && remaining[large] < (int64_t)tgt) large++;
  while (small < kNSyms && remaining[small] >= (int64_t)tgt) small++;
  int next_small = small + 1;

  while (large < kNSyms && small < kNSyms) {
    out->sym_id[2 * small] = (uint8_t)large;
    out->divider[small] = (uint32_t)remaining[small];
    remaining[large] -= tgt - out->divider[small];
    if (remaining[large] >= (int64_t)tgt || next_small <= large) {
      small = next_small;
      while (small < kNSyms && remaining[small] >= (int64_t)tgt) small++;
      next_small = small + 1;
    } else {
      small = large;  // donor turned small behind the cursor: back-track
    }
    while (large < kNSyms && remaining[large] < (int64_t)tgt) large++;
  }

  std::vector<uint32_t> assigned(kNSyms, 0);
  for (int i = 0; i < kNSyms; i++) {
    const int j = out->sym_id[2 * i];
    const uint32_t h0 = out->divider[i];       // alias-symbol slots (lower)
    const uint32_t h1 = tgt - h0;              // home-symbol slots (upper)
    const uint32_t b0 = assigned[i], b1 = assigned[j];
    const uint32_t cb0 = (uint32_t)cum[i] + b0;
    const uint32_t cb1 = (uint32_t)cum[j] + b1;
    out->divider[i] = i * tgt + h0;
    out->slot_freqs[2 * i + 1] = freqs[i];
    out->slot_freqs[2 * i + 0] = freqs[j];
    out->slot_adjust[2 * i + 1] = i * tgt - b0;
    out->slot_adjust[2 * i + 0] = i * tgt - (b1 - h0);
    for (uint32_t k = 0; k < h0; k++) out->remap[cb0 + k] = k + i * tgt;
    for (uint32_t k = 0; k < h1; k++) out->remap[cb1 + k] = (k + h0) + i * tgt;
    assigned[i] += h0;
    assigned[j] += h1;
  }
  for (int i = 0; i < kNSyms; i++)
    if (assigned[i] != freqs[i]) return false;
  return true;
}

// ---------------------------------------------------------------------------
// Lane engine
// ---------------------------------------------------------------------------

struct Layout {
  int64_t n_symbols;
  int n_lanes;
  int lpg;        // lanes per stream
  int n_streams;
  int64_t steps;  // ceil(n_symbols / n_lanes)
};

Layout make_layout(int64_t n_symbols, int n_lanes, int lpg) {
  Layout L;
  L.n_symbols = n_symbols;
  L.n_lanes = n_lanes;
  L.lpg = lpg;
  L.n_streams = n_lanes / lpg;
  L.steps = n_lanes ? (n_symbols + n_lanes - 1) / n_lanes : 0;
  return L;
}

// Encode one substream. Walks steps in reverse, lanes descending, emitting
// backwards into scratch, then copies forward (the reference's twist #2,
// rans_byte.h:24-26, realized with an explicit reversal buffer).
//
// EncUpdate: (x_renormed, symbol) -> new state.  EncThreshold: symbol ->
// renorm threshold x_max.
template <class T, class EncUpdate, class EncThreshold>
int64_t encode_stream(const Layout& L, int stream, const uint8_t* data,
                      const EncThreshold& x_max_of, const EncUpdate& update,
                      typename T::Word* out, int64_t out_cap_words) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  std::vector<uint64_t> x(lpg, T::kL);

  // worst case words: states + max_renorm per symbol
  const int max_renorm = (T::kWordBits == 8) ? 2 : 1;
  std::vector<typename T::Word> scratch(
      (size_t)(L.steps * lpg * max_renorm + (int64_t)lpg * T::kStateWords + 8));
  typename T::Word* ptr = scratch.data() + scratch.size();

  for (int64_t t = L.steps - 1; t >= 0; t--) {
    for (int g = lpg - 1; g >= 0; g--) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      const int s = data[i];
      uint64_t st = x[g];
      const uint64_t xmax = x_max_of(s);
      if constexpr (T::kWordBits != 8) {
        // WORD/RANS64 emit at most ONE word (rans64.h:81-89): branchless
        // renorm -- the ~50%-taken while-loop branch mispredicted at
        // book1 rates (the same penalty the AVX2 byte ENCODE removed,
        // r4).  The speculative store at ptr[-1] is harmless: if the
        // lane does not renorm, ptr stays put and the slot is either
        // overwritten by a later emission or lies below the final ptr
        // and is never copied out (scratch carries slack).
        const int rn = st >= xmax;
        ptr[-1] = (typename T::Word)st;
        ptr -= rn;
        st = rn ? st >> T::kWordBits : st;
      } else {
        while (st >= xmax) {
          *--ptr = (typename T::Word)(st & ((1ull << T::kWordBits) - 1));
          st >>= T::kWordBits;
        }
      }
      x[g] = update(st, s);
    }
  }
  // flush states, lane-descending so they read back lane-ascending
  for (int g = lpg - 1; g >= 0; g--) {
    uint64_t st = x[g];
    for (int w = T::kStateWords - 1; w >= 0; w--)
      *--ptr = (typename T::Word)(st >> (w * T::kWordBits));
  }

  const int64_t n_words = scratch.data() + scratch.size() - ptr;
  if (n_words > out_cap_words) return -1;
  std::memcpy(out, ptr, (size_t)n_words * sizeof(typename T::Word));
  return n_words;
}

#if defined(__AVX2__)
// Byte-encode compressed-store LUT: 4 lanes per entry, indexed by
// (k>=1 nibble) | (k==2 nibble)<<4 where k is the lane's emitted byte
// count.  Source bytes are [hi, lo] pairs at positions [2l, 2l+1]; the
// control selects, lane-ascending, the hi byte only when k==2 (MSB-first
// pair order, matching the scalar engine's backward emission).
alignas(16) static uint8_t g_enc_pack_lut[256][16];

static bool init_enc_pack_lut() {
  for (int idx = 0; idx < 256; idx++) {
    int o = 0;
    for (int l = 0; l < 4; l++) {
      const bool k1 = (idx >> l) & 1, k2 = (idx >> (4 + l)) & 1;
      if (k2) g_enc_pack_lut[idx][o++] = (uint8_t)(2 * l);
      if (k1) g_enc_pack_lut[idx][o++] = (uint8_t)(2 * l + 1);
    }
    while (o < 16) g_enc_pack_lut[idx][o++] = 0x80;
  }
  return true;
}
static const bool g_enc_pack_ready = init_enc_pack_lut();

// Word-encode compressed-store LUT: 8 lanes per entry, indexed by the
// renorm movemask; selects each renorming lane's low u16 (LE byte pair),
// lane-ascending.
alignas(16) static uint8_t g_enc_pack_lut16[256][16];

static bool init_enc_pack_lut16() {
  for (int idx = 0; idx < 256; idx++) {
    int o = 0;
    for (int l = 0; l < 8; l++)
      if ((idx >> l) & 1) {
        g_enc_pack_lut16[idx][o++] = (uint8_t)(2 * l);
        g_enc_pack_lut16[idx][o++] = (uint8_t)(2 * l + 1);
      }
    while (o < 16) g_enc_pack_lut16[idx][o++] = 0x80;
  }
  return true;
}
static const bool g_enc_pack16_ready = init_enc_pack_lut16();

// ---------------------------------------------------------------------------
// AVX2 8-lane WORD encode (16-bit emission), pb <= 15.
//
// Per symbol: renorm test x >= freq << (32-sb) becomes an unsigned
// compare against (freq << (32-sb)) - 1 (the u32 wrap at freq = M maps
// exactly to "never renorms"); the scalar engine's lane-DESCENDING
// backward emission lands lane-ASCENDING in memory, so the vector path
// decrements the scratch pointer by popcount and writes the renorming
// lanes' low halves in lane order.  The division x/freq is exact in
// double (both < 2^32 <= 2^53); freq == 1 lanes bypass it (q = x, and
// q >= 2^31 would overflow the signed convert) via blend.
// ---------------------------------------------------------------------------

int64_t encode_stream_word_avx2(const Layout& L, int stream,
                                const uint8_t* data, int sb,
                                const int32_t* encfc32, uint16_t* out,
                                int64_t out_cap_words) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  std::vector<uint64_t> xs(lpg, 1ull << 16);  // WordTraits::kL

  const int max_renorm = 1;
  std::vector<uint16_t> scratch(
      (size_t)(L.steps * lpg * max_renorm + (int64_t)lpg * 2 + 8));
  // top 8 words (16 B) are sacrificial slack for the branchless 16-byte
  // stores' save/restore on the very first emitting group
  uint16_t* const top = scratch.data() + scratch.size() - 8;
  uint16_t* ptr = top;

  // partial steps (any lane with i >= n_symbols) run scalar, first in
  // the reverse walk
  int64_t t_full = 0;
  if (L.n_symbols >= lane_base + lpg)
    t_full = (L.n_symbols - lane_base - lpg) / L.n_lanes + 1;
  for (int64_t t = L.steps - 1; t >= t_full; t--) {
    for (int g = lpg - 1; g >= 0; g--) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      const int s = data[i];
      const uint32_t e = (uint32_t)encfc32[s];
      const uint64_t freq = (e >> 16) + 1;
      uint64_t st = xs[g];
      while (st >= freq << (32 - sb)) {
        *--ptr = (uint16_t)st;
        st >>= 16;
      }
      xs[g] = (st / freq << sb) + st % freq + (e & 0xFFFF);
    }
  }

  const __m256i vlow16 = _mm256_set1_epi32(0xFFFF);
  const __m256i vsign = _mm256_set1_epi32((int32_t)0x80000000);
  const __m256i vone = _mm256_set1_epi32(1);
  std::vector<uint32_t> x32(lpg);
  for (int g = 0; g < lpg; g++) x32[g] = (uint32_t)xs[g];

  for (int64_t t = t_full - 1; t >= 0; t--) {
    const int64_t row = t * L.n_lanes + lane_base;
    for (int g0 = lpg - 8; g0 >= 0; g0 -= 8) {
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x32[g0]);
      const __m256i sym = _mm256_cvtepu8_epi32(
          _mm_loadl_epi64((const __m128i*)(data + row + g0)));
      const __m256i e = _mm256_i32gather_epi32(encfc32, sym, 4);
      const __m256i freq = _mm256_add_epi32(_mm256_srli_epi32(e, 16),
                                            vone);
      const __m256i cum = _mm256_and_si256(e, vlow16);
      // renorm: x >= freq << (32-sb)  <=>  x > (freq << (32-sb)) - 1
      const __m256i thm1 = _mm256_sub_epi32(
          _mm256_slli_epi32(freq, 32 - sb), vone);
      const __m256i need = _mm256_cmpgt_epi32(
          _mm256_xor_si256(vx, vsign), _mm256_xor_si256(thm1, vsign));
      {
        // branchless shuffle-LUT compressed store (r5, as in the BYTE
        // encoder): extract the 8 lanes' low u16s into one xmm, compact
        // the renorming lanes' LE byte pairs with a 256-entry pshufb
        // control LUT, land them in one 16-byte store.  The <= 16-byte
        // spill past the group's region is covered by one 16-byte
        // save/restore at the region end (scratch top slack covers the
        // very first group).
        const int m = _mm256_movemask_ps(_mm256_castsi256_ps(need));
        const __m256i lo16shuf = _mm256_setr_epi8(
            0, 1, 4, 5, 8, 9, 12, 13, -1, -1, -1, -1, -1, -1, -1, -1,
            0, 1, 4, 5, 8, 9, 12, 13, -1, -1, -1, -1, -1, -1, -1, -1);
        const __m256i p = _mm256_shuffle_epi8(vx, lo16shuf);
        const __m128i src = _mm256_castsi256_si128(
            _mm256_permutevar8x32_epi32(
                p, _mm256_setr_epi32(0, 1, 4, 5, 0, 0, 0, 0)));
        uint16_t* const oe = ptr;          // previous group's region start
        ptr -= __builtin_popcount((unsigned)m);
        __m128i save = _mm_loadu_si128((const __m128i*)oe);
        _mm_storeu_si128(
            (__m128i*)ptr,
            _mm_shuffle_epi8(src, _mm_load_si128(
                (const __m128i*)g_enc_pack_lut16[m])));
        _mm_storeu_si128((__m128i*)oe, save);
        vx = _mm256_blendv_epi8(vx, _mm256_srli_epi32(vx, 16), need);
      }
      // update x = (x/freq << sb) + x%freq + cum; x/freq exact in double
      const __m256i xlo = _mm256_and_si256(vx, vlow16);
      const __m256i xhi = _mm256_srli_epi32(vx, 16);
      const __m256d xd0 = _mm256_add_pd(
          _mm256_mul_pd(
              _mm256_cvtepi32_pd(_mm256_castsi256_si128(xhi)),
              _mm256_set1_pd(65536.0)),
          _mm256_cvtepi32_pd(_mm256_castsi256_si128(xlo)));
      const __m256d xd1 = _mm256_add_pd(
          _mm256_mul_pd(
              _mm256_cvtepi32_pd(_mm256_extracti128_si256(xhi, 1)),
              _mm256_set1_pd(65536.0)),
          _mm256_cvtepi32_pd(_mm256_extracti128_si256(xlo, 1)));
      const __m256d fd0 =
          _mm256_cvtepi32_pd(_mm256_castsi256_si128(freq));
      const __m256d fd1 =
          _mm256_cvtepi32_pd(_mm256_extracti128_si256(freq, 1));
      const __m256i q = _mm256_setr_m128i(
          _mm256_cvttpd_epi32(_mm256_div_pd(xd0, fd0)),
          _mm256_cvttpd_epi32(_mm256_div_pd(xd1, fd1)));
      const __m256i rem = _mm256_sub_epi32(
          vx, _mm256_mullo_epi32(q, freq));
      __m256i nx = _mm256_add_epi32(
          _mm256_add_epi32(_mm256_slli_epi32(q, sb), rem), cum);
      // freq == 1: q = x (may exceed the signed convert) -> x<<sb + cum
      const __m256i f1 = _mm256_cmpeq_epi32(freq, vone);
      nx = _mm256_blendv_epi8(
          nx, _mm256_add_epi32(_mm256_slli_epi32(vx, sb), cum), f1);
      _mm256_storeu_si256((__m256i*)&x32[g0], nx);
    }
  }

  // flush states, lane-descending so they read back lane-ascending
  for (int g = lpg - 1; g >= 0; g--) {
    const uint32_t st = x32[g];
    *--ptr = (uint16_t)(st >> 16);
    *--ptr = (uint16_t)st;
  }

  const int64_t n_words = top - ptr;
  if (n_words > out_cap_words) return -1;
  std::memcpy(out, ptr, (size_t)n_words * sizeof(uint16_t));
  return n_words;
}

// ---------------------------------------------------------------------------
// AVX2 8-lane encode for the BYTE-renorm variants (BYTE and ALIAS), pb<=16.
//
// The reverse of decode_stream_byte_avx2: the bounded 2-round byte renorm
// becomes closed-form k = (x >= xmax) + (x>>8 >= xmax) (n2 implies n1, so
// two blend-shifts realize both rounds), and the renorming lanes' bytes
// are stored lane-ASCENDING, MSB-first, behind a decrementing scratch
// pointer -- exactly the scalar engine's lane-descending backward
// emission order (docs/FORMAT.md).  x/freq is exact in double: after
// renorm x < freq << (31-sb) <= 2^31 and the quotient's distance to the
// next integer, >= 1/freq >= 2^-16, exceeds the <= 2^-21 division
// rounding error.  ALIAS adds one slot-remap gather (main_alias.cpp:
// 241-250 semantics); the reference's reciprocal scheme (rans_byte.h:
// 174-243) loses here -- this host is gather-bound and the extra table
// gathers cost more than div_pd (docs/DESIGN.md dead ends).
// ---------------------------------------------------------------------------

// Pack 8 symbol dwords to 8 output bytes in one store (replaces an
// 8-iteration scalar store loop in the decode hot paths).
static inline void store_syms8(uint8_t* o, __m256i sym) {
  const __m256i shuf = _mm256_setr_epi8(
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
      0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
  __m256i p = _mm256_shuffle_epi8(sym, shuf);
  p = _mm256_permutevar8x32_epi32(
      p, _mm256_setr_epi32(0, 4, 0, 0, 0, 0, 0, 0));
  _mm_storel_epi64((__m128i*)o, _mm256_castsi256_si128(p));
}

static inline __m256i exclusive_prefix_sum_epi32(__m256i v) {
  // 3-step inclusive scan over 8 lanes (rotate + zero-blend), minus v
  const __m256i sh1 = _mm256_setr_epi32(7, 0, 1, 2, 3, 4, 5, 6);
  const __m256i sh2 = _mm256_setr_epi32(6, 7, 0, 1, 2, 3, 4, 5);
  const __m256i sh4 = _mm256_setr_epi32(4, 5, 6, 7, 0, 1, 2, 3);
  const __m256i z = _mm256_setzero_si256();
  __m256i s = v;
  __m256i t = _mm256_blend_epi32(_mm256_permutevar8x32_epi32(s, sh1), z,
                                 0x01);
  s = _mm256_add_epi32(s, t);
  t = _mm256_blend_epi32(_mm256_permutevar8x32_epi32(s, sh2), z, 0x03);
  s = _mm256_add_epi32(s, t);
  t = _mm256_blend_epi32(_mm256_permutevar8x32_epi32(s, sh4), z, 0x0F);
  s = _mm256_add_epi32(s, t);
  return _mm256_sub_epi32(s, v);
}


struct IdentityRemap {
  __m256i operator()(__m256i slot) const { return slot; }
  uint32_t scalar(uint32_t slot) const { return slot; }
};

struct AliasRemap {
  const int32_t* remap32;
  __m256i operator()(__m256i slot) const {
    return _mm256_i32gather_epi32(remap32, slot, 4);
  }
  uint32_t scalar(uint32_t slot) const { return (uint32_t)remap32[slot]; }
};

template <class RemapSlot>
int64_t encode_stream_byte_avx2(const Layout& L, int stream,
                                const uint8_t* data, int sb,
                                const int32_t* encfc32, const RemapSlot& rm,
                                uint8_t* out, int64_t out_cap_bytes) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  const int max_renorm = 2;
  std::vector<uint8_t> scratch(
      (size_t)(L.steps * lpg * max_renorm + (int64_t)lpg * 4 + 8));
  // top 8 bytes are sacrificial slack for the branchless 8-byte stores'
  // save/restore on the very first emitting group
  uint8_t* const top = scratch.data() + scratch.size() - 8;
  uint8_t* ptr = top;
  std::vector<uint32_t> x32(lpg, 1u << 23);  // ByteTraits::kL

  // partial steps (any lane with i >= n_symbols) run scalar, first in
  // the reverse walk
  int64_t t_full = 0;
  if (L.n_symbols >= lane_base + lpg)
    t_full = (L.n_symbols - lane_base - lpg) / L.n_lanes + 1;
  for (int64_t t = L.steps - 1; t >= t_full; t--) {
    for (int g = lpg - 1; g >= 0; g--) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      const uint32_t e = (uint32_t)encfc32[data[i]];
      const uint32_t freq = (e >> 16) + 1, cum = e & 0xFFFF;
      uint32_t st = x32[g];
      const uint32_t xmax = freq << (31 - sb);
      while (st >= xmax) {
        *--ptr = (uint8_t)st;
        st >>= 8;
      }
      x32[g] = ((st / freq) << sb) + rm.scalar(st % freq + cum);
    }
  }

  const __m256i vone = _mm256_set1_epi32(1);
  const __m256i vlow16 = _mm256_set1_epi32(0xFFFF);
  const __m256i vsign = _mm256_set1_epi32((int32_t)0x80000000);
  for (int64_t t = t_full - 1; t >= 0; t--) {
    const int64_t row = t * L.n_lanes + lane_base;
    for (int g0 = lpg - 8; g0 >= 0; g0 -= 8) {
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x32[g0]);
      const __m256i sym = _mm256_cvtepu8_epi32(
          _mm_loadl_epi64((const __m128i*)(data + row + g0)));
      const __m256i e = _mm256_i32gather_epi32(encfc32, sym, 4);
      const __m256i freq = _mm256_add_epi32(_mm256_srli_epi32(e, 16), vone);
      const __m256i cum = _mm256_and_si256(e, vlow16);
      // renorm: x >= freq << (31-sb), unsigned via the sign-xor compare
      // (the u32 wrap at freq = M maps exactly to "x < 2^31 never hits")
      const __m256i thm1x = _mm256_xor_si256(
          _mm256_sub_epi32(_mm256_slli_epi32(freq, 31 - sb), vone), vsign);
      const __m256i n1 = _mm256_cmpgt_epi32(
          _mm256_xor_si256(vx, vsign), thm1x);
      const __m256i x8 = _mm256_srli_epi32(vx, 8);
      const __m256i n2 = _mm256_cmpgt_epi32(
          _mm256_xor_si256(x8, vsign), thm1x);  // n2 implies n1
      {
        // branchless shuffle-LUT compressed store (r5; the previous
        // spill-to-array + scalar-pair-loop form paid a store-forward
        // stall chain every group): per 4-lane half, one pshufb with a
        // 256-entry control LUT compacts the [hi, lo] byte pairs
        // (MSB-first, lane-ascending), one 8-byte store lands them, and
        // popcount of the LUT index is the byte count.  Both stores
        // spill <= 8 bytes past the group's region; one u64
        // save/restore at the region end covers every spill (the
        // scratch top slack covers the very first group).
        const int m1 = _mm256_movemask_ps(_mm256_castsi256_ps(n1));
        const int m2 = _mm256_movemask_ps(_mm256_castsi256_ps(n2));
        const __m256i pairshuf = _mm256_setr_epi8(
            1, 0, 5, 4, 9, 8, 13, 12, -1, -1, -1, -1, -1, -1, -1, -1,
            1, 0, 5, 4, 9, 8, 13, 12, -1, -1, -1, -1, -1, -1, -1, -1);
        const __m256i pairs = _mm256_shuffle_epi8(vx, pairshuf);
        const int idx0 = (m1 & 0xF) | ((m2 & 0xF) << 4);
        const int idx1 = (m1 >> 4) | (m2 & 0xF0);
        const int cnt0 = __builtin_popcount((unsigned)idx0);
        const int cnt1 = __builtin_popcount((unsigned)idx1);
        uint8_t* const oe = ptr;           // previous group's region start
        ptr -= cnt0 + cnt1;
        uint64_t save;
        std::memcpy(&save, oe, 8);
        const __m128i out0 = _mm_shuffle_epi8(
            _mm256_castsi256_si128(pairs),
            _mm_load_si128((const __m128i*)g_enc_pack_lut[idx0]));
        const __m128i out1 = _mm_shuffle_epi8(
            _mm256_extracti128_si256(pairs, 1),
            _mm_load_si128((const __m128i*)g_enc_pack_lut[idx1]));
        _mm_storel_epi64((__m128i*)ptr, out0);
        _mm_storel_epi64((__m128i*)(ptr + cnt0), out1);
        std::memcpy(oe, &save, 8);
        vx = _mm256_blendv_epi8(vx, x8, n1);
        vx = _mm256_blendv_epi8(vx, _mm256_srli_epi32(vx, 8), n2);
      }
      // x = (x/freq << sb) + remap(x%freq + cum); x < 2^31 so the signed
      // i32 -> double convert is direct (no limb split needed)
      const __m256d xd0 = _mm256_cvtepi32_pd(_mm256_castsi256_si128(vx));
      const __m256d xd1 =
          _mm256_cvtepi32_pd(_mm256_extracti128_si256(vx, 1));
      const __m256d fd0 =
          _mm256_cvtepi32_pd(_mm256_castsi256_si128(freq));
      const __m256d fd1 =
          _mm256_cvtepi32_pd(_mm256_extracti128_si256(freq, 1));
      const __m256i q = _mm256_setr_m128i(
          _mm256_cvttpd_epi32(_mm256_div_pd(xd0, fd0)),
          _mm256_cvttpd_epi32(_mm256_div_pd(xd1, fd1)));
      const __m256i rem =
          _mm256_sub_epi32(vx, _mm256_mullo_epi32(q, freq));
      const __m256i nx = _mm256_add_epi32(
          _mm256_slli_epi32(q, sb), rm(_mm256_add_epi32(rem, cum)));
      _mm256_storeu_si256((__m256i*)&x32[g0], nx);
    }
  }

  // flush states, lane-descending so they read back lane-ascending
  for (int g = lpg - 1; g >= 0; g--) {
    const uint32_t st = x32[g];
    for (int w = 3; w >= 0; w--) *--ptr = (uint8_t)(st >> (w * 8));
  }

  const int64_t n_bytes = top - ptr;
  if (n_bytes > out_cap_bytes) return -1;
  std::memcpy(out, ptr, (size_t)n_bytes);
  return n_bytes;
}
#endif  // __AVX2__

// Decode one substream forward (RansDecInit/Get/Advance semantics,
// rans_byte.h:109-149, generalized over lanes).
template <class T, class DecStep>
void decode_stream(const Layout& L, int stream,
                   const typename T::Word* words, const DecStep& step,
                   uint8_t* out) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  std::vector<uint64_t> x(lpg, 0);
  const typename T::Word* ptr = words;
  for (int g = 0; g < lpg; g++) {
    uint64_t st = 0;
    for (int w = 0; w < T::kStateWords; w++)
      st |= (uint64_t)(*ptr++) << (w * T::kWordBits);
    x[g] = st;
  }
  for (int64_t t = 0; t < L.steps; t++) {
    for (int g = 0; g < lpg; g++) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      uint64_t st = x[g];
      int sym;
      st = step(st, &sym);
      // at most max_renorm words, as a valid stream needs (1, or 2 for
      // 8-bit words)
      for (int r = 0; r < (T::kWordBits == 8 ? 2 : 1) && st < T::kL; r++)
        st = (st << T::kWordBits) | (uint64_t)(*ptr++);
      x[g] = st;
      out[i] = (uint8_t)sym;
    }
  }
}

#if defined(__AVX2__)
// ---------------------------------------------------------------------------
// AVX2 8-lane decode for the WORD variant (16-bit renorm, 32-bit states).
//
// Original vectorization of the interleaved-decode design the reference
// realizes with SSE 4.1 intrinsics (rans_word_sse41.h:151-227): per-slot
// symbol gather + per-slot (freq-1)<<16|bias gather (vpgatherdd) -- two
// INDEPENDENT slot-indexed lookups, the reference's own RansWordTables
// unrolling (rans_word_sse41.h:58-72) rather than the chained
// slot->sym->fc form (r4: chaining cost one full gather latency on the
// critical path; slot-direct tables are 4*2^sb B extra and drop it) --
// advance in 32-bit lanes, and ORDERED stream consumption -- the k-th
// renorming lane (lane-ascending) receives the k-th next stream word --
// done here with a movemask-indexed permutation LUT + popcount pointer
// bump instead of the reference's shuffle-LUT byte tables.  Groups of 8
// lanes run in lane order within each step, so any lanes_per_stream % 8
// == 0 layout keeps the exact scalar/kernel stream contract
// (docs/FORMAT.md).  Valid for prob_bits <= 15 (WORD's full range).
// ---------------------------------------------------------------------------

alignas(32) static int32_t g_perm_lut[256][8];

static bool init_perm_lut() {
  for (int m = 0; m < 256; m++) {
    int k = 0;
    for (int lane = 0; lane < 8; lane++)
      g_perm_lut[m][lane] = (m >> lane) & 1 ? k++ : 7;
  }
  return true;
}
static const bool g_perm_ready = init_perm_lut();

void decode_stream_word_avx2(const Layout& L, int stream,
                             const uint16_t* words, int64_t total_words,
                             int sb, const int32_t* c2s32,
                             const int32_t* slotfb32, uint8_t* out) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  const uint16_t* ptr = words;
  const uint16_t* end = words + total_words;
  std::vector<uint32_t> x(lpg);
  for (int g = 0; g < lpg; g++) {
    x[g] = (uint32_t)ptr[0] | ((uint32_t)ptr[1] << 16);
    ptr += 2;
  }
  // steps where every lane of the stream is in range AND the 8-word
  // renorm load cannot overread; the scalar tail finishes the rest
  int64_t t_full = 0;
  if (L.n_symbols >= lane_base + lpg)
    t_full = (L.n_symbols - lane_base - lpg) / L.n_lanes + 1;

  const __m256i vmask = _mm256_set1_epi32((1 << sb) - 1);
  const __m256i vzero = _mm256_setzero_si256();
  const __m256i vlow16 = _mm256_set1_epi32(0xFFFF);
  // two-pass step (r4.5, as in the RANS64 path): pass 1 advances every
  // 8-lane group with no cross-group dependency; a short scalar prefix
  // sum over the saved movemasks yields each group's renorm word offset;
  // pass 2 issues every renorm load at its precomputed ptr offset.  The
  // one-pass form serialized on load -> popcount -> next group's load.
  std::vector<uint8_t> gmask(lpg / 8);
  std::vector<int32_t> goff(lpg / 8 + 1);
  int64_t t = 0;
  // conservative per-step slack: a step consumes <= lpg words and every
  // renorm load touches 8 words from its offset (<= consumed so far), so
  // ptr + lpg + 8 <= end guarantees no load overreads the allocation
  for (; t < t_full && ptr + lpg + 8 <= end; t++) {
    const int64_t row = t * L.n_lanes + lane_base;
    for (int g0 = 0; g0 < lpg; g0 += 8) {  // pass 1: advance
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
      const __m256i slot = _mm256_and_si256(vx, vmask);
      const __m256i sym = _mm256_i32gather_epi32(c2s32, slot, 4);
      const __m256i fb = _mm256_i32gather_epi32(slotfb32, slot, 4);
      const __m256i freq = _mm256_add_epi32(
          _mm256_srli_epi32(fb, 16), _mm256_set1_epi32(1));
      // x = freq * (x >> sb) + bias, bias = slot - cum baked per slot
      // (rans_word_sse41.h:126; sym and fb gathers are independent)
      vx = _mm256_add_epi32(
          _mm256_mullo_epi32(freq, _mm256_srli_epi32(vx, sb)),
          _mm256_and_si256(fb, vlow16));
      const __m256i need =
          _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 16), vzero);
      gmask[g0 >> 3] =
          (uint8_t)_mm256_movemask_ps(_mm256_castsi256_ps(need));
      _mm256_storeu_si256((__m256i*)&x[g0], vx);
      store_syms8(out + row + g0, sym);
    }
    goff[0] = 0;
    for (int g = 0; g < lpg / 8; g++)
      goff[g + 1] = goff[g] + __builtin_popcount((unsigned)gmask[g]);
    for (int g0 = 0; g0 < lpg; g0 += 8) {  // pass 2: ordered renorm
      const int m = gmask[g0 >> 3];
      if (!m) continue;
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
      const __m256i need =
          _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 16), vzero);
      // <=1 word/lane, lane-ascending word order via the perm LUT
      const __m256i w8 = _mm256_cvtepu16_epi32(_mm_loadu_si128(
          (const __m128i*)(ptr + goff[g0 >> 3])));
      const __m256i w = _mm256_permutevar8x32_epi32(
          w8, _mm256_load_si256((const __m256i*)g_perm_lut[m]));
      vx = _mm256_blendv_epi8(
          vx,
          _mm256_or_si256(_mm256_slli_epi32(vx, 16),
                          _mm256_and_si256(w, vlow16)),
          need);
      _mm256_storeu_si256((__m256i*)&x[g0], vx);
    }
    ptr += goff[lpg / 8];
  }
  // scalar tail: remaining steps + the final window where the 8-word
  // SIMD load could overread the payload allocation
  const uint32_t mask = (1u << sb) - 1;
  for (; t < L.steps; t++) {
    for (int g = 0; g < lpg; g++) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      uint32_t st = x[g];
      const uint32_t slot = st & mask;
      const uint32_t fb = (uint32_t)slotfb32[slot];
      st = ((fb >> 16) + 1) * (st >> sb) + (fb & 0xFFFF);
      if (st < (1u << 16)) st = (st << 16) | (uint32_t)(*ptr++);
      x[g] = st;
      out[i] = (uint8_t)c2s32[slot];
    }
  }
}
// ---------------------------------------------------------------------------
// AVX2 8-lane decode for the BYTE-renorm variants (BYTE and ALIAS).
//
// The 8-bit renorm consumes <= 2 bytes per lane per step, LANE-MAJOR:
// lane g's bytes are adjacent, most-significant first (docs/FORMAT.md,
// rans_byte.h:62-74 bounded to two rounds).  A while-loop per lane would
// serialize; instead the byte count is closed-form
// k = (x < 2^23) + (x < 2^15) (same identity as the Pallas kernel), an
// in-vector exclusive prefix sum gives each lane's byte offset, and ONE
// 32-bit gather at (ptr + off) yields both bytes (b0 = low byte, b1 =
// next) -- ordered consumption without any per-lane loop.
// ---------------------------------------------------------------------------

// SymLookup: (slot, x>>sb) are implicit; functor fills (sym, freq, bias)
// vectors from the slot -- BYTE uses c2s+fc tables, ALIAS the divider
// tables.  Returns new x = freq * (x >> sb) + bias.
template <class SymLookup>
void decode_stream_byte_avx2(const Layout& L, int stream,
                             const uint8_t* bytes, int64_t total_bytes,
                             int sb, const SymLookup& lookup, uint8_t* out) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  const uint8_t* ptr = bytes;
  const uint8_t* end = bytes + total_bytes;
  std::vector<uint32_t> x(lpg);
  for (int g = 0; g < lpg; g++) {  // flushed state: 4 LE bytes per lane
    x[g] = (uint32_t)ptr[0] | ((uint32_t)ptr[1] << 8) |
           ((uint32_t)ptr[2] << 16) | ((uint32_t)ptr[3] << 24);
    ptr += 4;
  }
  int64_t t_full = 0;
  if (L.n_symbols >= lane_base + lpg)
    t_full = (L.n_symbols - lane_base - lpg) / L.n_lanes + 1;

  const __m256i vzero = _mm256_setzero_si256();
  int64_t t = 0;
  // per-step slack: <= 2*lpg bytes consumed, each gather reads 4 bytes
  if constexpr (SymLookup::kTwoPass) {
    // two-pass step (r4.5, as in the WORD/RANS64 paths): pass 1 advances
    // every 8-lane group independently, saving each group's in-vector
    // byte offsets and total; a scalar prefix sum over the totals gives
    // each group's stream base; pass 2 issues every renorm gather at its
    // precomputed base.  The one-pass form serialized on
    // gather -> extract -> next group's gather.  ALIAS opts OUT
    // (kTwoPass=false): its 3-gather lookup plus the saved-offset
    // traffic spills pass-1 registers and measures 24% SLOWER two-pass,
    // while 2-gather BYTE measures 17% faster (docs/DESIGN.md).
    std::vector<int32_t> loff(lpg);     // per-lane byte offsets (saved)
    std::vector<int32_t> goff(lpg / 8 + 1);
    for (; t < t_full && ptr + 2 * lpg + 4 <= end; t++) {
      const int64_t row = t * L.n_lanes + lane_base;
      goff[0] = 0;
      for (int g0 = 0; g0 < lpg; g0 += 8) {  // pass 1: advance
        __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
        __m256i sym, freq, bias;
        lookup(vx, &sym, &freq, &bias);
        vx = _mm256_add_epi32(
            _mm256_mullo_epi32(freq, _mm256_srli_epi32(vx, sb)), bias);
        // closed-form byte count: k = (x < 2^23) + (x < 2^15)
        const __m256i lt23 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 23), vzero);
        const __m256i lt15 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 15), vzero);
        const __m256i k = _mm256_sub_epi32(
            vzero, _mm256_add_epi32(lt23, lt15));  // cmp masks are -1
        const __m256i off = exclusive_prefix_sum_epi32(k);
        _mm256_storeu_si256((__m256i*)&loff[g0], off);
        goff[(g0 >> 3) + 1] =
            _mm256_extract_epi32(off, 7) + _mm256_extract_epi32(k, 7);
        _mm256_storeu_si256((__m256i*)&x[g0], vx);
        store_syms8(out + row + g0, sym);
      }
      for (int g = 0; g < lpg / 8; g++) goff[g + 1] += goff[g];
      for (int g0 = 0; g0 < lpg; g0 += 8) {  // pass 2: ordered renorm
        if (goff[(g0 >> 3) + 1] == goff[g0 >> 3]) continue;
        __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
        const __m256i lt23 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 23), vzero);
        const __m256i lt15 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 15), vzero);
        const __m256i off =
            _mm256_loadu_si256((const __m256i*)&loff[g0]);
        // one dword gather per lane: b0 = low byte (msb of the pair)
        const __m256i quad = _mm256_i32gather_epi32(
            (const int*)(ptr + goff[g0 >> 3]), off, 1);
        const __m256i b0 =
            _mm256_and_si256(quad, _mm256_set1_epi32(0xFF));
        const __m256i b1 = _mm256_and_si256(_mm256_srli_epi32(quad, 8),
                                            _mm256_set1_epi32(0xFF));
        __m256i x1 = _mm256_blendv_epi8(
            vx, _mm256_or_si256(_mm256_slli_epi32(vx, 8), b0), lt23);
        vx = _mm256_blendv_epi8(
            x1, _mm256_or_si256(_mm256_slli_epi32(x1, 8), b1), lt15);
        _mm256_storeu_si256((__m256i*)&x[g0], vx);
      }
      ptr += goff[lpg / 8];
    }
  } else {
    for (; t < t_full && ptr + 2 * lpg + 4 <= end; t++) {
      const int64_t row = t * L.n_lanes + lane_base;
      for (int g0 = 0; g0 < lpg; g0 += 8) {
        __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
        __m256i sym, freq, bias;
        lookup(vx, &sym, &freq, &bias);
        vx = _mm256_add_epi32(
            _mm256_mullo_epi32(freq, _mm256_srli_epi32(vx, sb)), bias);
        // closed-form byte count: k = (x < 2^23) + (x < 2^15)
        const __m256i lt23 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 23), vzero);
        const __m256i lt15 =
            _mm256_cmpeq_epi32(_mm256_srli_epi32(vx, 15), vzero);
        const __m256i k = _mm256_sub_epi32(
            vzero, _mm256_add_epi32(lt23, lt15));  // cmp masks are -1
        const __m256i off = exclusive_prefix_sum_epi32(k);
        // one dword gather per lane: b0 = low byte (msb of the pair)
        const __m256i quad =
            _mm256_i32gather_epi32((const int*)ptr, off, 1);
        const __m256i b0 =
            _mm256_and_si256(quad, _mm256_set1_epi32(0xFF));
        const __m256i b1 = _mm256_and_si256(_mm256_srli_epi32(quad, 8),
                                            _mm256_set1_epi32(0xFF));
        __m256i x1 = _mm256_blendv_epi8(
            vx, _mm256_or_si256(_mm256_slli_epi32(vx, 8), b0), lt23);
        vx = _mm256_blendv_epi8(
            x1, _mm256_or_si256(_mm256_slli_epi32(x1, 8), b1), lt15);
        // ptr += sum(k): last lane's off + k
        ptr +=
            _mm256_extract_epi32(off, 7) + _mm256_extract_epi32(k, 7);
        _mm256_storeu_si256((__m256i*)&x[g0], vx);
        store_syms8(out + row + g0, sym);
      }
    }
  }
  // scalar tail (same transition; two bounded renorm rounds)
  const uint32_t mask = (1u << sb) - 1;
  for (; t < L.steps; t++) {
    for (int g = 0; g < lpg; g++) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      uint32_t st = x[g];
      st = lookup.scalar(st, out + i);
      for (int r = 0; r < 2 && st < (1u << 23); r++)
        st = (st << 8) | (uint32_t)(*ptr++);
      x[g] = st;
    }
  }
}

struct ByteLookupAvx2 {
  static constexpr bool kTwoPass = true;  // 2-gather lookup: +17% two-pass
  const int32_t* c2s32;
  const int32_t* slotfb32;  // per slot: (freq-1)<<16 | (slot - cum)
  int sb;
  uint32_t mask;
  void operator()(__m256i vx, __m256i* sym, __m256i* freq,
                  __m256i* bias) const {
    // two INDEPENDENT slot-indexed gathers (r4; the old slot->sym->fc
    // chain paid a second gather latency on the critical path); freq-1
    // keeps the degenerate freq = 2^16 exact at prob_bits 16
    const __m256i slot = _mm256_and_si256(vx, _mm256_set1_epi32(mask));
    *sym = _mm256_i32gather_epi32(c2s32, slot, 4);
    const __m256i fb = _mm256_i32gather_epi32(slotfb32, slot, 4);
    *freq = _mm256_add_epi32(_mm256_srli_epi32(fb, 16),
                             _mm256_set1_epi32(1));
    *bias = _mm256_and_si256(fb, _mm256_set1_epi32(0xFFFF));
  }
  uint32_t scalar(uint32_t st, uint8_t* o) const {
    const uint32_t slot = st & mask;
    const uint32_t fb = (uint32_t)slotfb32[slot];
    *o = (uint8_t)c2s32[slot];
    return ((fb >> 16) + 1) * (st >> sb) + (fb & 0xFFFF);
  }
};

struct AliasLookupAvx2 {
  // 3-gather lookup spills pass-1 registers: 24% SLOWER two-pass, so it
  // keeps the one-pass engine (docs/DESIGN.md r4.5 bullet)
  static constexpr bool kTwoPass = false;
  const int32_t* div32;  // [256] divider (absolute)
  const int32_t* fs32;   // [512] (freq-1) << 8 | sym
  const int32_t* adj32;  // [512] slot_adjust (wrapped u32 in int lanes)
  int sb;
  uint32_t mask;
  void operator()(__m256i vx, __m256i* sym, __m256i* freq,
                  __m256i* bias) const {
    const __m256i xm = _mm256_and_si256(vx, _mm256_set1_epi32(mask));
    const __m256i bucket = _mm256_srli_epi32(xm, sb - 8);
    const __m256i dv = _mm256_i32gather_epi32(div32, bucket, 4);
    // xm < divider  (both < 2^31: signed compare is exact)
    const __m256i low = _mm256_cmpgt_epi32(dv, xm);
    const __m256i b2 = _mm256_sub_epi32(
        _mm256_slli_epi32(bucket, 1), low);  // 2*bucket (+1 if low)
    // (freq-1, sym) fused into one dword entry (r4): 3 dword gathers per
    // 8 lanes, was 4.  A qword-fused (fs<<32|adj) single entry measured
    // 41% SLOWER here: two 4-element vpgatherqq + 4 cross-lane shuffles
    // lose to wide 8-element vpgatherdd on this core (docs/DESIGN.md).
    const __m256i fs = _mm256_i32gather_epi32(fs32, b2, 4);
    *sym = _mm256_and_si256(fs, _mm256_set1_epi32(0xFF));
    *freq = _mm256_add_epi32(_mm256_srli_epi32(fs, 8),
                             _mm256_set1_epi32(1));
    // 32-bit wrapped subtract is exact (slot_adjust may wrap negative)
    *bias = _mm256_sub_epi32(xm, _mm256_i32gather_epi32(adj32, b2, 4));
  }
  uint32_t scalar(uint32_t st, uint8_t* o) const {
    const uint32_t xm = st & mask;
    uint32_t b2 = (xm >> (sb - 8)) * 2;
    if (xm < (uint32_t)div32[b2 >> 1]) b2++;
    const uint32_t fs = (uint32_t)fs32[b2];
    *o = (uint8_t)(fs & 0xFF);
    return ((fs >> 8) + 1) * (st >> sb) + xm - (uint32_t)adj32[b2];
  }
};
// ---------------------------------------------------------------------------
// AVX2 4-lane decode for RANS64 (63-bit states, 32-bit renorm), pb <= 16.
// One 32-bit word per renorming lane per step (x >= 1 so (x<<32)|w >= 2^32
// > 2^31, rans64.h:134-139); same ordered-consumption LUT idea as the word
// path, over 4 64-bit lanes.  The whole symbol lookup is ONE vpgatherqq
// of a per-slot 8-byte entry bias:16<<40 | sym:8<<32 | freq:32 (r4; was
// two chained dword gathers slot->sym->fc): mul_epu32 reads freq straight
// from the entry's low dword, the bias add replaces the slot-cum
// subtract, and the dependent-gather stage disappears.
// ---------------------------------------------------------------------------

alignas(32) static int32_t g_perm_lut64[16][8];

static bool init_perm_lut64() {
  for (int m = 0; m < 16; m++) {
    int k = 0;
    for (int lane = 0; lane < 4; lane++) {
      const int r = (m >> lane) & 1 ? k++ : 3;
      g_perm_lut64[m][2 * lane] = 2 * r;
      g_perm_lut64[m][2 * lane + 1] = 2 * r + 1;
    }
  }
  return true;
}
static const bool g_perm64_ready = init_perm_lut64();

void decode_stream_r64_avx2(const Layout& L, int stream,
                            const uint32_t* words, int64_t total_words,
                            int sb, const long long* ent64, uint8_t* out) {
  const int lpg = L.lpg;
  const int64_t lane_base = (int64_t)stream * lpg;
  const uint32_t* ptr = words;
  const uint32_t* end = words + total_words;
  std::vector<uint64_t> x(lpg);
  for (int g = 0; g < lpg; g++) {  // 2 LE u32 words per lane
    x[g] = (uint64_t)ptr[0] | ((uint64_t)ptr[1] << 32);
    ptr += 2;
  }
  int64_t t_full = 0;
  if (L.n_symbols >= lane_base + lpg)
    t_full = (L.n_symbols - lane_base - lpg) / L.n_lanes + 1;

  const __m256i vmask = _mm256_set1_epi64x((1ll << sb) - 1);
  const __m256i vzero = _mm256_setzero_si256();
  // two-pass step (r4.5): pass 1 advances every 4-lane group with NO
  // cross-group dependency (the gathers and limb products of all lpg/4
  // groups pipeline freely); the per-group renorm word offsets are a
  // short scalar prefix sum over the saved movemasks; pass 2 issues
  // every renorm load at its precomputed ptr offset.  The one-pass form
  // serialized on load -> popcount -> next group's load.
  std::vector<uint8_t> gmask(lpg / 4);
  std::vector<int32_t> goff(lpg / 4 + 1);
  int64_t t = 0;
  for (; t < t_full && ptr + lpg + 4 <= end; t++) {
    const int64_t row = t * L.n_lanes + lane_base;
    for (int g0 = 0; g0 < lpg; g0 += 4) {  // pass 1: advance
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
      const __m256i slot = _mm256_and_si256(vx, vmask);
      const __m256i e = _mm256_i64gather_epi64(ent64, slot, 8);
      const __m256i y = _mm256_srli_epi64(vx, sb);
      // x = freq * y + bias: 64x32 product via two 32x32->64; mul_epu32
      // reads each qword's LOW dword, which is exactly the entry's freq
      const __m256i t1 = _mm256_mul_epu32(y, e);
      const __m256i t2 = _mm256_mul_epu32(_mm256_srli_epi64(y, 32), e);
      vx = _mm256_add_epi64(
          _mm256_add_epi64(t1, _mm256_slli_epi64(t2, 32)),
          _mm256_srli_epi64(e, 40));
      // renorm need: x < 2^31  <=>  x >> 31 == 0
      const __m256i need =
          _mm256_cmpeq_epi64(_mm256_srli_epi64(vx, 31), vzero);
      gmask[g0 >> 2] =
          (uint8_t)_mm256_movemask_pd(_mm256_castsi256_pd(need));
      _mm256_storeu_si256((__m256i*)&x[g0], vx);
      // syms are byte 4 of each qword entry; pack 4 to one dword store
      const __m256i symshuf = _mm256_setr_epi8(
          4, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1,
          4, 12, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1);
      __m256i p = _mm256_shuffle_epi8(e, symshuf);
      p = _mm256_permutevar8x32_epi32(
          p, _mm256_setr_epi32(0, 4, 0, 0, 0, 0, 0, 0));
      const __m128i p128 = _mm256_castsi256_si128(p);
      const uint32_t s4 = (uint32_t)(uint16_t)_mm_extract_epi16(p128, 0) |
                          ((uint32_t)(uint16_t)_mm_extract_epi16(p128, 2)
                           << 16);
      std::memcpy(out + row + g0, &s4, 4);
    }
    goff[0] = 0;
    for (int g = 0; g < lpg / 4; g++)
      goff[g + 1] = goff[g] + __builtin_popcount((unsigned)gmask[g]);
    for (int g0 = 0; g0 < lpg; g0 += 4) {  // pass 2: ordered renorm
      const int m = gmask[g0 >> 2];
      if (!m) continue;
      __m256i vx = _mm256_loadu_si256((const __m256i*)&x[g0]);
      const __m256i need =
          _mm256_cmpeq_epi64(_mm256_srli_epi64(vx, 31), vzero);
      const __m256i w4 = _mm256_cvtepu32_epi64(
          _mm_loadu_si128((const __m128i*)(ptr + goff[g0 >> 2])));
      const __m256i w = _mm256_permutevar8x32_epi32(
          w4, _mm256_load_si256((const __m256i*)g_perm_lut64[m]));
      vx = _mm256_blendv_epi8(
          vx, _mm256_or_si256(_mm256_slli_epi64(vx, 32), w), need);
      _mm256_storeu_si256((__m256i*)&x[g0], vx);
    }
    ptr += goff[lpg / 4];
  }
  const uint64_t mask = (1ull << sb) - 1;
  for (; t < L.steps; t++) {
    for (int g = 0; g < lpg; g++) {
      const int64_t i = t * L.n_lanes + lane_base + g;
      if (i >= L.n_symbols) continue;
      uint64_t st = x[g];
      const uint64_t slot = st & mask;
      const uint64_t e = (uint64_t)ent64[slot];
      st = (e & 0xFFFFFFFFull) * (st >> sb) + (e >> 40);
      if (st < (1ull << 31)) st = (st << 32) | (uint64_t)(*ptr++);
      x[g] = st;
      out[i] = (uint8_t)(e >> 32);
    }
  }
}
#endif  // __AVX2__

// ---------------------------------------------------------------------------
// RANS64 division-free encode: per-symbol 64-bit Alverson reciprocals with
// the freq < 2 fold (rcp = 2^64-1 makes q = x-1; bias = start + M - 1
// absorbs the correction), the same scheme the reference uses
// (rans64.h:167-247) and models/tables.py builds for the K6 kernel.  The
// 64-bit hardware divide this replaces was the encode bottleneck
// (NATIVE_r03: 0.29 GB/s vs the reference's reciprocal build at 0.387).
// ---------------------------------------------------------------------------

struct R64EncSym {  // 32 bytes: two entries per cache line
  uint64_t rcp_freq;
  uint64_t x_max;      // freq << (63 - sb)
  uint64_t bias;       // cum (+ M - 1 in the freq < 2 fold); u64 so the
                       // pb=31 x + bias add never truncates
  uint32_t cmpl_freq;  // M - freq (fits u32 for sb <= 31)
  uint32_t rcp_shift;
};
static_assert(sizeof(R64EncSym) == 32, "keep two R64EncSym per cache line");

void build_r64_enc(const uint32_t* freqs, const uint64_t* cum, int sb,
                   R64EncSym* out) {
  const uint64_t M = 1ull << sb;
  for (int s = 0; s < kNSyms; s++) {
    const uint64_t freq = freqs[s];
    R64EncSym& e = out[s];
    e.x_max = freq << (63 - sb);
    e.cmpl_freq = M - freq;
    if (freq < 2) {
      e.rcp_freq = ~0ull;
      e.rcp_shift = 0;
      e.bias = cum[s] + M - 1;
    } else {
      uint32_t shift = 0;
      while (freq > (1ull << shift)) shift++;
      // ceil(2^(shift+63) / freq) via 128-bit arithmetic
      e.rcp_freq = (uint64_t)((((unsigned __int128)1 << (shift + 63)) +
                               freq - 1) / freq);
      e.rcp_shift = shift - 1;
      e.bias = cum[s];
    }
  }
}

struct Model {
  uint64_t cum[kNSyms + 1];
  uint32_t freqs[kNSyms];
  std::vector<uint8_t> c2s;  // slot -> symbol (decode only)

  void init(const uint32_t* f, const uint32_t* c, int scale_bits,
            bool with_c2s) {
    for (int i = 0; i < kNSyms; i++) freqs[i] = f[i];
    for (int i = 0; i <= kNSyms; i++) cum[i] = c[i];
    if (!with_c2s) return;
    const uint32_t M = 1u << scale_bits;
    c2s.resize(M);
    for (int s = 0; s < kNSyms; s++)
      for (uint64_t k = cum[s]; k < cum[s + 1]; k++) c2s[k] = (uint8_t)s;
  }
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Encode `data[n_symbols]`; writes substreams back-to-back (each substream
// word-aligned by construction) into `out` and per-substream WORD counts
// into `stream_words[n_streams]`.  Returns total payload bytes, or -1 if
// out_capacity is too small, -2 on bad arguments.
int64_t trans_encode(int variant, int prob_bits, int n_lanes,
                     int lanes_per_stream, const uint8_t* data,
                     int64_t n_symbols, const uint32_t* freqs,
                     const uint32_t* cum_freqs_u32, uint8_t* out,
                     int64_t out_capacity, int64_t* stream_words) {
  if (n_lanes <= 0 || lanes_per_stream <= 0 || n_lanes % lanes_per_stream)
    return -2;
  Layout L = make_layout(n_symbols, n_lanes, lanes_per_stream);
  Model m;
  m.init(freqs, cum_freqs_u32, prob_bits, false);
  const int sb = prob_bits;

  AliasTables alias;
  if (variant == 3 && !build_alias(m.freqs, m.cum, sb, &alias)) return -2;

#if defined(__AVX2__)
  const bool enc_avx2_ok = __builtin_cpu_supports("avx2") &&
                           std::getenv("RANS_CORE_NO_AVX2") == nullptr &&
                           L.lpg % 8 == 0;
  const bool enc_word_avx2 = variant == 1 && sb <= 15 && enc_avx2_ok;
  const bool enc_byte_avx2 =
      (variant == 0 || variant == 3) && sb <= 16 && enc_avx2_ok;
  std::vector<int32_t> encfc32;
  if (enc_word_avx2 || enc_byte_avx2) {
    encfc32.resize(kNSyms);
    for (int sy = 0; sy < kNSyms; sy++)
      encfc32[sy] = (int32_t)(((m.freqs[sy] ? m.freqs[sy] - 1 : 0) << 16) |
                              (uint32_t)m.cum[sy]);
  }
#endif
  std::vector<R64EncSym> r64tab;
  if (variant == 2) {
    r64tab.resize(kNSyms);
    build_r64_enc(m.freqs, m.cum, sb, r64tab.data());
  }

  int64_t total = 0;
  for (int s = 0; s < L.n_streams; s++) {
    int64_t words = 0;
    switch (variant) {
      case 0: {  // BYTE: x_max = freq << (23 - sb + 8)   (rans_byte.h:64)
#if defined(__AVX2__)
        if (enc_byte_avx2) {
          words = encode_stream_byte_avx2(L, s, data, sb, encfc32.data(),
                                          IdentityRemap{}, out + total,
                                          out_capacity - total);
          break;
        }
#endif
        auto xmax = [&](int sym) {
          return (uint64_t)m.freqs[sym] << (23 - sb + 8);
        };
        auto upd = [&](uint64_t x, int sym) {
          return ((x / m.freqs[sym]) << sb) + (x % m.freqs[sym]) + m.cum[sym];
        };
        words = encode_stream<ByteTraits>(
            L, s, data, xmax, upd, out + total,
            (out_capacity - total) / (int64_t)sizeof(uint8_t));
        break;
      }
      case 1: {  // WORD: x_max = freq << (16 - sb + 16) (rans_word_sse41.h:85)
#if defined(__AVX2__)
        if (enc_word_avx2) {
          words = encode_stream_word_avx2(
              L, s, data, sb, encfc32.data(), (uint16_t*)(out + total),
              (out_capacity - total) / (int64_t)sizeof(uint16_t));
          break;
        }
#endif
        auto xmax = [&](int sym) {
          return (uint64_t)m.freqs[sym] << (16 - sb + 16);
        };
        auto upd = [&](uint64_t x, int sym) {
          return ((x / m.freqs[sym]) << sb) + (x % m.freqs[sym]) + m.cum[sym];
        };
        words = encode_stream<WordTraits>(
            L, s, data, xmax, upd, (uint16_t*)(out + total),
            (out_capacity - total) / (int64_t)sizeof(uint16_t));
        break;
      }
      case 2: {  // RANS64: x_max = freq << (31 - sb + 32)   (rans64.h:83)
        auto xmax = [&](int sym) { return r64tab[sym].x_max; };
        auto upd = [&](uint64_t x, int sym) {
          // q = mulhi64(x, rcp) >> shift; x += bias + q * (M - freq)
          const R64EncSym& e = r64tab[sym];
          const uint64_t q =
              (uint64_t)(((unsigned __int128)x * e.rcp_freq) >> 64) >>
              e.rcp_shift;
          return x + e.bias + q * e.cmpl_freq;
        };
        words = encode_stream<R64Traits>(
            L, s, data, xmax, upd, (uint32_t*)(out + total),
            (out_capacity - total) / (int64_t)sizeof(uint32_t));
        break;
      }
      case 3: {  // ALIAS: byte renorm + remapped slot (main_alias.cpp:241-250)
#if defined(__AVX2__)
        if (enc_byte_avx2) {
          words = encode_stream_byte_avx2(
              L, s, data, sb, encfc32.data(),
              AliasRemap{(const int32_t*)alias.remap.data()}, out + total,
              out_capacity - total);
          break;
        }
#endif
        auto xmax = [&](int sym) {
          return (uint64_t)m.freqs[sym] << (23 - sb + 8);
        };
        auto upd = [&](uint64_t x, int sym) {
          return ((x / m.freqs[sym]) << sb) +
                 alias.remap[(x % m.freqs[sym]) + m.cum[sym]];
        };
        words = encode_stream<ByteTraits>(
            L, s, data, xmax, upd, out + total,
            (out_capacity - total) / (int64_t)sizeof(uint8_t));
        break;
      }
      default:
        return -2;
    }
    if (words < 0) return -1;
    stream_words[s] = words;
    const int word_size = (variant == 1) ? 2 : (variant == 2) ? 4 : 1;
    total += words * word_size;
  }
  return total;
}

// Decode a payload produced by trans_encode. Returns 0, or -2 on bad args.
int64_t trans_decode(int variant, int prob_bits, int n_lanes,
                     int lanes_per_stream, const uint8_t* payload,
                     const int64_t* stream_words, int64_t n_symbols,
                     const uint32_t* freqs, const uint32_t* cum_freqs_u32,
                     uint8_t* out) {
  if (n_lanes <= 0 || lanes_per_stream <= 0 || n_lanes % lanes_per_stream)
    return -2;
  Layout L = make_layout(n_symbols, n_lanes, lanes_per_stream);
  Model m;
  m.init(freqs, cum_freqs_u32, prob_bits, true);
  const int sb = prob_bits;
  const uint64_t mask = (1ull << sb) - 1;

  AliasTables alias;
  if (variant == 3 && !build_alias(m.freqs, m.cum, sb, &alias)) return -2;

#if defined(__AVX2__)
  // widened tables for the AVX2 paths' vpgatherdd (32-bit loads)
  // RANS_CORE_NO_AVX2=1 forces the scalar engine (differential testing)
  const bool have_avx2 = __builtin_cpu_supports("avx2") &&
                         std::getenv("RANS_CORE_NO_AVX2") == nullptr;
  const bool lanes8 = L.lpg % 8 == 0;
  const bool word_avx2 = variant == 1 && sb <= 15 && have_avx2 && lanes8;
  const bool byte_avx2 = variant == 0 && sb <= 16 && have_avx2 && lanes8;
  const bool alias_avx2 = variant == 3 && have_avx2 && lanes8;
  const bool r64_avx2 =
      variant == 2 && sb <= 16 && have_avx2 && L.lpg % 4 == 0;
  // slot-direct per-slot tables (r4): both lookups index by SLOT, so the
  // gathers are independent (the reference's own RansWordTables unrolling,
  // rans_word_sse41.h:58-72) instead of the chained slot->sym->fc form
  std::vector<int32_t> c2s32, slotfb32;
  if (word_avx2 || byte_avx2) {
    const uint32_t M = 1u << sb;
    c2s32.assign(m.c2s.begin(), m.c2s.end());
    slotfb32.resize(M);
    for (uint32_t sl = 0; sl < M; sl++) {
      const int sy = m.c2s[sl];
      slotfb32[sl] = (int32_t)(((m.freqs[sy] - 1) << 16) |
                               (uint32_t)(sl - m.cum[sy]));
    }
  }
  std::vector<long long> r64ent;  // bias:16<<40 | sym:8<<32 | freq:32
  if (r64_avx2) {
    const uint32_t M = 1u << sb;
    r64ent.resize(M);
    for (uint32_t sl = 0; sl < M; sl++) {
      const int sy = m.c2s[sl];
      r64ent[sl] = (long long)(
          ((uint64_t)(sl - (uint32_t)m.cum[sy]) << 40) |
          ((uint64_t)(uint8_t)sy << 32) | (uint64_t)m.freqs[sy]);
    }
  }
  std::vector<int32_t> adiv32, afs32, aadj32;
  if (alias_avx2) {
    adiv32.assign(alias.divider.begin(), alias.divider.end());
    aadj32.assign(alias.slot_adjust.begin(), alias.slot_adjust.end());
    afs32.resize(512);
    for (int b2 = 0; b2 < 512; b2++) {
      const uint32_t f = alias.slot_freqs[b2];  // 0 only for unselected
      afs32[b2] = (int32_t)((((f ? f : 1) - 1) << 8) | alias.sym_id[b2]);
    }
  }
#endif

  int64_t off = 0;
  for (int s = 0; s < L.n_streams; s++) {
    switch (variant) {
      case 0: {
#if defined(__AVX2__)
        if (byte_avx2) {
          ByteLookupAvx2 lk{c2s32.data(), slotfb32.data(), sb,
                            (uint32_t)mask};
          decode_stream_byte_avx2(L, s, payload + off, stream_words[s],
                                  sb, lk, out);
          off += stream_words[s];
          break;
        }
#endif
        auto step = [&](uint64_t x, int* sym) {
          const uint64_t slot = x & mask;
          const int sy = m.c2s[slot];
          *sym = sy;
          return m.freqs[sy] * (x >> sb) + slot - m.cum[sy];
        };
        decode_stream<ByteTraits>(L, s, payload + off, step, out);
        off += stream_words[s];
        break;
      }
      case 1: {
#if defined(__AVX2__)
        if (word_avx2) {
          decode_stream_word_avx2(L, s, (const uint16_t*)(payload + off),
                                  stream_words[s], sb, c2s32.data(),
                                  slotfb32.data(), out);
          off += stream_words[s] * 2;
          break;
        }
#endif
        auto step = [&](uint64_t x, int* sym) {
          const uint64_t slot = x & mask;
          const int sy = m.c2s[slot];
          *sym = sy;
          return m.freqs[sy] * (x >> sb) + slot - m.cum[sy];
        };
        decode_stream<WordTraits>(L, s, (const uint16_t*)(payload + off),
                                  step, out);
        off += stream_words[s] * 2;
        break;
      }
      case 2: {
#if defined(__AVX2__)
        if (r64_avx2) {
          decode_stream_r64_avx2(L, s, (const uint32_t*)(payload + off),
                                 stream_words[s], sb, r64ent.data(), out);
          off += stream_words[s] * 4;
          break;
        }
#endif
        auto step = [&](uint64_t x, int* sym) {
          const uint64_t slot = x & mask;
          const int sy = m.c2s[slot];
          *sym = sy;
          return m.freqs[sy] * (x >> sb) + slot - m.cum[sy];
        };
        decode_stream<R64Traits>(L, s, (const uint32_t*)(payload + off), step,
                                 out);
        off += stream_words[s] * 4;
        break;
      }
      case 3: {  // alias O(1) lookup (main_alias.cpp:252-267)
#if defined(__AVX2__)
        if (alias_avx2) {
          AliasLookupAvx2 lk{adiv32.data(), afs32.data(), aadj32.data(),
                             sb, (uint32_t)mask};
          decode_stream_byte_avx2(L, s, payload + off, stream_words[s],
                                  sb, lk, out);
          off += stream_words[s];
          break;
        }
#endif
        auto step = [&](uint64_t x, int* sym) {
          const uint64_t xm = x & mask;
          uint32_t b2 = (uint32_t)(xm >> (sb - 8)) * 2;
          if (xm < alias.divider[b2 >> 1]) b2++;
          *sym = alias.sym_id[b2];
          return alias.slot_freqs[b2] * (x >> sb) + xm - alias.slot_adjust[b2];
        };
        decode_stream<ByteTraits>(L, s, payload + off, step, out);
        off += stream_words[s];
        break;
      }
      default:
        return -2;
    }
  }
  return 0;
}

// Build-and-export alias tables so Python callers can check the builder.
// Buffers: divider[256], slot_freqs[512], slot_adjust[512], sym_id[512],
// remap[1<<scale_bits].  Returns 0 on success.
int64_t trans_build_alias(int scale_bits, const uint32_t* freqs,
                          const uint32_t* cum_freqs_u32, uint32_t* divider,
                          uint32_t* slot_freqs, uint32_t* slot_adjust,
                          uint8_t* sym_id, uint32_t* remap) {
  uint64_t cum[kNSyms + 1];
  for (int i = 0; i <= kNSyms; i++) cum[i] = cum_freqs_u32[i];
  AliasTables t;
  if (!build_alias(freqs, cum, scale_bits, &t)) return -2;
  std::memcpy(divider, t.divider.data(), 256 * 4);
  std::memcpy(slot_freqs, t.slot_freqs.data(), 512 * 4);
  std::memcpy(slot_adjust, t.slot_adjust.data(), 512 * 4);
  std::memcpy(sym_id, t.sym_id.data(), 512);
  std::memcpy(remap, t.remap.data(), ((size_t)1 << scale_bits) * 4);
  return 0;
}

}  // extern "C"

// Int8 tensor-core tiles over digits, shared by the packed conv (K2), the
// packed GEMM (K3) and the code GEMM (K4).
//
// All three compute acc[row, col] = sum_k a[row, k] * w[k, col] (mod 2^32)
// from weight bit planes packed 32 K values to a word, (w_bits, W, cols),
// W the number of K words. The activations come from a source: bit-plane
// words (a_bits, rows, ...) for K2 and K3, int32 codes (rows, K) for K4.
// The reference's TPU kernels turn both operands into int8 digit planes
// (digits_from_planes, _act_operands) and issue one int8 MXU product per
// digit pair, Horner-combined in int32 (_digit_matmul_acc,
// bitserial_matmul.py:277). Here each digit pair is one
// mma.sync.m16n8k32.s8.s8.s32 per K word:
//
// * Digit plan (chosen by the wrapper from (bits, signed) alone,
//   core/bitops.py::kernel_digits): a signed operand of <= 8 bits
//   is one signed int8 digit; anything else is radix-7 digits, the top one
//   carrying the sign. Digit d of a pair (i, j) weighs 2^(7 (i + j)); a
//   one-digit operand only has index 0, so its radix never shows.
// * Expansion in registers. A K word of one plane holds 32 K values of one
//   row (activations) or column (weights), exactly one k32 step. The
//   product does not depend on the order of K inside the step, so K value
//   at bit 8b + c of the word is put at byte b of the fragment register of
//   k-chunk c (chunk c = k 4c..4c+3 in PTX's fragment layout). The register
//   of chunk c is then (word >> c) & 0x01010101 for one plane, shifted to
//   the plane's place in its digit; the MSB plane of a signed digit adds
//   its sign extension (0xff << q) & 0xff per set byte. About one integer
//   op per value and plane, with no table and no loop over bits.
// * Digits from codes (K4). The same K order read from (rows, K) codes:
//   lane (g, t) needs codes 32 kw + t + 4j, j = 0..7, of its row; byte b of
//   chunk t is code 8b + t and of chunk t + 4 code 8b + t + 4. It loads
//   codes 4t..4t+3 and 16+4t..16+4t+3 (two 16-byte loads) and a byte
//   transpose within the quad of lanes t = 0..3 moves them. A code is
//   masked to a_bits and sign-extended when signed (_act_operands), giving
//   v; its digits are v's low byte (one digit) or radix 7,
//   (v >> 7j) & 0x7f and the top one v >> 7 (nd - 1) with the sign. For
//   the LM's A8 the digit is the code's low byte: a byte permute per four
//   codes. No planes are packed or expanded.
// * Accumulation. One s32 mma sum per digit-pair magnitude, folded with its
//   shift into a uint32 tile in shared memory every kFoldWords K words and
//   at the end. A digit product is at most 2^14 in magnitude and a
//   magnitude takes at most 3 pairs, so 3 * 2^14 * 32 * kFoldWords < 2^31:
//   no mma sum overflows, whatever K is. The uint32 tile wraps modulo 2^32
//   like the reference's int32 sums, and the K-split warps of a block add
//   into it in any order with the same result.
// * Tiles. Weights are the A operand (m16: 16 output columns), activation
//   rows the B operand (n8: 8 rows), so at decode (M = 4) one read of each
//   weight word serves every row. A block owns 32 columns x 8 NT rows
//   (NT = 4, 2 or 1) and splits the K words over its warps (word kw goes
//   to warp kw % warps). The caller's tile sets NT and the warps
//   (kernels/tuning.py); given none, the heuristic takes the largest NT
//   that leaves about two blocks per SM and about kWordsPerWarp words a
//   warp (dispatch). Each warp runs 2 x NT mma tiles per digit
//   pair and word. Every load of a word is issued before its first use:
//   the weights' and the source's load steps issue them all, and only then
//   are digits built. The main paths' operands (W2A2, W4A8) get
//   instantiations whose plane count and sign are compile-time (Fixed); any
//   other plan runs Any.
// * Epilogue. The uint32 tile is staged in shared memory (row stride 36
//   words: the fragments' atomics hit distinct banks), then warp w runs
//   epi::store for rows w, w + warps, ...: one warp holds 32 consecutive
//   columns of a row, as the shared epilogue wants.
//
// Fragment layout of mma.m16n8k32 .s8 (PTX ISA, "Matrix fragments for
// mma.m16n8k32"), g = lane / 4, t = lane % 4:
//   A (16 x 32, row): a0 row g, k 4t..4t+3; a1 row g+8, same k;
//                     a2 row g, k 16+4t..; a3 row g+8, k 16+4t..
//   B (32 x 8, col):  b0 col g, k 4t..4t+3; b1 col g, k 16+4t..
//   C (16 x 8, s32):  c0, c1 row g, cols 2t, 2t+1; c2, c3 row g+8.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace dig {

constexpr int kFoldWords = 1024;   // K words between folds of the s32 sums
constexpr int kRowStride = 36;     // uint32 words per staged tile row
constexpr int kMaxBits = 16;       // the MVU's operand range
constexpr uint32_t kBytes = 0x01010101u;

// The heuristic's tile sizes (chosen on an H100 at ResNet9's and
// stablelm-1.6b's shapes; PERF.md gives the sweep). A caller may pass its
// own tile instead (dispatch's nt and warps: kernels/tuning.py's choice).
constexpr int kWarpsNT4 = 4;      // K-split warps of a 4-row-tile block, most
constexpr int kMinBlocksNT4 = 4;  // its blocks per SM (launch bound)
constexpr int kWordsPerWarp = 4;  // K words per warp the split aims at
constexpr int kMaxNT = 4;         // row tiles per block, at most (1, 2 or 4)
constexpr int kBlocks = 264;      // blocks a shape should give before NT halves

// One operand's digit plan: `bits` planes, the MSB weighing negative when
// `sign`, split into `nd` digits (1: one int8 digit; else radix 7).
struct Plan {
  int bits, sign, nd;
};

// How a kernel instantiation reads an operand. Fixed<P, S>: exactly P
// planes, signed when S, one int8 digit, all known when compiling (the main
// paths' W2A2 and W4A8: no work on planes that do not exist). Any: up to 16
// planes and 3 digits, read from the Plan at run time.
template <int P, bool S>
struct Fixed {
  static constexpr int kPlanes = P, kDigits = 1;
  static constexpr bool kFixed = true, kSigned = S;
  __host__ __device__ static bool fits(const Plan& p) {
    return p.bits == P && (p.sign != 0) == S && p.nd == 1;
  }
};
struct Any {
  static constexpr int kPlanes = kMaxBits, kDigits = 3;
  static constexpr bool kFixed = false, kSigned = false;  // from the Plan
};

// The plane words of one row or column: p[b * plane] for b < bits, each
// ANDed with `mask` (0: a padding or out-of-range row; nothing is loaded).
// Predicated loads, no branch: a caller issues every load of a K word
// before the first use, one memory round trip per word.
template <class Op>
__device__ __forceinline__ void load_planes(const int32_t* p, long long plane,
                                            uint32_t mask, const Plan& pl,
                                            uint32_t (&w)[Op::kPlanes]) {
#pragma unroll
  for (int b = 0; b < Op::kPlanes; ++b)
    w[b] = ((Op::kFixed || b < pl.bits) && mask != 0u)
               ? (uint32_t)__ldg(p + b * plane) & mask : 0u;
}

// Digit registers of the two k-chunks (t and t + 4) of one row or column.
template <class Op>
__device__ __forceinline__ void expand(const uint32_t (&w)[Op::kPlanes],
                                       const Plan& pl, int t,
                                       uint32_t (&lo)[Op::kDigits],
                                       uint32_t (&hi)[Op::kDigits]) {
#pragma unroll
  for (int j = 0; j < Op::kDigits; ++j) lo[j] = hi[j] = 0u;
#pragma unroll
  for (int b = 0; b < Op::kPlanes; ++b) {
    const uint32_t x0 = (w[b] >> t) & kBytes;
    const uint32_t x1 = (w[b] >> (t + 4)) & kBytes;
    const bool one = Op::kFixed || pl.nd == 1;
    const int q = one ? b : b % 7;            // place inside its digit
    const bool msb = Op::kFixed ? (Op::kSigned && b == Op::kPlanes - 1)
                                : (pl.sign && b == pl.bits - 1);
    const uint32_t mul = msb ? ((0xffu << q) & 0xffu)   // sign extension
                             : (1u << q);
    if (one) {
      lo[0] |= x0 * mul;
      hi[0] |= x1 * mul;
    } else {
#pragma unroll
      for (int j = 0; j < Op::kDigits; ++j)
        if (j == b / 7) {
          lo[j] |= x0 * mul;
          hi[j] |= x1 * mul;
        }
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The weights of one tile product: (w_bits, W, cols) words.
struct Weights {
  const int32_t* w;
  int words, cols;
  Plan plan;
};

// acc (uint32, modulo 2^32) of the block's 32 columns x 8 NT rows, then the
// fused epilogue. The activation source `Src` is stepped through this
// warp's K words in order (kw = warp, warp + warps, ...) and provides:
//   void step(int kw);                       // move to K word kw
//   bool live() const;                       // any of this lane's rows real
//   template <class OpA, int NT> using Regs; // what one K word loads into
//   template <class OpA, int NT>             // issue every load of the word
//   void load(const Plan&, Regs<OpA, NT>&) const;
//   template <class OpA, int NT>             // digit registers of chunks
//   void digits(const Regs<OpA, NT>&, const Plan&, int t,     // t, t + 4
//               uint32_t (&lo)[NT][OpA::kDigits],
//               uint32_t (&hi)[NT][OpA::kDigits]) const;
// Blocks: blockIdx.y is the column tile (c0 = 32 blockIdx.y), the caller's
// r0 the first of its 8 NT rows.
template <class OpA, class OpW, int NT, class Src>
__device__ __forceinline__ void tile(Src& src, const Plan& ap,
                                     const Weights& wt, long long rows,
                                     long long r0, const epi::Epilogue& e) {
  constexpr int NDA = OpA::kDigits, NDW = OpW::kDigits;
  constexpr int NMAG = NDA + NDW - 1;
  __shared__ uint32_t red[8 * NT][kRowStride];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.y * 32;
  for (int i = threadIdx.x; i < 8 * NT * kRowStride; i += blockDim.x)
    (&red[0][0])[i] = 0u;
  __syncthreads();

  int32_t acc[NMAG][2][NT][4];
  auto zero = [&]() {
#pragma unroll
    for (int m = 0; m < NMAG; ++m)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][mt][nt][r] = 0;
  };
  auto fold = [&]() {
#pragma unroll
    for (int m = 0; m < NMAG; ++m) {
      if (m > ap.nd + wt.plan.nd - 2) continue;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 8 * nt + 2 * t + (r & 1);
            const int col = 16 * mt + g + 8 * (r >> 1);
            atomicAdd(&red[row][col], (uint32_t)acc[m][mt][nt][r] << (7 * m));
          }
    }
    zero();
  };
  zero();

  const long long wplane = (long long)wt.words * wt.cols;
  int since_fold = 0;
  for (int kw = warp; kw < wt.words; kw += warps) {
    src.step(kw);
    if (!__any_sync(0xffffffffu, src.live())) continue;  // padding taps
    uint32_t wp[4][OpW::kPlanes];  // columns c0 + g + 8q
    typename Src::template Regs<OpA, NT> xr;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = c0 + g + 8 * q;
      load_planes<OpW>(wt.w + (long long)kw * wt.cols + col, wplane,
                       col < wt.cols ? 0xffffffffu : 0u, wt.plan, wp[q]);
    }
    src.template load<OpA, NT>(ap, xr);
    uint32_t wl[4][NDW], wh[4][NDW], al[NT][NDA], ah[NT][NDA];
#pragma unroll
    for (int q = 0; q < 4; ++q) expand<OpW>(wp[q], wt.plan, t, wl[q], wh[q]);
    src.template digits<OpA, NT>(xr, ap, t, al, ah);
#pragma unroll
    for (int i = 0; i < NDA; ++i) {
      if (i >= ap.nd) continue;
#pragma unroll
      for (int j = 0; j < NDW; ++j) {
        if (j >= wt.plan.nd) continue;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_s8(acc[i + j][mt][nt], wl[2 * mt][j], wl[2 * mt + 1][j],
                   wh[2 * mt][j], wh[2 * mt + 1][j], al[nt][i], ah[nt][i]);
      }
    }
    if (++since_fold == kFoldWords) {
      fold();
      since_fold = 0;
    }
  }
  fold();
  __syncthreads();

  const int c = c0 + lane;
  for (int rl = warp; rl < 8 * NT; rl += warps) {
    const long long row = r0 + rl;
    if (row >= rows) break;  // the same for the whole warp
    epi::store(e, red[rl][lane], lane, c < wt.cols, c, row, rows, wt.cols);
  }
}

__host__ __device__ inline uint32_t tail_mask(int k) {
  return (k % 32) ? ((1u << (k % 32)) - 1u) : 0xffffffffu;
}

// The load and digits steps of a source of activation plane words (Dense,
// ConvSrc): D provides `plane`, the plane stride, and
// word(nt, &p) -> the mask of row tile nt's word at *p (0: none).
template <class D>
struct PlaneSrc {
  template <class OpA, int NT>
  using Regs = uint32_t[NT][OpA::kPlanes];

  template <class OpA, int NT>
  __device__ __forceinline__ void load(const Plan& ap,
                                       Regs<OpA, NT>& xp) const {
    const D& d = static_cast<const D&>(*this);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int32_t* p = nullptr;
      const uint32_t mask = d.word(nt, &p);
      load_planes<OpA>(p, d.plane, mask, ap, xp[nt]);
    }
  }
  template <class OpA, int NT>
  __device__ __forceinline__ void digits(
      const Regs<OpA, NT>& xp, const Plan& ap, int t,
      uint32_t (&al)[NT][OpA::kDigits],
      uint32_t (&ah)[NT][OpA::kDigits]) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) expand<OpA>(xp[nt], ap, t, al[nt], ah[nt]);
  }
};

// Dense activation words (a_bits, rows, words): row r0 + 8 nt + g of
// lane g; lanes past K in the last word masked.
struct Dense : PlaneSrc<Dense> {
  const int32_t* x;
  long long plane, rows, r0;
  int words, g, kw;
  uint32_t tail;
  __device__ __forceinline__ void step(int k) { kw = k; }
  __device__ __forceinline__ bool live() const { return true; }
  __device__ __forceinline__ uint32_t word(int nt, const int32_t** p) const {
    const long long row = r0 + 8 * nt + g;
    if (row >= rows) return 0u;
    *p = x + row * words + kw;
    return kw == words - 1 ? tail : 0xffffffffu;
  }
};

// Integer codes (rows, k), int32, of row r0 + 8 nt + g: lane (g, t) loads
// codes 32 kw + 4t + i and 32 kw + 16 + 4t + i, i = 0..3, of the word, two
// 16-byte loads when `vec` (k % 4 == 0 and x 16-byte aligned), else one by
// one; codes past k and rows past `rows` load nothing and are 0. The digits
// step makes each code's digit byte, then a 4 x 4 byte transpose within the
// quad (two shuffles) gives lane t codes t + 4j, j = 0..7: even j to chunk
// t (byte j / 2), odd j to chunk t + 4 — the K order expand gives the
// weights.
struct Codes {
  const int32_t* x;
  long long rows, r0;
  int k, g, t, kw;
  bool vec;

  template <class OpA, int NT>
  using Regs = int4[NT][2];

  __device__ __forceinline__ void step(int word) { kw = word; }
  __device__ __forceinline__ bool live() const { return true; }

  template <class OpA, int NT>
  __device__ __forceinline__ void load(const Plan&, Regs<OpA, NT>& c) const {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const long long row = r0 + 8 * nt + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k0 = 32 * kw + 16 * h + 4 * t;
        const int32_t* p = x + row * k + k0;
        if (vec) {
          c[nt][h] = (row < rows && k0 < k)
                         ? __ldg(reinterpret_cast<const int4*>(p))
                         : make_int4(0, 0, 0, 0);
        } else {
          const bool real = row < rows;
          c[nt][h].x = (real && k0 < k) ? __ldg(p) : 0;
          c[nt][h].y = (real && k0 + 1 < k) ? __ldg(p + 1) : 0;
          c[nt][h].z = (real && k0 + 2 < k) ? __ldg(p + 2) : 0;
          c[nt][h].w = (real && k0 + 3 < k) ? __ldg(p + 3) : 0;
        }
      }
    }
  }

  // v: the code masked to the plan's bits, sign-extended when signed.
  template <class OpA>
  __device__ __forceinline__ static int32_t value(int32_t c, const Plan& ap) {
    const int bits = OpA::kFixed ? OpA::kPlanes : ap.bits;
    const bool sign = OpA::kFixed ? OpA::kSigned : ap.sign != 0;
    if (OpA::kFixed && OpA::kSigned && OpA::kPlanes == 8)
      return c;  // one digit: only the low byte is read
    return sign ? (int32_t)((uint32_t)c << (32 - bits)) >> (32 - bits)
                : (int32_t)((uint32_t)c & ((1u << bits) - 1u));
  }
  // Digit i of v: radix 7, the top one (i == nd - 1) keeping the sign.
  __device__ __forceinline__ static int32_t digit(int32_t v, int i, int nd) {
    return i == nd - 1 ? v >> (7 * i) : (v >> (7 * i)) & 0x7f;
  }
  // The low bytes of digit i of a vector's four codes, bytes 0..3.
  template <class OpA>
  __device__ __forceinline__ static uint32_t bytes(const int4& c, int i,
                                                   int nd, const Plan& ap) {
    const int32_t b0 = digit(value<OpA>(c.x, ap), i, nd);
    const int32_t b1 = digit(value<OpA>(c.y, ap), i, nd);
    const int32_t b2 = digit(value<OpA>(c.z, ap), i, nd);
    const int32_t b3 = digit(value<OpA>(c.w, ap), i, nd);
    return __byte_perm(__byte_perm(b0, b1, 0x0040),
                       __byte_perm(b2, b3, 0x0040), 0x5410);
  }
  // Lane t of a quad gets byte t of each lane's word, lane j's in byte j.
  __device__ __forceinline__ static uint32_t transpose(uint32_t w, int t) {
    w = __byte_perm(w, __shfl_xor_sync(0xffffffffu, w, 2),
                    (t & 2) ? 0x3276 : 0x5410);
    return __byte_perm(w, __shfl_xor_sync(0xffffffffu, w, 1),
                       (t & 1) ? 0x3715 : 0x6240);
  }

  template <class OpA, int NT>
  __device__ __forceinline__ void digits(
      const Regs<OpA, NT>& c, const Plan& ap, int,
      uint32_t (&al)[NT][OpA::kDigits],
      uint32_t (&ah)[NT][OpA::kDigits]) const {
    const int nd = OpA::kFixed ? 1 : ap.nd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < OpA::kDigits; ++i) {
        if (i >= nd) {
          al[nt][i] = ah[nt][i] = 0u;
          continue;
        }
        // codes t, t + 4, t + 8, t + 12 and t + 16, t + 20, t + 24, t + 28
        const uint32_t c0 = transpose(bytes<OpA>(c[nt][0], i, nd, ap), t);
        const uint32_t c16 = transpose(bytes<OpA>(c[nt][1], i, nd, ap), t);
        al[nt][i] = __byte_perm(c0, c16, 0x6420);
        ah[nt][i] = __byte_perm(c0, c16, 0x7531);
      }
  }
};

// The most K-split warps a block of an instantiation takes (its launch
// bound): 32 at one row tile of fixed planes (few registers), 16 at two,
// kWarpsNT4 at four, 8 for Any (many registers).
template <class OpA, class OpW, int NT>
__host__ __device__ constexpr int max_warps() {
  return !(OpA::kFixed && OpW::kFixed) ? 8
         : (NT == 1 ? 32 : (NT == 2 ? 16 : kWarpsNT4));
}
template <class OpA, class OpW, int NT>
__host__ __device__ constexpr int min_blocks() {
  return NT == 4 ? kMinBlocksNT4 : 1;
}

// Warps per block: enough to split the K words kWordsPerWarp to a warp.
inline int warps_for(int words, int most) {
  const int w = (words + kWordsPerWarp - 1) / kWordsPerWarp;
  return w < 1 ? 1 : (w > most ? most : w);
}

// Rows per block (8 NT): the most that still leaves kBlocks blocks (two
// per SM of the H100's 132), never more rows than there are.
inline int nt_for(long long rows, int cols) {
  const long long col_blocks = (cols + 31) / 32;
  int nt = kMaxNT;
  while (nt > 1 && (8LL * nt / 2 >= rows ||
                    col_blocks * ((rows + 8 * nt - 1) / (8 * nt)) < kBlocks))
    nt /= 2;
  return nt;
}

// Launches one instantiation with `warps` K-split warps (0: warps_for's
// choice); cudaErrorInvalidValue when `warps` is outside 1..max_warps, the
// instantiation's launch bound. Nothing runs on an empty shape.
template <template <class, class, int> class Run, class OpA, class OpW,
          int NT, class Args>
int go(const Args& p, int warps, long long rows, int cols, cudaStream_t s) {
  constexpr int most = max_warps<OpA, OpW, NT>();
  if (warps == 0) warps = warps_for(p.wt.words, most);
  if (warps < 1 || warps > most) return (int)cudaErrorInvalidValue;
  if (rows > 0 && cols > 0) Run<OpA, OpW, NT>::go(p, warps, s);
  return (int)cudaSuccess;
}

template <template <class, class, int> class Run, class OpA, class OpW,
          class Args>
int go_nt(const Args& p, int nt, int warps, long long rows, int cols,
          cudaStream_t s) {
  switch (nt) {
    case 1: return go<Run, OpA, OpW, 1>(p, warps, rows, cols, s);
    case 2: return go<Run, OpA, OpW, 2>(p, warps, rows, cols, s);
    case 4: return go<Run, OpA, OpW, 4>(p, warps, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Picks the kernel instantiation for the plans and launches it through
// `Run<OpA, OpW, NT>::go(args, warps, stream)` (K2, K3 and K4 each define
// their Run): the main paths' W2A2 and W4A8 get their fixed-plane code,
// anything else Any. The tile is the caller's: `nt` row tiles of 8 rows
// (or output pixels) per block, 1, 2 or 4 (only 1 for Any), and `warps`
// K-split warps, 1..max_warps of that instantiation; 0 for either is the
// heuristic's choice (nt_for, warps_for). Any other value launches nothing
// and returns cudaErrorInvalidValue; else cudaSuccess (the launch's own
// errors are the caller's cudaGetLastError()).
template <template <class, class, int> class Run, class Args>
int dispatch(const Args& p, const Plan& ap, const Plan& wp, long long rows,
             int cols, int nt, int warps, cudaStream_t s) {
  using W2 = Fixed<2, true>;
  using W4 = Fixed<4, true>;
  using A8 = Fixed<8, true>;
  const bool w2a2 = W2::fits(ap) && W2::fits(wp);
  const bool a8w4 = A8::fits(ap) && W4::fits(wp);
  if (nt == 0) nt = (w2a2 || a8w4) ? nt_for(rows, cols) : 1;
  if (w2a2) return go_nt<Run, W2, W2>(p, nt, warps, rows, cols, s);
  if (a8w4) return go_nt<Run, A8, W4>(p, nt, warps, rows, cols, s);
  if (nt != 1) return (int)cudaErrorInvalidValue;
  return go<Run, Any, Any, 1>(p, warps, rows, cols, s);
}

}  // namespace dig

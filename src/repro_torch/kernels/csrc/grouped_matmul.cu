// Grouped K4: E experts' integer-code GEMMs in one launch, raw int32
// accumulators out.
//
// Replaces the routed experts' product of repro/models/moe.py::
// _expert_matmul (:75), which the reference computes as
// serial_matmul_packed under vmap over experts, outside any Pallas kernel:
//   x: (E, C, K) int32 codes, masked to a_bits and sign-extended when signed
//   w: (E, w_bits, W, N) packed weight planes, W = ceil(K/32), lane k%32 of
//      word k/32 (the reference's layout)
//   out[e, c, n] = sum_k xval[e, c, k] * wval[e, k, n]          (mod 2^32)
//
// Bound on the H100: bytes. At the MoE's capacity C is small (1 at a
// batch-4 decode step of deepseek-v2-lite, 2 at a 16-token prefill, 8 at a
// 4 x 16 one), so the packed weights are nearly all the bytes: 92.3 MB per
// 2048 -> 1408 projection at W4, 0.72 MACs per weight byte at C = 1. And
// an expert that the dispatch left empty has an all-zero row tile (its
// rows of the dispatch buffer stay the zero they were made as, and
// silu(0) * 0 is 0 for the down projection), whose accumulators are
// exactly 0 in every digit plan. So the least work at a given load is the
// packed bytes of the occupied experts only.
//
// What the design does about it:
// * One block owns one (expert, row tile, 128-column tile) item across the
//   whole K; the expert is the fastest index, so that the blocks on the
//   card at once hold many experts and the occupied ones spread over the
//   SMs. The block stages the tile's codes once in shared memory as int8
//   digits (in the K order the weight expansion gives; 16-byte code loads,
//   all issued before the first digit is stored) and ORs them on the way:
//   a row tile whose digits are all zero reads no weight and stores zeros.
//   The test reads the staged copy only, and no occupancy comes from the
//   caller, so the result rests on the inputs alone.
// * The weights are streamed through a ring of kStages stages in shared
//   memory: for each plane and K word the tile's columns are contiguous,
//   so every thread copies 16-byte pieces with cp.async.cg (4-byte copies
//   when N is not a multiple of 4), each stage's completion an mbarrier
//   that every thread arrives on with cp.async.mbarrier.arrive.noinc. With
//   three blocks per SM up to 144 KB of weights are in flight per SM.
// * Each of the block's 4 warps owns 32 of the tile's columns, lane g the
//   four at 4g .. 4g + 3 (one 16-byte shared-memory load per plane). It
//   expands them into int8 digits and runs one mma.sync m16n8k32 per digit
//   pair, weights as A and rows as B (8 rows an n8 tile, 16 rows two). A
//   signed weight of at most 4 planes (the model's W4) is expanded by a
//   rotate and a masked OR per plane into nibbles, its value placed in the
//   top bits of each digit byte: the product is the true one times
//   2^(8 - planes), shifted out when the sums fold.
// * The K sum stays in registers: the s32 sums of a staged K segment fold
//   into uint32 totals (mod 2^32, as the reference wraps), staged once in
//   shared memory for a coalesced store.
// Nothing is read on the host, so a decode step captures as one CUDA graph.
// What holds it back now: a block's first weights arrive after two memory
// round trips in a row (its codes' staging, then the ring's first stage),
// long under the card's load, and at a decode step's occupancy the busy
// blocks that start after an empty one ends set the tail.

#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"

namespace {

constexpr int kCols = 128;       // columns per tile
constexpr int kWarps = 4;        // each owns 32 of them across the whole K
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;       // ring depth
constexpr int kStagePlanes = 32; // plane words per column in a stage (16 KB)
constexpr int kActBytes = 32768; // staged digits of one K segment, at most
constexpr int kRedStride = kCols + 4;  // row stride of the staged output

struct Args {
  const int32_t* x;  // (E, C, K) codes
  const int32_t* w;  // (E, w_bits, W, N) planes
  int32_t* out;      // (E, C, N)
  int m, k, n, words;
  dig::Plan ap, wp;
  int chunk;         // K words per ring stage
  int seg;           // K words per staged segment, a multiple of chunk
  int col_tiles, row_tiles;
  int experts;       // E
  long long items;   // E x row_tiles x col_tiles, the expert fastest
  bool wvec;         // 16-byte weight copies (N % 4 == 0, w aligned)
  bool xvec;         // 16-byte code loads (K % 4 == 0, x aligned)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// src_bytes 0: the destination is zero-filled and nothing is read.
__device__ __forceinline__ void copy16(uint32_t* dst, const int32_t* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t* dst, const int32_t* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The stage's barrier counts this thread's arrival once all of its earlier
// copies have landed.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// A signed weight of at most 4 planes goes the nibble way (kShift > 0).
template <class OpW>
__host__ __device__ constexpr int w_shift() {
  return (OpW::kFixed && OpW::kSigned && OpW::kPlanes <= 4)
             ? 8 - OpW::kPlanes : 0;
}

// Digit registers of chunks t (lo) and t + 4 (hi) of a lane's four
// columns (q = 0..3) of one K word: `w` holds plane b's words of the four
// columns at w[b] (x, y, z, w for q = 0..3). The nibble way: plane b's
// bits 8j + t and 8j + t + 4 rotate to bits 8j + s and 8j + 4 + s,
// s = b + 4 - planes, so each nibble holds the value times 2^(4 - planes);
// the high nibbles are the hi digits' top bits as they stand, the low ones
// shifted up by 4. Otherwise digits.cuh's expand, column by column.
template <class OpW>
__device__ __forceinline__ void weight_digits(const uint4 (&w)[OpW::kPlanes],
                                              const dig::Plan& wp, int t,
                                              uint32_t (&lo)[4][OpW::kDigits],
                                              uint32_t (&hi)[4][OpW::kDigits]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t v[OpW::kPlanes];
#pragma unroll
    for (int b = 0; b < OpW::kPlanes; ++b)
      v[b] = q == 0 ? w[b].x : q == 1 ? w[b].y : q == 2 ? w[b].z : w[b].w;
    if constexpr (w_shift<OpW>() > 0) {
      constexpr int P = OpW::kPlanes;
      uint32_t y = 0u;
#pragma unroll
      for (int b = 0; b < P; ++b) {
        const int s = b + 4 - P;
        y |= __funnelshift_r(v[b], v[b], (t - s) & 31) & (0x11111111u << s);
      }
      hi[q][0] = y & 0xf0f0f0f0u;
      lo[q][0] = (y << 4) & 0xf0f0f0f0u;
    } else {
      dig::expand<OpW>(v, wp, t, lo[q], hi[q]);
    }
  }
}

// Stage K words [s0, s0 + sw) of the row tile's codes as digits: word c of
// row r's K word kw holds, at byte b, the digit of code 32 kw + 8b + c
// (chunk c), at slot 2 (c % 4) + c / 4, so a lane reads chunks t and t + 4
// as one uint2. Rows past C (`live` rows are real) are zeros and load
// nothing. Returns whether this thread staged a nonzero digit. With 16-byte
// code loads a thread loads all of its codes before it stores a digit, so
// the staging waits on memory once.
template <class OpA, int ROWS>
__device__ __forceinline__ bool stage(const Args& p, const int32_t* x,
                                      int live, int s0, int sw, int nda,
                                      uint32_t* acts) {
  constexpr int NDA = OpA::kDigits;
  const int tid = threadIdx.x;
  bool any = false;
  unsigned char* bytes = reinterpret_cast<unsigned char*>(acts);
  if (p.xvec) {
    // thread item v: row v / (8 sw), K word (v / 8) % sw, codes 4 (v % 8) ..
    // + 3 of the word: chunks 4 (v % 2) + i at byte (v % 8) / 2
    constexpr int U = 4;
    const int n = live * sw * 8;
    for (int v0 = tid; v0 < n; v0 += U * kThreads) {
      int4 c4[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * kThreads;
        const int m4 = v & 7, kw = (v >> 3) % sw, r = (v >> 3) / sw;
        c4[u] = (v < n && 32 * (s0 + kw) + 4 * m4 < p.k)
                    ? __ldg(reinterpret_cast<const int4*>(
                          x + (long long)r * p.k + 32 * (s0 + kw) + 4 * m4))
                    : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int v = v0 + u * kThreads;
        if (v >= n) break;
        const int m4 = v & 7, kw = (v >> 3) % sw, r = (v >> 3) / sw;
        const int32_t cs[4] = {c4[u].x, c4[u].y, c4[u].z, c4[u].w};
#pragma unroll
        for (int i = 0; i < NDA; ++i) {
          if (i >= nda) break;
          unsigned char* row = bytes + 4 * (((i * p.seg + kw) * ROWS + r) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t d = (uint32_t)dig::Codes::digit(
                dig::Codes::value<OpA>(cs[j], p.ap), i, nda) & 0xffu;
            row[4 * (2 * j + (m4 & 1)) + (m4 >> 1)] = (unsigned char)d;
            any |= d != 0u;
          }
        }
      }
    }
  } else {
    // thread item v: row v / (8 sw), K word (v / 8) % sw, chunk c = v % 8
    const int n = live * sw * 8;
    for (int v = tid; v < n; v += kThreads) {
      const int c = v & 7, kw = (v >> 3) % sw, r = (v >> 3) / sw;
      int32_t cv[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kv = 32 * (s0 + kw) + 8 * b + c;
        cv[b] = kv < p.k ? dig::Codes::value<OpA>(
                               __ldg(x + (long long)r * p.k + kv), p.ap)
                         : 0;
      }
#pragma unroll
      for (int i = 0; i < NDA; ++i) {
        if (i >= nda) break;
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          word |= ((uint32_t)dig::Codes::digit(cv[b], i, nda) & 0xffu)
                  << (8 * b);
        acts[((i * p.seg + kw) * ROWS + r) * 8 + 2 * (c & 3) + (c >> 2)] =
            word;
        any |= word != 0u;
      }
    }
  }
  // rows past C: zero digits
  const int pad = (ROWS - live) * 8;
  for (int v = tid; v < nda * sw * pad; v += kThreads)
    acts[(v / pad * ROWS + live) * 8 + v % pad] = 0u;
  return any;
}

// Whether any of the row tile's `live` rows holds a nonzero code (masked to
// a_bits), over the whole K: the zero test when K takes several segments.
template <class OpA>
__device__ __forceinline__ bool any_code(const Args& p, const int32_t* x,
                                         int live) {
  bool any = false;
  for (int r = 0; r < live; ++r)
    for (int kv = threadIdx.x; kv < p.k; kv += kThreads)
      any |= dig::Codes::value<OpA>(__ldg(x + (long long)r * p.k + kv),
                                    p.ap) != 0;
  return any;
}

template <class OpA, class OpW, int NR>
__global__ void __launch_bounds__(kThreads,
                                  (OpA::kFixed && OpW::kFixed) ? 3 : 1)
grouped_code_gemm_kernel(const Args p) {
  constexpr int NDA = OpA::kDigits, NDW = OpW::kDigits;
  constexpr int NMAG = NDA + NDW - 1;
  constexpr int ROWS = 8 * NR;
  constexpr int kShift = w_shift<OpW>();
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint64_t full[kStages];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  const int planes = OpW::kFixed ? OpW::kPlanes : p.wp.bits;
  const int nda = OpA::kFixed ? 1 : p.ap.nd;
  const int ndw = OpW::kFixed ? 1 : p.wp.nd;
  const int chunk = OpW::kFixed ? kStagePlanes / OpW::kPlanes : p.chunk;
  const int stage_words = planes * chunk * kCols;
  const int nchk = (p.words + chunk - 1) / chunk;  // chunks per column tile
  const bool one_seg = p.words <= p.seg;
  uint32_t* ring = smem;
  uint32_t* acts = ring + kStages * stage_words;   // (nda, seg, ROWS, 8)
  uint32_t* red = acts + nda * p.seg * ROWS * 8;   // (ROWS, kRedStride)

  if (tid == 0)
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads);
  __syncthreads();
  uint32_t seq = 0;  // stages filled (and waited on) so far by this block

  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    // the expert fastest, so that the blocks the card runs at once hold
    // many experts, and the experts the dispatch fills spread over the SMs
    const long long e = item % p.experts;
    const long long rest = item / p.experts;
    const long long r0 = (rest % p.row_tiles) * ROWS;
    const int c0 = (int)(rest / p.row_tiles) * kCols;
    const int live = (int)min((long long)ROWS, p.m - r0);
    const int32_t* x = p.x + (e * p.m + r0) * p.k;
    const int32_t* w = p.w + e * planes * p.words * (long long)p.n;
    int32_t* out = p.out + (e * p.m + r0) * p.n;

    __syncthreads();  // the last item's digits and `red` are read
    // the zero test: a row tile whose codes are all zero reads no weight
    const bool any = one_seg ? stage<OpA, ROWS>(p, x, live, 0, p.words, nda,
                                                acts)
                             : any_code<OpA>(p, x, live);
    if (!__syncthreads_or(any)) {
      for (int v = tid; v < live * kCols; v += kThreads)
        if (c0 + v % kCols < p.n)
          out[(long long)(v / kCols) * p.n + c0 + v % kCols] = 0;
      continue;
    }

    // the tile's weights, chunk by chunk through the ring
    auto fill = [&](int jj) {
      const uint32_t q = seq + jj;
      uint32_t* dst = ring + (q % kStages) * stage_words;
      const int kw0 = jj * chunk;
      const int cw = min(chunk, p.words - kw0);
      if (p.wvec) {  // warp i copies rows i, i + 8, ...: 32 x 16 bytes each
        const int col = c0 + 4 * lane;
        for (int b = 0; b < planes; ++b)
          for (int kk = warp; kk < cw; kk += kWarps)
            copy16(dst + (b * chunk + kk) * kCols + 4 * lane,
                   col < p.n ? w + ((long long)b * p.words + kw0 + kk) * p.n +
                                   col
                             : w,
                   col < p.n ? 16 : 0);
      } else {       // 128 threads a row, 4 bytes each
        const int cc = tid & (kCols - 1), col = c0 + cc;
        for (int b = 0; b < planes; ++b)
          for (int kk = tid / kCols; kk < cw; kk += kThreads / kCols)
            copy4(dst + (b * chunk + kk) * kCols + cc,
                  col < p.n ? w + ((long long)b * p.words + kw0 + kk) * p.n +
                                  col
                            : w,
                  col < p.n ? 4 : 0);
      }
      arrive_on_copies(&full[q % kStages]);
    };
    for (int jj = 0; jj < min(nchk, kStages); ++jj) fill(jj);

    int32_t acc[NMAG][2][NR][4];
    uint32_t tot[2][NR][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NR; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          tot[mt][nt][r] = 0u;
#pragma unroll
          for (int mg = 0; mg < NMAG; ++mg) acc[mg][mt][nt][r] = 0;
        }

    for (int jj = 0; jj < nchk; ++jj) {
      const int kw0 = jj * chunk;
      const int cw = min(chunk, p.words - kw0);
      const int s0 = kw0 / p.seg * p.seg;  // the chunk's segment
      if (!one_seg && kw0 == s0) {  // stage the segment (several per tile)
        __syncthreads();
        stage<OpA, ROWS>(p, x, live, s0, min(p.seg, p.words - s0), nda, acts);
        __syncthreads();
      }
      const uint32_t q = seq + jj;
      mbar_wait(&full[q % kStages], (q / kStages) & 1u);
      // this warp's 32 columns: lane g's four at 4g .. 4g + 3
      const uint32_t* st =
          ring + (q % kStages) * stage_words + warp * 32 + 4 * g;
#pragma unroll 2
      for (int kk = 0; kk < cw; ++kk) {
        const int kws = kw0 - s0 + kk;  // K word within the segment
        uint32_t al[NR][NDA], ah[NR][NDA];
#pragma unroll
        for (int nt = 0; nt < NR; ++nt)
#pragma unroll
          for (int i = 0; i < NDA; ++i) {
            const uint2 d = (i < nda)
                ? *reinterpret_cast<const uint2*>(
                      acts + ((i * p.seg + kws) * ROWS + 8 * nt + g) * 8 +
                      2 * t)
                : make_uint2(0u, 0u);
            al[nt][i] = d.x;
            ah[nt][i] = d.y;
          }
        uint4 wv[OpW::kPlanes];
#pragma unroll
        for (int b = 0; b < OpW::kPlanes; ++b)
          wv[b] = (OpW::kFixed || b < planes)
              ? *reinterpret_cast<const uint4*>(st + (b * chunk + kk) * kCols)
              : make_uint4(0u, 0u, 0u, 0u);
        uint32_t wl[4][NDW], wh[4][NDW];
        weight_digits<OpW>(wv, p.wp, t, wl, wh);
        // m tile mt: A rows g and g + 8 are columns 4g + 2mt and + 1
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < NDA; ++i) {
            if (i >= nda) continue;
#pragma unroll
            for (int jd = 0; jd < NDW; ++jd) {
              if (jd >= ndw) continue;
#pragma unroll
              for (int nt = 0; nt < NR; ++nt)
                dig::mma_s8(acc[i + jd][mt][nt], wl[2 * mt][jd],
                            wl[2 * mt + 1][jd], wh[2 * mt][jd],
                            wh[2 * mt + 1][jd], al[nt][i], ah[nt][i]);
            }
          }
      }
      __syncthreads();  // every warp is done with this stage
      if (jj + kStages < nchk) fill(jj + kStages);

      if (kw0 + cw == min(s0 + p.seg, p.words)) {
        // the segment's last chunk: fold its s32 sums, exact (at most 3 x
        // 2^14 x 32 x 128 in magnitude, the shifted weight digits included)
#pragma unroll
        for (int mg = 0; mg < NMAG; ++mg) {
          if (mg > nda + ndw - 2) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NR; ++nt)
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                tot[mt][nt][r] += (uint32_t)(acc[mg][mt][nt][r] >> kShift)
                                  << (7 * mg);
                acc[mg][mt][nt][r] = 0;
              }
        }
      }
    }
    seq += nchk;
    // through shared memory, for a coalesced store
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NR; ++nt)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          red[(8 * nt + 2 * t + (r & 1)) * kRedStride + warp * 32 + 4 * g +
              2 * mt + (r >> 1)] = tot[mt][nt][r];
    __syncthreads();
    for (int v = tid; v < live * kCols; v += kThreads)
      if (c0 + v % kCols < p.n)
        out[(long long)(v / kCols) * p.n + c0 + v % kCols] =
            (int32_t)red[(v / kCols) * kRedStride + v % kCols];
  }
}

template <class OpA, class OpW, int NR>
int run(const Args& p, cudaStream_t stream) {
  auto kernel = grouped_code_gemm_kernel<OpA, OpW, NR>;
  const int nda = OpA::kFixed ? 1 : p.ap.nd;
  const int planes = OpW::kFixed ? OpW::kPlanes : p.wp.bits;
  const size_t smem =
      sizeof(uint32_t) * ((size_t)kStages * planes * p.chunk * kCols +
                          (size_t)nda * p.seg * 8 * NR * 8 +
                          (size_t)8 * NR * kRedStride);
  // all of the SM's shared memory for shared memory (three blocks fit)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // one block per item; past a grid's reach a block walks blockIdx.x,
  // blockIdx.x + gridDim.x, ...
  const long long grid = p.items < 0x7fffffffLL ? p.items : 0x7fffffffLL;
  kernel<<<(unsigned int)grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Grouped K4: `groups` experts, (groups, M, K) int32 codes x (groups,
// w_bits, ceil(K/32), N) packed weights -> (groups, M, N) raw int32
// accumulators, one launch; nd_a and nd_w are the operands' digit counts
// (bitops.kernel_digits). Returns cudaGetLastError() (or the error of a
// call that sets up the launch).
extern "C" int bitserial_matmul_v1_grouped(const void* x, const void* w,
                                           void* out, int groups, int m,
                                           int k, int n, int a_bits,
                                           int w_bits, int a_signed,
                                           int w_signed, int nd_a, int nd_w,
                                           void* stream) {
  if (a_bits < 1 || a_bits > dig::kMaxBits || w_bits < 1 ||
      w_bits > dig::kMaxBits || nd_a < 1 || nd_a > 3 || nd_w < 1 ||
      nd_w > 3 || groups < 1 || groups > 65535 || m < 0 || k < 0 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (m == 0 || n == 0) return (int)cudaGetLastError();
  const int nr = m > 8 ? 2 : 1;
  Args p;
  p.x = (const int32_t*)x;
  p.w = (const int32_t*)w;
  p.out = (int32_t*)out;
  p.m = m;
  p.k = k;
  p.n = n;
  p.words = (k + 31) / 32;
  p.ap = dig::Plan{a_bits, a_signed, nd_a};
  p.wp = dig::Plan{w_bits, w_signed, nd_w};
  p.chunk = kStagePlanes / w_bits > 0 ? kStagePlanes / w_bits : 1;
  p.seg = kActBytes / (nd_a * 8 * nr * 32) / p.chunk * p.chunk;
  if (p.seg < p.chunk) p.seg = p.chunk;
  if (p.seg > p.words) p.seg = p.words > 0 ? p.words : 1;
  p.col_tiles = (n + kCols - 1) / kCols;
  p.row_tiles = (m + 8 * nr - 1) / (8 * nr);
  p.experts = groups;
  p.items = (long long)groups * p.row_tiles * p.col_tiles;
  p.wvec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  p.xvec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  using W2 = dig::Fixed<2, true>;
  using W4 = dig::Fixed<4, true>;
  using A8 = dig::Fixed<8, true>;
  const cudaStream_t s = (cudaStream_t)stream;
  if (W2::fits(p.ap) && W2::fits(p.wp))
    return nr == 2 ? run<W2, W2, 2>(p, s) : run<W2, W2, 1>(p, s);
  if (A8::fits(p.ap) && W4::fits(p.wp))
    return nr == 2 ? run<A8, W4, 2>(p, s) : run<A8, W4, 1>(p, s);
  return nr == 2 ? run<dig::Any, dig::Any, 2>(p, s)
                 : run<dig::Any, dig::Any, 1>(p, s);
}

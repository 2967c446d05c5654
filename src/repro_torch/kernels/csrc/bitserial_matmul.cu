// Bit-serial GEMMs over bit-transposed packed weights, with the MVU
// post-pipeline fused (BARVINN Algorithm 1, §3.1.3-3.1.4).
//
// K3 replaces repro/kernels/bitserial_matmul.py::bitserial_matmul_v2_pallas
// (pallas_call at bitserial_matmul.py:505, body _kernel_v2 at :319):
//   x: (a_bits, M, W) words, W = ceil(K/32), lane k%32 of word k/32
//   w: (w_bits, W, N) words
//   out = epilogue(acc) -> float | codes = clip(rint(out / rs)) | packed
// K4 replaces repro/kernels/bitserial_matmul.py::bitserial_matmul_pallas
// (pallas_call at :224, body _kernel at :123): x is (M, K) int32 codes,
// masked to a_bits (sign-extended when signed, _act_operands at :94) and
// packed inside the kernel; its requant has no divide (scale folds it).
//
//   acc[m, n] = sum_k xval[m, k] * wval[k, n]                 (mod 2^32)
//
// Algorithm 1 on the packed words, as in bitserial_conv.cu: for each word
// and plane pair (i, j) the accumulator gains +-2^(i+j) * popc(a & w), the
// MSB plane of a signed operand weighing negative. The radix of the
// reference's digit plan does not change the integer result. Lanes past K
// in the last word are masked. The accumulator is uint32: it wraps modulo
// 2^32 like the reference's int32 Horner sums, and the K-split below adds
// partial sums in any order with the same result.
//
// Bound on the H100: at the LM's decode shapes (M = 4) bytes, the packed
// weights (w_bits/8 bytes per weight); at prefill (M = 64) still bytes for
// W4A8 against the int8 tensor-core peak. Design, simple first: a block of
// kSplitK warps owns 32 consecutive output columns of one row m. Weight
// words w[j][g][n] are contiguous in n, so a warp's loads are one coalesced
// 128-byte transaction; the activation word x[i][m][g] is one address for
// the whole warp (a broadcast). Warp s of the block walks words g = s,
// s + kSplitK, ...: four times the warps in flight at decode, where M*N/32
// alone leaves most of the 132 SMs idle. The partial sums meet in shared
// memory and warp 0 runs the epilogue (epilogue.cuh, shared with K2); a
// packed output is one __ballot_sync per plane, the warp's 32 columns being
// exactly one output word. K4 packs its codes the same way: lane t reads
// code x[m, 32g + t] (coalesced) and one ballot per plane makes the word.
// The TPU kernels' VMEM digit-plane caches have no counterpart: every row
// re-reads the weights (from L2 after the first). Tensor-core tiles over
// digit planes, and rows sharing weight loads, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kSplitK = 4;     // warps per block, splitting the K words
constexpr int kMaxBits = 16;   // the MVU's operand range

struct MatmulArgs {
  const int32_t* x;  // K3: (a_bits, M, W) words; K4: (M, K) codes
  const int32_t* w;  // (w_bits, W, N) words
  int m, k, n, words;
  int a_bits, w_bits, a_signed, w_signed;
  epi::Epilogue e;
};

template <bool kPackedActs>
__global__ void __launch_bounds__(kSplitK * 32)
bitserial_matmul_kernel(const MatmulArgs p) {
  __shared__ uint32_t partial[kSplitK][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int c = blockIdx.y * 32 + lane;
  const bool valid = c < p.n;

  const long long a_plane = (long long)p.m * p.words;
  const long long w_plane = (long long)p.words * p.n;
  const int tail_bits = p.k % 32;
  const uint32_t tail = tail_bits ? ((1u << tail_bits) - 1u) : 0xffffffffu;
  const uint32_t a_mask = (1u << p.a_bits) - 1u;
  const int32_t* wc = p.w + c;

  uint32_t acc = 0;
  for (int g = warp; g < p.words; g += kSplitK) {
    const uint32_t m = (g == p.words - 1) ? tail : 0xffffffffu;
    uint32_t wv[kMaxBits];
#pragma unroll
    for (int j = 0; j < kMaxBits; ++j)
      wv[j] = (j < p.w_bits && valid)
                  ? ((uint32_t)wc[j * w_plane + (long long)g * p.n] & m)
                  : 0u;
    uint32_t u = 0;  // K4: this lane's masked code of word g
    if (!kPackedActs) {
      const int col = g * 32 + lane;
      if (col < p.k) u = (uint32_t)p.x[(long long)row * p.k + col] & a_mask;
    }
    for (int i = 0; i < p.a_bits; ++i) {
      const uint32_t av =
          kPackedActs ? (uint32_t)p.x[i * a_plane + (long long)row * p.words + g]
                      : __ballot_sync(0xffffffffu, (u >> i) & 1u);
      const bool a_neg = p.a_signed && i == p.a_bits - 1;
#pragma unroll
      for (int j = 0; j < kMaxBits; ++j) {
        if (j < p.w_bits) {
          const uint32_t term = (uint32_t)__popc(av & wv[j]) << (i + j);
          const bool neg = a_neg != (p.w_signed && j == p.w_bits - 1);
          acc = neg ? acc - term : acc + term;
        }
      }
    }
  }
  partial[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int s = 1; s < kSplitK; ++s) acc += partial[s][lane];
  epi::store(p.e, acc, lane, valid, c, row, p.m, p.n);
}

int launch(bool packed_acts, const void* x, const void* w, const void* scale,
           const void* bias, const void* rs, void* out, int m, int k, int n,
           int a_bits, int w_bits, int a_signed, int w_signed, int relu,
           int out_mode, int rq_bits, int qn, int qp, void* stream) {
  if (a_bits < 1 || a_bits > kMaxBits || w_bits < 1 || w_bits > kMaxBits)
    return (int)cudaErrorInvalidValue;
  MatmulArgs p;
  p.x = (const int32_t*)x;
  p.w = (const int32_t*)w;
  p.m = m; p.k = k; p.n = n; p.words = (k + 31) / 32;
  p.a_bits = a_bits; p.w_bits = w_bits; p.a_signed = a_signed;
  p.w_signed = w_signed;
  p.e = epi::make(scale, bias, rs, out, relu, out_mode, rq_bits, qn, qp);
  if (m > 0 && n > 0) {
    dim3 grid((unsigned int)m, (unsigned int)((n + 31) / 32));
    if (packed_acts)
      bitserial_matmul_kernel<true><<<grid, kSplitK * 32, 0,
                                      (cudaStream_t)stream>>>(p);
    else
      bitserial_matmul_kernel<false><<<grid, kSplitK * 32, 0,
                                       (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3: packed activations (a_bits, M, ceil(K/32)) x packed weights.
extern "C" int bitserial_matmul_v2(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* rs, void* out, int m, int k,
                                   int n, int a_bits, int w_bits, int a_signed,
                                   int w_signed, int relu, int out_mode,
                                   int rq_bits, int qn, int qp, void* stream) {
  return launch(true, x, w, scale, bias, rs, out, m, k, n, a_bits, w_bits,
                a_signed, w_signed, relu, out_mode, rq_bits, qn, qp, stream);
}

// K4: int32 codes (M, K) x packed weights; rs is null (no requant divide).
extern "C" int bitserial_matmul_v1(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int m, int k, int n, int a_bits,
                                   int w_bits, int a_signed, int w_signed,
                                   int relu, int out_mode, int rq_bits, int qn,
                                   int qp, void* stream) {
  return launch(false, x, w, scale, bias, nullptr, out, m, k, n, a_bits,
                w_bits, a_signed, w_signed, relu, out_mode, rq_bits, qn, qp,
                stream);
}

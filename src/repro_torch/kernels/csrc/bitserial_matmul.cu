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
// K3 (design v2): int8 tensor-core mma on digit planes expanded in
// registers from the packed words (digits.cuh, shared with K2), as the TPU
// kernel issues one int8 MXU product per digit pair. At the LM's W4A8 both
// operands are one int8 digit, so one m16n8k32 mma per K word and tile does
// all the work. Bound on the H100: bytes at decode (M = 4; the packed
// weights, w_bits/8 bytes per weight) and at prefill (M = 64) against the
// int8 peak. Weights are the mma's A operand (16 columns per m16), the
// activation rows its B operand (8 per n8): every row is served by one
// read of each weight word. A block owns 32 columns x 8 NT rows and splits
// the K words over up to 32 warps, about four words each, with every load
// of a word issued before its first use, so that a warp's time is a few
// memory round trips. What holds it back now: at decode, launch latency and
// those round trips (N = 2048 gives only 64 blocks, half the SMs); at
// prefill, the same plus the activation expansion, which every column
// block repeats.
// Not done yet (ROADMAP queue 2): 16-byte vector weight loads (each word is
// a scalar __ldg that the four lanes of a fragment row issue at one
// address), activation planes staged once in shared memory, and m16
// activation row tiles at prefill (it runs the same swapped n8 tile).
// K4 (design v1, unchanged): a block of kSplitK warps owns 32 consecutive
// output columns of one row m; lane t reads code x[m, 32g + t] (coalesced),
// masks it to a_bits and makes each activation plane with one
// __ballot_sync; Algorithm 1 on the packed words, +-2^(i+j) * popc(a & w)
// per plane pair (the MSB plane of a signed operand weighing negative),
// lanes past K masked, a 4-way K split added in shared memory, and the
// shared epilogue (epilogue.cuh) by warp 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"
#include "epilogue.cuh"

namespace {

constexpr int kSplitK = 4;     // warps per block, splitting the K words

struct MatmulArgs {
  const int32_t* x;  // (M, K) codes
  const int32_t* w;  // (w_bits, W, N) words
  int m, k, n, words;
  int a_bits, w_bits, a_signed, w_signed;
  epi::Epilogue e;
};

__global__ void __launch_bounds__(kSplitK * 32)
bitserial_matmul_v1_kernel(const MatmulArgs p) {
  __shared__ uint32_t partial[kSplitK][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  const int c = blockIdx.y * 32 + lane;
  const bool valid = c < p.n;

  const long long w_plane = (long long)p.words * p.n;
  const int tail_bits = p.k % 32;
  const uint32_t tail = tail_bits ? ((1u << tail_bits) - 1u) : 0xffffffffu;
  const uint32_t a_mask = (1u << p.a_bits) - 1u;
  const int32_t* wc = p.w + c;

  uint32_t acc = 0;
  for (int g = warp; g < p.words; g += kSplitK) {
    const uint32_t m = (g == p.words - 1) ? tail : 0xffffffffu;
    uint32_t wv[dig::kMaxBits];
#pragma unroll
    for (int j = 0; j < dig::kMaxBits; ++j)
      wv[j] = (j < p.w_bits && valid)
                  ? ((uint32_t)wc[j * w_plane + (long long)g * p.n] & m)
                  : 0u;
    uint32_t u = 0;  // this lane's masked code of word g
    const int col = g * 32 + lane;
    if (col < p.k) u = (uint32_t)p.x[(long long)row * p.k + col] & a_mask;
    for (int i = 0; i < p.a_bits; ++i) {
      const uint32_t av = __ballot_sync(0xffffffffu, (u >> i) & 1u);
      const bool a_neg = p.a_signed && i == p.a_bits - 1;
#pragma unroll
      for (int j = 0; j < dig::kMaxBits; ++j) {
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

struct K3Args {
  const int32_t* x;  // (a_bits, M, W) words
  dig::Weights wt;
  dig::Plan ap;
  int m, k;
  epi::Epilogue e;
};

template <class OpA, class OpW, int NT>
__global__ void __launch_bounds__(dig::max_warps<OpA, OpW, NT>() * 32,
                                  dig::min_blocks<OpA, OpW, NT>())
bitserial_matmul_v2_kernel(const K3Args p) {
  const long long r0 = (long long)blockIdx.x * 8 * NT;
  dig::Dense src;
  src.x = p.x;
  src.plane = (long long)p.m * p.wt.words;
  src.rows = p.m;
  src.r0 = r0;
  src.words = p.wt.words;
  src.g = (threadIdx.x & 31) >> 2;
  src.kw = 0;
  src.tail = dig::tail_mask(p.k);
  dig::tile<OpA, OpW, NT>(src, p.ap, p.wt, p.m, r0, p.e);
}

template <class OpA, class OpW, int NT>
struct RunV2 {
  static void go(const K3Args& p, cudaStream_t stream) {
    dim3 grid((unsigned int)((p.m + 8 * NT - 1) / (8 * NT)),
              (unsigned int)((p.wt.cols + 31) / 32));
    const int warps =
        dig::warps_for(p.wt.words, dig::max_warps<OpA, OpW, NT>());
    bitserial_matmul_v2_kernel<OpA, OpW, NT>
        <<<grid, warps * 32, 0, stream>>>(p);
  }
};

}  // namespace

// K3: packed activations (a_bits, M, ceil(K/32)) x packed weights; nd_a and
// nd_w are the operands' digit counts (bitops.kernel_digits).
extern "C" int bitserial_matmul_v2(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* rs, void* out, int m, int k,
                                   int n, int a_bits, int w_bits, int a_signed,
                                   int w_signed, int nd_a, int nd_w, int relu,
                                   int out_mode, int rq_bits, int qn, int qp,
                                   void* stream) {
  if (a_bits < 1 || a_bits > dig::kMaxBits || w_bits < 1 ||
      w_bits > dig::kMaxBits || nd_a < 1 || nd_a > 3 || nd_w < 1 || nd_w > 3)
    return (int)cudaErrorInvalidValue;
  K3Args p;
  p.x = (const int32_t*)x;
  p.wt.w = (const int32_t*)w;
  p.wt.words = (k + 31) / 32;
  p.wt.cols = n;
  p.wt.plan = dig::Plan{w_bits, w_signed, nd_w};
  p.ap = dig::Plan{a_bits, a_signed, nd_a};
  p.m = m;
  p.k = k;
  p.e = epi::make(scale, bias, rs, out, relu, out_mode, rq_bits, qn, qp);
  if (m > 0 && n > 0)
    dig::dispatch<RunV2>(p, p.ap, p.wt.plan, m, n, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// K4: int32 codes (M, K) x packed weights; rs is null (no requant divide).
extern "C" int bitserial_matmul_v1(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int m, int k, int n, int a_bits,
                                   int w_bits, int a_signed, int w_signed,
                                   int relu, int out_mode, int rq_bits, int qn,
                                   int qp, void* stream) {
  if (a_bits < 1 || a_bits > dig::kMaxBits || w_bits < 1 ||
      w_bits > dig::kMaxBits)
    return (int)cudaErrorInvalidValue;
  MatmulArgs p;
  p.x = (const int32_t*)x;
  p.w = (const int32_t*)w;
  p.m = m; p.k = k; p.n = n; p.words = (k + 31) / 32;
  p.a_bits = a_bits; p.w_bits = w_bits; p.a_signed = a_signed;
  p.w_signed = w_signed;
  p.e = epi::make(scale, bias, nullptr, out, relu, out_mode, rq_bits, qn, qp);
  if (m > 0 && n > 0) {
    dim3 grid((unsigned int)m, (unsigned int)((n + 31) / 32));
    bitserial_matmul_v1_kernel<<<grid, kSplitK * 32, 0,
                                 (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

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
// masked to a_bits and sign-extended when signed (_act_operands at :94);
// its requant has no divide (scale folds it).
//
//   acc[m, n] = sum_k xval[m, k] * wval[k, n]                 (mod 2^32)
//
// Both (design v2) are the int8 tensor-core tile of digits.cuh, shared with
// K2: one mma.sync m16n8k32 per digit pair, K word and tile, as the TPU
// kernels issue one int8 MXU product per digit pair. They differ only in
// the activation source. K3's (Dense) expands packed planes into digits in
// registers; K4's (Codes) reads the codes from the (M, K) tensor straight
// into digit bytes: at the LM's W4A8 the digit is the code's low byte, so
// K4 packs no planes and counts no bits. A lane loads 8 codes of a K word
// as two 16-byte vectors, and a byte transpose within each quad of lanes
// puts them in the weights' K order. Weights are the mma's A operand
// (16 columns per m16), activation rows its B operand (8 per n8): every row
// is served by one read of each weight word. A block owns 32 columns x 8 NT
// rows and splits the K words over up to 32 warps, about four words each,
// with every load of a word issued before its first use.
// Bound on the H100: bytes, at decode (M = 4) and at prefill (M = 64)
// alike: the packed weights, w_bits/8 bytes per weight, and for K4 the
// int32 codes, 4 bytes each; the int8 peak's time is below it at both.
// What holds them back now: at
// decode, launch latency and a few memory round trips per warp (N = 2048
// gives only 64 blocks, half the SMs); at prefill, the same plus the
// activations, which every column block reads again (K3 expands the planes
// again; K4 reads 4-byte codes again from L2, 4 x K3's packed bytes at A8).
// Not done yet (ROADMAP queue 2): 16-byte vector weight loads (each weight
// word is a scalar __ldg that the four lanes of a fragment row issue at one
// address), activations staged once per block in shared memory, and m16
// activation row tiles at prefill (it runs the same swapped n8 tile).
// The grouped K4 entry (the MoE's routed experts, E code GEMMs in one
// launch) is a kernel of its own: grouped_matmul.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"
#include "epilogue.cuh"

namespace {

struct GemmArgs {
  const int32_t* x;  // K3: (a_bits, M, W) words; K4: (M, K) codes
  dig::Weights wt;
  dig::Plan ap;
  int m, k;
  epi::Epilogue e;
};

// kCodes: K4 (Codes source), else K3 (Dense source).
template <bool kCodes, class OpA, class OpW, int NT>
__global__ void __launch_bounds__(dig::max_warps<OpA, OpW, NT>() * 32,
                                  dig::min_blocks<OpA, OpW, NT>())
bitserial_gemm_kernel(const GemmArgs p) {
  const long long r0 = (long long)blockIdx.x * 8 * NT;
  const int lane = threadIdx.x & 31;
  if constexpr (kCodes) {
    dig::Codes src;
    src.x = p.x;
    src.rows = p.m;
    src.r0 = r0;
    src.k = p.k;
    src.g = lane >> 2;
    src.t = lane & 3;
    src.kw = 0;
    src.vec = p.k % 4 == 0 && (reinterpret_cast<uintptr_t>(p.x) & 15) == 0;
    dig::tile<OpA, OpW, NT>(src, p.ap, p.wt, p.m, r0, p.e);
  } else {
    dig::Dense src;
    src.x = p.x;
    src.plane = (long long)p.m * p.wt.words;
    src.rows = p.m;
    src.r0 = r0;
    src.words = p.wt.words;
    src.g = lane >> 2;
    src.kw = 0;
    src.tail = dig::tail_mask(p.k);
    dig::tile<OpA, OpW, NT>(src, p.ap, p.wt, p.m, r0, p.e);
  }
}

template <bool kCodes>
struct Gemm {
  template <class OpA, class OpW, int NT>
  struct Run {
    static void go(const GemmArgs& p, int warps, cudaStream_t stream) {
      dim3 grid((unsigned int)((p.m + 8 * NT - 1) / (8 * NT)),
                (unsigned int)((p.wt.cols + 31) / 32));
      bitserial_gemm_kernel<kCodes, OpA, OpW, NT>
          <<<grid, warps * 32, 0, stream>>>(p);
    }
  };
};

// Checks the plans and the tile, fills the arguments and launches K3
// (kCodes false) or K4 with `nt` row tiles and `warps` K-split warps a
// block (0: the heuristic's; dig::dispatch); returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan or tile out of range.
template <bool kCodes>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           const void* rs, void* out, int m, int k, int n, int a_bits,
           int w_bits, int a_signed, int w_signed, int nd_a, int nd_w,
           int relu, int out_mode, int rq_bits, int qn, int qp, int nt,
           int warps, void* stream) {
  if (a_bits < 1 || a_bits > dig::kMaxBits || w_bits < 1 ||
      w_bits > dig::kMaxBits || nd_a < 1 || nd_a > 3 || nd_w < 1 || nd_w > 3)
    return (int)cudaErrorInvalidValue;
  GemmArgs p;
  p.x = (const int32_t*)x;
  p.wt.w = (const int32_t*)w;
  p.wt.words = (k + 31) / 32;
  p.wt.cols = n;
  p.wt.plan = dig::Plan{w_bits, w_signed, nd_w};
  p.ap = dig::Plan{a_bits, a_signed, nd_a};
  p.m = m;
  p.k = k;
  p.e = epi::make(scale, bias, rs, out, relu, out_mode, rq_bits, qn, qp);
  const int rc = dig::dispatch<Gemm<kCodes>::template Run>(
      p, p.ap, p.wt.plan, m, n, nt, warps, (cudaStream_t)stream);
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}

}  // namespace

// K3: packed activations (a_bits, M, ceil(K/32)) x packed weights; nd_a and
// nd_w are the operands' digit counts (bitops.kernel_digits); nt and warps
// the tile (0: the heuristic's).
extern "C" int bitserial_matmul_v2(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   const void* rs, void* out, int m, int k,
                                   int n, int a_bits, int w_bits, int a_signed,
                                   int w_signed, int nd_a, int nd_w, int relu,
                                   int out_mode, int rq_bits, int qn, int qp,
                                   int nt, int warps, void* stream) {
  return launch<false>(x, w, scale, bias, rs, out, m, k, n, a_bits, w_bits,
                       a_signed, w_signed, nd_a, nd_w, relu, out_mode,
                       rq_bits, qn, qp, nt, warps, stream);
}

// K4: int32 codes (M, K) x packed weights; no requant divide (scale folds
// the step); nt and warps as K3's.
extern "C" int bitserial_matmul_v1(const void* x, const void* w,
                                   const void* scale, const void* bias,
                                   void* out, int m, int k, int n, int a_bits,
                                   int w_bits, int a_signed, int w_signed,
                                   int nd_a, int nd_w, int relu, int out_mode,
                                   int rq_bits, int qn, int qp, int nt,
                                   int warps, void* stream) {
  return launch<true>(x, w, scale, bias, nullptr, out, m, k, n, a_bits,
                      w_bits, a_signed, w_signed, nd_a, nd_w, relu, out_mode,
                      rq_bits, qn, qp, nt, warps, stream);
}

// Implicit-GEMM bit-serial conv2d over packed NHWC activations and packed
// HWIO weights, with the MVU post-pipeline fused (BARVINN §3.1.3-3.1.4).
//
// Replaces the TPU kernel repro/kernels/bitserial_conv.py::
// bitserial_conv2d_v2_pallas (pallas_call at bitserial_conv.py:282, body
// _kernel at :72, with _unpack_plane_words/_digit_matmul_acc/_pack_codes
// from bitserial_matmul.py).
//
//   x: (a_bits, N, H, W, G) words, G = ceil(Ci/32), channel c in bit c%32
//   w: (w_bits, FH, FW, G, Co) words
//   acc[n,oh,ow,co] = sum_{taps, channels} xval * wval        (mod 2^32)
//   out = fmaf((float)acc, scale[co], bias[co]) -> ReLU ->
//         float | codes = clip(rint(out / rs), qn, qp) | packed codes
//
// Design v2: an implicit GEMM on the int8 tensor cores, rows = N*Ho*Wo
// output pixels, columns = Co, K = FH*FW*Ci, walked one packed word (32
// channels of one tap) at a time. The weights (w_bits, FH*FW*G, Co) are
// exactly the packed GEMM's (w_bits, W, N) weights, so the tile, the digit
// expansion in registers, the mma.sync per digit pair and the staged
// epilogue are K3's (digits.cuh). Only the activation words differ: word
// kw = tap * G + g of pixel (n, oh, ow) is x[.., n, oh*s - p + r, ow*s - p +
// s', g], zero when the tap falls in the padding; a word whose tap is
// padding for every pixel of a warp's rows is skipped by the whole warp
// (conv8 is 1x1: only its centre tap is real). Lanes past Ci in each tap's
// last word are masked.
//
// Bound on the H100: at ResNet9's W2A2 the operations (2 x MACs at the int8
// peak), 5 µs per batch-32 forward; the packed operands are a few hundred
// KB. What holds the kernel back now is latency, not the tensor cores: a
// warp walks a handful of K words, each one memory round trip plus about
// 150 integer instructions of expansion and addressing against 8 mma, and
// then the block's epilogue; the early layers run 16 waves of blocks. The
// design's answers: one m16n8k32 mma does 4,096 MACs where the popcount
// design (v1) did 32 per instruction; the K words are split over the
// block's warps so that the small late layers (32 to 512 output pixels)
// still put hundreds of warps in flight; 4-row-tile blocks are held to 4
// warps and 128 registers so that four fit on an SM.
// Not done yet (ROADMAP queue 2): operand words go from global memory
// straight to registers, a scalar __ldg that the four lanes of a fragment
// row issue at one address, with no cp.async staging in shared memory; each
// warp expands its words itself.
// Numerics: the epilogue (epilogue.cuh, shared with the packed GEMMs) is
// the single-rounding fmaf the reference's XLA epilogue contracts to, the
// IEEE divide and rintf's round half to even.

#include <cuda_runtime.h>
#include <stdint.h>

#include "digits.cuh"
#include "epilogue.cuh"

namespace {

struct ConvArgs {
  const int32_t* x;
  dig::Weights wt;  // (w_bits, FH*FW*G, Co)
  dig::Plan ap;
  int n, h, wd, ci, groups, fw, stride, pad, ho, wo;
  epi::Epilogue e;
};

// The activation words of a lane's NT output pixels (rows r0 + 8 nt + g).
// Word kw is tap (r, s) = divmod(kw / G, FW) and channel word gi = kw % G;
// step() moves (r, s, gi) on from the previous word without dividing.
template <int NT>
struct ConvSrc : dig::PlaneSrc<ConvSrc<NT>> {
  const int32_t* x;
  long long plane;
  long long pix[NT];  // word offset of input (ih0, iw0) of the pixel's image
  int ih0[NT], iw0[NT];
  bool real[NT];      // the row is an output pixel
  int h, wd, groups, fw, kw, r, s, gi;
  uint32_t tail;

  __device__ __forceinline__ void step(int k) {
    if (kw < 0) {
      const int tap = k / groups;
      gi = k - tap * groups;
      r = tap / fw;
      s = tap - r * fw;
    } else {
      gi += k - kw;
      while (gi >= groups) {
        gi -= groups;
        if (++s == fw) {
          s = 0;
          ++r;
        }
      }
    }
    kw = k;
  }
  __device__ __forceinline__ bool in(int nt) const {
    return real[nt] && (unsigned)(ih0[nt] + r) < (unsigned)h &&
           (unsigned)(iw0[nt] + s) < (unsigned)wd;
  }
  __device__ __forceinline__ bool live() const {
    bool any = false;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) any |= in(nt);
    return any;
  }
  __device__ __forceinline__ uint32_t word(int nt, const int32_t** p) const {
    if (!in(nt)) return 0u;
    *p = x + pix[nt] + ((long long)r * wd + s) * groups + gi;
    return gi == groups - 1 ? tail : 0xffffffffu;
  }
};

template <class OpA, class OpW, int NT>
__global__ void __launch_bounds__(dig::max_warps<OpA, OpW, NT>() * 32,
                                  dig::min_blocks<OpA, OpW, NT>())
bitserial_conv2d_kernel(const ConvArgs p) {
  const long long pixels = (long long)p.n * p.ho * p.wo;
  const long long r0 = (long long)blockIdx.x * 8 * NT;
  ConvSrc<NT> src;
  src.x = p.x;
  src.plane = (long long)p.n * p.h * p.wd * p.groups;
  src.h = p.h;
  src.wd = p.wd;
  src.groups = p.groups;
  src.fw = p.fw;
  src.kw = -1;
  src.tail = dig::tail_mask(p.ci);
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const long long pix = r0 + 8 * nt + g;
    const int ow = (int)(pix % p.wo);
    const int oh = (int)((pix / p.wo) % p.ho);
    const long long img = pix / ((long long)p.wo * p.ho);
    src.real[nt] = pix < pixels;
    src.ih0[nt] = oh * p.stride - p.pad;
    src.iw0[nt] = ow * p.stride - p.pad;
    src.pix[nt] = ((img * p.h + src.ih0[nt]) * p.wd + src.iw0[nt]) *
                  (long long)p.groups;
  }
  dig::tile<OpA, OpW, NT>(src, p.ap, p.wt, pixels, r0, p.e);
}

template <class OpA, class OpW, int NT>
struct Run {
  static void go(const ConvArgs& p, int warps, cudaStream_t stream) {
    const long long pixels = (long long)p.n * p.ho * p.wo;
    dim3 grid((unsigned int)((pixels + 8 * NT - 1) / (8 * NT)),
              (unsigned int)((p.wt.cols + 31) / 32));
    bitserial_conv2d_kernel<OpA, OpW, NT><<<grid, warps * 32, 0, stream>>>(p);
  }
};

}  // namespace

// nd_a and nd_w are the operands' digit counts (bitops.kernel_digits); nt
// output-pixel tiles of 8 and warps K-split warps a block are the tile (0:
// the heuristic's; dig::dispatch).
extern "C" int bitserial_conv2d(const void* x, const void* w, const void* scale,
                                const void* bias, const void* rs, void* out,
                                int n, int h, int wd, int ci, int co, int fh,
                                int fw, int stride, int pad, int ho, int wo,
                                int a_bits, int w_bits, int a_signed,
                                int w_signed, int nd_a, int nd_w, int relu,
                                int out_mode, int rq_bits, int qn, int qp,
                                int nt, int warps, void* stream) {
  if (a_bits < 1 || a_bits > dig::kMaxBits || w_bits < 1 ||
      w_bits > dig::kMaxBits || nd_a < 1 || nd_a > 3 || nd_w < 1 || nd_w > 3)
    return (int)cudaErrorInvalidValue;
  ConvArgs p;
  p.x = (const int32_t*)x;
  p.groups = (ci + 31) / 32;
  p.wt.w = (const int32_t*)w;
  p.wt.words = fh * fw * p.groups;
  p.wt.cols = co;
  p.wt.plan = dig::Plan{w_bits, w_signed, nd_w};
  p.ap = dig::Plan{a_bits, a_signed, nd_a};
  p.n = n; p.h = h; p.wd = wd; p.ci = ci; p.fw = fw;
  p.stride = stride; p.pad = pad; p.ho = ho; p.wo = wo;
  p.e = epi::make(scale, bias, rs, out, relu, out_mode, rq_bits, qn, qp);
  const long long pixels = (long long)n * ho * wo;
  const int rc = dig::dispatch<Run>(p, p.ap, p.wt.plan, pixels, co, nt, warps,
                                    (cudaStream_t)stream);
  if (rc != (int)cudaSuccess) return rc;
  return (int)cudaGetLastError();
}

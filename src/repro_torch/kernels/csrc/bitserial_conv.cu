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
// Algorithm 1 on the packed words, so nothing is ever unpacked: for each
// tap, channel word and plane pair (i, j) the accumulator gains
// +-2^(i+j) * popc(a_word & w_word), the MSB plane of a signed operand
// weighing negative. The radix of the reference's digit plan does not change
// the integer result, so it is not needed here. Padding taps are skipped
// (zero words add nothing) and the lanes past Ci in the last word are masked.
// The accumulator is uint32, so it wraps modulo 2^32 like the reference's
// int32 Horner sums without signed-overflow undefined behaviour.
//
// Bound on the H100: operations (and, at these small sizes, launch latency);
// the packed operands are a few hundred KB. Design: one warp owns 32
// consecutive output channels of one output pixel. Weights are Co-contiguous,
// so a warp's weight loads are one coalesced 128-byte transaction; the
// activation word of the pixel is the same address for all 32 lanes (a
// broadcast). The packed epilogue is one __ballot_sync per output plane over
// the warp's 32 channels, which is the (rq_bits, N, Ho, Wo, ceil(Co/32))
// word itself. The TPU kernel's VMEM digit caches across an "arbitrary"
// grid have no counterpart: blocks share nothing. Tensor-core (int8 mma or
// wgmma on digit planes) tiles are later work.
//
// Numerics: the epilogue (epilogue.cuh, shared with the packed GEMMs) is
// the single-rounding fmaf the reference's XLA epilogue contracts to, the
// IEEE divide and rintf's round half to even.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

struct ConvArgs {
  const int32_t* x;
  const int32_t* w;
  int n, h, wd, ci, words, co, fh, fw, stride, pad, ho, wo;
  int a_bits, w_bits, a_signed, w_signed;
  epi::Epilogue e;
};

__global__ void bitserial_conv2d_kernel(const ConvArgs p) {
  const int lane = threadIdx.x & 31;
  const long long pixels = (long long)p.n * p.ho * p.wo;
  const long long pix = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pix >= pixels) return;  // the whole warp leaves together
  const int group = blockIdx.y;
  const int c = group * 32 + lane;
  const bool valid = c < p.co;

  const int ow = (int)(pix % p.wo);
  const int oh = (int)((pix / p.wo) % p.ho);
  const int img = (int)(pix / ((long long)p.wo * p.ho));

  const long long a_plane = (long long)p.n * p.h * p.wd * p.words;
  const long long w_plane = (long long)p.fh * p.fw * p.words * p.co;
  const int tail_bits = p.ci % 32;
  const uint32_t tail = tail_bits ? ((1u << tail_bits) - 1u) : 0xffffffffu;

  uint32_t acc = 0;
  for (int r = 0; r < p.fh; ++r) {
    const int ih = oh * p.stride - p.pad + r;
    if (ih < 0 || ih >= p.h) continue;
    for (int s = 0; s < p.fw; ++s) {
      const int iw = ow * p.stride - p.pad + s;
      if (iw < 0 || iw >= p.wd) continue;
      const int32_t* xa = p.x + (((long long)img * p.h + ih) * p.wd + iw) * p.words;
      const int32_t* wb = p.w + (long long)(r * p.fw + s) * p.words * p.co + c;
      for (int g = 0; g < p.words; ++g) {
        const uint32_t m = (g == p.words - 1) ? tail : 0xffffffffu;
        for (int j = 0; j < p.w_bits; ++j) {
          const uint32_t wv =
              valid ? ((uint32_t)wb[j * w_plane + (long long)g * p.co] & m) : 0u;
          const bool w_neg = p.w_signed && j == p.w_bits - 1;
          for (int i = 0; i < p.a_bits; ++i) {
            const uint32_t av = (uint32_t)xa[i * a_plane + g];
            const uint32_t term = (uint32_t)__popc(av & wv) << (i + j);
            const bool neg = w_neg != (p.a_signed && i == p.a_bits - 1);
            acc = neg ? acc - term : acc + term;
          }
        }
      }
    }
  }

  // fused epilogue: scaler (+ bias) as one FMA, ReLU, optional requant
  epi::store(p.e, acc, lane, valid, c, pix, pixels, p.co);
}

}  // namespace

extern "C" int bitserial_conv2d(const void* x, const void* w, const void* scale,
                                const void* bias, const void* rs, void* out,
                                int n, int h, int wd, int ci, int co, int fh,
                                int fw, int stride, int pad, int ho, int wo,
                                int a_bits, int w_bits, int a_signed,
                                int w_signed, int relu, int out_mode,
                                int rq_bits, int qn, int qp, void* stream) {
  ConvArgs p;
  p.x = (const int32_t*)x;
  p.w = (const int32_t*)w;
  p.n = n; p.h = h; p.wd = wd; p.ci = ci; p.words = (ci + 31) / 32; p.co = co;
  p.fh = fh; p.fw = fw; p.stride = stride; p.pad = pad; p.ho = ho; p.wo = wo;
  p.a_bits = a_bits; p.w_bits = w_bits; p.a_signed = a_signed;
  p.w_signed = w_signed;
  p.e = epi::make(scale, bias, rs, out, relu, out_mode, rq_bits, qn, qp);
  const long long pixels = (long long)n * ho * wo;
  if (pixels > 0 && co > 0) {
    dim3 grid((unsigned int)((pixels + kWarpsPerBlock - 1) / kWarpsPerBlock),
              (unsigned int)((co + 31) / 32));
    bitserial_conv2d_kernel<<<grid, kWarpsPerBlock * 32, 0,
                              (cudaStream_t)stream>>>(p);
  }
  return (int)cudaGetLastError();
}

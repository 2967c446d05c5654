// Quantize + bit-transpose pack (the QuantSer unit, BARVINN §3.1.4).
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py::quantize_pack_pallas
// (pallas_call at quantize_pack.py:67, body _kernel at :38).
//
//   codes[g, r, l] = clip(rint(x[r, l] / alpha[g]), qn, qp)      g < G <= 4
//   out[g, b, r, w] bit t = bit b of (codes[g, r, 32 w + t] & mask), t < 32
//
// x is float32 or bf16, read in its own type and widened in registers
// (__bfloat162float is exact, as the reference's astype(float32) is). One
// launch quantizes one activation for G step sizes: the LM's q/k/v and
// gate/up projections read the same activation, each with its own step.
// out is (G, bits, R, ceil(L/32)) 32-bit words, lane t in bit t: slice g is
// the reference's uint32 planes for step g, carried as int32, in the layout
// the packed GEMM (K3) takes. Lanes past L are 0, the reference's zero
// padding. A second entry packs int32 codes that are already quantized (the
// `pack_codes` step after an integer pool).
//
// Bound on the H100: at the LM's sizes, the launch, not the bytes. A
// (4, 2048) bf16 activation is 16 KB, 0.01 us of memory time, and K1 there
// takes about what a launch that zeroes one float takes (6.0 against 5.0 us
// under the same cold timer, PERF.md). At larger sizes, bytes: each element
// is read once and costs G divides, rounds and clips; the output is
// G * bits / 32 of a word per element. Design: one launch per distinct
// activation instead of one per projection, and no float32 copy of a bf16
// activation before it.
// One warp owns 32 consecutive lanes of one row, so its load is one
// coalesced transaction; it issues that load and its G step-size loads
// before the first divide, and __ballot_sync of bit b of the warp's codes
// IS the packed word of plane b — no shared memory, no shuffles. Lane b of
// the warp stores plane b's word. A warp walking 4 words of its row was
// slower summed over an LM step at decode and at prefill (PERF.md). The
// TPU kernel's (block_r, block_l) tiling is a VMEM choice and has no
// counterpart here.
//
// Numerics match the reference bit for bit: __fdiv_rn is the IEEE divide
// (never built with --use_fast_math) and rintf rounds half to even like
// jnp.round. The steps are read from device memory, so the host never syncs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxGroups = 4;

// the G step sizes, each one float32 on the card
struct Steps {
  const float* p[kMaxGroups];
};

__device__ __forceinline__ uint32_t lane_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Every lane of the warp calls this with its masked code u (0 for lanes past
// the row); lane b writes the word of plane b.
__device__ __forceinline__ void ballot_store(uint32_t u, int bits, int lane,
                                             int32_t* out, long long plane,
                                             long long word) {
  uint32_t mine = 0;
  for (int b = 0; b < bits; ++b) {
    uint32_t w = __ballot_sync(0xffffffffu, (u >> b) & 1u);
    if (lane == b) mine = w;
  }
  if (lane < bits) out[(long long)lane * plane + word] = (int32_t)mine;
}

template <typename T, int G>
__global__ void quantize_pack_kernel(const T* __restrict__ x, Steps steps,
                                     int32_t* __restrict__ out, int rows,
                                     int len, int words, int bits, float qn,
                                     float qp) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long total = (long long)rows * words;
  if (warp >= total) return;  // the whole warp leaves together
  const int row = (int)(warp / words);
  const int col = (int)(warp % words) * 32 + lane;
  // every load first: the warp's 32 columns, then its step sizes
  const float v = col < len ? widen(x[(long long)row * len + col]) : 0.0f;
  float alpha[G];
#pragma unroll
  for (int g = 0; g < G; ++g) alpha[g] = __ldg(steps.p[g]);
  const uint32_t mask = lane_mask(bits);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t u = 0;
    if (col < len) {
      float q = rintf(__fdiv_rn(v, alpha[g]));
      q = fminf(fmaxf(q, qn), qp);
      u = (uint32_t)(int)q & mask;
    }
    ballot_store(u, bits, lane, out + (long long)g * bits * total, total,
                 warp);
  }
}

__global__ void pack_codes_kernel(const int32_t* __restrict__ codes,
                                  int32_t* __restrict__ out, int rows, int len,
                                  int words, int bits) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long total = (long long)rows * words;
  if (warp >= total) return;
  const int row = (int)(warp / words);
  const int g = (int)(warp % words);
  const int col = g * 32 + lane;
  uint32_t u = 0;
  if (col < len) u = (uint32_t)codes[(long long)row * len + col] & lane_mask(bits);
  ballot_store(u, bits, lane, out, total, warp);
}

unsigned int grid_for(long long warps) {
  return (unsigned int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// One call's operands, the same for every (T, G) instantiation.
struct Args {
  const void* x;
  Steps steps;
  void* out;
  int rows, len, words, bits;
  float qn, qp;
};

template <typename T, int G>
void launch(const Args& a, cudaStream_t stream) {
  quantize_pack_kernel<T, G>
      <<<grid_for((long long)a.rows * a.words), kWarpsPerBlock * 32, 0,
         stream>>>((const T*)a.x, a.steps, (int32_t*)a.out, a.rows, a.len,
                   a.words, a.bits, a.qn, a.qp);
}

template <typename T>
void launch_groups(int groups, const Args& a, cudaStream_t stream) {
  switch (groups) {
    case 1: launch<T, 1>(a, stream); break;
    case 2: launch<T, 2>(a, stream); break;
    case 3: launch<T, 3>(a, stream); break;
    default: launch<T, 4>(a, stream); break;
  }
}

}  // namespace

// x: (rows, len) float32 (bf16 = 0) or bf16 (bf16 = 1); a0..a3: the step
// sizes, one float32 each (those past `groups` unused); out: (groups, bits,
// rows, ceil(len/32)) int32.
extern "C" int quantize_pack_float(const void* x, int bf16, const void* a0,
                                   const void* a1, const void* a2,
                                   const void* a3, int groups, void* out,
                                   int rows, int len, int bits, int qn, int qp,
                                   void* stream) {
  if (groups < 1 || groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  const Steps steps = {{(const float*)a0, (const float*)a1, (const float*)a2,
                        (const float*)a3}};
  const Args a = {x, steps, out, rows, len, (len + 31) / 32, bits,
                  (float)qn, (float)qp};
  if (rows > 0 && a.words > 0) {
    if (bf16)
      launch_groups<__nv_bfloat16>(groups, a, (cudaStream_t)stream);
    else
      launch_groups<float>(groups, a, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_codes_i32(const void* codes, void* out, int rows, int len,
                              int bits, void* stream) {
  const int words = (len + 31) / 32;
  if (rows > 0 && words > 0) {
    pack_codes_kernel<<<grid_for((long long)rows * words),
                        kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
        (const int32_t*)codes, (int32_t*)out, rows, len, words, bits);
  }
  return (int)cudaGetLastError();
}

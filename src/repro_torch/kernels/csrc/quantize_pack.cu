// Quantize + bit-transpose pack (the QuantSer unit, BARVINN §3.1.4).
//
// Replaces the TPU kernel repro/kernels/quantize_pack.py::quantize_pack_pallas
// (pallas_call at quantize_pack.py:67, body _kernel at :38).
//
//   codes[r, l] = clip(rint(x[r, l] / alpha), qn, qp)            (float input)
//   out[b, r, g] bit t = bit b of (codes[r, 32 g + t] & mask)    t = 0..31
//
// out is (bits, R, ceil(L/32)) 32-bit words, lane t in bit t: the layout of
// the reference's uint32 planes, carried here as int32. Lanes past L are 0,
// which is the reference's zero padding. A second entry packs int32 codes
// that are already quantized (the `pack_codes` step after an integer pool).
//
// Bound on the H100: bytes. Each element is read once (4 bytes) and costs a
// divide, a round and a clip; the output is bits/32 of a word per element.
// Design: one warp owns 32 consecutive lanes of one row, so the 32 loads of
// a warp are one coalesced 128-byte transaction, and __ballot_sync of bit b
// of the warp's codes IS the packed word of plane b — no shared memory, no
// shuffles. Lane b of the warp stores plane b's word. The TPU kernel's
// (block_r, block_l) tiling is a VMEM choice and has no counterpart here.
//
// Numerics match the reference bit for bit: __fdiv_rn is the IEEE divide
// (never built with --use_fast_math) and rintf rounds half to even like
// jnp.round. alpha is read from device memory, so the host never syncs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t lane_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
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

__global__ void quantize_pack_f32_kernel(const float* __restrict__ x,
                                         const float* __restrict__ alpha,
                                         int32_t* __restrict__ out, int rows,
                                         int len, int words, int bits,
                                         float qn, float qp) {
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long total = (long long)rows * words;
  if (warp >= total) return;  // the whole warp leaves together
  const int row = (int)(warp / words);
  const int g = (int)(warp % words);
  const int col = g * 32 + lane;
  uint32_t u = 0;
  if (col < len) {
    float q = rintf(__fdiv_rn(x[(long long)row * len + col], *alpha));
    q = fminf(fmaxf(q, qn), qp);
    u = (uint32_t)(int)q & lane_mask(bits);
  }
  ballot_store(u, bits, lane, out, total, warp);
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

unsigned int grid_for(int rows, int words) {
  long long warps = (long long)rows * words;
  return (unsigned int)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

}  // namespace

extern "C" int quantize_pack_f32(const void* x, const void* alpha, void* out,
                                 int rows, int len, int bits, int qn, int qp,
                                 void* stream) {
  const int words = (len + 31) / 32;
  if (rows > 0 && words > 0) {
    quantize_pack_f32_kernel<<<grid_for(rows, words), kWarpsPerBlock * 32, 0,
                               (cudaStream_t)stream>>>(
        (const float*)x, (const float*)alpha, (int32_t*)out, rows, len, words,
        bits, (float)qn, (float)qp);
  }
  return (int)cudaGetLastError();
}

extern "C" int pack_codes_i32(const void* codes, void* out, int rows, int len,
                              int bits, void* stream) {
  const int words = (len + 31) / 32;
  if (rows > 0 && words > 0) {
    pack_codes_kernel<<<grid_for(rows, words), kWarpsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)codes, (int32_t*)out, rows, len, words, bits);
  }
  return (int)cudaGetLastError();
}

// The fused MVU post-pipeline (BARVINN §3.1.4) shared by the packed conv
// (K2) and the packed GEMMs (K3, K4): scaler + bias as one FMA -> ReLU ->
// float | codes = clip(rint(out / rs), qn, qp) | packed codes; or no
// post-pipeline at all: the raw int32 accumulator (kAcc, the grouped K4
// entry, whose caller scales in torch as the reference does).
//
// Plain side: repro_torch/kernels/epilogue.py. Numerics: fmaf is the single
// rounding the reference's jitted (and Pallas) epilogue contracts to (the
// sources are built with --fmad=false, so nothing else is contracted);
// __fdiv_rn is the IEEE divide; rintf rounds half to even like jnp.round.
// rs == nullptr means no divide (K4's requant: its scale folds the step).
// scale, bias and rs are read from device memory, so the host never syncs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace epi {

enum OutMode { kFloat = 0, kCodes8 = 1, kCodes32 = 2, kPacked = 3, kAcc = 4 };

struct Epilogue {
  const float* scale;  // (cols,); null for kAcc
  const float* bias;   // (cols,) or null
  const float* rs;     // one float, or null: no divide
  void* out;
  int relu, out_mode, rq_bits;
  float qn, qp;
};

// Called by all 32 lanes of a warp together. Lane `lane` owns column `c` of
// output row `row` (of `rows`); `valid` is c < cols. The warp's 32 columns
// are one 32-lane word, so a packed output is one __ballot_sync per plane:
// (rq_bits, rows, ceil(cols/32)) words, lanes past `cols` contributing 0.
__device__ __forceinline__ void store(const Epilogue& e, uint32_t acc,
                                      int lane, bool valid, int c,
                                      long long row, long long rows,
                                      int cols) {
  if (e.out_mode == kAcc) {
    if (valid) ((int32_t*)e.out)[row * cols + c] = (int32_t)acc;
    return;
  }
  const float f = (float)(int32_t)acc;
  const float sc = valid ? e.scale[c] : 0.f;
  float out = e.bias ? fmaf(f, sc, valid ? e.bias[c] : 0.f) : f * sc;
  if (e.relu) out = fmaxf(out, 0.f);
  const long long o = row * cols + c;
  if (e.out_mode == kFloat) {
    if (valid) ((float*)e.out)[o] = out;
    return;
  }
  float q = rintf(e.rs ? __fdiv_rn(out, *e.rs) : out);
  q = fminf(fmaxf(q, e.qn), e.qp);
  const int code = (int)q;
  if (e.out_mode == kCodes8) {
    if (valid) ((int8_t*)e.out)[o] = (int8_t)code;
    return;
  }
  if (e.out_mode == kCodes32) {
    if (valid) ((int32_t*)e.out)[o] = code;
    return;
  }
  // packed: lane b stores plane b's word
  const uint32_t mask = (1u << e.rq_bits) - 1u;
  const uint32_t u = valid ? ((uint32_t)code & mask) : 0u;
  const int cw = (cols + 31) / 32;
  uint32_t mine = 0;
  for (int b = 0; b < e.rq_bits; ++b) {
    const uint32_t word = __ballot_sync(0xffffffffu, (u >> b) & 1u);
    if (lane == b) mine = word;
  }
  if (lane < e.rq_bits)
    ((int32_t*)e.out)[((long long)lane * rows + row) * cw + c / 32] =
        (int32_t)mine;
}

inline Epilogue make(const void* scale, const void* bias, const void* rs,
                     void* out, int relu, int out_mode, int rq_bits, int qn,
                     int qp) {
  Epilogue e;
  e.scale = (const float*)scale;
  e.bias = (const float*)bias;
  e.rs = (const float*)rs;
  e.out = out;
  e.relu = relu;
  e.out_mode = out_mode;
  e.rq_bits = rq_bits;
  e.qn = (float)qn;
  e.qp = (float)qp;
  return e;
}

}  // namespace epi

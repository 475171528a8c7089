// Fast activation forms of the paper's §3.4, shared by fast_act.cu and
// fused_matmul.cu.
//
// Each function reproduces its plain torch version
// (repro_torch/kernels/fast_act/ref.py) bit for bit: every multiply,
// add and divide is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn), which nvcc never contracts into an FMA, and
// eager torch likewise rounds after each op.  The clamps are written
// as comparisons so a NaN passes through as torch.clamp lets it.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float clamp_f32(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// Schraudolph exp: int32(A*x + (B-C)) truncated toward zero, read as the
// bits of an f32.  The constants are the reference's doubles rounded to
// f32, as jnp and torch round them: A = 2^23/ln 2 -> 12102203,
// B - C = 127*2^23 - 8*60801 = 1064866808 -> 1064866816.
__device__ __forceinline__ float schraudolph_exp(float x) {
  x = clamp_f32(x, -87.0f, 88.0f);
  const float v = __fadd_rn(__fmul_rn(12102203.0f, x), 1064866816.0f);
  return __int_as_float(__float2int_rz(v));
}

// tanh via the degree-(7,8) continued fraction (paper Eq. 5).
__device__ __forceinline__ float cf_tanh(float x) {
  x = clamp_f32(x, -4.97f, 4.97f);
  const float x2 = __fmul_rn(x, x);
  float num = __fadd_rn(__fmul_rn(36.0f, x2), 6930.0f);
  num = __fadd_rn(__fmul_rn(num, x2), 270270.0f);
  num = __fadd_rn(__fmul_rn(num, x2), 2027025.0f);
  num = __fmul_rn(num, x);
  float den = __fadd_rn(x2, 630.0f);
  den = __fadd_rn(__fmul_rn(den, x2), 51975.0f);
  den = __fadd_rn(__fmul_rn(den, x2), 945945.0f);
  den = __fadd_rn(__fmul_rn(den, x2), 2027025.0f);
  return __fdiv_rn(num, den);
}

// sigmoid(x) = 0.5 * (tanh(0.5 * x) + 1)  (paper Eq. 4).
__device__ __forceinline__ float cf_sigmoid(float x) {
  return __fmul_rn(0.5f, __fadd_rn(cf_tanh(__fmul_rn(0.5f, x)), 1.0f));
}

}  // namespace repro

// The fused dense epilogue of fused_matmul.cu and fused_matmul_q8.cu:
// bias -> activation -> folded-BN affine on one f32 value in registers,
// before the single store of the output element (the paper's §3.4).
//
// Each step rounds like its plain torch version
// (repro_torch/kernels/fused_matmul/ref.py::epilogue_chain): explicitly
// rounded intrinsics, never contracted into an FMA, so an int8 site,
// whose dequantized value is exact, stores the plain version's bits for
// none/relu/relu6/leaky_relu/hard_sigmoid and the affine, and for the
// fast tanh/sigmoid.  elu, tanh and sigmoid use CUDA's expm1f/tanhf/expf,
// which may differ from torch's by an ulp.
#pragma once

#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace repro {

// Activation codes; repro_torch/kernels/fused_matmul/kernel.py::ACT_CODES.
enum Act {
  kNone = 0,
  kRelu = 1,
  kRelu6 = 2,
  kLeakyRelu = 3,
  kHardSigmoid = 4,
  kElu = 5,
  kTanh = 6,
  kSigmoid = 7,
};

__device__ __forceinline__ float activate(float y, int act, float alpha,
                                          int fast) {
  switch (act) {
    case kRelu:
      return y < 0.0f ? 0.0f : y;
    case kRelu6:
      return clamp_f32(y, 0.0f, 6.0f);
    case kLeakyRelu:
      return y >= 0.0f ? y : __fmul_rn(alpha, y);
    case kHardSigmoid:
      return clamp_f32(__fadd_rn(__fmul_rn(y, 0.2f), 0.5f), 0.0f, 1.0f);
    case kElu:  // exact expm1 even when fast, as the TPU kernel does
      return y >= 0.0f ? y : expm1f(y);
    case kTanh:
      return fast ? cf_tanh(y) : tanhf(y);
    case kSigmoid:
      return fast ? cf_sigmoid(y) : __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
    default:
      return y;
  }
}

// y of output column n -> the stored value.  bias/scale/offset may be
// null (scale and offset together).
__device__ __forceinline__ float epilogue(float y, int n,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ offset,
                                          int act, float alpha, int fast) {
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  y = activate(y, act, alpha, fast);
  if (scale != nullptr) y = __fadd_rn(__fmul_rn(y, scale[n]), offset[n]);
  return y;
}

}  // namespace repro

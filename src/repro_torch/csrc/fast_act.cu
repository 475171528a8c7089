// fast_act: elementwise Schraudolph exp / continued-fraction tanh /
// sigmoid over a flat contiguous f32 or bf16 tensor.
//
// Replaces the TPU kernel fast_act_2d (src/repro/kernels/fast_act/
// kernel.py, bodies _exp_body/_tanh_body/_sigmoid_body), which mapped
// the same bodies over 256x128 VMEM tiles.
//
// Bound on the H100: device-memory bytes.  Each element is read once
// and written once (8 bytes in f32) for a few dozen f32 operations, far
// below the ~20 operations per byte where the card's f32 units would
// become the limit.  The design is a grid-stride loop over the flat
// tensor with neighbouring threads on neighbouring elements, so every
// warp access is one coalesced transaction; the math is f32 inside and
// bf16 rounds once, on the store.  Vector (16-byte) loads are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

enum FastFn { kExp = 0, kTanh = 1, kSigmoid = 2 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int FN>
__global__ void __launch_bounds__(kThreads)
    fast_act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v = load_f32(x + i);
    float r;
    if (FN == kExp) {
      r = repro::schraudolph_exp(v);
    } else if (FN == kTanh) {
      r = repro::cf_tanh(v);
    } else {
      r = repro::cf_sigmoid(v);
    }
    store_f32(y + i, r);
  }
}

template <typename T>
void launch(const void* x, void* y, long long n, int fn, cudaStream_t s) {
  long long want = (n + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (fn) {
    case kExp:
      fast_act_kernel<T, kExp><<<blocks, kThreads, 0, s>>>(xi, yo, n);
      break;
    case kTanh:
      fast_act_kernel<T, kTanh><<<blocks, kThreads, 0, s>>>(xi, yo, n);
      break;
    default:
      fast_act_kernel<T, kSigmoid><<<blocks, kThreads, 0, s>>>(xi, yo, n);
      break;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// fn: 0 exp, 1 tanh, 2 sigmoid.  bf16 != 0 means both x and y are bf16.
extern "C" int repro_fast_act(const void* x, void* y, long long n, int fn,
                              int bf16, void* stream) {
  if (fn < kExp || fn > kSigmoid || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(x, y, n, fn, s);
  } else {
    launch<float>(x, y, n, fn, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

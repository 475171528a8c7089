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
// become the limit.  Streaming at the memory's rate takes enough bytes
// in flight to cover its latency (some megabytes on the H100), so:
//
// * Loads and stores are 16 bytes a thread: a float4 in f32, eight bf16
//   as a uint4.  Neighbouring threads take neighbouring vectors, so a
//   warp moves 512 contiguous bytes per access.
// * Each thread issues kUnroll such loads before it does any arithmetic.
// * The grid is the SMs times the blocks each holds at once (from the
//   occupancy calculator), capped by the work; blocks stride over the
//   rest.
// * A scalar head covers the elements before the first 16-byte boundary
//   of x (a view may start at any element), a scalar tail the length
//   past the last whole vector.  The wrapper allocates y in the same
//   phase of 16 bytes as x; a y in another phase takes the scalar loop.
// * Stores are ordinary write-back ones: fast_softmax reads y again at
//   once, and at the main path's 26 MB it fits in the 50 MB L2.
//
// The math is f32 inside and bf16 rounds once, on the store.  Why CUDA
// and not Triton: the fast forms (fast_math.cuh) are bit-exact with their
// plain versions only because every multiply and add is an explicitly
// rounded intrinsic that is never contracted into an FMA, and Triton
// gives no such guarantee.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fast_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // 16-byte loads in flight per thread
constexpr int kMaxDevices = 64;

enum FastFn { kExp = 0, kTanh = 1, kSigmoid = 2 };

template <int FN>
__device__ __forceinline__ float apply(float v) {
  if (FN == kExp) return repro::schraudolph_exp(v);
  if (FN == kTanh) return repro::cf_tanh(v);
  return repro::cf_sigmoid(v);
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte vector through the function, element by element.  A bf16
// widens to f32 exactly as its bits shifted up 16 (__bfloat162float).
template <int FN>
__device__ __forceinline__ unsigned apply_bits(unsigned w, float) {
  return __float_as_uint(apply<FN>(__uint_as_float(w)));
}
template <int FN>
__device__ __forceinline__ unsigned apply_bits(unsigned w, __nv_bfloat16) {
  const float lo = apply<FN>(__uint_as_float(w << 16));
  const float hi = apply<FN>(__uint_as_float(w & 0xffff0000u));
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
template <typename T, int FN>
__device__ __forceinline__ uint4 apply_vec(uint4 u) {
  return make_uint4(apply_bits<FN>(u.x, T()), apply_bits<FN>(u.y, T()),
                    apply_bits<FN>(u.z, T()), apply_bits<FN>(u.w, T()));
}

// Elements [0, head) and [head + 16 * nvec / sizeof(T), n) one a thread;
// the nvec 16-byte vectors between, kUnroll a thread per step, loaded
// before any is computed.  With nvec = 0 and head = n, the scalar loop
// over all of it.
template <typename T, int FN>
__global__ void __launch_bounds__(kThreads)
    fast_act_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                    long long head, long long nvec) {
  constexpr int kVec = 16 / sizeof(T);
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * kThreads;
  const long long tail = head + nvec * kVec;
  for (long long i = tid; i < head; i += nthreads)
    store_f32(y + i, apply<FN>(load_f32(x + i)));
  for (long long i = tail + tid; i < n; i += nthreads)
    store_f32(y + i, apply<FN>(load_f32(x + i)));

  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  const long long step = nthreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll +
                        threadIdx.x;
       base < nvec; base += step) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < nvec) r[u] = __ldg(xv + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < nvec) yv[i] = apply_vec<T, FN>(r[u]);
    }
  }
}

// Blocks one SM holds at once of this kernel, per device, from the
// occupancy calculator (asked once per device and kernel).
template <typename T, int FN>
int resident_blocks(int dev) {
  static int cached[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return 1;
  if (cached[dev] == 0) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, fast_act_kernel<T, FN>, kThreads, 0) != cudaSuccess ||
        blocks < 1)
      blocks = 1;
    cached[dev] = blocks;
  }
  return cached[dev];
}

int sm_count(int dev) {
  static int cached[kMaxDevices] = {0};
  if (dev < 0 || dev >= kMaxDevices) return 1;
  if (cached[dev] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms < 1)
      sms = 1;
    cached[dev] = sms;
  }
  return cached[dev];
}

template <typename T, int FN>
void launch_fn(const T* x, T* y, long long n, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  long long head = n, nvec = 0;
  if (xa % sizeof(T) == 0 && xa % 16 == ya % 16) {
    head = (long long)((16 - xa % 16) % 16 / sizeof(T));
    head = head < n ? head : n;
    nvec = (n - head) / kVec;
  }
  int dev = 0;
  cudaGetDevice(&dev);
  const long long per_block = (long long)kThreads * kUnroll;
  long long want = (nvec + per_block - 1) / per_block;
  const long long scalar = head + (n - head - nvec * kVec);
  const long long want_scalar = (scalar + kThreads - 1) / kThreads;
  want = want > want_scalar ? want : want_scalar;
  const long long cap = (long long)sm_count(dev) * resident_blocks<T, FN>(dev);
  const int blocks = (int)(want < cap ? (want > 0 ? want : 1) : cap);
  fast_act_kernel<T, FN><<<blocks, kThreads, 0, s>>>(x, y, n, head, nvec);
}

template <typename T>
void launch(const void* x, void* y, long long n, int fn, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* yo = static_cast<T*>(y);
  switch (fn) {
    case kExp:
      launch_fn<T, kExp>(xi, yo, n, s);
      break;
    case kTanh:
      launch_fn<T, kTanh>(xi, yo, n, s);
      break;
    default:
      launch_fn<T, kSigmoid>(xi, yo, n, s);
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

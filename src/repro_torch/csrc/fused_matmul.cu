// fused_matmul: out = affine(act(x . W + bias)) in one kernel, f32
// accumulation, with the epilogue applied in registers before the one
// store of each output element (the paper's §3.4: "the activation
// function is applied before writing the result into memory").
//
// Replaces the TPU kernel fused_matmul_p (src/repro/kernels/
// fused_matmul/kernel.py, bodies _matmul_kernel and _apply_epilogue).
// Where that kernel carried an accumulator across a sequential K grid
// axis in VMEM scratch, each block here owns one BM x BN output tile and
// loops over K itself; blocks share nothing.
//
//   x    (M, K) row-major, float or bf16 (widened to f32 as it is loaded)
//   W    "io": (K, N) row-major; "oi": (N, K) row-major, contracted on K
//        in place (no transpose is materialised)
//   bias, scale, offset: (N,) f32 or null (scale and offset together)
//   out  (M, N) f32
//
// Ragged edges are masked loads (zeros) and masked stores, in place of
// the reference wrapper's trace-time pads.
//
// Bound on the H100: at the compiler's main-path shapes (M = batch of
// 1..256, K <= 256, N <= 128) neither the bytes nor the f32 operations
// are: a launch costs microseconds while the work is well under one.
// At large M, K and N it is the f32 FMA rate, since this kernel uses the
// SIMT units and not the tensor cores.  The design is the simple, right
// one first: 64x64 output tiles, K in steps of 16 through shared memory,
// 256 threads with a 4x4 register sub-tile each; the tiles are padded by
// one column so neither the transposing stores nor the reads conflict on
// banks.  wgmma/TMA and CUDA graphs are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// Must agree with repro_torch/kernels/tiles.py::CUDA_BLOCK.
constexpr int BM = 64, BN = 64, BK = 16;
constexpr int TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kTx = BN / TN;                     // 16 threads along N

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, bool OI>
__global__ void __launch_bounds__(kThreads)
    fused_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias,
                        const float* __restrict__ scale,
                        const float* __restrict__ offset,
                        float* __restrict__ out, int M, int K, int N, int act,
                        float alpha, int fast) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: element e covers row e / BK, depth e % BK, so a warp reads
    // two runs of 16 consecutive K values.
#pragma unroll
    for (int i = 0; i < (BM * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[c][r] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < (BN * BK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      if (OI) {  // W (N, K): consecutive threads walk K within a row
        const int r = e / BK, c = e % BK;
        const int gn = n0 + r, gk = k0 + c;
        ws[c][r] =
            (gn < N && gk < K) ? to_f32(w[(size_t)gn * K + gk]) : 0.0f;
      } else {  // W (K, N): consecutive threads walk N within a row
        const int r = e / BN, c = e % BN;
        const int gk = k0 + r, gn = n0 + c;
        ws[r][c] =
            (gk < K && gn < N) ? to_f32(w[(size_t)gk * N + gn]) : 0.0f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * kTx];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue in registers (epilogue.cuh): bias -> activation ->
  // folded-BN affine, then the single store.  Neighbouring threads store neighbouring columns.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * kTx;
      if (gn >= N) continue;
      out[(size_t)gm * N + gn] = repro::epilogue(
          acc[i][j], gn, bias, scale, offset, act, alpha, fast);
    }
  }
}

template <typename T>
void launch(const void* x, const void* w, const float* bias,
            const float* scale, const float* offset, float* out, int M, int K,
            int N, int w_oi, int act, float alpha, int fast, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  if (w_oi) {
    fused_matmul_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, wt, bias, scale, offset, out, M, K, N, act, alpha, fast);
  } else {
    fused_matmul_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, wt, bias, scale, offset, out, M, K, N, act, alpha, fast);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller guarantees contiguous operands of the stated shapes, M, N
// > 0 and (M + 63) / 64 <= 65535.
extern "C" int repro_fused_matmul(const void* x, const void* w,
                                  const float* bias, const float* scale,
                                  const float* offset, float* out, int M,
                                  int K, int N, int w_oi, int bf16, int act,
                                  float alpha, int fast, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < repro::kNone ||
      act > repro::kSigmoid || (scale == nullptr) != (offset == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(x, w, bias, scale, offset, out, M, K, N, w_oi, act,
                          alpha, fast, s);
  } else {
    launch<float>(x, w, bias, scale, offset, out, M, K, N, w_oi, act, alpha,
                  fast, s);
  }
  return (int)cudaGetLastError();
}

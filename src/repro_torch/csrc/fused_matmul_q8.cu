// fused_matmul_q8: the int8 dense site in one kernel.
//   out = affine(act(float(sum_k q(x)[m,k] * wq[k,n]) * deq[n] + bias[n]))
// with q(x) = clamp(rint(x / x_scale), -127, 127): x arrives in f32 and is
// quantized as it is loaded, so an int8 dense node costs one launch, as an
// f32 one does under fused_matmul.
//
// Replaces the TPU kernel fused_matmul_q8_p (src/repro/kernels/
// fused_matmul/kernel.py, body _q8_matmul_kernel), together with the
// activation quantize of its wrapper (ops.py::fused_matmul_q8, through
// qmath.quantize_q8).  As there, the int8 x int8 products are summed
// exactly in int32, the sum gets one f32 multiply by deq[n] = s_x * s_w[n]
// while still in registers, then fused_matmul's epilogue (epilogue.cuh)
// and a single store.  The exact sum makes the result independent of the
// summation order, so the output is bit-equal to the plain version
// (ref.py::fused_matmul_q8_ref) for every epilogue built from rounded
// adds, multiplies and compares.
//
// The quantize is the one expression of qmath.quantize_q8: a true
// division (__fdiv_rn; never a multiply by the reciprocal), rintf (round
// half to even, like torch.round), clamp to +-127.
//
//   x     (M, K) f32 row-major
//   wq    int8 "io": (K, N) row-major; "oi": (N, K) row-major, contracted
//         on K in place.  Quantized once, when the program is compiled.
//   deq   (N,) f32; bias, scale, offset: (N,) f32 or null
//   out   (M, N) f32
//
// Ragged M, K and N are masked per element (zeros in, no store out), so K
// need not be a multiple of 4 and the layout pass's padded N costs nothing.
//
// Bound on the H100: at the compiler's main-path shapes (M = batch of
// 1..256, K <= 256, N <= 128) a launch costs microseconds while the bytes
// and operations are well under one.  The design is the simple, right one:
// 64x64 output tiles, 256 threads with a 4x4 register sub-tile, K in steps
// of 32 through shared memory as packed int8x4 words, and dp4a on the CUDA
// cores (four int8 products and their int32 sum per instruction).  s8
// mma.sync/wgmma on the tensor cores, vector loads and TMA are later work.
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// Must agree with repro_torch/kernels/tiles.py::CUDA_Q8_BLOCK.
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int BK4 = BK / 4;  // packed int8x4 words along K per tile row
constexpr int TM = 4, TN = 4;
constexpr int kThreads = (BM / TM) * (BN / TN);  // 256
constexpr int kTx = BN / TN;                     // 16 threads along N

__device__ __forceinline__ int quantize_q8(float v, float s) {
  float q = rintf(__fdiv_rn(v, s));
  q = q < -127.0f ? -127.0f : q;
  q = q > 127.0f ? 127.0f : q;
  return static_cast<int>(q);
}

__device__ __forceinline__ int pack4(int b0, int b1, int b2, int b3) {
  return (b0 & 0xff) | ((b1 & 0xff) << 8) | ((b2 & 0xff) << 16) |
         static_cast<int>(static_cast<unsigned>(b3 & 0xff) << 24);
}

template <bool OI>
__global__ void __launch_bounds__(kThreads)
    fused_matmul_q8_kernel(const float* __restrict__ x,
                           const signed char* __restrict__ w,
                           const float* __restrict__ deq,
                           const float* __restrict__ bias,
                           const float* __restrict__ scale,
                           const float* __restrict__ offset,
                           float* __restrict__ out, int M, int K, int N,
                           float x_scale, int act, float alpha, int fast) {
  // Word [c][r] holds the int8 values of depths 4c..4c+3 of row r (byte
  // 0 = lowest depth), the operand layout of __dp4a.  One int of padding
  // per row keeps the column reads of the inner loop off shared banks.
  __shared__ int xs[BK4][BM + 1];
  __shared__ int ws[BK4][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % kTx;
  const int ty = tid / kTx;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: word e covers row e / BK4, depths 4 * (e % BK4) + 0..3,
    // quantized here; a warp reads four rows' 32 consecutive depths.
#pragma unroll
    for (int i = 0; i < (BM * BK4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / BK4, c = e % BK4;
      const int gm = m0 + r, gk = k0 + 4 * c;
      int q[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        q[t] = (gm < M && gk + t < K)
                   ? quantize_q8(x[(size_t)gm * K + gk + t], x_scale)
                   : 0;
      xs[c][r] = pack4(q[0], q[1], q[2], q[3]);
    }
#pragma unroll
    for (int i = 0; i < (BN * BK4) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      int b[4];
      if (OI) {  // W (N, K): a thread packs four consecutive bytes of a row
        const int r = e / BK4, c = e % BK4;
        const int gn = n0 + r, gk = k0 + 4 * c;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          b[t] = (gn < N && gk + t < K) ? w[(size_t)gn * K + gk + t] : 0;
        ws[c][r] = pack4(b[0], b[1], b[2], b[3]);
      } else {  // W (K, N): neighbouring threads walk N within four rows
        const int r = e % BN, c = e / BN;
        const int gn = n0 + r, gk = k0 + 4 * c;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          b[t] = (gn < N && gk + t < K) ? w[(size_t)(gk + t) * N + gn] : 0;
        ws[c][r] = pack4(b[0], b[1], b[2], b[3]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK4; ++kk) {
      int a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx + j * kTx];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Dequantize the exact sum with one f32 multiply, then the epilogue,
  // then the single store.  Neighbouring threads store neighbouring columns.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * (BM / TM);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * kTx;
      if (gn >= N) continue;
      const float y = __fmul_rn(__int2float_rn(acc[i][j]), deq[gn]);
      out[(size_t)gm * N + gn] =
          repro::epilogue(y, gn, bias, scale, offset, act, alpha, fast);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// The caller guarantees contiguous operands of the stated shapes, M, N
// > 0, x_scale > 0 and (M + 63) / 64 <= 65535.
extern "C" int repro_fused_matmul_q8(const float* x, const void* wq,
                                     const float* deq, const float* bias,
                                     const float* scale, const float* offset,
                                     float* out, int M, int K, int N,
                                     int w_oi, float x_scale, int act,
                                     float alpha, int fast, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || deq == nullptr || !(x_scale > 0.0f) ||
      act < repro::kNone || act > repro::kSigmoid ||
      (scale == nullptr) != (offset == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const signed char* w = static_cast<const signed char*>(wq);
  if (w_oi) {
    fused_matmul_q8_kernel<true><<<grid, kThreads, 0, s>>>(
        x, w, deq, bias, scale, offset, out, M, K, N, x_scale, act, alpha,
        fast);
  } else {
    fused_matmul_q8_kernel<false><<<grid, kThreads, 0, s>>>(
        x, w, deq, bias, scale, offset, out, M, K, N, x_scale, act, alpha,
        fast);
  }
  return (int)cudaGetLastError();
}

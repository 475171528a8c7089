// fused_matmul: out = affine(act(x . W + bias)) in one launch, f32
// accumulation, with the epilogue applied in registers before the one
// store of each output element (the paper's §3.4: "the activation
// function is applied before writing the result into memory").
//
// Replaces the TPU kernel fused_matmul_p (src/repro/kernels/
// fused_matmul/kernel.py, bodies _matmul_kernel and _apply_epilogue).
// Where that kernel carried an accumulator across a sequential K grid
// axis in VMEM scratch, blocks here run in parallel and a K split is
// reduced inside the launch (below).
//
//   x    (M, K) row-major, float or bf16 (widened to f32 as it is read)
//   W    "io": (K, N) row-major; "oi": (N, K) row-major, contracted on K
//        in place (no transpose is materialised)
//   bias, scale, offset: (N,) f32 or null (scale and offset together)
//   out  (M, N) f32
//
// Bound on the H100: at the compiler's main-path shapes (M = batch of
// 1..256, K <= 256, N <= 128) neither the bytes nor the f32 operations
// are (both well under a microsecond); what a call costs is latency: the
// launch, and each round trip to device memory that the block waits on.
// At large M, K and N it is the f32 FMA rate: TF32 is off by contract and
// the kernel stays on the SIMT units.  The design pays the memory latency
// about once per block and spreads small products over many blocks:
//
// * Plan.  The host picks the path, tile and K split from (M, K, N) in
//   one pure function (repro_torch/kernels/fused_matmul/kernel.py::plan)
//   and passes it here; the selector reports the same plan.
// * GEMV path (M <= 16).  Each block stages its rows of x for its K range
//   in shared memory.  "oi": each warp owns one output column and its
//   lanes walk the contiguous W row along K, then reduce across lanes;
//   "io": the lanes own 32 neighbouring columns and the 8 warps split K,
//   reduced through shared memory in warp order.  No masked tile rows.
// * Tiled path (M > 16).  32x32 output tiles, 128 threads with 2x4
//   outputs each, K through a 4-stage ring of 32-deep shared-memory
//   stages filled by 16-byte cp.async.cg copies (3 stages ahead), so a
//   split of up to 128 K values is in flight before the first wait.
//   Rows that are not 16-byte aligned, and the ragged edges, are copied
//   element by element with zero fill.
// * Split K.  The grid splits K so that small outputs still cover the
//   card.  Each split block writes its partial tile to scratch (the
//   wrapper's torch.empty), then one integer atomicAdd on the tile's
//   counter finds the last block to finish; that block sums the partials
//   in split order, applies the epilogue and makes the single store, and
//   resets the counter.  No float atomics: the bits are the same from run
//   to run.  The counters (int32, zeroed once per device by the wrapper)
//   are shared by every launch, so two streams must not run this kernel
//   at once on the same counter buffer; the port uses one stream.
//
// One call is one kernel launch.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// Must agree with repro_torch/kernels/fused_matmul/kernel.py.
constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kGemvXFloats = 4096;  // x staged: MM * ksplit <= this (16 KB)
constexpr int BM = 32, BN = 32, BK = 32;   // tiled path (tiles.py::CUDA_BLOCK)
constexpr int kStages = 4;
constexpr int TM = 2, TN = 4;
constexpr int kTiledThreads = (BM / TM) * (BN / TN);  // 128
constexpr int kTx = BN / TN;                          // 8 threads along N

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Four consecutive values from shared memory, widened to f32; 16-byte
// (f32) or 8-byte (bf16) aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__device__ __forceinline__ T zero() {
  return T(0.0f);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies `n` elements (at most 16 bytes' worth) from global `src` to
// shared `dst`: one cp.async when `whole` (all in bounds, both 16-byte
// aligned), else element by element with zeros past `n`.
template <typename T>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int n,
                                           bool whole) {
  constexpr int kVec = 16 / sizeof(T);
  if (whole) {
    cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = e < n ? src[e] : zero<T>();
  }
}

// After the block's partial sums are in registers: when the launch splits
// K, park them in `part` and report whether this block is the last of the
// tile's splits to arrive (it then reduces them).  `flag` is a shared int.
__device__ __forceinline__ bool arrive_last(int* counter, int splits,
                                            int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!*flag) return false;
  __threadfence();
  return true;
}

// Sum of the splits' partials of element e, in split order.
__device__ __forceinline__ float sum_splits(const float* part, size_t e,
                                            size_t stride, int splits) {
  float s = __ldcg(part + e);
  for (int i = 1; i < splits; ++i) s += __ldcg(part + e + i * stride);
  return s;
}

// ---------------------------------------------------------------------------
// GEMV path: M <= MM <= 16.
// ---------------------------------------------------------------------------
template <typename T, bool OI, int MM>
__global__ void __launch_bounds__(kGemvThreads)
    gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ scale,
                const float* __restrict__ offset, float* __restrict__ out,
                int M, int K, int N, int act, float alpha, int fast,
                int splits, int ksplit, float* __restrict__ part,
                int* __restrict__ counters) {
  __shared__ float xs[kGemvXFloats];
  __shared__ float red[OI ? 1 : kGemvWarps * MM * 32];
  __shared__ int flag;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.y;
  const int k0 = split * ksplit;
  const int kd = max(0, min(ksplit, K - k0));

  for (int i = tid; i < M * kd; i += kGemvThreads) {
    const int m = i / kd, kk = i % kd;
    xs[m * ksplit + kk] = to_f32(x[(size_t)m * K + k0 + kk]);
  }
  __syncthreads();

  float acc[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0.0f;
  int n;  // this thread's output column, valid where `owner`
  bool owner;
  if (OI) {
    n = blockIdx.x * kGemvWarps + warp;
    if (n < N) {
      const T* wr = w + (size_t)n * K + k0;
#pragma unroll 4
      for (int kk = lane; kk < kd; kk += 32) {
        const float wv = to_f32(wr[kk]);
#pragma unroll
        for (int m = 0; m < MM; ++m)
          if (m < M) acc[m] = fmaf(xs[m * ksplit + kk], wv, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
    owner = lane == 0 && n < N;
  } else {
    n = blockIdx.x * 32 + lane;
    if (n < N) {
      const T* wc = w + (size_t)k0 * N + n;
#pragma unroll 4
      for (int kk = warp; kk < kd; kk += kGemvWarps) {
        const float wv = to_f32(wc[(size_t)kk * N]);
#pragma unroll
        for (int m = 0; m < MM; ++m)
          if (m < M) acc[m] = fmaf(xs[m * ksplit + kk], wv, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) red[(warp * MM + m) * 32 + lane] = acc[m];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        float s = red[m * 32 + lane];
        for (int j = 1; j < kGemvWarps; ++j) s += red[(j * MM + m) * 32 + lane];
        acc[m] = s;
      }
    }
    owner = warp == 0 && n < N;
  }

  if (splits > 1) {
    const size_t stride = (size_t)M * N;
    if (owner) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
        if (m < M) __stcg(part + split * stride + (size_t)m * N + n, acc[m]);
    }
    if (!arrive_last(counters + blockIdx.x, splits, &flag)) return;
    if (owner) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
        if (m < M) acc[m] = sum_splits(part, (size_t)m * N + n, stride, splits);
    }
    if (tid == 0) counters[blockIdx.x] = 0;
  }
  if (owner) {
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (m < M)
        out[(size_t)m * N + n] =
            repro::epilogue(acc[m], n, bias, scale, offset, act, alpha, fast);
  }
}

// ---------------------------------------------------------------------------
// Tiled path.
// ---------------------------------------------------------------------------
template <typename T>
struct TiledSmem {
  static constexpr int kVec = 16 / sizeof(T);   // elements per 16 bytes
  static constexpr int kRow = BK + kVec;        // x / "oi" W rows, padded
  static constexpr int kIoRow = BN + kVec;      // "io" W rows, padded
  static constexpr int kX = BM * kRow;          // per stage
  static constexpr int kW = BN * kRow > BK * kIoRow ? BN * kRow : BK * kIoRow;
  static constexpr int kStage = kX + kW;
};

template <typename T, bool OI>
__device__ __forceinline__ void load_stage(T* xs, T* ws, const T* x,
                                           const T* w, int M, int K, int N,
                                           int m0, int n0, int kb, int ke,
                                           bool x_al, bool w_al) {
  using S = TiledSmem<T>;
  constexpr int kVec = S::kVec;
  constexpr int kChunks = BK / kVec;  // chunks per BK-deep row
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * kChunks; c += kTiledThreads) {
    const int r = c / kChunks, kk = (c % kChunks) * kVec;
    const int gm = m0 + r, gk = kb + kk;
    const int n = gm < M ? ke - gk : 0;
    copy_chunk<T>(xs + r * S::kRow + kk, x + (size_t)gm * K + gk, n,
                  x_al && n >= kVec);
  }
  if (OI) {
    for (int c = tid; c < BN * kChunks; c += kTiledThreads) {
      const int r = c / kChunks, kk = (c % kChunks) * kVec;
      const int gn = n0 + r, gk = kb + kk;
      const int n = gn < N ? ke - gk : 0;
      copy_chunk<T>(ws + r * S::kRow + kk, w + (size_t)gn * K + gk, n,
                    w_al && n >= kVec);
    }
  } else {
    constexpr int kNChunks = BN / kVec;
    for (int c = tid; c < BK * kNChunks; c += kTiledThreads) {
      const int r = c / kNChunks, nn = (c % kNChunks) * kVec;
      const int gk = kb + r, gn = n0 + nn;
      const int n = gk < ke ? N - gn : 0;
      copy_chunk<T>(ws + r * S::kIoRow + nn, w + (size_t)gk * N + gn, n,
                    w_al && n >= kVec);
    }
  }
}

template <typename T, bool OI>
__global__ void __launch_bounds__(kTiledThreads)
    tiled_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias,
                 const float* __restrict__ scale,
                 const float* __restrict__ offset, float* __restrict__ out,
                 int M, int K, int N, int act, float alpha, int fast,
                 int splits, int ksplit, float* __restrict__ part,
                 int* __restrict__ counters, int x_al, int w_al) {
  using S = TiledSmem<T>;
  __shared__ __align__(16) T smem[kStages * S::kStage];
  __shared__ int flag;
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int split = blockIdx.z;
  const int kb0 = split * ksplit;
  const int ke = min(K, kb0 + ksplit);
  const int nst = ke > kb0 ? (ke - kb0 + BK - 1) / BK : 0;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // Prologue: the first kStages - 1 stages in flight.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) {
      T* st = smem + s * S::kStage;
      load_stage<T, OI>(st, st + S::kX, x, w, M, K, N, m0, n0, kb0 + s * BK,
                        ke, x_al, w_al);
    }
    cp_async_commit();
  }
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {  // refill the slot that stage s - 1 used
      const int f = s + kStages - 1;
      if (f < nst) {
        T* st = smem + (f % kStages) * S::kStage;
        load_stage<T, OI>(st, st + S::kX, x, w, M, K, N, m0, n0, kb0 + f * BK,
                          ke, x_al, w_al);
      }
      cp_async_commit();
    }
    const T* xs = smem + (s % kStages) * S::kStage;
    const T* ws = xs + S::kX;
    const int kd = min(BK, ke - (kb0 + s * BK));
    for (int kk = 0; kk < kd; kk += 4) {
      float4 a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = load4(xs + (ty + i * (BM / TM)) * S::kRow + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + j * kTx;
        if (OI) {
          b[j] = load4(ws + c * S::kRow + kk);
        } else {
          b[j] = make_float4(to_f32(ws[(kk + 0) * S::kIoRow + c]),
                             to_f32(ws[(kk + 1) * S::kIoRow + c]),
                             to_f32(ws[(kk + 2) * S::kIoRow + c]),
                             to_f32(ws[(kk + 3) * S::kIoRow + c]));
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
  }
  cp_async_wait<0>();

  if (splits > 1) {
    const size_t stride = (size_t)M * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * (BM / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * kTx;
        if (gm < M && gn < N)
          __stcg(part + split * stride + (size_t)gm * N + gn, acc[i][j]);
      }
    }
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (!arrive_last(counters + tile, splits, &flag)) return;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + i * (BM / TM);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gn = n0 + tx + j * kTx;
        if (gm < M && gn < N)
          acc[i][j] = sum_splits(part, (size_t)gm * N + gn, stride, splits);
      }
    }
    if (tid == 0) counters[tile] = 0;
  }

  // Epilogue in registers (epilogue.cuh): bias -> activation ->
  // folded-BN affine, then the single store.
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

struct Args {
  const float *bias, *scale, *offset;
  float* out;
  int M, K, N, act;
  float alpha;
  int fast, splits, ksplit;
  float* part;
  int* counters;
};

// The GEMV template's row count for M (a power of two up to 16).
int gemv_rows(int M) {
  int mm = 1;
  while (mm < M) mm *= 2;
  return mm;
}

template <typename T, int MM>
void launch_gemv(const T* x, const T* w, bool oi, const Args& a,
                 cudaStream_t s) {
  const int cols = oi ? kGemvWarps : 32;
  const dim3 grid((a.N + cols - 1) / cols, a.splits);
  if (oi) {
    gemv_kernel<T, true, MM><<<grid, kGemvThreads, 0, s>>>(
        x, w, a.bias, a.scale, a.offset, a.out, a.M, a.K, a.N, a.act, a.alpha,
        a.fast, a.splits, a.ksplit, a.part, a.counters);
  } else {
    gemv_kernel<T, false, MM><<<grid, kGemvThreads, 0, s>>>(
        x, w, a.bias, a.scale, a.offset, a.out, a.M, a.K, a.N, a.act, a.alpha,
        a.fast, a.splits, a.ksplit, a.part, a.counters);
  }
}

template <typename T>
void launch(const void* xv, const void* wv, bool oi, int path,
            const Args& a, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  if (path == 0) {
    if (a.M <= 1) return launch_gemv<T, 1>(x, w, oi, a, s);
    if (a.M <= 2) return launch_gemv<T, 2>(x, w, oi, a, s);
    if (a.M <= 4) return launch_gemv<T, 4>(x, w, oi, a, s);
    if (a.M <= 8) return launch_gemv<T, 8>(x, w, oi, a, s);
    return launch_gemv<T, 16>(x, w, oi, a, s);
  }
  // cp.async of 16 bytes: every row start 16-byte aligned.
  const size_t al = 16;
  const bool x_al = (a.K * sizeof(T)) % al == 0 &&
                    reinterpret_cast<uintptr_t>(x) % al == 0;
  const bool w_al = ((oi ? a.K : a.N) * sizeof(T)) % al == 0 &&
                    reinterpret_cast<uintptr_t>(w) % al == 0;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  if (oi) {
    tiled_kernel<T, true><<<grid, kTiledThreads, 0, s>>>(
        x, w, a.bias, a.scale, a.offset, a.out, a.M, a.K, a.N, a.act, a.alpha,
        a.fast, a.splits, a.ksplit, a.part, a.counters, x_al, w_al);
  } else {
    tiled_kernel<T, false><<<grid, kTiledThreads, 0, s>>>(
        x, w, a.bias, a.scale, a.offset, a.out, a.M, a.K, a.N, a.act, a.alpha,
        a.fast, a.splits, a.ksplit, a.part, a.counters, x_al, w_al);
  }
}

}  // namespace

// Launches the plan (path 0 = GEMV, 1 = tiled; `splits` K ranges of
// `ksplit`) on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees contiguous operands of the stated shapes, M, N > 0, a
// plan from kernel.py::plan, `part` of splits * M * N floats when
// splits > 1 and `counters` (zeros) with one int per output tile.
extern "C" int repro_fused_matmul(const void* x, const void* w,
                                  const float* bias, const float* scale,
                                  const float* offset, float* out, int M,
                                  int K, int N, int w_oi, int bf16, int act,
                                  float alpha, int fast, int path, int splits,
                                  int ksplit, float* part, int* counters,
                                  void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || act < repro::kNone ||
      act > repro::kSigmoid || (scale == nullptr) != (offset == nullptr) ||
      path < 0 || path > 1 || splits < 1 || splits > 65535 || ksplit < 1 ||
      (long long)splits * ksplit < K || (path == 0 && (M > 16 ||
      ksplit * gemv_rows(M) > kGemvXFloats)) || (path == 1 && ksplit % BK != 0) ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{bias, scale, offset, out, M, K, N, act, alpha, fast, splits,
               ksplit, part, counters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    launch<__nv_bfloat16>(x, w, w_oi != 0, path, a, s);
  } else {
    launch<float>(x, w, w_oi != 0, path, a, s);
  }
  return (int)cudaGetLastError();
}

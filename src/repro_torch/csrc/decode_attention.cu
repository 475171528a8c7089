// decode_attention: single-token grouped-query attention over a KV cache,
// length-masked, with an online softmax.
//
//   out[b, kvh*G + g] = sum_s p[g, s] V[b, s, kvh],
//   p = softmax_s(q[b, kvh*G + g] . K[b, s, kvh] * scale), s < lengths[b]
//
// Replaces the TPU kernel decode_attention_p (src/repro/kernels/
// decode_attention/kernel.py, body _decode_kernel).  There the grid ran
// (batch, kv head, S / 512) in order on one core and carried the softmax
// state (m, l, acc) across the S axis in VMEM scratch.  Here one block
// owns one (batch, kv head) and its G query heads, and walks S itself in
// 512-row tiles, in order, keeping m and l in shared memory and acc in
// registers; blocks share nothing.  Per tile, as in the TPU body:
//   1. scores = q . K_tile * scale, -inf at positions >= lengths[b];
//   2. m_new = max(m, max scores); p = exp(scores - m_new), 0 where masked;
//      alpha = exp(m - m_new); l = l * alpha + sum p;
//   3. acc = acc * alpha + p . V_tile.
// At the end out = acc / l.  Under `fast` every exp is the Schraudolph exp
// of fast_math.cuh, bit-exact with the eager torch form; since that exp
// does not compose exactly, the tile size and order are part of the
// semantics, and this kernel follows the tiled plain version
// (repro_torch/kernels/decode_attention/ref.py::decode_attention_tiled).
// A tile wholly past lengths[b] changes nothing but the factor
// alpha = exp(0), which is 1 when exact and is applied without loading the
// tile when fast, so no row past a length is ever read.  Rows past S are
// not padded: the loads stop at S.
//
//   q        (B, H, D) f32, H = Hkv * G
//   K, V     (B, S, Hkv, D) f32
//   lengths  (B,) int32
//   out      (B, H, D) f32
//
// Bound on the H100: device-memory bytes.  Each K and V row up to the
// length is read once (D floats) for 4 * G * D flops, about G operations
// per byte, far below the f32 units' ~20.  What sets the time here is how
// many bytes each block keeps in flight.  256 threads; where D % 4 == 0
// and K, V are 16-byte aligned, every load is a float4 (VEC = 4), else a
// float (VEC = 1).  In step 1 each warp takes four rows at a time, each
// lane loading its VEC-wide chunks of all four before it uses them, and
// reduces the G dot products with shuffles; in step 3 the threads split
// D into VEC-wide chunks (neighbouring threads on neighbouring chunks of
// a V row) and the rows into groups, and the groups' partial sums are
// added at the end.  One block per (batch, kv head) leaves most of the 132
// SMs idle at small batch (8 blocks at batch 1 for Hkv = 8); splitting S
// across blocks (flash-decoding) is later work.
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "fast_math.cuh"

namespace {

// Must agree with repro_torch/kernels/decode_attention/kernel.py.
constexpr int BS = 512;  // KV rows per tile (DEFAULT_BS of the TPU kernel)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kRows = 4;  // rows a warp scores at once

template <bool FAST>
__device__ __forceinline__ float exp_f32(float x) {
  return FAST ? repro::schraudolph_exp(x) : expf(x);
}

// VEC consecutive floats, 16-byte aligned when VEC = 4 (global or shared).
template <int VEC>
__device__ __forceinline__ void load(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x;
    out[1] = t.y;
    out[2] = t.z;
    out[3] = t.w;
  } else {
    out[0] = *p;
  }
}

// Floats of the per-head scratch: the tile's scores then p, and at the end
// the row groups' partial sums (at most kThreads * VEC per head).
__host__ __device__ constexpr int scratch_per_head(int vec) {
  return BS > kThreads * vec ? BS : kThreads * vec;
}

// Dynamic shared memory, in floats: q [G][D], the scratch [G][...], m, l
// and alpha [GM].
__host__ __device__ constexpr size_t smem_floats(int gm, int g, int d,
                                                 int vec) {
  return (size_t)g * d + (size_t)g * scratch_per_head(vec) + 3 * (size_t)gm;
}

template <int GM, bool FAST, int VEC>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int S, int Hkv, int G,
                            int D, float scale) {
  constexpr int kCh = kMaxD / (32 * VEC);  // VEC-wide chunks per lane, at most
  constexpr int kPs = scratch_per_head(VEC);
  extern __shared__ float smem[];
  float* qs = smem;
  float* ps = qs + G * D;
  float* ms = ps + G * kPs;
  float* ls = ms + GM;
  float* as = ls + GM;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = Hkv * G;
  const int nch = D / VEC;  // VEC-wide chunks per row
  const int len = min(max(lengths[b], 0), S);
  const size_t row = (size_t)Hkv * D;  // floats between consecutive s
  const float* kb = k + ((size_t)b * S * Hkv + kvh) * D;
  const float* vb = v + ((size_t)b * S * Hkv + kvh) * D;
  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;

  for (int i = tid; i < G * D; i += kThreads) qs[i] = qb[i];
  if (tid < GM) {
    ms[tid] = -CUDART_INF_F;
    ls[tid] = 0.0f;
  }
  // Step 3's split: thread -> (row group rg, chunk ch of a row).
  const int ngroups = kThreads / nch;
  const int rg = tid / nch, ch = tid % nch;
  float acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  __syncthreads();

  const int ntiles = (S + BS - 1) / BS;
  for (int t = 0; t < ntiles; ++t) {
    const int s0 = t * BS;
    if (s0 >= len) {
      // Wholly masked: m stays, p = 0, alpha = exp(0) (1 when exact).
      if (FAST) {
        const float e0 = exp_f32<FAST>(0.0f);
#pragma unroll
        for (int g = 0; g < GM; ++g)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = __fmul_rn(acc[g][e], e0);
        if (tid < G) ls[tid] = __fmul_rn(ls[tid], e0);
      }
      continue;
    }
    const int rows = min(BS, S - s0);
    const int valid = min(rows, len - s0);

    // 1. scores, kRows rows per warp at a time, all their loads first.
    for (int r0 = warp * kRows; r0 < rows; r0 += kWarps * kRows) {
      float kv[kRows][kCh][VEC];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float* kr = kb + (size_t)(s0 + r0 + j) * row;
        const bool live = r0 + j < valid;
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const int cc = lane + 32 * c;
          if (live && cc < nch) {
            load<VEC>(kr + cc * VEC, kv[j][c]);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) kv[j][c][e] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int r = r0 + j;
        if (r >= rows) break;
        float part[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          part[g] = 0.0f;
          if (g < G) {
#pragma unroll
            for (int c = 0; c < kCh; ++c) {
              const int cc = lane + 32 * c;
              if (cc < nch) {
                float qv[VEC];
                load<VEC>(qs + g * D + cc * VEC, qv);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  part[g] = fmaf(qv[e], kv[j][c][e], part[g]);
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G && lane == g)
            ps[g * kPs + r] =
                r < valid ? __fmul_rn(part[g], scale) : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // 2. the online softmax state, one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * kPs;
      float mx = -CUDART_INF_F;
      for (int r = lane; r < valid; r += 32) mx = fmaxf(mx, pg[r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p =
            r < valid ? exp_f32<FAST>(__fsub_rn(pg[r], m_new)) : 0.0f;
        pg[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = exp_f32<FAST>(__fsub_rn(m_prev, m_new));
        as[g] = alpha;
        ls[g] = __fadd_rn(__fmul_rn(ls[g], alpha), sum);
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + p . V over this thread's rows and chunk.
    if (rg < ngroups) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = __fmul_rn(acc[g][e], as[g]);
        }
#pragma unroll 4
      for (int r = rg; r < valid; r += ngroups) {
        float vv[VEC];
        load<VEC>(vb + (size_t)(s0 + r) * row + ch * VEC, vv);
#pragma unroll
        for (int g = 0; g < GM; ++g)
          if (g < G) {
            const float p = ps[g * kPs + r];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
          }
      }
    }
    __syncthreads();
  }

  // out = (sum of the row groups' acc) / l.
  if (rg < ngroups) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < G) {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          ps[g * kPs + rg * D + ch * VEC + e] = acc[g][e];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float sum = 0.0f;
    for (int j = 0; j < ngroups; ++j) sum += ps[g * kPs + j * D + dd];
    out[((size_t)b * H + (size_t)kvh * G + g) * D + dd] = __fdiv_rn(sum, ls[g]);
  }
}

template <int GM, bool FAST, int VEC>
int launch(const float* q, const float* k, const float* v,
           const int* lengths, float* out, int B, int S, int Hkv, int G,
           int D, float scale, cudaStream_t s) {
  const size_t bytes = smem_floats(GM, G, D, VEC) * sizeof(float);
  auto kernel = decode_attention_kernel<GM, FAST, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Hkv, B), kThreads, bytes, s>>>(q, k, v, lengths, out, S, Hkv,
                                               G, D, scale);
  return (int)cudaGetLastError();
}

template <bool FAST, int VEC>
int dispatch(const float* q, const float* k, const float* v,
             const int* lengths, float* out, int B, int S, int Hkv, int G,
             int D, float scale, cudaStream_t s) {
  if (G <= 1) return launch<1, FAST, VEC>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  if (G <= 2) return launch<2, FAST, VEC>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  if (G <= 4) return launch<4, FAST, VEC>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  if (G <= 8) return launch<8, FAST, VEC>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  return launch<16, FAST, VEC>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller guarantees contiguous operands of the stated shapes.
extern "C" int repro_decode_attention(const float* q, const float* k,
                                      const float* v, const int* lengths,
                                      float* out, int B, int S, int Hkv,
                                      int G, int D, float scale, int fast,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G < 1 || G > 16 || D < 1 ||
      D > kMaxD || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  if (vec4)
    return fast ? dispatch<true, 4>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s)
                : dispatch<false, 4>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
  return fast ? dispatch<true, 1>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s)
              : dispatch<false, 1>(q, k, v, lengths, out, B, S, Hkv, G, D, scale, s);
}

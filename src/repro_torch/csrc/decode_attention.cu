// decode_attention: single-token grouped-query attention over a KV cache,
// length-masked, with the online softmax of the TPU kernel.
//
//   out[b, kvh*G + g] = sum_s p[g, s] V[b, s, kvh],
//   p = softmax_s(q[b, kvh*G + g] . K[b, s, kvh] * scale), s < lengths[b]
//
// Replaces the TPU kernel decode_attention_p (src/repro/kernels/
// decode_attention/kernel.py, body _decode_kernel).  There the grid ran
// (batch, kv head, S / 512) in order on one core and carried the softmax
// state (m, l, acc) across the S axis in VMEM scratch: per 512-row tile t,
//   m_t = max(m_{t-1}, max scores_t);  p = exp(scores_t - m_t);
//   alpha_t = exp(m_{t-1} - m_t);  l = l * alpha_t + sum p;
//   acc = acc * alpha_t + p . V_t;  and at the end out = acc / l.
// Under `fast` every exp is the Schraudolph exp of fast_math.cuh, which
// does not compose (exp(a) exp(b) != exp(a + b)), so the tiles' running
// maxima m_t and the chain of alpha_t are part of the result: a split
// that gave each chunk of S its own maximum would be another function.
//
// Bound on the H100: device-memory bytes.  Each K and V row up to the
// length is read once (D floats) for 4 * G * D flops, about G operations
// per byte, far below the f32 units' ~20.  So the kernels must keep the
// whole card streaming, at batch 1 too.  One call launches three kernels
// over (S-chunk, kv head, batch) blocks; a chunk is `tpc` whole 512-row
// tiles (kernel.py::chunk_plan sizes it so batch 1 gives a few hundred
// blocks), and blocks whose chunk starts at or past lengths[b] exit at
// once (the lengths stay on the card: no host sync):
//   1. scores: read K once, write scores = q . K * scale for the G heads
//      to scratch (B, H, S) and each tile's maximum to (B, H, ntiles).
//      An 8-lane group takes a row (lanes on neighbouring 16-byte chunks),
//      a warp four rows at a time, so the G dot products are reduced with
//      three shuffles per row and head.
//   2. p . V: each block forms the running maxima m_t of its tiles from
//      the maxima of every tile before them (a shuffle prefix max), then
//      per tile, in order, exactly the tiled form's p and alpha_t, and
//      accumulates its chunk's (l_c, acc_c) and the product A_c of its
//      alphas.  Threads split D into 16-byte chunks and the rows into
//      groups, as the single-pass kernel did.
//   3. combine, per (batch, kv head), in chunk order:
//      acc = acc * A_c + acc_c, l = l * A_c + l_c; out = acc / l.
// Every p and alpha is the tiled form's bit for bit; only the order of
// the f32 sums differs.  A tile wholly past lengths[b] is dropped: the
// tiled form multiplies acc and l by its alpha = exp(0), which is 1 when
// exact and, under `fast`, a factor common to acc and l that cancels in
// acc / l up to rounding.  No row past a length is ever read, and no row
// past S (the loads stop at S).  No float atomics: the result is the same
// from run to run.  len <= 0 gives 0 / 0, as the single-pass kernel did.
//
//   q        (B, H, D) f32, H = Hkv * G
//   K, V     (B, S, Hkv, D) f32
//   lengths  (B,) int32
//   out      (B, H, D) f32
//   scratch  scores (B, H, S), tmax (B, H, ntiles), pacc (B, Hkv, nchunks,
//            G, D), pl and pA (B, Hkv, nchunks, G), all f32, from the
//            wrapper
//
// Where D % 4 == 0 and K, V are 16-byte aligned every K/V load is a
// float4 (VEC = 4), else a float (VEC = 1).
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
constexpr int kLanesPerRow = 8;                      // scores: lanes a row
constexpr int kRowsPerWarp = 32 / kLanesPerRow;      // 4

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

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int S) {
  return min(max(lengths[b], 0), S);
}

// ---------------------------------------------------------------------------
// 1. scores and tile maxima.
// ---------------------------------------------------------------------------
template <int GM, int VEC>
__global__ void __launch_bounds__(kThreads)
    scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const int* __restrict__ lengths, float* __restrict__ scores,
                  float* __restrict__ tmax, int S, int Hkv, int G, int D,
                  float scale, int tpc, int ntiles) {
  constexpr int kCh = kMaxD / (kLanesPerRow * VEC);  // chunks a lane, at most
  extern __shared__ float smem[];
  float* qs = smem;             // [G][D]
  float* wmax = qs + G * D;     // [kWarps][GM]
  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = clamp_len(lengths, b, S);
  const int c0 = c * tpc * BS;
  if (c0 >= len) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane / kLanesPerRow, sl = lane % kLanesPerRow;
  const int H = Hkv * G;
  const int nch = D / VEC;
  const size_t row = (size_t)Hkv * D;  // floats between consecutive s
  const float* kb = k + ((size_t)b * S * Hkv + kvh) * D;
  const float* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  float* sb = scores + ((size_t)b * H + (size_t)kvh * G) * S;
  for (int i = tid; i < G * D; i += kThreads) qs[i] = qb[i];
  __syncthreads();

  for (int tt = 0; tt < tpc; ++tt) {
    const int s0 = c0 + tt * BS;
    if (s0 >= len) break;
    const int valid = min(BS, len - s0);
    float mx[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) mx[g] = -CUDART_INF_F;
    for (int r0 = warp * kRowsPerWarp; r0 < valid; r0 += kWarps * kRowsPerWarp) {
      const int r = r0 + grp;
      const bool live = r < valid;
      const float* kr = kb + (size_t)(s0 + r) * row;
      float kv[kCh][VEC];
#pragma unroll
      for (int j = 0; j < kCh; ++j) {
        const int cc = sl + kLanesPerRow * j;
        if (live && cc < nch) {
          load<VEC>(kr + cc * VEC, kv[j]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kv[j][e] = 0.0f;
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        float part = 0.0f;
#pragma unroll
        for (int j = 0; j < kCh; ++j) {
          const int cc = sl + kLanesPerRow * j;
          if (cc < nch) {
            float qv[VEC];
            load<VEC>(qs + g * D + cc * VEC, qv);
#pragma unroll
            for (int e = 0; e < VEC; ++e) part = fmaf(qv[e], kv[j][e], part);
          }
        }
#pragma unroll
        for (int off = kLanesPerRow / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (live) {
          const float sc = __fmul_rn(part, scale);
          if (sl == (g % kLanesPerRow)) sb[(size_t)g * S + s0 + r] = sc;
          mx[g] = fmaxf(mx[g], sc);
        }
      }
    }
    // The tile's maximum per head: across the warp's rows, then the warps.
#pragma unroll
    for (int g = 0; g < GM; ++g) {
#pragma unroll
      for (int off = 16; off >= kLanesPerRow; off >>= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      if (lane == 0) wmax[warp * GM + g] = mx[g];
    }
    __syncthreads();
    if (tid < G) {
      float m = wmax[tid];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, wmax[w * GM + tid]);
      tmax[((size_t)b * H + (size_t)kvh * G + tid) * ntiles + s0 / BS] = m;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// 2. p . V per chunk.
// ---------------------------------------------------------------------------
// Floats of the per-head scratch: the tile's p, and at the end the row
// groups' partial sums (at most kThreads * VEC per head).
__host__ __device__ constexpr int scratch_per_head(int vec) {
  return BS > kThreads * vec ? BS : kThreads * vec;
}

// Dynamic shared memory of pv_kernel, in floats: p [G][...], then per
// head alpha, l, A, the previous maximum and the tpc running maxima.
__host__ __device__ constexpr size_t pv_smem_floats(int gm, int g, int tpc,
                                                    int vec) {
  return (size_t)g * scratch_per_head(vec) + (size_t)gm * (4 + tpc);
}

template <int GM, bool FAST, int VEC>
__global__ void __launch_bounds__(kThreads)
    pv_kernel(const float* __restrict__ v, const int* __restrict__ lengths,
              const float* __restrict__ scores,
              const float* __restrict__ tmax, float* __restrict__ pacc,
              float* __restrict__ pl, float* __restrict__ pA, int S, int Hkv,
              int G, int D, int tpc, int ntiles, int nchunks) {
  constexpr int kPs = scratch_per_head(VEC);
  extern __shared__ float smem[];
  float* ps = smem;              // [G][kPs]
  float* as = ps + G * kPs;      // [GM] this tile's alpha
  float* ls = as + GM;           // [GM] l of the chunk
  float* Ap = ls + GM;           // [GM] product of the chunk's alphas
  float* mprev = Ap + GM;        // [GM] m of the tile before the chunk
  float* mt = mprev + GM;        // [GM][tpc] m of the chunk's tiles

  const int c = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = clamp_len(lengths, b, S);
  const int t0 = c * tpc;
  if (c > 0 && t0 * BS >= len) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int H = Hkv * G;
  const int nch = D / VEC;
  const size_t row = (size_t)Hkv * D;
  const float* vb = v + ((size_t)b * S * Hkv + kvh) * D;
  const float* sb = scores + ((size_t)b * H + (size_t)kvh * G) * S;
  // The last tile of this chunk that holds a valid row.
  const int t_last = min(t0 + tpc, (len + BS - 1) / BS) - 1;

  // Running maxima: an inclusive prefix max over tiles 0..t_last.
  for (int g = warp; g < G; g += kWarps) {
    const float* tm = tmax + ((size_t)b * H + (size_t)kvh * G + g) * ntiles;
    float run = -CUDART_INF_F;
    if (t0 == 0 && lane == 0) mprev[g] = -CUDART_INF_F;
    for (int base = 0; base <= t_last; base += 32) {
      const int t = base + lane;
      float m = t <= t_last ? tm[t] : -CUDART_INF_F;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, m, off);
        if (lane >= off) m = fmaxf(m, o);
      }
      m = fmaxf(m, run);
      if (t == t0 - 1) mprev[g] = m;
      if (t >= t0 && t <= t_last) mt[g * tpc + (t - t0)] = m;
      run = __shfl_sync(0xffffffffu, m, 31);
    }
  }
  if (tid < G) {
    ls[tid] = 0.0f;
    Ap[tid] = 1.0f;
  }
  // Thread -> (row group rg, chunk ch of a row).
  const int ngroups = kThreads / nch;
  const int rg = tid / nch, ch = tid % nch;
  float acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
  __syncthreads();

  for (int t = t0; t <= t_last; ++t) {
    const int s0 = t * BS;
    const int valid = min(BS, len - s0);
    const float* mcur = mt + (t - t0);  // stride tpc per head
    // p = exp(score - m_t).
    for (int i = tid; i < G * valid; i += kThreads) {
      const int g = i / valid, r = i % valid;
      ps[g * kPs + r] = exp_f32<FAST>(
          __fsub_rn(sb[(size_t)g * S + s0 + r], mcur[g * tpc]));
    }
    __syncthreads();
    // l = l * alpha_t + sum p, A = A * alpha_t: one warp a head.
    for (int g = warp; g < G; g += kWarps) {
      const float* pg = ps + g * kPs;
      float sum = 0.0f;
      for (int r = lane; r < valid; r += 32) sum += pg[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float m_prev = t == t0 ? mprev[g] : mcur[g * tpc - 1];
        const float alpha = exp_f32<FAST>(__fsub_rn(m_prev, mcur[g * tpc]));
        as[g] = alpha;
        ls[g] = __fadd_rn(__fmul_rn(ls[g], alpha), sum);
        Ap[g] = __fmul_rn(Ap[g], alpha);
      }
    }
    __syncthreads();
    // acc = acc * alpha_t + p . V over this thread's rows and chunk.
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

  // The chunk's acc: the row groups' partial sums, in group order.
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
  const size_t base = (((size_t)b * Hkv + kvh) * nchunks + c) * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float sum = 0.0f;
    for (int j = 0; j < ngroups; ++j) sum += ps[g * kPs + j * D + dd];
    pacc[(base + g) * D + dd] = sum;
  }
  if (tid < G) {
    pl[base + tid] = ls[tid];
    pA[base + tid] = Ap[tid];
  }
}

// ---------------------------------------------------------------------------
// 3. combine the chunks, in order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* __restrict__ pacc,
                   const float* __restrict__ pl, const float* __restrict__ pA,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int S, int Hkv, int G, int D, int tpc, int nchunks) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int len = clamp_len(lengths, b, S);
  const int rows = tpc * BS;
  const int live = max(1, (len + rows - 1) / rows);
  const size_t base = ((size_t)b * Hkv + kvh) * nchunks;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, dd = i % D;
    float acc = 0.0f, l = 0.0f;
    for (int c = 0; c < live; ++c) {
      const size_t j = (base + c) * G + g;
      const float a = pA[j];
      acc = __fadd_rn(__fmul_rn(acc, a), pacc[j * D + dd]);
      l = __fadd_rn(__fmul_rn(l, a), pl[j]);
    }
    out[(((size_t)b * Hkv + kvh) * G + g) * D + dd] = __fdiv_rn(acc, l);
  }
}

struct Args {
  const float *q, *k, *v;
  const int* lengths;
  float* out;
  int B, S, Hkv, G, D;
  float scale;
  int tpc, ntiles, nchunks;
  float *scores, *tmax, *pacc, *pl, *pA;
};

template <int GM, bool FAST, int VEC>
int launch(const Args& a, cudaStream_t s) {
  const dim3 grid(a.nchunks, a.Hkv, a.B);
  const size_t s_bytes = ((size_t)a.G * a.D + kWarps * GM) * sizeof(float);
  auto sk = scores_kernel<GM, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      sk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s_bytes);
  if (err != cudaSuccess) return (int)err;
  sk<<<grid, kThreads, s_bytes, s>>>(a.q, a.k, a.lengths, a.scores, a.tmax,
                                     a.S, a.Hkv, a.G, a.D, a.scale, a.tpc,
                                     a.ntiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t p_bytes = pv_smem_floats(GM, a.G, a.tpc, VEC) * sizeof(float);
  auto pk = pv_kernel<GM, FAST, VEC>;
  err = cudaFuncSetAttribute(pk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p_bytes);
  if (err != cudaSuccess) return (int)err;
  pk<<<grid, kThreads, p_bytes, s>>>(a.v, a.lengths, a.scores, a.tmax, a.pacc,
                                     a.pl, a.pA, a.S, a.Hkv, a.G, a.D, a.tpc,
                                     a.ntiles, a.nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  combine_kernel<<<dim3(a.Hkv, a.B), kThreads, 0, s>>>(
      a.pacc, a.pl, a.pA, a.lengths, a.out, a.S, a.Hkv, a.G, a.D, a.tpc,
      a.nchunks);
  return (int)cudaGetLastError();
}

template <bool FAST, int VEC>
int dispatch(const Args& a, cudaStream_t s) {
  if (a.G <= 1) return launch<1, FAST, VEC>(a, s);
  if (a.G <= 2) return launch<2, FAST, VEC>(a, s);
  if (a.G <= 4) return launch<4, FAST, VEC>(a, s);
  if (a.G <= 8) return launch<8, FAST, VEC>(a, s);
  return launch<16, FAST, VEC>(a, s);
}

}  // namespace

// Launches the three kernels on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 = all launched).  The caller
// guarantees contiguous operands of the stated shapes and scratch of the
// sizes in the note above, with nchunks = ceil(ntiles / tpc).
extern "C" int repro_decode_attention(const float* q, const float* k,
                                      const float* v, const int* lengths,
                                      float* out, int B, int S, int Hkv,
                                      int G, int D, float scale, int fast,
                                      int tpc, float* scores, float* tmax,
                                      float* pacc, float* pl, float* pA,
                                      void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G < 1 || G > 16 || D < 1 ||
      D > kMaxD || B > 65535 || Hkv > 65535 || tpc < 1)
    return (int)cudaErrorInvalidValue;
  const int ntiles = (S + BS - 1) / BS;
  const Args a{q, k, v, lengths, out, B, S, Hkv, G, D, scale, tpc, ntiles,
               (ntiles + tpc - 1) / tpc, scores, tmax, pacc, pl, pA};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  if (vec4)
    return fast ? dispatch<true, 4>(a, s) : dispatch<false, 4>(a, s);
  return fast ? dispatch<true, 1>(a, s) : dispatch<false, 1>(a, s);
}

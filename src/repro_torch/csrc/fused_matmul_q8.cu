// fused_matmul_q8: the int8 dense site in one kernel.
//   out = affine(act(float(sum_k q(x)[m,k] * wq[k,n]) * deq[n] + bias[n]))
// with q(x) = clamp(rint(x / x_scale), -127, 127): x arrives in f32 and is
// quantized inside the kernel, so an int8 dense node costs one launch, as
// an f32 one does under fused_matmul.
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
// adds, multiplies and compares, however K is split.
//
// The quantize is the one expression of qmath.quantize_q8: a true
// division (__fdiv_rn; never a multiply by the reciprocal), rintf (round
// half to even, like torch.round), clamp to +-127.
//
//   x     (M, K) f32 row-major
//   wq    int8 "io": (K, N) row-major; "oi": (N, K) row-major, contracted
//         on K in place.  Quantized once, when the program is compiled.
//   deq   (N,) f32; bias, scale, offset: (N,) f32 or null
//   out   (M, N) f32; in the sums mode (int32 (M, N)) the exact sums
//         themselves, no dequantize and no epilogue: a row-parallel site
//         of a sharded compile all-reduces them, then dequantizes
//
// Bound on the H100: at the compiler's main-path shapes (M = batch of
// 1..256, K <= 256, N <= 128) neither bytes nor operations are: the
// largest product, 8.4 M MACs, takes ~4 ns at the int8 tensor-core peak.
// What a call costs is latency: the launch, and each round trip to
// device memory a block waits on, on few blocks.  The design pays that
// round trip once per block and spreads small products over many blocks:
//
// * Plan.  The host picks the path, tile, lanes and K split from
//   (M, K, N) in one pure function (repro_torch/kernels/fused_matmul/
//   kernel.py::plan_q8) and passes it here; the selector reports it.
//   Every block first issues all its loads (W, x, and the epilogue's
//   vectors into registers), then waits once.
// * GEMV path (M <= 16).  q(x) of the block's rows and K range is staged
//   in shared memory as int8, packed four to a word.  "oi": a column's
//   row of Wq is contiguous; a group of `lanes` lanes (a power of two,
//   just enough that each lane issues at most kGemvChunks 16-byte loads)
//   reads it 16 bytes a lane, issued before x is staged, __dp4a's it
//   against the staged q(x), and reduces the int32 partials by warp
//   shuffles; at K <= 256 a column takes 2..16 lanes, not a whole warp.
//   "io": lanes on 32 neighbouring columns, the 8 warps split K four deep.
// * Tiled path (M > 16).  s8 tensor cores: mma.sync m16n8k32
//   .row.col.s32.s8.s8.s32, four warps on a 16x32 output tile (16x64
//   and 32x16 are compiled for the plan's sweep), in two or four K
//   groups (256 or 512 threads) on alternate K steps, whose int32 sums
//   are added in shared memory.  Its A operand is q(x), row-major; its B
//   operand is "oi" Wq, already the K-major "col" operand, copied in as
//   it lies.  A block's whole K range (<= 256) is put in flight at once
//   in 16-byte cp.async copies, x in f32 and Wq as it lies; the block
//   waits once, quantizes all of its x from shared memory into the int8
//   A tile, and runs the K steps' mma back to back with no barrier
//   between them.  (Waiting and quantizing 32-deep stage by stage, with
//   two barriers a stage, cost ~0.5 us a stage on the H100: a thread's
//   divisions run one after another, and four warps could not hide
//   their latency.)  "io" Wq is transposed into K-major words as it is
//   staged.  Rows that are not 16-byte aligned (odd K or N) and ragged
//   edges are copied element by element with zero fill; K < 32 is
//   zero-filled to the instruction's depth.
// * Split K.  As fused_matmul: each split block parks its int32 partials
//   in scratch, one integer atomicAdd on the tile's counter finds the
//   last to finish, which sums them (exact in any order), dequantizes,
//   applies the epilogue and makes the single store, and resets the
//   counter.  The counters are fused_matmul's (one stream).
//
// Why not wgmma: a warpgroup's 64-row tiles leave 4 row tiles at
// M = 256, the block shortage this design removes, and at these shapes
// arithmetic is not what the time is spent on.
//
// One call is one kernel launch.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// Must agree with repro_torch/kernels/tiles.py.
constexpr int kGemvChunks = 2;          // Q8_GEMV_CHUNKS
constexpr int kGemvXBytes = 16384;      // Q8_GEMV_X_BYTES
constexpr int kGemvIoThreads = 256;     // Q8_GEMV_IO_THREADS
constexpr int kGemvMaxThreads = 256;    // Q8_GEMV_MAX_THREADS
constexpr int kGemvIoWarps = kGemvIoThreads / 32;
constexpr int BK = 32;                  // Q8_BK: mma depth, stage depth
constexpr int kMaxKsplit = 256;         // Q8_MAX_KSPLIT
constexpr int kMmaWarps = 4;            // warps on the tile in a K group
constexpr int kWRow = kMaxKsplit + 16;  // K-major int8 row, shared memory

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

__device__ __forceinline__ int quant_pack(float4 v, float s) {
  return pack4(quantize_q8(v.x, s), quantize_q8(v.y, s), quantize_q8(v.z, s),
               quantize_q8(v.w, s));
}

// Four consecutive values of x quantized into one word, the first `nv` of
// them read (one float4 when `al` and nv >= 4), zeros past them.
__device__ __forceinline__ int load_quant4(const float* p, int nv, bool al,
                                           float s) {
  if (al && nv >= 4) return quant_pack(*reinterpret_cast<const float4*>(p), s);
  int q[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) q[t] = t < nv ? quantize_q8(p[t], s) : 0;
  return pack4(q[0], q[1], q[2], q[3]);
}

// Sixteen consecutive bytes of Wq, the first `nv` of them read (one
// 16-byte load when `al` and nv >= 16), zeros past them.
__device__ __forceinline__ int4 load_w16(const signed char* p, int nv,
                                         bool al) {
  if (al && nv >= 16) return __ldg(reinterpret_cast<const int4*>(p));
  int b[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = e < nv ? p[e] : 0;
  return make_int4(pack4(b[0], b[1], b[2], b[3]), pack4(b[4], b[5], b[6], b[7]),
                   pack4(b[8], b[9], b[10], b[11]),
                   pack4(b[12], b[13], b[14], b[15]));
}

// The epilogue's per-column operands, loaded into registers when a block
// starts so that their round trip overlaps the operands'.
struct Col {
  float deq, bias, scale, offset;
};

__device__ __forceinline__ Col load_col(int n, int N, const float* deq,
                                        const float* bias, const float* scale,
                                        const float* offset) {
  Col c{0.0f, 0.0f, 1.0f, 0.0f};
  if (n < N) {
    if (deq != nullptr) c.deq = __ldg(deq + n);
    if (bias != nullptr) c.bias = __ldg(bias + n);
    if (scale != nullptr) {
      c.scale = __ldg(scale + n);
      c.offset = __ldg(offset + n);
    }
  }
  return c;
}

// The exact sum -> the stored value: one f32 multiply by deq, then the
// epilogue of fused_matmul (epilogue.cuh) on this column's operands.
__device__ __forceinline__ float finish(int acc, const Col& c, bool has_bias,
                                        bool has_affine, int act, float alpha,
                                        int fast) {
  const float y = __fmul_rn(__int2float_rn(acc), c.deq);
  return repro::epilogue(y, 0, has_bias ? &c.bias : nullptr,
                         has_affine ? &c.scale : nullptr,
                         has_affine ? &c.offset : nullptr, act, alpha, fast);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
// Commits this thread's cp.async copies and waits for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// D += A . B on the s8 tensor cores, one m16n8k32 tile.  A: four words
// (rows g and g+8, depths 4t..4t+3 and 16+4t..16+4t+3); B: two words
// (column g, the same depths); D: rows g and g+8, columns 2t and 2t+1,
// where g = lane / 4 and t = lane % 4.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// After a block's partial sums are parked in scratch: whether it is the
// last of its tile's splits to arrive (it then reduces them).
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

__device__ __forceinline__ int sum_splits(const int* part, size_t e,
                                          size_t stride, int splits) {
  int s = __ldcg(part + e);
  for (int i = 1; i < splits; ++i) s += __ldcg(part + e + i * stride);
  return s;
}

struct Args {
  const float* x;
  const signed char* w;
  const float *deq, *bias, *scale, *offset;
  float* out;
  int M, K, N;
  float x_scale;
  int act;
  float alpha;
  int fast, splits, ksplit, lanes;
  int* part;
  int* counters;
  int x_al, w_al;
  // The sums mode: out holds the int32 sums themselves, no dequantize and
  // no epilogue (a row-parallel site all-reduces them before both).
  int sums;
};

// The stored value of one output: the exact sum (sums mode) or finish().
__device__ __forceinline__ void store(const Args& a, size_t e, int acc,
                                      const Col& c, bool has_bias,
                                      bool has_affine) {
  if (a.sums)
    reinterpret_cast<int*>(a.out)[e] = acc;
  else
    a.out[e] = finish(acc, c, has_bias, has_affine, a.act, a.alpha, a.fast);
}

// ---------------------------------------------------------------------------
// GEMV path: M <= MM <= 16.
// ---------------------------------------------------------------------------

// q(x) rows [0, M) x K range [k0, k0 + kd) into xs, `words` int8x4 words a
// row, zeros past kd.
__device__ __forceinline__ void stage_x(int* xs, const Args& a, int k0,
                                        int kd, int words) {
  const bool al = a.x_al != 0;
  for (int i = threadIdx.x; i < a.M * words; i += blockDim.x) {
    const int m = i / words, c = i % words;
    xs[i] = load_quant4(a.x + (size_t)m * a.K + k0 + 4 * c, kd - 4 * c, al,
                        a.x_scale);
  }
}

template <int MM>
__device__ __forceinline__ void dot16(int (&acc)[MM], int4 w, const int* xs,
                                      int words, int c, int M) {
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (m < M) {
      const int4 xv = *reinterpret_cast<const int4*>(xs + m * words + 4 * c);
      acc[m] = __dp4a(xv.x, w.x, acc[m]);
      acc[m] = __dp4a(xv.y, w.y, acc[m]);
      acc[m] = __dp4a(xv.z, w.z, acc[m]);
      acc[m] = __dp4a(xv.w, w.w, acc[m]);
    }
  }
}

// The GEMV blocks' common end: split reduction and the epilogue by the
// column's owner thread.
template <int MM>
__device__ __forceinline__ void gemv_finish(int (&acc)[MM], const Args& a,
                                            int n, bool owner, const Col& col,
                                            int* flag) {
  if (a.splits > 1) {
    const size_t stride = (size_t)a.M * a.N;
    if (owner) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
        if (m < a.M)
          __stcg(a.part + blockIdx.y * stride + (size_t)m * a.N + n, acc[m]);
    }
    if (!arrive_last(a.counters + blockIdx.x, a.splits, flag)) return;
    if (owner) {
#pragma unroll
      for (int m = 0; m < MM; ++m)
        if (m < a.M)
          acc[m] = sum_splits(a.part, (size_t)m * a.N + n, stride, a.splits);
    }
    if (threadIdx.x == 0) a.counters[blockIdx.x] = 0;
  }
  if (owner) {
    const bool hb = a.bias != nullptr, ha = a.scale != nullptr;
#pragma unroll
    for (int m = 0; m < MM; ++m)
      if (m < a.M) store(a, (size_t)m * a.N + n, acc[m], col, hb, ha);
  }
}

template <int MM>
__global__ void __launch_bounds__(kGemvMaxThreads)
    q8_gemv_oi_kernel(const Args a) {
  __shared__ __align__(16) int xs[kGemvXBytes / 4];
  __shared__ int flag;
  const int lanes = a.lanes;
  const int lig = threadIdx.x & (lanes - 1);
  const int n = blockIdx.x * (blockDim.x / lanes) + threadIdx.x / lanes;
  const int k0 = blockIdx.y * a.ksplit;
  const int kd = max(0, min(a.ksplit, a.K - k0));
  const int words = (a.ksplit + 15) / 16 * 4;
  const int nch = (kd + 15) / 16;
  const bool al = a.w_al != 0;
  const signed char* wr = a.w + (size_t)n * a.K + k0;

  // This lane's first chunks of its column's row and the column's
  // epilogue operands are in flight while q(x) is staged.
  int4 wv[kGemvChunks];
#pragma unroll
  for (int i = 0; i < kGemvChunks; ++i) {
    const int c = lig + i * lanes;
    wv[i] = (n < a.N && c < nch) ? load_w16(wr + 16 * c, kd - 16 * c, al)
                                 : make_int4(0, 0, 0, 0);
  }
  const Col col = load_col(n, a.N, a.deq, a.bias, a.scale, a.offset);
  stage_x(xs, a, k0, kd, words);
  __syncthreads();

  int acc[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0;
  if (n < a.N) {
#pragma unroll
    for (int i = 0; i < kGemvChunks; ++i) {
      const int c = lig + i * lanes;
      if (c < nch) dot16<MM>(acc, wv[i], xs, words, c, a.M);
    }
    for (int c = lig + kGemvChunks * lanes; c < nch; c += lanes)
      dot16<MM>(acc, load_w16(wr + 16 * c, kd - 16 * c, al), xs, words, c,
                a.M);
  }
#pragma unroll
  for (int m = 0; m < MM; ++m)
    for (int off = lanes / 2; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  gemv_finish<MM>(acc, a, n, lig == 0 && n < a.N, col, &flag);
}

template <int MM>
__global__ void __launch_bounds__(kGemvIoThreads)
    q8_gemv_io_kernel(const Args a) {
  __shared__ __align__(16) int xs[kGemvXBytes / 4];
  __shared__ int red[kGemvIoWarps * MM * 32];
  __shared__ int flag;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n = blockIdx.x * 32 + lane;
  const int k0 = blockIdx.y * a.ksplit;
  const int kd = max(0, min(a.ksplit, a.K - k0));
  const int words = (a.ksplit + 15) / 16 * 4;

  const Col col = load_col(n, a.N, a.deq, a.bias, a.scale, a.offset);
  stage_x(xs, a, k0, kd, words);
  __syncthreads();

  int acc[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) acc[m] = 0;
  if (n < a.N) {
    const signed char* wc = a.w + (size_t)k0 * a.N + n;
#pragma unroll 4
    for (int c = warp; 4 * c < kd; c += kGemvIoWarps) {
      int b[4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        b[t] = 4 * c + t < kd ? wc[(size_t)(4 * c + t) * a.N] : 0;
      const int wv = pack4(b[0], b[1], b[2], b[3]);
#pragma unroll
      for (int m = 0; m < MM; ++m)
        if (m < a.M) acc[m] = __dp4a(xs[m * words + c], wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < MM; ++m) red[(warp * MM + m) * 32 + lane] = acc[m];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      int s = 0;
      for (int j = 0; j < kGemvIoWarps; ++j) s += red[(j * MM + m) * 32 + lane];
      acc[m] = s;
    }
  }
  gemv_finish<MM>(acc, a, n, warp == 0 && n < a.N, col, &flag);
}

// ---------------------------------------------------------------------------
// Tiled path: s8 mma.sync, four warps as WM x (4 / WM) over a BM x BN tile,
// KG times over: the block's 4 * KG warps are KG K groups, which take
// alternate K steps and add their sums in shared memory.
// ---------------------------------------------------------------------------
template <int BM, int BN, int WM, int KG, bool OI>
__global__ void __launch_bounds__(32 * kMmaWarps * KG)
    q8_tiled_kernel(const Args a) {
  constexpr int kTiledThreads = 32 * kMmaWarps * KG;
  constexpr int WN = kMmaWarps / WM;
  constexpr int WTM = BM / WM, WTN = BN / WN;  // one warp's output tile
  constexpr int MI = WTM / 16, NJ = WTN / 8;   // its m16n8 tiles
  static_assert(MI >= 1 && NJ >= 1 && WTM % 16 == 0 && WTN % 8 == 0,
                "warp tile");
  // xs: x of the block's rows over its K range, f32, row-major;
  // ws: Wq K-major, row r = column n0 + r over the K range;
  // aq: q(x), int8, K-major rows.  Rows of ws and aq are padded by 16
  // bytes, which keeps the fragment reads off each other's banks.
  __shared__ __align__(16) float xs[BM * kMaxKsplit];
  __shared__ __align__(16) signed char ws[BN * kWRow];
  __shared__ __align__(16) signed char aq[BM * kWRow];
  __shared__ int red[BM * BN];
  __shared__ int flag;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int kg = warp / kMmaWarps, mw = warp % kMmaWarps;
  const int wm = mw / WN, wn = mw % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.z * a.ksplit;
  const int ke = min(a.K, kb0 + a.ksplit);
  const int nst = ke > kb0 ? (ke - kb0 + BK - 1) / BK : 0;
  const int xc = nst * (BK / 4), wc = nst * (BK / 16);  // 16-byte chunks a row
  const bool x_al = a.x_al != 0, w_al = a.w_al != 0;

  // The whole K range in flight at once: 16-byte cp.async copies, a warp
  // on 512 contiguous bytes of x or 32 of each of 16 Wq rows.
  for (int c = tid; c < BM * xc; c += kTiledThreads) {
    const int r = c / xc, kk = (c % xc) * 4;
    const int gm = m0 + r, gk = kb0 + kk;
    const int nv = gm < a.M ? ke - gk : 0;
    float* dst = xs + r * kMaxKsplit + kk;
    const float* src = a.x + (size_t)gm * a.K + gk;
    if (x_al && nv >= 4) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = e < nv ? src[e] : 0.0f;
    }
  }
  if (OI) {
    for (int c = tid; c < BN * wc; c += kTiledThreads) {
      const int r = c / wc, kk = (c % wc) * 16;
      const int gn = n0 + r, gk = kb0 + kk;
      const int nv = gn < a.N ? ke - gk : 0;
      signed char* dst = ws + r * kWRow + kk;
      const signed char* src = a.w + (size_t)gn * a.K + gk;
      if (w_al && nv >= 16) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = e < nv ? src[e] : 0;
      }
    }
  } else {  // W (K, N): four rows' bytes of a column packed into a word
    for (int e = tid; e < BN * xc; e += kTiledThreads) {
      const int r = e % BN, c = e / BN;
      const int gn = n0 + r, gk = kb0 + 4 * c;
      int b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = (gn < a.N && gk + q < ke) ? a.w[(size_t)(gk + q) * a.N + gn]
                                         : 0;
      *reinterpret_cast<int*>(ws + r * kWRow + 4 * c) =
          pack4(b[0], b[1], b[2], b[3]);
    }
  }
  Col col[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      col[j][q] = load_col(n0 + wn * WTN + j * 8 + 2 * t + q, a.N, a.deq,
                           a.bias, a.scale, a.offset);

  for (int e = tid; e < BM * BN; e += kTiledThreads) red[e] = 0;

  // One wait, then q(x) of the whole K range into the A tile, a warp on
  // 512 contiguous bytes of a row.  A division (__fdiv_rn) has a branch
  // to its slow path, so a thread's divisions run one after another; the
  // block's 8 or 16 warps keep enough of them in flight.
  cp_async_wait_all();
  __syncthreads();
#pragma unroll 4
  for (int c = tid; c < BM * xc; c += kTiledThreads) {
    const int r = c / xc, kk = (c % xc) * 4;
    const float4 v = *reinterpret_cast<const float4*>(xs + r * kMaxKsplit + kk);
    *reinterpret_cast<int*>(aq + r * kWRow + kk) = quant_pack(v, a.x_scale);
  }
  __syncthreads();

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  for (int s = kg; s < nst; s += KG) {
    int af[MI][4], bf[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const signed char* ar =
          aq + (wm * WTM + i * 16 + g) * kWRow + s * BK + 4 * t;
      af[i][0] = *reinterpret_cast<const int*>(ar);
      af[i][1] = *reinterpret_cast<const int*>(ar + 8 * kWRow);
      af[i][2] = *reinterpret_cast<const int*>(ar + 16);
      af[i][3] = *reinterpret_cast<const int*>(ar + 8 * kWRow + 16);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const signed char* br =
          ws + (wn * WTN + j * 8 + g) * kWRow + s * BK + 4 * t;
      bf[j][0] = *reinterpret_cast<const int*>(br);
      bf[j][1] = *reinterpret_cast<const int*>(br + 16);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }

  // Groups 1.. add their sums into `red` (exact int32, in any order);
  // group 0 adds them to its own and owns the tile from here.
  // Element (i, j, q): row wm*WTM + 16i + g + 8*(q / 2), column
  // wn*WTN + 8j + 2t + q % 2 of the tile.
  auto red_at = [&](int i, int j, int q) -> int& {
    return red[(wm * WTM + i * 16 + g + 8 * (q / 2)) * BN + wn * WTN + j * 8 +
               2 * t + q % 2];
  };
  if (KG > 1 && kg > 0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) atomicAdd(&red_at(i, j, q), acc[i][j][q]);
  }
  __syncthreads();
  const bool owner = kg == 0;
  if (KG > 1 && owner) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += red_at(i, j, q);
  }

  // Element (i, j, q): row m0 + wm*WTM + 16i + g + 8*(q / 2), column
  // n0 + wn*WTN + 8j + 2t + q % 2.
  if (a.splits > 1) {
    const size_t stride = (size_t)a.M * a.N;
    int* part = a.part + blockIdx.z * stride;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gm = m0 + wm * WTM + i * 16 + g + 8 * (q / 2);
          const int gn = n0 + wn * WTN + j * 8 + 2 * t + q % 2;
          if (owner && gm < a.M && gn < a.N)
            __stcg(part + (size_t)gm * a.N + gn, acc[i][j][q]);
        }
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (!arrive_last(a.counters + tile, a.splits, &flag)) return;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int gm = m0 + wm * WTM + i * 16 + g + 8 * (q / 2);
          const int gn = n0 + wn * WTN + j * 8 + 2 * t + q % 2;
          if (owner && gm < a.M && gn < a.N)
            acc[i][j][q] =
                sum_splits(a.part, (size_t)gm * a.N + gn, stride, a.splits);
        }
    if (tid == 0) a.counters[tile] = 0;
  }

  const bool hb = a.bias != nullptr, ha = a.scale != nullptr;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int gm = m0 + wm * WTM + i * 16 + g + 8 * (q / 2);
        const int gn = n0 + wn * WTN + j * 8 + 2 * t + q % 2;
        if (owner && gm < a.M && gn < a.N)
          store(a, (size_t)gm * a.N + gn, acc[i][j][q], col[j][q % 2], hb,
                ha);
      }
}

// The GEMV template's row count for M (a power of two up to 16).
int gemv_rows(int M) {
  int mm = 1;
  while (mm < M) mm *= 2;
  return mm;
}

template <int MM>
void launch_gemv(const Args& a, bool oi, int threads, cudaStream_t s) {
  const int cols = oi ? threads / a.lanes : 32;
  const dim3 grid((a.N + cols - 1) / cols, a.splits);
  if (oi) {
    q8_gemv_oi_kernel<MM><<<grid, threads, 0, s>>>(a);
  } else {
    q8_gemv_io_kernel<MM><<<grid, kGemvIoThreads, 0, s>>>(a);
  }
}

template <int BM, int BN, int WM, int KG>
void launch_tiled(const Args& a, bool oi, cudaStream_t s) {
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, a.splits);
  constexpr int threads = 32 * kMmaWarps * KG;
  if (oi) {
    q8_tiled_kernel<BM, BN, WM, KG, true><<<grid, threads, 0, s>>>(a);
  } else {
    q8_tiled_kernel<BM, BN, WM, KG, false><<<grid, threads, 0, s>>>(a);
  }
}

template <int KG>
void launch_tiled_kg(const Args& a, bool oi, int bm, int bn, cudaStream_t s) {
  if (bm == 32) {
    launch_tiled<32, 16, 2, KG>(a, oi, s);
  } else if (bn == 32) {
    launch_tiled<16, 32, 1, KG>(a, oi, s);
  } else {
    launch_tiled<16, 64, 1, KG>(a, oi, s);
  }
}

}  // namespace

// Launches the plan of kernel.py::plan_q8 on `stream` (path 0 = GEMV,
// 1 = tiled with a bm x bn tile; its `threads`, and the GEMV path's
// `threads` and `lanes`;
// `splits` K ranges of `ksplit`); returns cudaGetLastError() (0 =
// launched).  The caller guarantees contiguous operands of the stated
// shapes, M, N > 0, x_scale > 0, `part` of splits * M * N ints when
// splits > 1 and `counters` (zeros) with one int per output tile.  With
// `sums` set, `out` is an int32 (M, N) tensor that takes the exact sums:
// `deq`, `bias`, `scale` and `offset` are null and `act` is none.
extern "C" int repro_fused_matmul_q8(
    const float* x, const void* wq, const float* deq, const float* bias,
    const float* scale, const float* offset, void* out, int M, int K, int N,
    int w_oi, float x_scale, int act, float alpha, int fast, int path, int bm,
    int bn, int threads, int lanes, int splits, int ksplit, int* part,
    int* counters, int sums, void* stream) {
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
  const bool bad_gemv =
      path == 0 &&
      (M > 16 || gemv_rows(M) * ((ksplit + 15) / 16 * 16) > kGemvXBytes ||
       (w_oi && (!lanes_ok || threads < 32 || threads > kGemvMaxThreads ||
                 threads % 32 != 0 || threads % lanes != 0)) ||
       (!w_oi && threads != kGemvIoThreads));
  const bool bad_tiled =
      path == 1 &&
      (ksplit % BK != 0 || ksplit > kMaxKsplit ||
       !((bm == 16 && bn == 32) || (bm == 16 && bn == 64) ||
         (bm == 32 && bn == 16)) ||
       (threads != 256 && threads != 512) || (M + bm - 1) / bm > 65535);
  const bool bad_sums =
      sums ? (deq != nullptr || bias != nullptr || scale != nullptr ||
              act != repro::kNone)
           : deq == nullptr;
  if (M <= 0 || N <= 0 || K < 0 || bad_sums || !(x_scale > 0.0f) ||
      act < repro::kNone || act > repro::kSigmoid ||
      (scale == nullptr) != (offset == nullptr) || path < 0 || path > 1 ||
      bad_gemv || bad_tiled || splits < 1 || splits > 65535 || ksplit < 1 ||
      (long long)splits * ksplit < K ||
      (splits > 1 && (part == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need every row start 16-byte aligned.
  const bool x_al = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_al = w_oi && K % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const Args a{x, static_cast<const signed char*>(wq), deq, bias, scale,
               offset, static_cast<float*>(out), M, K, N, x_scale, act,
               alpha, fast, splits, ksplit, lanes, part, counters, x_al,
               w_al, sums != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool oi = w_oi != 0;
  if (path == 0) {
    if (M <= 1) launch_gemv<1>(a, oi, threads, s);
    else if (M <= 2) launch_gemv<2>(a, oi, threads, s);
    else if (M <= 4) launch_gemv<4>(a, oi, threads, s);
    else if (M <= 8) launch_gemv<8>(a, oi, threads, s);
    else launch_gemv<16>(a, oi, threads, s);
  } else if (threads == 256) {
    launch_tiled_kg<2>(a, oi, bm, bn, s);
  } else {
    launch_tiled_kg<4>(a, oi, bm, bn, s);
  }
  return (int)cudaGetLastError();
}

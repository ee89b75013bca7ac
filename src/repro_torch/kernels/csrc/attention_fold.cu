// Fold-streamed attention for Hopper (sm_90a): online-softmax attention
// with grouped KV heads and causal / sliding-window masks,
//   out[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h / G] * hd^-1/2 | mask)
//                  @ v[b, s, h / G],                  G = H / KV.
//
// Replaces the Pallas TPU kernel repro/kernels/attention_fold.py:_kernel
// (launched from flash_attention_folded).  There the grid walks
// (B, H, Tq/qb, Tkv/kb) with the kv blocks innermost and in order, the q
// block resident and the running (max, denominator, accumulator) in VMEM
// scratch.  Here a CTA owns one (batch, head, q tile) and walks the kv
// tiles of KT rows itself, in order, through a two-stage cp.async ring in
// shared memory, so that the next tile loads while this one computes.  The
// kv head is h / (H / KV): no copy of K or V is made.  The q tiles are
// launched last tile first: under a causal mask the last tiles see the
// most keys, and starting them first keeps them from setting the finish
// time.
//
// Operands (contiguous, one type, fp32 or bf16): q (B, T, H, hd),
// k and v (B, S, KV, hd), out (B, T, H, hd); hd in {16, 32, 64, 128}.
// Masked scores are -1e30 (not -inf, whose exp(-inf - -inf) would be NaN
// before the first visible key), the output is acc / max(d, 1e-30) in the
// operands' type, rounded once.  A kv tile that the causal or window mask
// hides from every row of the q tile is skipped; that changes no bit of
// the result, since a row's first visible key sets its correction factor
// to 0 and the hidden keys' p = exp(-1e30 - m) is 0 after it.
//
// Bound: operations.  Each (query, key) pair costs 2*hd multiply-adds on
// operands read once per CTA, so at zamba2's shape (T = S = 2048, hd = 64)
// the arithmetic binds long before device memory does.  The two instances
// put it on different units:
//
// bf16 -- the tensor cores.  A CTA of 4 warps owns 64 query rows, 16 per
// warp.  K and V tiles stay bf16 in shared memory, rows padded by 16 bytes
// so that every ldmatrix is free of bank conflicts.  S = Q.K^T runs on
// mma.sync m16n8k16 (bf16 in, fp32 sums; the ldmatrix / mma helpers are
// mma.cuh's, shared with the fold-conv kernels) with the warp's Q
// fragments held in registers for the whole kv walk; hd^-1/2 (times
// log2 e, for exp2) is applied to the fp32 scores, never to q in bf16.
// The online softmax runs
// on the S accumulator's registers: the row max and sum across the 4 lanes
// of a quad by shuffles, the correction and the denominator in fp32.  The
// same registers are P.V's A operand (the accumulator and A fragment
// layouts of m16n8k16 line up), V's B fragments come from ldmatrix.trans.
// P is split into hi = bf16(p) and lo = bf16(p - hi) and both go through
// the tensor cores into the fp32 output: P rounded to bf16 alone would
// miss the plain version by more than one bf16 step of the output; the
// split carries p to about 2^-16 of itself for 50% more tensor work.
//
// fp32 -- the CUDA cores.  TF32 is not fp32, so this instance stays on
// FFMA, on register tiles: a CTA of 256 threads owns 64 query rows; each
// thread computes 4 queries x 4 keys of scores from 16-byte shared-memory
// loads of q (pre-scaled by hd^-1/2 in fp32) and K, 64 multiply-adds per
// 8 loads, then 4 queries x hd/16 columns of P.V from 16-byte loads of P
// and V.  The 16 threads that share 4 rows take the row max and sum by
// shuffles; P waits in shared memory between the two products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace {

constexpr int KT = 64;  // kv rows per staged tile
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// rows x HD elements of type T from global rows `row_stride` apart into
// shared rows LD elements apart; rows at or past `valid` read as zeros
// (`base` is any address the kernel may read, passed where a row is not)
template <typename T, int HD, int LD, int ROWS, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long row_stride, int valid,
                                           const T* base, int tid) {
  constexpr int PER_ROW = HD * static_cast<int>(sizeof(T)) / 16;
  constexpr int ELEMS = 16 / static_cast<int>(sizeof(T));
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i - r * PER_ROW) * ELEMS;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + c, ok ? src + r * row_stride + c : base, ok);
  }
}

// whether some key of [k0, k0 + KT) is hidden from some row of [q0, q_last]
__device__ __forceinline__ bool tile_needs_mask(int k0, int q0, int q_last,
                                                int s_len, int causal,
                                                int window) {
  return (causal && k0 + KT - 1 > q0) ||
         (window > 0 && k0 <= q_last - window) || k0 + KT > s_len;
}

__device__ __forceinline__ bool visible(int kpos, int row, int s_len,
                                        int causal, int window) {
  return kpos < s_len && (!causal || kpos <= row) &&
         (window <= 0 || kpos > row - window);
}

// the first kv tile and the number of kv tiles the rows [q0, q_last] see
__device__ __forceinline__ int2 kv_tiles(int q0, int q_last, int s_len,
                                         int causal, int window) {
  int k_hi = s_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int first = k_lo / KT;
  return make_int2(first, max(0, (k_hi + KT - 1) / KT - first));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_QT = 16 * TC_WARPS;  // query rows per CTA

template <int HD>
struct TcShape {
  static constexpr int LD = HD + 8;  // shared row, bf16: 16 bytes of pad
  static constexpr int TILE = KT * LD;
  static constexpr size_t SMEM = sizeof(bf16) * (TC_QT * LD + 4 * TILE);
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> the bf16 pairs hi = bf16(x, y) and lo = bf16(x - hi, y - hi)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - __low2float(h),
                                         y - __high2float(h)));
}

// grid (H, B, q tiles), the q tiles last first.  Warp w owns the query rows
// q0 + 16w .. + 15; lane l holds rows g = l / 4 and g + 8 of them, and the
// columns 2 (l % 4), + 1 of every 8-wide block of S and of the output.
template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    int t_len, int s_len, int heads, int kv_heads, int causal,
                    int window, float scale) {
  using S = TcShape<HD>;
  constexpr int LD = S::LD;
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // (TC_QT, LD)
  bf16* ks = qs + TC_QT * LD;                 // 2 stages of (KT, LD)
  bf16* vs = ks + 2 * S::TILE;                // 2 stages of (KT, LD)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_QT;
  const int q_last = min(q0 + TC_QT, t_len) - 1;
  const int kh = h / (heads / kv_heads);
  const long long q_stride = static_cast<long long>(heads) * HD;
  const long long kv_stride = static_cast<long long>(kv_heads) * HD;
  const bf16* qb = q + static_cast<long long>(b) * t_len * q_stride + h * HD;
  const bf16* kb = k + static_cast<long long>(b) * s_len * kv_stride + kh * HD;
  const bf16* vb = v + static_cast<long long>(b) * s_len * kv_stride + kh * HD;

  const int2 tiles = kv_tiles(q0, q_last, s_len, causal, window);
  stage_rows<bf16, HD, LD, TC_QT, TC_THREADS>(qs, qb + q0 * q_stride,
                                              q_stride, t_len - q0, qb, tid);
  if (tiles.y > 0) {
    const int k0 = tiles.x * KT;
    stage_rows<bf16, HD, LD, KT, TC_THREADS>(ks, kb + k0 * kv_stride,
                                             kv_stride, s_len - k0, kb, tid);
    stage_rows<bf16, HD, LD, KT, TC_THREADS>(vs, vb + k0 * kv_stride,
                                             kv_stride, s_len - k0, vb, tid);
  }
  cp_async_commit();

  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
  const int row0 = q0 + 16 * warp + g;  // and row0 + 8
  const float sl2 = scale * LOG2E;
  uint32_t qf[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  }
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < tiles.y; ++it) {
    const int k0 = (tiles.x + it) * KT;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < tiles.y) {
      const int k1 = k0 + KT;
      const int st = (it + 1) & 1;
      stage_rows<bf16, HD, LD, KT, TC_THREADS>(
          ks + st * S::TILE, kb + k1 * kv_stride, kv_stride, s_len - k1, kb,
          tid);
      stage_rows<bf16, HD, LD, KT, TC_THREADS>(
          vs + st * S::TILE, vb + k1 * kv_stride, kv_stride, s_len - k1, vb,
          tid);
      cp_async_commit();
    }
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        ldsm_x4(qf[kk], qs + (16 * warp + (lane & 15)) * LD + 16 * kk +
                            (lane >> 4) * 8);
      }
    }
    const bf16* kt = ks + (it & 1) * S::TILE;
    const bf16* vt = vs + (it & 1) * S::TILE;

    // S = Q . K^T: 8 blocks of 8 keys, the keys' rows as the col operand
    float s[KT / 8][4];
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int j2 = 0; j2 < KT / 16; ++j2) {
        uint32_t kf[4];
        ldsm_x4(kf, kt + (16 * j2 + (lane >> 4) * 8 + (lane & 7)) * LD +
                        16 * kk + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * j2], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * j2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale, mask, and the running max of rows row0 and row0 + 8
    const bool edge = tile_needs_mask(k0, q0, q_last, s_len, causal, window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl2;
        if (edge && !visible(k0 + 8 * j + c2 + (e & 1),
                             row0 + (e >> 1) * 8, s_len, causal, window)) {
          x = NEG;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float cr0 = exp2f(m0 - mx0);
    const float cr1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= cr0;
    l1 *= cr1;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      o[d][0] *= cr0;
      o[d][1] *= cr0;
      o[d][2] *= cr1;
      o[d][3] *= cr1;
    }
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mx0);
      s[j][1] = exp2f(s[j][1] - mx0);
      s[j][2] = exp2f(s[j][2] - mx1);
      s[j][3] = exp2f(s[j][3] - mx1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P . V, 16 keys a step; P's A fragments are S's registers
#pragma unroll
    for (int ks16 = 0; ks16 < KT / 16; ++ks16) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * ks16][0], s[2 * ks16][1], ph[0], pl[0]);
      split_bf16(s[2 * ks16][2], s[2 * ks16][3], ph[1], pl[1]);
      split_bf16(s[2 * ks16 + 1][0], s[2 * ks16 + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * ks16 + 1][2], s[2 * ks16 + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int d2 = 0; d2 < HD / 16; ++d2) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, vt + (16 * ks16 + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LD +
                              16 * d2 + (lane >> 4) * 8);
        mma_bf16(o[2 * d2], ph, vf[0], vf[1]);
        mma_bf16(o[2 * d2], pl, vf[0], vf[1]);
        mma_bf16(o[2 * d2 + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * d2 + 1], pl, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait_all();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f);
  const float den1 = fmaxf(l1, 1e-30f);
  bf16* ob = out + static_cast<long long>(b) * t_len * q_stride + h * HD + c2;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    if (row0 < t_len) {
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * q_stride + 8 * d) =
          __floats2bfloat162_rn(o[d][0] / den0, o[d][1] / den0);
    }
    if (row0 + 8 < t_len) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * q_stride + 8 * d) =
          __floats2bfloat162_rn(o[d][2] / den1, o[d][3] / den1);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: register tiles on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int RT_THREADS = 256;  // 16 row groups x 16 key (column) groups
constexpr int RT_QT = 64;        // query rows per CTA
constexpr int RT_PLD = KT + 16;  // shared row of P, floats

template <int HD>
struct RtShape {
  static constexpr int LD = HD + 4;    // shared row of q, K, V, floats
  static constexpr int COLS = HD / 16;  // output columns per thread
  static constexpr int TILE = KT * LD;
  static constexpr size_t SMEM =
      sizeof(float) * (RT_QT * LD + 4 * TILE + RT_QT * RT_PLD);
};

template <int N>
__device__ __forceinline__ void load_cols(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = t.x;
      r[4 * i + 1] = t.y;
      r[4 * i + 2] = t.z;
      r[4 * i + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

// grid (H, B, q tiles), the q tiles last first.  Thread (ty, tx) = (tid /
// 16, tid % 16) owns the query rows q0 + ty + 16 i, the keys k0 + tx + 16 j
// of each tile (i, j < 4) and the output columns tx * COLS .. + COLS.
template <int HD>
__global__ void __launch_bounds__(RT_THREADS)
attention_rt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    int t_len, int s_len, int heads, int kv_heads, int causal,
                    int window, float scale) {
  using S = RtShape<HD>;
  constexpr int LD = S::LD;
  constexpr int COLS = S::COLS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // (RT_QT, LD), scaled
  float* ks = qs + RT_QT * LD;                  // 2 stages of (KT, LD)
  float* vs = ks + 2 * S::TILE;                 // 2 stages of (KT, LD)
  float* ps = vs + 2 * S::TILE;                 // (RT_QT, RT_PLD)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * RT_QT;
  const int q_last = min(q0 + RT_QT, t_len) - 1;
  const int kh = h / (heads / kv_heads);
  const long long q_stride = static_cast<long long>(heads) * HD;
  const long long kv_stride = static_cast<long long>(kv_heads) * HD;
  const float* qb = q + static_cast<long long>(b) * t_len * q_stride + h * HD;
  const float* kb =
      k + static_cast<long long>(b) * s_len * kv_stride + kh * HD;
  const float* vb =
      v + static_cast<long long>(b) * s_len * kv_stride + kh * HD;

  const int2 tiles = kv_tiles(q0, q_last, s_len, causal, window);
  if (tiles.y > 0) {
    const int k0 = tiles.x * KT;
    stage_rows<float, HD, LD, KT, RT_THREADS>(ks, kb + k0 * kv_stride,
                                              kv_stride, s_len - k0, kb, tid);
    stage_rows<float, HD, LD, KT, RT_THREADS>(vs, vb + k0 * kv_stride,
                                              kv_stride, s_len - k0, vb, tid);
  }
  cp_async_commit();
  // q scaled by hd^-1/2 in fp32, as the plain version scales it
  for (int i = tid; i < RT_QT * HD / 4; i += RT_THREADS) {
    const int r = i / (HD / 4);
    const int c = (i - r * (HD / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < t_len) {
      t = *reinterpret_cast<const float4*>(qb + (q0 + r) * q_stride + c);
      t.x = __fmul_rn(t.x, scale);
      t.y = __fmul_rn(t.y, scale);
      t.z = __fmul_rn(t.z, scale);
      t.w = __fmul_rn(t.w, scale);
    }
    *reinterpret_cast<float4*>(qs + r * LD + c) = t;
  }

  float o[4][COLS];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) o[i][c] = 0.f;
  }

  for (int it = 0; it < tiles.y; ++it) {
    const int k0 = (tiles.x + it) * KT;
    cp_async_wait_all();
    __syncthreads();  // tile it has landed; tile it - 1 is no longer read
    if (it + 1 < tiles.y) {
      const int k1 = k0 + KT;
      const int st = (it + 1) & 1;
      stage_rows<float, HD, LD, KT, RT_THREADS>(
          ks + st * S::TILE, kb + k1 * kv_stride, kv_stride, s_len - k1, kb,
          tid);
      stage_rows<float, HD, LD, KT, RT_THREADS>(
          vs + st * S::TILE, vb + k1 * kv_stride, kv_stride, s_len - k1, vb,
          tid);
      cp_async_commit();
    }
    const float* kt = ks + (it & 1) * S::TILE;
    const float* vt = vs + (it & 1) * S::TILE;

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
        kv[i] = *reinterpret_cast<const float4*>(kt + (tx + 16 * i) * LD + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qv[i].x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv[i].y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv[i].z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv[i].w, kv[j].w, sc[i][j]);
        }
      }
    }

    const bool edge = tile_needs_mask(k0, q0, q_last, s_len, causal, window);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (edge && !visible(k0 + tx + 16 * j, row, s_len, causal, window)) {
          sc[i][j] = NEG;
        }
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int sh = 8; sh > 0; sh >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      }
      const float cr = expf(m[i] - mx);
      m[i] = mx;
      l[i] *= cr;
#pragma unroll
      for (int c = 0; c < COLS; ++c) o[i][c] *= cr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - mx);
        l[i] += p;
        ps[(ty + 16 * i) * RT_PLD + tx + 16 * j] = p;
      }
    }
    __syncthreads();  // P of the whole tile is in shared memory

#pragma unroll 2
    for (int j = 0; j < KT; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * RT_PLD +
                                                 j);
      }
      float vv[4][COLS];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        load_cols(vv[jj], vt + (j + jj) * LD + tx * COLS);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          o[i][c] = fmaf(pv[i].x, vv[0][c], o[i][c]);
          o[i][c] = fmaf(pv[i].y, vv[1][c], o[i][c]);
          o[i][c] = fmaf(pv[i].z, vv[2][c], o[i][c]);
          o[i][c] = fmaf(pv[i].w, vv[3][c], o[i][c]);
        }
      }
    }
  }
  cp_async_wait_all();

  float* ob = out + static_cast<long long>(b) * t_len * q_stride + h * HD +
              tx * COLS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float den = l[i];
#pragma unroll
    for (int sh = 8; sh > 0; sh >>= 1) {
      den += __shfl_xor_sync(0xffffffffu, den, sh);
    }
    den = fmaxf(den, 1e-30f);
    const int row = q0 + ty + 16 * i;
    if (row < t_len) {
#pragma unroll
      for (int c = 0; c < COLS; ++c) ob[row * q_stride + c] = o[i][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename T>
struct Instance;
template <>
struct Instance<bf16> {
  static constexpr int THREADS = TC_THREADS;
  static constexpr int QT = TC_QT;
  template <int HD>
  static constexpr size_t smem() { return TcShape<HD>::SMEM; }
  template <int HD>
  static constexpr auto kernel() { return attention_tc_kernel<HD>; }
};
template <>
struct Instance<float> {
  static constexpr int THREADS = RT_THREADS;
  static constexpr int QT = RT_QT;
  template <int HD>
  static constexpr size_t smem() { return RtShape<HD>::SMEM; }
  template <int HD>
  static constexpr auto kernel() { return attention_rt_kernel<HD>; }
};

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int t_len, int s_len, int heads, int kv_heads, int causal,
              int window, float scale, void* stream) {
  using I = Instance<T>;
  const auto kernel = I::template kernel<HD>();
  const size_t smem = I::template smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(heads, b, (t_len + I::QT - 1) / I::QT);
  kernel<<<grid, I::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), t_len, s_len, heads,
      kv_heads, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int t_len, int s_len, int heads, int kv_heads, int hd, int causal,
           int window, float scale, void* stream) {
  if (kv_heads < 1 || heads % kv_heads != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16-byte copies of whole rows
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (b == 0 || t_len == 0 || heads == 0) return 0;
  switch (hd) {
    case 16:
      return launch_hd<T, 16>(q, k, v, out, b, t_len, s_len, heads, kv_heads,
                              causal, window, scale, stream);
    case 32:
      return launch_hd<T, 32>(q, k, v, out, b, t_len, s_len, heads, kv_heads,
                              causal, window, scale, stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, b, t_len, s_len, heads, kv_heads,
                              causal, window, scale, stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, b, t_len, s_len, heads,
                               kv_heads, causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int attention_fold_f32(const void* q, const void* k, const void* v,
                       void* out, int b, int t_len, int s_len, int heads,
                       int kv_heads, int hd, int causal, int window,
                       float scale, void* stream) {
  return launch<float>(q, k, v, out, b, t_len, s_len, heads, kv_heads, hd,
                       causal, window, scale, stream);
}

int attention_fold_bf16(const void* q, const void* k, const void* v,
                        void* out, int b, int t_len, int s_len, int heads,
                        int kv_heads, int hd, int causal, int window,
                        float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, b, t_len, s_len, heads,
                               kv_heads, hd, causal, window, scale, stream);
}

}  // extern "C"

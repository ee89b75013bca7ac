// Fold-streamed convolution for Hopper (sm_90a), the kernels' templates
// (fold_conv.cu instantiates the fp32 and int8 entries, fold_conv_bf16.cu
// the bf16 ones, so that the two compile in parallel): the weight-stationary
// and output-stationary dataflows of the paper and the depthwise fold, with
// the fused bias -> BN scale/shift -> residual add -> ReLU or ReLU6 ->
// 2x2/2 max-pool epilogue, in fp32 and int8; the partial-sum staging
// formulation of the weight-stationary dataflow (the paper's Fig. 5) in
// fp32; and the bf16 instance of the depthwise kernel.  The bf16 WS, OS
// and psum kernels run on the tensor cores (fold_conv_tc.cuh), on this
// header's geometry, gather table and epilogue.
//
// Replaces the Pallas TPU kernels repro/kernels/conv2d_ws.py:_ws_kernel,
// :_os_kernel, :_dw_kernel and :_ws_psum_kernel (all launched from
// conv2d_folded).  The Python wrapper (repro_torch/kernels/conv2d_ws.py)
// pads every operand to the fold plan (fold_kernel_spec), picks the CTA
// tile (fold_tile), allocates the output and the WS slab, and checks the
// error code each entry returns.
//
// Operands (contiguous; x and w are fp32, int8 for the *_i8 entries, bf16
// for the *_bf16 entries):
//   x    (N, C_pad, X_rows, Yp)   pre-padded input
//   w    (NF_pad, C_pad/G, R, S)  dense or grouped; (C_pad, 1, R, S)
//                                 depthwise
//   vec  (NF_pad, 3)              bias, BN scale, BN shift per filter (fp32)
//   res  (N, NF_pad, P_pad, Q)    the shortcut in the output's type, or null
//   out  (N, NF_pad, P_pad or P_pad/2, Q or Q/2), fp32 (bf16 for *_bf16)
//   slab (N, NF_pad, P_pad, Q)     WS partial sums while g_c > 1, else null
//                                  (fp32, or int32 for int8)
//   psum (g_c, N, NF_pad, P_pad, Q) fold_conv_psum's staging buffer, fp32
//                                  (bf16 for fold_conv_psum_bf16)
//
// Int8 (the *_i8 entries, the JAX kernels' acc_dtype=int32 bodies): each
// int8 operand is widened to int32 as it is staged (IMAD on the CUDA
// cores), the sums and the WS slab are int32, and the flush converts the
// finished sum with __int2float_rn and applies the requant affine the
// caller put in the scale/shift columns (core/quant.py: requant_affine),
// then the fp32 epilogue as for fp32.  Integer sums are exact in any
// order.  The fp32 and int8 kernels are one template on the operand type T
// and the accumulator type A.
//
// bf16 depthwise (fold_conv_dw_bf16; the JAX kernel with bf16 operands,
// which it widens to fp32): T = __nv_bfloat16, A = float.  Each bf16 value
// is widened to fp32 where it is loaded (the window, two values a 4-byte
// load), so the FMAs and the epilogue are the fp32 instance's, and each
// output is rounded once to bf16 at its store (a thread's outputs in one
// word where aligned).  This core has no bf16 WS, OS or psum instance:
// those run on the tensor cores (fold_conv_tc.cuh).
//
// The WS, OS and psum kernels (ws_kernel, os_kernel, psum_kernel; they replace
// _ws_kernel and _os_kernel, fp32 and int8, and _ws_psum_kernel in fp32)
// share one tile core: a fold interaction as an
// implicit GEMM, M = output pixels flattened over (n, p, q) (2x2 quads of them
// where the pool is fused, so each pool window is finished in one thread), N =
// the filters of one group, K = the group's (c, r, s) taps.  A CTA owns BM
// pixels x BN filters (a Tile); each thread keeps TM x TN accumulators in
// registers and feeds them from shared memory, TM pixels and TN filters per tap
// read as 16-byte (or 8-byte) words, operands read PF taps ahead.  K streams in
// chunks of BK taps.  The input taps of the tile's pixels (an im2col slice of
// the pre-padded input, whose rows are not 16-byte aligned: Yp is 226, 34, 18,
// so no TMA and no vector copy) are gathered into registers while the previous
// chunk's FFMAs issue and stored into a two-stage ring; a k -> offset table in
// shared memory and each thread's pixel offset in a register keep the gather to
// one broadcast shared read and an add per element.
//   OS: a CTA owns one output tile, keeps its accumulators across the
//       whole of K, and streams its filters' rows through a cp.async
//       ring PB chunks ahead.
//   WS: per depth fold, a CTA stages its filter tile (BN x c_b*R*S) once
//       by cp.async and keeps it resident while it walks its share of the
//       M tiles (the paper's Filter Fold held while Image Folds stream);
//       with g_c > 1 the partial sums of each tile go through the slab,
//       which only that CTA touches.
//   psum: as WS for one depth fold per CTA, the folds on the grid's third
//       axis and so in parallel; each tile's raw sums go to its fold's
//       slice of the staging buffer, and the caller sums the folds.
// Grouped (1 < G < C): a CTA's filter tile never straddles a group, and
// its channel base is group(f0) * C/G (the counterpart of _ix_ws_x); where
// NF/G < BN the tile's last filters are masked.  The wrapper picks the
// tile of each launch (conv2d_ws.py: fold_tile) from the launch spec and
// the SM count; the shared memory a tile needs is checked here again.
//
// Bound: the FFMA rate (67 TFLOP/s fp32) for every dense layer of the zoo (the
// int8 tensor-core rate for int8, which IMAD does not reach).  What binds the kernels instead (PERF.md): the gather, one
// 4-byte load per tap and pixel, which takes more issue slots and more latency
// than the TM*TN FFMAs it feeds where the tile is small; and, on the smallest
// layers (4x4 outputs, K up to 4608), too few outputs to put more than one or
// two warps on each SM scheduler, since nothing splits K.
// Staging the tile's input window in shared memory instead (halo
// included, by bulk or 16-byte asynchronous copies a few chunks ahead,
// each element read from device memory once per chunk, the taps then
// expanded from shared memory) ran 1.07x to 3x slower on every zoo layer
// (PERF.md): the gather's loads mostly hit L1, so the window saves
// no instruction and adds the copies and a wait per chunk.  The
// order of each output's sum is fixed: it starts from 0 and runs c
// ascending, then r, then s, one fmaf (or integer multiply-add) per tap,
// whatever the tile, the grid, N, the dataflow or the epilogue: no split
// of K across threads or CTAs, no atomics.  So a conv trunk gives the same
// bits at every batch width, and in fp32 and int8 the two dataflows give
// the same bits (as bf16 WS and OS do, each output a chain of 16-tap MMA
// steps in fold_conv_tc.cuh).  The depthwise kernel's bound is bytes, but
// a launch and a thread's memory round trips are what bind it: a thread
// owns TQ outputs along Q (TQ picked per launch), issues every load before
// its first multiply-add, and sums each output's R*S taps, R then S
// (dw_kernel below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int DW_THREADS = 128;     // threads of a depthwise CTA at most
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory of one CTA
constexpr int BK = 32;               // taps per K chunk of the tile core
constexpr int PB = 8;                // OS weight chunks copied ahead
constexpr int SB = PB + 1;           // stages of the OS weight ring
constexpr int PF = 4;                // taps of operands read ahead

// Epilogue steps, one bit each (EPI_* in conv2d_ws.py)
constexpr int EPI_BIAS = 1;
constexpr int EPI_SCALE = 2;
constexpr int EPI_RESIDUAL = 4;
constexpr int EPI_RELU = 8;
constexpr int EPI_RELU6 = 16;
constexpr int EPI_POOL = 32;

// _flush_value on one finished sum: bias -> scale/shift -> residual -> ReLU
// or ReLU6.  Each step is rounded on its own: __fmul_rn / __fadd_rn keep
// nvcc from contracting v*scale + shift into one fmaf, so a fused layer
// gives the bits of the same steps run as separate torch ops.
__device__ __forceinline__ float epilogue(float v, float bias, float scale,
                                          float shift, int epi, float res) {
  if (epi & EPI_BIAS) v = __fadd_rn(v, bias);
  if (epi & EPI_SCALE) v = __fadd_rn(__fmul_rn(v, scale), shift);
  if (epi & EPI_RESIDUAL) v = __fadd_rn(v, res);
  if (epi & EPI_RELU) v = v < 0.f ? 0.f : v;
  if (epi & EPI_RELU6) v = fminf(fmaxf(v, 0.f), 6.f);
  return v;
}

// The same for filter f, its bias, scale and shift read from the vector
// block as the steps need them
__device__ __forceinline__ float epilogue(float v,
                                          const float* __restrict__ vec,
                                          int f, int epi, float res) {
  const float* p = vec + 3 * f;
  const bool scaled = epi & EPI_SCALE;
  return epilogue(v, epi & EPI_BIAS ? p[0] : 0.f, scaled ? p[1] : 0.f,
                  scaled ? p[2] : 0.f, epi, res);
}

// The arithmetic that differs between the fp32 and the int8 instances
__device__ __forceinline__ float mac(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ int mac(int a, int b, int c) { return a * b + c; }
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int v) { return __int2float_rn(v); }

template <typename A> struct Vec;
template <> struct Vec<float> { using v4 = float4; using v2 = float2; };
template <> struct Vec<int> { using v4 = int4; using v2 = int2; };

// A load widened to the accumulator's type: fp32 as it is, int8 to int32,
// bf16 to fp32 (exact: its 16 bits are the top half of the fp32 word)
__device__ __forceinline__ float ldg_wide(const float* p) { return __ldg(p); }
__device__ __forceinline__ int ldg_wide(const int8_t* p) {
  return static_cast<int>(__ldg(p));
}
__device__ __forceinline__ float ldg_wide(const __nv_bfloat16* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A store in the destination's type: the one rounding of a bf16 output
// (round to nearest even)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// What an instance stores (and reads the residual in): bf16 for bf16
// operands, fp32 for fp32 and int8
template <typename T> struct OutOf { using type = float; };
template <> struct OutOf<__nv_bfloat16> { using type = __nv_bfloat16; };

// ---------------------------------------------------------------------------
// The tile core of the WS and OS kernels
// ---------------------------------------------------------------------------

// A CTA tile: MG x NG threads, each with TM pixels x TN filters.  BNP is
// the shared-memory row of the weight tile, padded where a row of 32 or
// more words would put every tap of a staging warp on one bank.
template <int TM_, int TN_, int MG_, int NG_>
struct Tile {
  static constexpr int TM = TM_, TN = TN_, MG = MG_, NG = NG_;
  static constexpr int BM = TM * MG, BN = TN * NG, THREADS = MG * NG;
  static constexpr int BNP = BN >= 32 ? BN + 4 : BN;
  static_assert(THREADS % BM == 0 && BK % (THREADS / BM) == 0,
                "each thread gathers one pixel of the tile");
};

// The tiles the wrapper picks from (TILES in conv2d_ws.py, same order):
// each is the fastest on some conv of the zoo (fold_tiles.py, PERF.md)
using Tile0 = Tile<2, 4, 32, 4>;    //  64 x 16, 128 threads
using Tile1 = Tile<1, 4, 64, 2>;    //  64 x 8,  128: the small OS layers
using Tile2 = Tile<4, 2, 32, 4>;    // 128 x 8,  128
using Tile3 = Tile<4, 2, 64, 4>;    // 256 x 8,  256: WS at K = 4608
using Tile4 = Tile<4, 4, 32, 4>;    // 128 x 16, 128
using Tile5 = Tile<4, 4, 64, 4>;    // 256 x 16, 256
using Tile6 = Tile<4, 1, 16, 8>;    //  64 x 8,  128: small pooled layers

struct Geom {
  int n, c_pad, x_rows, yp;
  int nf_pad, r, s, stride;
  int q, p_pad, groups, c_b;
  int epi;        // EPI_* bits
  int m_per_cta;  // WS: M tiles one CTA walks
};

// What a launch derives from Geom.  M counts output pixels, four per
// pooled output where the pool is fused (a thread's pixels are then whole
// 2x2 quads).
struct Dims {
  int cg, K, Kf, nfg, tiles_per_group, M, po, qo, plane;
  bool pool;
};

__host__ __device__ inline Dims make_dims(const Geom& g, int bn) {
  Dims d;
  d.cg = g.c_pad / g.groups;
  d.K = d.cg * g.r * g.s;
  d.Kf = g.c_b * g.r * g.s;
  d.nfg = g.nf_pad / g.groups;
  d.tiles_per_group = (d.nfg + bn - 1) / bn;
  d.pool = (g.epi & EPI_POOL) != 0;
  d.po = d.pool ? g.p_pad / 2 : g.p_pad;
  d.qo = d.pool ? g.q / 2 : g.q;
  d.M = d.pool ? 4 * g.n * d.po * d.qo : g.n * g.p_pad * g.q;
  d.plane = g.x_rows * g.yp;
  return d;
}

// Output pixel (n, p, q) of flat index m
__device__ __forceinline__ void pixel(const Geom& g, const Dims& d, int m,
                                      int& n, int& p, int& q) {
  if (d.pool) {
    const int u = m >> 2;
    const int qq = u % d.qo;
    const int t = u / d.qo;
    p = 2 * (t % d.po) + ((m >> 1) & 1);
    q = 2 * qq + (m & 1);
    n = t / d.po;
  } else {
    q = m % g.q;
    const int t = m / g.q;
    p = t % g.p_pad;
    n = t / g.p_pad;
  }
}

// Where this CTA's filter tile starts, how many of its filters are real,
// and the first input channel of its group
__device__ __forceinline__ void filter_tile(const Dims& d, int bn, int& f0,
                                            int& nvalid, int& cbase) {
  const int grp = static_cast<int>(blockIdx.y) / d.tiles_per_group;
  const int t = static_cast<int>(blockIdx.y) % d.tiles_per_group;
  f0 = grp * d.nfg + t * bn;
  nvalid = min(bn, d.nfg - t * bn);
  cbase = grp * d.cg;
}

// One weight into shared memory: a 4-byte cp.async (zero-filled where the
// filter is not real) for fp32; a load widened to int32 for int8
__device__ __forceinline__ void stage_elem(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}
template <typename T, typename A>
__device__ __forceinline__ void stage_elem(A* dst, const T* src, bool ok) {
  *dst = ok ? ldg_wide(src) : A(0);
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// k -> offset of tap (c, r, s) from its pixel's first input element
__device__ void fill_koff(int* koff, const Geom& g, const Dims& d,
                          int threads) {
  const int rs = g.r * g.s;
  for (int k = threadIdx.x; k < d.K; k += threads) {
    const int c = k / rs;
    const int t = k - c * rs;
    const int r = t / g.s;
    koff[k] = c * d.plane + r * g.yp + (t - r * g.s);
  }
}

// Offset of the first input element of pixel m (the tap c = r = s = 0 of
// the group starting at channel cbase), -1 past M
__device__ __forceinline__ int row_base(const Geom& g, const Dims& d, int m,
                                        int cbase) {
  if (m >= d.M) return -1;
  int n, p, q;
  pixel(g, d, m, n, p, q);
  return ((n * g.c_pad + cbase) * g.x_rows + p * g.stride) * g.yp +
         q * g.stride;
}

// Weight rows k in [kbeg, kbeg + BK) of the filter tile into b_s as
// [k][BNP] (OS: one ring stage)
template <class TL, typename T, typename A>
__device__ __forceinline__ void load_b(A* b_s, const T* __restrict__ w,
                                       int K, int f0, int nvalid, int kbeg,
                                       int kend) {
  for (int e = threadIdx.x; e < BK * TL::BN; e += TL::THREADS) {
    const int kl = e % BK;
    const int nl = e / BK;
    const int k = kbeg + kl;
    const bool ok = nl < nvalid && k < kend;
    stage_elem(b_s + kl * TL::BNP + nl,
               w + (ok ? static_cast<size_t>(f0 + nl) * K + k : 0), ok);
  }
}

// WS: the filter tile's whole depth fold [k0, k0 + Kf) as [k][BNP]
template <class TL, typename T, typename A>
__device__ void load_b_resident(A* b_s, const T* __restrict__ w, int K,
                                int Kf, int k0, int f0, int nvalid) {
  const int total = Kf * TL::BN;
  for (int e = threadIdx.x; e < total; e += TL::THREADS) {
    const int nl = e / Kf;
    const int kl = e - nl * Kf;
    const bool ok = nl < nvalid;
    stage_elem(b_s + kl * TL::BNP + nl,
               w + (ok ? static_cast<size_t>(f0 + nl) * K + k0 + kl : 0),
               ok);
  }
}

template <int L, typename A>
__device__ __forceinline__ void load_vec(A (&v)[L], const A* p) {
  if constexpr (L % 4 == 0) {
#pragma unroll
    for (int i = 0; i < L / 4; ++i) {
      const auto t = reinterpret_cast<const typename Vec<A>::v4*>(p)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (L == 2) {
    const auto t = *reinterpret_cast<const typename Vec<A>::v2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < L; ++i) v[i] = p[i];
  }
}

// The FFMAs of one chunk: kn taps, in k order, into every accumulator
template <class TL, bool FULL, typename A>
__device__ __forceinline__ void compute(A (&acc)[TL::TM][TL::TN],
                                        const A* a_s, const A* b_s, int kn,
                                        int tm, int tn) {
  // the operands of tap kk + PF - 1 are read while tap kk's FFMAs issue
  A avs[PF][TL::TM], bvs[PF][TL::TN];
#pragma unroll
  for (int p = 0; p < PF - 1; ++p) {
    if (FULL || p < kn) {
      load_vec(avs[p], a_s + p * TL::BM + tm * TL::TM);
      load_vec(bvs[p], b_s + p * TL::BNP + tn * TL::TN);
    }
  }
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    if (FULL || kk < kn) {
      const int nx = kk + PF - 1;
      if (nx < BK && (FULL || nx < kn)) {
        load_vec(avs[nx % PF], a_s + nx * TL::BM + tm * TL::TM);
        load_vec(bvs[nx % PF], b_s + nx * TL::BNP + tn * TL::TN);
      }
      const A (&av)[TL::TM] = avs[kk % PF];
      const A (&bv)[TL::TN] = bvs[kk % PF];
#pragma unroll
      for (int i = 0; i < TL::TM; ++i) {
#pragma unroll
        for (int j = 0; j < TL::TN; ++j) acc[i][j] = mac(bv[j], av[i], acc[i][j]);
      }
    }
  }
}

// The input taps of one chunk, gathered into registers (one pixel per
// thread, tid % BM, whose offset mb it holds; every THREADS/BM-th tap, so
// a warp reads neighbouring pixels of one tap) and widened to the
// accumulator's type as they load, then stored into a ring stage as
// [k][BM]
template <class TL, typename T, typename A>
__device__ __forceinline__ void fetch_a(A (&r)[BK * TL::BM / TL::THREADS],
                                        const T* __restrict__ x,
                                        const int* koff, int mb, int kbeg,
                                        int kend) {
  constexpr int KSTEP = TL::THREADS / TL::BM;
  const int kl0 = threadIdx.x / TL::BM;
#pragma unroll
  for (int i = 0; i < BK / KSTEP; ++i) {
    const int k = kbeg + kl0 + i * KSTEP;
    r[i] = (mb >= 0 && k < kend) ? ldg_wide(x + mb + koff[k]) : A(0);
  }
}

template <class TL, typename A>
__device__ __forceinline__ void store_a(
    A* a_s, const A (&r)[BK * TL::BM / TL::THREADS]) {
  constexpr int KSTEP = TL::THREADS / TL::BM;
  const int ml = threadIdx.x % TL::BM;
  const int kl0 = threadIdx.x / TL::BM;
#pragma unroll
  for (int i = 0; i < BK / KSTEP; ++i) {
    a_s[(kl0 + i * KSTEP) * TL::BM + ml] = r[i];
  }
}

// Stream taps [kbeg, kend) of the tile and accumulate.  Each thread
// gathers chunk kc+1 of the input into registers while chunk kc's FFMAs
// issue, then stores it into the other stage of the input's two-stage
// ring; one barrier a chunk.  OS streams the weights' rows through a
// (PB+1)-stage ring of cp.async groups, PB chunks ahead, because every
// CTA reads its filters' rows from device memory; WS reads its resident
// tile, whose row 0 is tap kbeg.
template <class TL, bool OS, typename T, typename A>
__device__ __forceinline__ void run_k(A (&acc)[TL::TM][TL::TN],
                                      const T* __restrict__ x,
                                      const T* __restrict__ w, A* a_ring,
                                      A* b_base, const int* koff, int mb,
                                      int K, int kbeg, int kend, int f0,
                                      int nvalid, int tm, int tn) {
  const int nk = (kend - kbeg + BK - 1) / BK;
#pragma unroll
  for (int j = 0; j < PB; ++j) {
    if (OS && j < nk) {
      load_b<TL>(b_base + j * BK * TL::BNP, w, K, f0, nvalid, kbeg + j * BK,
                 kend);
    }
    commit();
  }
  A ar[BK * TL::BM / TL::THREADS];
  fetch_a<TL>(ar, x, koff, mb, kbeg, kend);
  store_a<TL>(a_ring, ar);
  wait_pending<PB - 1>();
  __syncthreads();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) fetch_a<TL>(ar, x, koff, mb, kbeg + (kc + 1) * BK, kend);
    if (OS && kc + PB < nk) {
      load_b<TL>(b_base + (kc + PB) % SB * BK * TL::BNP, w, K, f0, nvalid,
                 kbeg + (kc + PB) * BK, kend);
    }
    commit();
    const A* a = a_ring + (kc & 1) * BK * TL::BM;
    const A* b = b_base + (OS ? kc % SB : kc) * BK * TL::BNP;
    const int kn = min(BK, kend - kbeg - kc * BK);
    if (kn == BK) {
      compute<TL, true>(acc, a, b, kn, tm, tn);
    } else {
      compute<TL, false>(acc, a, b, kn, tm, tn);
    }
    if (kc + 1 < nk) store_a<TL>(a_ring + ((kc + 1) & 1) * BK * TL::BM, ar);
    wait_pending<PB - 1>();
    __syncthreads();
  }
}

// _flush_value: the epilogue, the 2x2 max of each quad where the pool is
// fused, and the one write of each finished output element.  Each pixel's
// position is decoded once, for all the thread's filters.
template <class TL, typename A, typename O>
__device__ __forceinline__ void flush(const A (&acc)[TL::TM][TL::TN],
                                      O* __restrict__ out,
                                      const float* __restrict__ vec,
                                      const O* __restrict__ res,
                                      const Geom& g, const Dims& d, int m0,
                                      int f0, int nvalid, int tm, int tn) {
  const int mt = m0 + tm * TL::TM;
  const int fl0 = tn * TL::TN;
  const size_t plane = static_cast<size_t>(g.p_pad) * g.q;
  const bool residual = g.epi & EPI_RESIDUAL;
  if (d.pool) {
    if constexpr (TL::TM % 4 == 0) {
      const size_t oplane = static_cast<size_t>(d.po) * d.qo;
#pragma unroll
      for (int iq = 0; iq < TL::TM / 4; ++iq) {
        if (mt + 4 * iq >= d.M) break;
        size_t at[4];
        int n, p, q;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          pixel(g, d, mt + 4 * iq + k, n, p, q);
          at[k] = (static_cast<size_t>(n) * g.nf_pad * g.p_pad + p) * g.q + q;
        }
        // (p, q) is the quad's last pixel: p / 2 and q / 2 are its window
        const size_t oat =
            (static_cast<size_t>(n) * g.nf_pad * d.po + p / 2) * d.qo + q / 2;
#pragma unroll
        for (int j = 0; j < TL::TN; ++j) {
          if (fl0 + j >= nvalid) break;
          const int f = f0 + fl0 + j;
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float r = residual ? widen(res[at[k] + f * plane]) : 0.f;
            v[k] = epilogue(to_float(acc[4 * iq + k][j]), vec, f, g.epi, r);
          }
          put(out + oat + f * oplane,
              fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    if (mt + i >= d.M) break;
    int n, p, q;
    pixel(g, d, mt + i, n, p, q);
    const size_t at =
        (static_cast<size_t>(n) * g.nf_pad * g.p_pad + p) * g.q + q;
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      if (fl0 + j >= nvalid) break;
      const int f = f0 + fl0 + j;
      const float r = residual ? widen(res[at + f * plane]) : 0.f;
      put(out + at + f * plane, epilogue(to_float(acc[i][j]), vec, f, g.epi, r));
    }
  }
}

// WS partial sums of the tile to (STORE) or from the slab; psum stores a
// fold's sums to its staging slice
template <class TL, bool STORE, typename A>
__device__ __forceinline__ void slab_io(A (&acc)[TL::TM][TL::TN],
                                        A* __restrict__ slab, const Geom& g,
                                        const Dims& d, int m0, int f0,
                                        int nvalid, int tm, int tn) {
  const int mt = m0 + tm * TL::TM;
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
    if (mt + i >= d.M) break;
    int n, p, q;
    pixel(g, d, mt + i, n, p, q);
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) {
      if (tn * TL::TN + j >= nvalid) break;
      A* s = slab + ((static_cast<size_t>(n) * g.nf_pad + f0 + tn * TL::TN +
                      j) * g.p_pad + p) * g.q + q;
      if constexpr (STORE) {
        *s = acc[i][j];
      } else {
        acc[i][j] = *s;
      }
    }
  }
}

template <class TL, typename A>
__device__ __forceinline__ void zero(A (&acc)[TL::TM][TL::TN]) {
#pragma unroll
  for (int i = 0; i < TL::TM; ++i) {
#pragma unroll
    for (int j = 0; j < TL::TN; ++j) acc[i][j] = A(0);
  }
}

// Output-stationary: grid (M tiles, groups x filter tiles).  Shared
// memory: the weight ring, the input ring, the k offset table.
template <class TL, typename T, typename A, typename O>
__global__ void __launch_bounds__(TL::THREADS)
os_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const O* __restrict__ res,
          O* __restrict__ out, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TL::BN);
  int f0, nvalid, cbase;
  filter_tile(d, TL::BN, f0, nvalid, cbase);
  A* b_ring = reinterpret_cast<A*>(smem4);
  A* a_ring = b_ring + SB * BK * TL::BNP;
  int* koff = reinterpret_cast<int*>(a_ring + 2 * BK * TL::BM);
  const int m0 = blockIdx.x * TL::BM;
  fill_koff(koff, g, d, TL::THREADS);
  const int mb = row_base(g, d, m0 + threadIdx.x % TL::BM, cbase);
  __syncthreads();
  const int tm = threadIdx.x % TL::MG;
  const int tn = threadIdx.x / TL::MG;
  A acc[TL::TM][TL::TN];
  zero<TL>(acc);
  run_k<TL, true>(acc, x, w, a_ring, b_ring, koff, mb, d.K, 0, d.K, f0,
                  nvalid, tm, tn);
  flush<TL>(acc, out, vec, res, g, d, m0, f0, nvalid, tm, tn);
}

// Weight-stationary: grid (M-tile shares, groups x filter tiles).  Shared
// memory: the resident filter tile of one depth fold, the input ring, the
// k offset table.
template <class TL, typename T, typename A, typename O>
__global__ void __launch_bounds__(TL::THREADS)
ws_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const O* __restrict__ res,
          O* __restrict__ out, A* __restrict__ slab, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TL::BN);
  int f0, nvalid, cbase;
  filter_tile(d, TL::BN, f0, nvalid, cbase);
  A* b_res = reinterpret_cast<A*>(smem4);
  A* a_ring = b_res + d.Kf * TL::BNP;
  int* koff = reinterpret_cast<int*>(a_ring + 2 * BK * TL::BM);
  fill_koff(koff, g, d, TL::THREADS);
  const int m_tiles = (d.M + TL::BM - 1) / TL::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const int g_c = d.cg / g.c_b;
  const int tm = threadIdx.x % TL::MG;
  const int tn = threadIdx.x / TL::MG;
  for (int cf = 0; cf < g_c; ++cf) {
    __syncthreads();  // the previous depth fold's tile is no longer read
    load_b_resident<TL>(b_res, w, d.K, d.Kf, cf * d.Kf, f0, nvalid);
    commit();
    for (int mt = mt_lo; mt < mt_hi; ++mt) {
      const int m0 = mt * TL::BM;
      const int mb = row_base(g, d, m0 + threadIdx.x % TL::BM, cbase);
      __syncthreads();  // the last tile's ring is no longer read
      A acc[TL::TM][TL::TN];
      zero<TL>(acc);
      if (cf > 0) slab_io<TL, false>(acc, slab, g, d, m0, f0, nvalid, tm, tn);
      run_k<TL, false>(acc, x, w, a_ring, b_res, koff, mb, d.K,
                       cf * d.Kf, (cf + 1) * d.Kf, f0, nvalid, tm, tn);
      if (cf == g_c - 1) {
        flush<TL>(acc, out, vec, res, g, d, m0, f0, nvalid, tm, tn);
      } else {
        slab_io<TL, true>(acc, slab, g, d, m0, f0, nvalid, tm, tn);
      }
    }
  }
}

// Partial-sum staging (the paper's Fig. 5 formulation): grid (M-tile
// shares, filter tiles, depth folds).  A CTA stages depth fold
// blockIdx.z's filter tile as WS does, runs that fold's Kf taps from zero
// for each of its M tiles, and stores the raw sums to the fold's own slice
// of the (g_c, N, NF_pad, P_pad, Q) staging buffer.  Nothing is flushed
// and no slab is read: the folds are independent and run in parallel
// across the grid, and the caller sums them afterwards, through device
// memory.  Dense, identity epilogue, fp32 (the bf16 instance is
// fold_conv_tc.cuh's psum_tc_kernel).
template <class TL>
__global__ void __launch_bounds__(TL::THREADS)
psum_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ psum, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TL::BN);
  int f0, nvalid, cbase;
  filter_tile(d, TL::BN, f0, nvalid, cbase);
  float* b_res = reinterpret_cast<float*>(smem4);
  float* a_ring = b_res + d.Kf * TL::BNP;
  int* koff = reinterpret_cast<int*>(a_ring + 2 * BK * TL::BM);
  fill_koff(koff, g, d, TL::THREADS);
  const int cf = blockIdx.z;
  float* fold = psum + static_cast<size_t>(cf) * g.n * g.nf_pad * g.p_pad * g.q;
  load_b_resident<TL>(b_res, w, d.K, d.Kf, cf * d.Kf, f0, nvalid);
  commit();
  const int m_tiles = (d.M + TL::BM - 1) / TL::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const int tm = threadIdx.x % TL::MG;
  const int tn = threadIdx.x / TL::MG;
  for (int mt = mt_lo; mt < mt_hi; ++mt) {
    const int m0 = mt * TL::BM;
    const int mb = row_base(g, d, m0 + threadIdx.x % TL::BM, cbase);
    __syncthreads();  // the last tile's ring is no longer read
    float acc[TL::TM][TL::TN];
    zero<TL>(acc);
    run_k<TL, false>(acc, x, w, a_ring, b_res, koff, mb, d.K, cf * d.Kf,
                     (cf + 1) * d.Kf, f0, nvalid, tm, tn);
    slab_io<TL, true>(acc, fold, g, d, m0, f0, nvalid, tm, tn);
  }
}

// What a launch runs: the dataflow's kernel
enum Kind { KIND_OS = 0, KIND_WS = 1, KIND_PSUM = 2 };

template <class TL>
size_t tile_smem(int kind, const Dims& d) {
  const size_t words = (kind != KIND_OS ? static_cast<size_t>(d.Kf) * TL::BNP
                                        : static_cast<size_t>(SB) * BK * TL::BNP) +
                       static_cast<size_t>(2) * BK * TL::BM + d.K;
  return 4 * words;
}

// Raise a kernel's dynamic shared memory cap where it needs more than the
// default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <class TL, typename T, typename A>
int launch_tile(int kind, const void* x, const void* w, const void* vec,
                const void* res, void* out, void* slab, const Geom& g,
                cudaStream_t stream) {
  const Dims d = make_dims(g, TL::BN);
  const size_t smem = tile_smem<TL>(kind, d);
  if (smem > SMEM_LIMIT || g.c_pad % g.groups || g.nf_pad % g.groups ||
      d.cg % g.c_b || (d.pool && TL::TM % 4) || g.m_per_cta < 1 ||
      (kind == KIND_PSUM && (g.groups != 1 || g.epi != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (d.M + TL::BM - 1) / TL::BM;
  const int gx = kind != KIND_OS ? (m_tiles + g.m_per_cta - 1) / g.m_per_cta
                                 : m_tiles;
  const dim3 grid(gx, g.groups * d.tiles_per_group,
                  kind == KIND_PSUM ? d.cg / g.c_b : 1);
  if (gx == 0) return static_cast<int>(cudaSuccess);
  using O = typename OutOf<T>::type;
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* vf = static_cast<const float*>(vec);
  const auto* rf = static_cast<const O*>(res);
  auto* of = static_cast<O*>(out);
  cudaError_t err;
  // the psum staging is fp32 only (int8 has none; bf16 runs on the tensor
  // cores, fold_conv_tc.cuh, as bf16 WS and OS do)
  if (kind == KIND_PSUM) {
    if constexpr (std::is_same<T, float>::value) {
      err = allow_smem(psum_kernel<TL>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      psum_kernel<TL><<<grid, TL::THREADS, smem, stream>>>(
          xt, wt, static_cast<float*>(slab), g);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kind == KIND_WS) {
    err = allow_smem(ws_kernel<TL, T, A, O>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ws_kernel<TL, T, A, O><<<grid, TL::THREADS, smem, stream>>>(
        xt, wt, vf, rf, of, static_cast<A*>(slab), g);
  } else {
    err = allow_smem(os_kernel<TL, T, A, O>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    os_kernel<TL, T, A, O><<<grid, TL::THREADS, smem, stream>>>(xt, wt, vf,
                                                                rf, of, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_fold(int tile, int kind, const void* x, const void* w,
                const void* vec, const void* res, void* out, void* slab,
                const Geom& g, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tile<Tile0, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 1: return launch_tile<Tile1, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 2: return launch_tile<Tile2, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 3: return launch_tile<Tile3, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 4: return launch_tile<Tile4, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 5: return launch_tile<Tile5, T, A>(kind, x, w, vec, res, out, slab, g, s);
    case 6: return launch_tile<Tile6, T, A>(kind, x, w, vec, res, out, slab, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// The depthwise kernel
// ---------------------------------------------------------------------------

struct DwGeom {
  int n, c, c_pad, x_rows, yp;
  int r, s, stride;
  int q, p_pad;
  int epi;
};

// blockDim.z of a depthwise CTA at most (the card's limit)
constexpr int DW_MAX_CHANS = 64;

// Keep a loaded value where it was loaded: the front end may not sink the
// load below this point, into a branch of the epilogue
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)); }
__device__ __forceinline__ void pin(int& v) { asm volatile("" : "+r"(v)); }

// Two neighbouring elements at an even element offset in one load (8
// bytes of fp32, 4 of bf16, 2 of int8), widened as ldg_wide widens
__device__ __forceinline__ void ldg_pair(const float* p, float& a, float& b) {
  const float2 v = __ldg(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ldg_pair(const int8_t* p, int& a, int& b) {
  const char2 v = __ldg(reinterpret_cast<const char2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ldg_pair(const __nv_bfloat16* p, float& a,
                                         float& b) {
  const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
  a = __uint_as_float(v << 16);
  b = __uint_as_float(v & 0xffff0000u);
}

// WIN values of one input row from column col0 on, widened; a column at yp
// or past it reads 0 (only outputs past the row's end take it).  PAIRS:
// two elements a load (the wrapper passes it where yp is even and x is
// aligned, so every row starts on a two-element boundary; col0, a multiple
// of the even TQ, is even).
template <int WIN, bool PAIRS, typename T, typename A>
__device__ __forceinline__ void load_row(A (&win)[WIN], const T* row,
                                         int col0, int yp) {
  if constexpr (PAIRS) {
    A raw[WIN + 1];
#pragma unroll
    for (int i = 0; i < WIN; i += 2) {
      raw[i] = raw[i + 1] = A(0);
      if (col0 + i < yp) ldg_pair(row + col0 + i, raw[i], raw[i + 1]);
    }
#pragma unroll
    for (int i = 0; i < WIN; ++i) win[i] = raw[i];
  } else {
#pragma unroll
    for (int i = 0; i < WIN; ++i) {
      const int col = col0 + i;
      win[i] = col < yp ? ldg_wide(row + col) : A(0);
    }
  }
}

// L consecutive outputs from p on as 16-, 8- or 4-byte words (each bf16
// rounded once, as put rounds it), where all L are real and p is aligned
// to the run (up to 16 bytes); else one put each for the first `valid`
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <int L>
__device__ __forceinline__ void put_words(float* p, const float (&v)[L]) {
  if constexpr (L == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < L; j += 4) {
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  }
}
template <int L>
__device__ __forceinline__ void put_words(__nv_bfloat16* p,
                                          const float (&v)[L]) {
  unsigned u[L / 2];
#pragma unroll
  for (int k = 0; k < L / 2; ++k) {
    u[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
  }
  if constexpr (L == 2) {
    *reinterpret_cast<unsigned*>(p) = u[0];
  } else if constexpr (L == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  } else {
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
}
template <int L, typename O>
__device__ __forceinline__ void put_run(O* p, const float (&v)[L],
                                        int valid) {
  constexpr size_t WORD = L * sizeof(O) < 16 ? L * sizeof(O) : 16;
  if constexpr (L >= 2) {
    if (valid >= L && reinterpret_cast<uintptr_t>(p) % WORD == 0) {
      put_words<L>(p, v);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (j < valid) put(p + j, v[j]);
  }
}

// Depthwise (replaces _dw_kernel): grid (row blocks, channel blocks,
// images), a CTA of (strips, ROWS, CHANS) threads owning CHANS channels x
// ROWS output rows of one image, thread (x, y, z) TQ consecutive outputs
// along Q of one row (and the row below it where the pool is fused, so
// each 2x2 window is finished in one thread; the pool takes TQ 2 or 4).  The wrapper picks TQ, ROWS and CHANS per
// launch (conv2d_ws.py: dw_geometry) so that the small planes put enough
// warps on every SM and the large ones keep wide strips; launch_dw checks
// them again.  What binds it is not bytes (the zoo's layers move 0.1-2 MB)
// but a launch and the memory round trips a thread waits on, so a thread
// aims at one: its source issues every load it needs (its channel's R*S
// weights, the channel's bias, scale and shift, the residual of its
// outputs, and the window of (TQ - 1) * stride + S columns of each input
// row its outputs read, shared by its outputs and by both rows of a pool
// window) before its first multiply-add, each value pinned where it is
// loaded so that none sinks into a branch of the epilogue (ptxas still
// moves a few loads past the first FFMAs in some instances; a fence that
// stops it made the forward slower: PERF.md), the window two elements a
// load where the rows allow (PAIRS), and it stores its outputs as one 4-
// to 16-byte word where alignment allows.  Its channel, row and strip are
// its thread index's three axes, so no division stands between its start
// and its loads; all index arithmetic is 32-bit (the wrapper keeps every
// offset below 2^31).
// Each output's sum runs R then S from 0, one fmaf (integer multiply-add)
// per tap, and the epilogue flushes at once: there is no depth fold, and
// neither TQ nor the CTA's shape nor the batch changes a bit.
// Channels C..C_pad-1 of the output are padding and are not written.
// KR, KS, ST fix the taps and the stride at compile time (3x3, stride 1
// or 2: every depthwise layer of the zoo); KR = 0 takes them from g and
// reads each tap from the read-only cache as it sums.
template <typename T, typename A, typename O, int KR, int KS, int ST, int TQ,
          bool PAIRS>
__global__ void __launch_bounds__(DW_THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const O* __restrict__ res,
          O* __restrict__ out, DwGeom g) {
  constexpr bool FIXED = KR > 0;
  const int R = FIXED ? KR : g.r;
  const int S = FIXED ? KS : g.s;
  const int st = FIXED ? ST : g.stride;
  const bool pool = g.epi & EPI_POOL;
  const int span = pool ? 2 : 1;
  const int po = g.p_pad >> pool;
  const int qo = g.q >> pool;
  const int qlim = qo << pool;  // pre-pool columns an output needs
  const int op = blockIdx.x * blockDim.y + threadIdx.y;
  const int c = blockIdx.y * blockDim.z + threadIdx.z;
  if (op >= po || c >= g.c) return;
  const int plane = blockIdx.z * g.c_pad + c;
  const int q0 = threadIdx.x * TQ;
  const int nq = min(TQ, qlim - q0);  // the thread's real (pre-pool) columns
  const T* xc = x + plane * g.x_rows * g.yp;
  const T* wc = w + c * R * S;

  // -- the loads: the channel's vector, the residual of the thread's
  // outputs, then (fixed taps) the weights and every input row's window
  float bias = __ldg(vec + 3 * c);
  float scale = __ldg(vec + 3 * c + 1);
  float shift = __ldg(vec + 3 * c + 2);
  pin(bias);
  pin(scale);
  pin(shift);
  const bool residual = g.epi & EPI_RESIDUAL;
  float rv[2][TQ];
#pragma unroll
  for (int dp = 0; dp < 2; ++dp) {
    const O* rp = res + (plane * g.p_pad + op * span + dp) * g.q + q0;
#pragma unroll
    for (int j = 0; j < TQ; ++j) {
      rv[dp][j] = residual && dp < span && j < nq ? ldg_wide(rp + j) : 0.f;
      pin(rv[dp][j]);
    }
  }
  float best[TQ];
  if constexpr (FIXED) {
    constexpr int WIN = (TQ - 1) * ST + KS;
    // input rows: R, or ST + R for both rows of a pool window
    constexpr int NR = TQ < 8 ? ST + KR : KR;
    A wr[KR * KS];
#pragma unroll
    for (int k = 0; k < KR * KS; ++k) {
      wr[k] = ldg_wide(wc + k);
      pin(wr[k]);
    }
    A win[NR][WIN];
    const int nr = pool ? ST + KR : KR;
    const T* row0 = xc + op * span * ST * g.yp;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
      if (i < nr) {
        load_row<WIN, PAIRS>(win[i], row0 + i * g.yp, q0 * ST, g.yp);
#pragma unroll
        for (int k = 0; k < WIN; ++k) pin(win[i][k]);
      }
    }
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      if (dp < span) {
        A acc[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[j] = A(0);
#pragma unroll
        for (int r = 0; r < KR; ++r) {
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              acc[j] = mac(win[dp * ST + r][j * ST + s], wr[r * KS + s],
                           acc[j]);
            }
          }
        }
        // every column's epilogue (put_run stores none past nq)
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const float v = epilogue(to_float(acc[j]), bias, scale, shift,
                                   g.epi, rv[dp][j]);
          best[j] = dp == 0 ? v : fmaxf(best[j], v);
        }
      }
    }
  } else {
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      if (dp < span) {
        const int p = op * span + dp;
        A acc[TQ];
#pragma unroll
        for (int j = 0; j < TQ; ++j) acc[j] = A(0);
        for (int r = 0; r < R; ++r) {
          const T* row = xc + (p * st + r) * g.yp;
#pragma unroll
          for (int j = 0; j < TQ; ++j) {
            if (j < nq) {
              for (int s = 0; s < S; ++s) {
                acc[j] = mac(ldg_wide(row + (q0 + j) * st + s),
                             ldg_wide(wc + r * S + s), acc[j]);
              }
            }
          }
        }
        // every column's epilogue (put_run stores none past nq)
#pragma unroll
        for (int j = 0; j < TQ; ++j) {
          const float v = epilogue(to_float(acc[j]), bias, scale, shift,
                                   g.epi, rv[dp][j]);
          best[j] = dp == 0 ? v : fmaxf(best[j], v);
        }
      }
    }
  }
  O* o = out + (plane * po + op) * qo;
  if (pool) {
    float pv[TQ / 2];
#pragma unroll
    for (int k = 0; k < TQ / 2; ++k) {
      pv[k] = fmaxf(best[2 * k], best[2 * k + 1]);
    }
    put_run<TQ / 2>(o + q0 / 2, pv, nq / 2);
  } else {
    put_run<TQ>(o + q0, best, nq);
  }
}

template <typename T, typename A, int KR, int KS, int ST, int TQ>
void launch_dw_taps(bool pairs, dim3 grid, dim3 threads, cudaStream_t st,
                    const T* x, const T* w, const float* vec,
                    const typename OutOf<T>::type* res,
                    typename OutOf<T>::type* out, const DwGeom& g) {
  using O = typename OutOf<T>::type;
  if constexpr (KR > 0) {
    if (pairs) {
      dw_kernel<T, A, O, KR, KS, ST, TQ, true><<<grid, threads, 0, st>>>(
          x, w, vec, res, out, g);
      return;
    }
  }
  dw_kernel<T, A, O, KR, KS, ST, TQ, false><<<grid, threads, 0, st>>>(
      x, w, vec, res, out, g);
}

template <typename T, typename A, int KR, int KS, int ST>
void launch_dw_tq(int tq, bool pairs, dim3 grid, dim3 threads,
                  cudaStream_t st, const T* x, const T* w, const float* vec,
                  const typename OutOf<T>::type* res,
                  typename OutOf<T>::type* out, const DwGeom& g) {
  switch (tq) {
    case 2: return launch_dw_taps<T, A, KR, KS, ST, 2>(
        pairs, grid, threads, st, x, w, vec, res, out, g);
    case 4: return launch_dw_taps<T, A, KR, KS, ST, 4>(
        pairs, grid, threads, st, x, w, vec, res, out, g);
    default: return launch_dw_taps<T, A, KR, KS, ST, 8>(
        pairs, grid, threads, st, x, w, vec, res, out, g);
  }
}

// The depthwise launch on the wrapper's geometry: TQ outputs a thread
// (2, 4 or 8; 2 or 4 under the pool), ROWS x CHANS a CTA (CHANS up to
// DW_MAX_CHANS), whole rows of strips in one CTA, and PAIRS (two-element
// window loads) only where every row starts on a two-element boundary.  A
// geometry it cannot run is refused with cudaErrorInvalidValue.
template <typename T, typename A>
int launch_dw(const void* x, const void* w, const void* vec, const void* res,
              void* out, int n, int c, int c_pad, int x_rows, int yp, int r,
              int s, int stride, int q, int p_pad, int epi, int tq, int rows,
              int chans, int pairs, void* stream) {
  const int span = (epi & EPI_POOL) ? 2 : 1;
  const int po = p_pad / span;
  const int qlim = span * (q / span);
  if (n == 0 || c == 0 || po == 0 || qlim == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const bool tq_ok = tq == 2 || tq == 4 || (tq == 8 && span == 1);
  const int strips = tq_ok ? (qlim + tq - 1) / tq : 0;
  const int gy = chans > 0 ? (c + chans - 1) / chans : 0;
  if (!tq_ok || rows < 1 || rows > po || chans < 1 || chans > c ||
      chans > DW_MAX_CHANS || chans * rows * strips > DW_THREADS ||
      gy > 65535 || n > 65535 ||
      (pairs && (yp % 2 != 0 ||
                 reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DwGeom g{n, c, c_pad, x_rows, yp, r, s, stride, q, p_pad, epi};
  const dim3 grid((po + rows - 1) / rows, gy, n);
  const dim3 threads(strips, rows, chans);
  using O = typename OutOf<T>::type;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* vf = static_cast<const float*>(vec);
  const auto* rf = static_cast<const O*>(res);
  auto* of = static_cast<O*>(out);
  if (r == 3 && s == 3 && stride == 1) {
    launch_dw_tq<T, A, 3, 3, 1>(tq, pairs, grid, threads, st, xt, wt, vf, rf,
                                of, g);
  } else if (r == 3 && s == 3 && stride == 2) {
    launch_dw_tq<T, A, 3, 3, 2>(tq, pairs, grid, threads, st, xt, wt, vf, rf,
                                of, g);
  } else {
    launch_dw_tq<T, A, 0, 0, 0>(tq, false, grid, threads, st, xt, wt, vf, rf,
                                of, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

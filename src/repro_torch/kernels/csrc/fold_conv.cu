// Fold-streamed convolution for Hopper (sm_90a): the weight-stationary
// and output-stationary dataflows of the paper and the depthwise fold, with
// the fused bias -> BN scale/shift -> residual add -> ReLU or ReLU6 ->
// 2x2/2 max-pool epilogue, in fp32 and int8; and the partial-sum staging
// formulation of the weight-stationary dataflow (the paper's Fig. 5).
//
// Replaces the Pallas TPU kernels repro/kernels/conv2d_ws.py:_ws_kernel,
// :_os_kernel, :_dw_kernel and :_ws_psum_kernel (all launched from
// conv2d_folded).  The Python wrapper (repro_torch/kernels/conv2d_ws.py)
// pads every operand to the fold plan (fold_kernel_spec), picks the CTA
// tile (fold_tile), allocates the output and the WS slab, and checks the
// error code each entry returns.
//
// Operands (contiguous; x and w are fp32, or int8 for the *_i8 entries):
//   x    (N, C_pad, X_rows, Yp)   pre-padded input
//   w    (NF_pad, C_pad/G, R, S)  dense or grouped; (C_pad, 1, R, S)
//                                 depthwise
//   vec  (NF_pad, 3)              bias, BN scale, BN shift per filter (fp32)
//   res  (N, NF_pad, P_pad, Q)    the fp32 shortcut, or null
//   out  (N, NF_pad, P_pad or P_pad/2, Q or Q/2), fp32
//   slab (N, NF_pad, P_pad, Q)     WS partial sums while g_c > 1, else null
//                                  (fp32, or int32 for int8)
//   psum (g_c, N, NF_pad, P_pad, Q) fold_conv_psum's staging buffer, fp32
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
// The WS and OS kernels (ws_kernel, os_kernel; they replace _ws_kernel and
// _os_kernel, fp32 and int8) share one tile core: a fold interaction as an
// implicit GEMM, M = output pixels flattened over (n, p, q) (2x2 quads of
// them where the pool is fused, so each pool window is finished in one
// thread), N = the filters of one group, K = the group's (c, r, s) taps.
// A CTA owns BM pixels x BN filters (a Tile); each thread keeps TM x TN
// accumulators in registers and feeds them from shared memory, TM pixels
// and TN filters per tap read as 16-byte (or 8-byte) words, operands read
// PF taps ahead.  K streams in chunks of BK taps.  The input taps of the
// tile's pixels (an im2col slice of the pre-padded input, whose rows are
// not 16-byte aligned: Yp is 226, 34, 18, so no TMA and no vector copy)
// are gathered into registers while the previous chunk's FFMAs issue and
// stored into a two-stage ring; a k -> offset table in shared memory and
// each thread's pixel offset in a register keep the gather to one
// broadcast shared read and an add per element.
//   OS: a CTA owns one output tile, keeps its accumulators across the
//       whole of K, and streams its filters' rows through a cp.async
//       ring PB chunks ahead.
//   WS: per depth fold, a CTA stages its filter tile (BN x c_b*R*S) once
//       by cp.async and keeps it resident while it walks its share of the
//       M tiles (the paper's Filter Fold held while Image Folds stream);
//       with g_c > 1 the partial sums of each tile go through the slab,
//       which only that CTA touches.
// Grouped (1 < G < C): a CTA's filter tile never straddles a group, and
// its channel base is group(f0) * C/G (the counterpart of _ix_ws_x); where
// NF/G < BN the tile's last filters are masked.  The wrapper picks the
// tile of each launch (conv2d_ws.py: fold_tile) from the launch spec and
// the SM count; the shared memory a tile needs is checked here again.
//
// Bound: the FFMA rate (67 TFLOP/s fp32) for every dense layer of the zoo.
// What binds the kernels instead (PERF.md): the gather, one 4-byte
// load per tap and pixel, which takes more issue slots and more latency
// than the TM*TN FFMAs it feeds where the tile is small; and, on the
// smallest layers (4x4 outputs, K up to 4608), too few outputs to put more
// than one or two warps on each SM scheduler, since nothing splits K.
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
// bits at every batch width and the two dataflows give the same bits.  The
// depthwise kernel is bound by bytes; one thread owns one output element
// and sums its R*S taps, R then S.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 256;     // __launch_bounds__ of dw / psum
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

// _flush_value on one finished sum of filter f: bias -> scale/shift ->
// residual -> ReLU or ReLU6.  Each step is rounded on its own: __fmul_rn /
// __fadd_rn keep nvcc from contracting v*scale + shift into one fmaf, so a
// fused layer gives the bits of the same steps run as separate torch ops.
__device__ __forceinline__ float epilogue(float v,
                                          const float* __restrict__ vec,
                                          int f, int epi, float res) {
  if (epi & EPI_BIAS) v = __fadd_rn(v, vec[3 * f]);
  if (epi & EPI_SCALE) {
    v = __fadd_rn(__fmul_rn(v, vec[3 * f + 1]), vec[3 * f + 2]);
  }
  if (epi & EPI_RESIDUAL) v = __fadd_rn(v, res);
  if (epi & EPI_RELU) v = v < 0.f ? 0.f : v;
  if (epi & EPI_RELU6) v = fminf(fmaxf(v, 0.f), 6.f);
  return v;
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
__device__ __forceinline__ void stage_elem(int* dst, const int8_t* src,
                                           bool ok) {
  *dst = ok ? static_cast<int>(__ldg(src)) : 0;
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
// a warp reads neighbouring pixels of one tap), then stored into a ring
// stage as [k][BM]
template <class TL, typename T>
__device__ __forceinline__ void fetch_a(T (&r)[BK * TL::BM / TL::THREADS],
                                        const T* __restrict__ x,
                                        const int* koff, int mb, int kbeg,
                                        int kend) {
  constexpr int KSTEP = TL::THREADS / TL::BM;
  const int kl0 = threadIdx.x / TL::BM;
#pragma unroll
  for (int i = 0; i < BK / KSTEP; ++i) {
    const int k = kbeg + kl0 + i * KSTEP;
    r[i] = (mb >= 0 && k < kend) ? __ldg(x + mb + koff[k]) : T(0);
  }
}

template <class TL, typename T, typename A>
__device__ __forceinline__ void store_a(
    A* a_s, const T (&r)[BK * TL::BM / TL::THREADS]) {
  constexpr int KSTEP = TL::THREADS / TL::BM;
  const int ml = threadIdx.x % TL::BM;
  const int kl0 = threadIdx.x / TL::BM;
#pragma unroll
  for (int i = 0; i < BK / KSTEP; ++i) {
    a_s[(kl0 + i * KSTEP) * TL::BM + ml] = static_cast<A>(r[i]);
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
  T ar[BK * TL::BM / TL::THREADS];
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
template <class TL, typename A>
__device__ __forceinline__ void flush(const A (&acc)[TL::TM][TL::TN],
                                      float* __restrict__ out,
                                      const float* __restrict__ vec,
                                      const float* __restrict__ res,
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
            const float r = residual ? res[at[k] + f * plane] : 0.f;
            v[k] = epilogue(to_float(acc[4 * iq + k][j]), vec, f, g.epi, r);
          }
          out[oat + f * oplane] = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
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
      const float r = residual ? res[at + f * plane] : 0.f;
      out[at + f * plane] = epilogue(to_float(acc[i][j]), vec, f, g.epi, r);
    }
  }
}

// WS partial sums of the tile to (STORE) or from the slab
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
      if (STORE) {
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
template <class TL, typename T, typename A>
__global__ void __launch_bounds__(TL::THREADS)
os_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const float* __restrict__ res,
          float* __restrict__ out, Geom g) {
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
template <class TL, typename T, typename A>
__global__ void __launch_bounds__(TL::THREADS)
ws_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const float* __restrict__ res,
          float* __restrict__ out, A* __restrict__ slab, Geom g) {
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

template <class TL>
size_t tile_smem(bool ws, const Dims& d) {
  const size_t words = (ws ? static_cast<size_t>(d.Kf) * TL::BNP
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
int launch_tile(bool ws, const void* x, const void* w, const void* vec,
                const void* res, void* out, void* slab, const Geom& g,
                cudaStream_t stream) {
  const Dims d = make_dims(g, TL::BN);
  const size_t smem = tile_smem<TL>(ws, d);
  if (smem > SMEM_LIMIT || g.c_pad % g.groups || g.nf_pad % g.groups ||
      d.cg % g.c_b || (d.pool && TL::TM % 4) || g.m_per_cta < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (d.M + TL::BM - 1) / TL::BM;
  const int gx = ws ? (m_tiles + g.m_per_cta - 1) / g.m_per_cta : m_tiles;
  const dim3 grid(gx, g.groups * d.tiles_per_group);
  if (gx == 0) return static_cast<int>(cudaSuccess);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* vf = static_cast<const float*>(vec);
  const auto* rf = static_cast<const float*>(res);
  auto* of = static_cast<float*>(out);
  cudaError_t err;
  if (ws) {
    err = allow_smem(ws_kernel<TL, T, A>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ws_kernel<TL, T, A><<<grid, TL::THREADS, smem, stream>>>(
        xt, wt, vf, rf, of, static_cast<A*>(slab), g);
  } else {
    err = allow_smem(os_kernel<TL, T, A>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    os_kernel<TL, T, A><<<grid, TL::THREADS, smem, stream>>>(xt, wt, vf, rf,
                                                             of, g);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_fold(int tile, bool ws, const void* x, const void* w,
                const void* vec, const void* res, void* out, void* slab,
                const Geom& g, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tile<Tile0, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 1: return launch_tile<Tile1, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 2: return launch_tile<Tile2, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 3: return launch_tile<Tile3, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 4: return launch_tile<Tile4, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 5: return launch_tile<Tile5, T, A>(ws, x, w, vec, res, out, slab, g, s);
    case 6: return launch_tile<Tile6, T, A>(ws, x, w, vec, res, out, slab, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Partial-sum staging: its own micro-tile loop (the one the WS and OS
// kernels had before the tile core), so that its numbers stay where they
// were
// ---------------------------------------------------------------------------

constexpr int PSUM_NFT = 8;  // filters per CTA sub-fold

struct PsumGeom {
  int n, c_pad, x_rows, yp;
  int nf_pad, r, s, stride;
  int q, p_pad;
  int nf_b, c_b, p_b;
  int mq;        // micro-tile columns per CTA tile
  int q_tiles;   // CTA tiles along Q
};

// One 2x2 micro-tile of the CTA tile: where it sits and which of its four
// outputs are real (rows past the P fold and columns past Q are not).
struct Micro {
  int prow, qcol;
  bool rv1, cv1;
};

// Copy the weight sub-fold [f0, f0+nvalid) x [c0, c0+nch) x R x S into
// shared memory as [c][r][s][PSUM_NFT]: one tap of all the sub-fold's
// filters is two 16-byte words, read as a broadcast.  Missing filters are
// zeros.
__device__ void psum_stage_weights(float* w_s, const float* __restrict__ w,
                                   const PsumGeom& g, int f0, int nvalid,
                                   int c0, int nch) {
  const int rs = g.r * g.s;
  const int total = nch * rs * PSUM_NFT;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i % PSUM_NFT;
    const int crs = i / PSUM_NFT;
    const int c = crs / rs;
    const int k = crs % rs;
    w_s[i] = j < nvalid
        ? w[(static_cast<size_t>(f0 + j) * g.c_pad + c0 + c) * rs + k]
        : 0.f;
  }
}

// _fold_partial: R*S stationary taps of nch channels against the strided
// input window of one micro-tile, accumulated into acc in fixed order.
__device__ __forceinline__ void psum_fold_partial(
    float (&acc)[PSUM_NFT][4], const float* __restrict__ xc0,
    const float* w_s, int nch, const PsumGeom& g, const Micro& m) {
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  const int col0 = m.qcol * g.stride;
  for (int c = 0; c < nch; ++c) {
    const float* xc = xc0 + c * plane;
    for (int r = 0; r < g.r; ++r) {
      const float* row0 =
          xc + static_cast<size_t>(m.prow * g.stride + r) * g.yp + col0;
      const float* row1 = row0 + static_cast<size_t>(g.stride) * g.yp;
      for (int s = 0; s < g.s; ++s) {
        const float4* wp = reinterpret_cast<const float4*>(
            w_s + ((c * g.r + r) * g.s + s) * PSUM_NFT);
        const float4 wa = wp[0];
        const float4 wb = wp[1];
        const float wv[PSUM_NFT] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
        float xv[4];
        xv[0] = __ldg(row0 + s);
        xv[1] = m.cv1 ? __ldg(row0 + s + g.stride) : 0.f;
        xv[2] = m.rv1 ? __ldg(row1 + s) : 0.f;
        xv[3] = (m.rv1 && m.cv1) ? __ldg(row1 + s + g.stride) : 0.f;
#pragma unroll
        for (int f = 0; f < PSUM_NFT; ++f) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[f][k] = fmaf(wv[f], xv[k], acc[f][k]);
        }
      }
    }
  }
}

__device__ __forceinline__ bool micro_tile(const PsumGeom& g, int t,
                                           int q_tile, int pf, Micro& m) {
  const int mrow = t / g.mq;
  const int mcol = t % g.mq;
  const int pl = 2 * mrow;
  m.qcol = 2 * (q_tile * g.mq + mcol);
  if (pl >= g.p_b || m.qcol >= g.q) return false;
  m.prow = pf * g.p_b + pl;
  m.rv1 = pl + 1 < g.p_b;
  m.cv1 = m.qcol + 1 < g.q;
  return true;
}

// Partial-sum staging (replaces _ws_psum_kernel, the paper's Fig. 5
// formulation): grid (Q tiles x P folds, filter sub-folds, N x depth
// folds).  A CTA stages one depth fold of its filter sub-fold, sums that
// fold's c_b channels x R x S taps for each micro-tile, c then r then s,
// and writes the fold's partial sums to its own slice of the staging
// buffer (g_c, N, NF_pad, P_pad, Q).  Nothing is flushed: the caller sums
// the folds afterwards, through device memory.
__global__ void __launch_bounds__(MAX_THREADS)
psum_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ psum, PsumGeom g) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  const int subs = (g.nf_b + PSUM_NFT - 1) / PSUM_NFT;
  const int sub = blockIdx.y % subs;
  const int f0 = (blockIdx.y / subs) * g.nf_b + sub * PSUM_NFT;
  const int nvalid = min(PSUM_NFT, g.nf_b - sub * PSUM_NFT);
  const int g_c = g.c_pad / g.c_b;
  const int cf = blockIdx.z % g_c;
  const int nidx = blockIdx.z / g_c;
  const int q_tile = blockIdx.x % g.q_tiles;
  const int pf = blockIdx.x / g.q_tiles;
  const int tile = ((g.p_b + 1) / 2) * g.mq;
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  psum_stage_weights(w_s, w, g, f0, nvalid, cf * g.c_b, g.c_b);
  __syncthreads();
  const float* xc0 =
      x + (static_cast<size_t>(nidx) * g.c_pad + cf * g.c_b) * plane;
  float* fold =
      psum + static_cast<size_t>(cf) * g.n * g.nf_pad * g.p_pad * g.q;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    Micro m;
    if (!micro_tile(g, t, q_tile, pf, m)) continue;
    float acc[PSUM_NFT][4];
#pragma unroll
    for (int j = 0; j < PSUM_NFT; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
    }
    psum_fold_partial(acc, xc0, w_s, g.c_b, g, m);
    for (int j = 0; j < nvalid; ++j) {
      float* o = fold + (static_cast<size_t>(nidx) * g.nf_pad + f0 + j) *
                            g.p_pad * g.q;
      o[m.prow * g.q + m.qcol] = acc[j][0];
      if (m.cv1) o[m.prow * g.q + m.qcol + 1] = acc[j][1];
      if (m.rv1) o[(m.prow + 1) * g.q + m.qcol] = acc[j][2];
      if (m.rv1 && m.cv1) o[(m.prow + 1) * g.q + m.qcol + 1] = acc[j][3];
    }
  }
}

struct DwGeom {
  int n, c, c_pad, x_rows, yp;
  int r, s, stride;
  int q, p_pad;
  int epi;
};

// Depthwise (replaces _dw_kernel): one thread per output element of the
// layer's own C channels, a grid-stride loop over (N, C, P_pad, Q), Q
// fastest so a warp reads neighbouring input columns.  The channel's R*S
// taps come through the read-only cache (a warp's threads mostly share
// one channel, so each tap load is a broadcast); the sum runs R then S in
// one thread, and the epilogue flushes at once: there is no depth fold.
// Channels C..C_pad-1 of the output are padding and are not written.
template <typename T, typename A>
__global__ void __launch_bounds__(MAX_THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const float* __restrict__ res,
          float* __restrict__ out, DwGeom g) {
  const bool pool = g.epi & EPI_POOL;
  const int span = pool ? 2 : 1;
  const int qo = g.q / span;
  const int po = g.p_pad / span;
  const long long total = static_cast<long long>(g.n) * g.c * po * qo;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int oq = static_cast<int>(i % qo);
    long long t = i / qo;
    const int op = static_cast<int>(t % po);
    t /= po;
    const int c = static_cast<int>(t % g.c);
    const int nidx = static_cast<int>(t / g.c);
    const size_t plane = static_cast<size_t>(nidx) * g.c_pad + c;
    const T* xc = x + plane * g.x_rows * g.yp;
    const T* wc = w + static_cast<size_t>(c) * g.r * g.s;
    const float* rp = (g.epi & EPI_RESIDUAL)
        ? res + plane * g.p_pad * g.q : nullptr;
    float best = 0.f;
    for (int dp = 0; dp < span; ++dp) {
      for (int dq = 0; dq < span; ++dq) {
        const int p = op * span + dp;
        const int q = oq * span + dq;
        A acc = A(0);
        for (int r = 0; r < g.r; ++r) {
          const T* row =
              xc + static_cast<size_t>(p * g.stride + r) * g.yp + q * g.stride;
          for (int s = 0; s < g.s; ++s) {
            acc = mac(static_cast<A>(__ldg(row + s)),
                      static_cast<A>(__ldg(wc + r * g.s + s)), acc);
          }
        }
        const float v = epilogue(to_float(acc), vec, c, g.epi,
                                 rp ? rp[static_cast<size_t>(p) * g.q + q]
                                    : 0.f);
        best = (dp == 0 && dq == 0) ? v : fmaxf(best, v);
      }
    }
    out[(plane * po + op) * qo + oq] = best;
  }
}


template <typename T, typename A>
int launch_dw(const void* x, const void* w, const void* vec, const void* res,
              void* out, int n, int c, int c_pad, int x_rows, int yp, int r,
              int s, int stride, int q, int p_pad, int epi, void* stream) {
  const DwGeom g{n, c, c_pad, x_rows, yp, r, s, stride, q, p_pad, epi};
  const int span = (epi & EPI_POOL) ? 2 : 1;
  const long long total =
      static_cast<long long>(n) * c * (p_pad / span) * (q / span);
  // enough CTAs to fill every SM several times over; the grid-stride loop
  // covers the rest
  const long long want = (total + MAX_THREADS - 1) / MAX_THREADS;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  if (blocks > 0) {
    dw_kernel<T, A>
        <<<blocks, MAX_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(w),
            static_cast<const float*>(vec), static_cast<const float*>(res),
            static_cast<float*>(out), g);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_psum(const void* x, const void* w, void* psum, int n, int c_pad,
                int x_rows, int yp, int nf_pad, int r, int s, int stride,
                int q, int p_pad, int nf_b, int c_b, int p_b, void* stream) {
  // the CTA tile inside one P fold: all ceil(p_b/2) micro-tile rows by mq
  // micro-tile columns (2x2 outputs each)
  const int mrows = (p_b + 1) / 2;
  const int mcols = (q + 1) / 2;
  const int mq = max(1, min(mcols, MAX_THREADS / mrows));
  const int threads = min(MAX_THREADS, (mrows * mq + 31) / 32 * 32);
  const size_t smem = sizeof(float) * PSUM_NFT * c_b * r * s;
  if (mrows > MAX_THREADS || smem > SMEM_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PsumGeom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad,
                   nf_b, c_b, p_b, mq, (mcols + mq - 1) / mq};
  const cudaError_t err = allow_smem(psum_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.q_tiles * (p_pad / p_b),
                  (nf_pad / nf_b) * ((nf_b + PSUM_NFT - 1) / PSUM_NFT),
                  n * (c_pad / c_b));
  psum_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(psum), g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* fold_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The dense entries: the operands, then n, c_pad, x_rows, yp, nf_pad, r, s,
// stride, q, p_pad, groups, c_b, epi, the tile (Tile0..Tile6) and, for WS,
// the M tiles one CTA walks.

int fold_conv_ws(const void* x, const void* w, const void* vec,
                 const void* res, void* out, void* slab, int n, int c_pad,
                 int x_rows, int yp, int nf_pad, int r, int s, int stride,
                 int q, int p_pad, int groups, int c_b, int epi, int tile,
                 int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, m_per_cta};
  return launch_fold<float, float>(tile, true, x, w, vec, res, out, slab, g,
                                   stream);
}

int fold_conv_ws_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, void* slab, int n, int c_pad,
                    int x_rows, int yp, int nf_pad, int r, int s, int stride,
                    int q, int p_pad, int groups, int c_b, int epi, int tile,
                    int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, m_per_cta};
  return launch_fold<int8_t, int>(tile, true, x, w, vec, res, out, slab, g,
                                  stream);
}

int fold_conv_os(const void* x, const void* w, const void* vec,
                 const void* res, void* out, int n, int c_pad, int x_rows,
                 int yp, int nf_pad, int r, int s, int stride, int q,
                 int p_pad, int groups, int c_b, int epi, int tile,
                 void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, 1};
  return launch_fold<float, float>(tile, false, x, w, vec, res, out, nullptr,
                                   g, stream);
}

int fold_conv_os_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, int n, int c_pad, int x_rows,
                    int yp, int nf_pad, int r, int s, int stride, int q,
                    int p_pad, int groups, int c_b, int epi, int tile,
                    void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, 1};
  return launch_fold<int8_t, int>(tile, false, x, w, vec, res, out, nullptr,
                                  g, stream);
}

int fold_conv_dw(const void* x, const void* w, const void* vec,
                 const void* res, void* out, int n, int c, int c_pad,
                 int x_rows, int yp, int r, int s, int stride, int q,
                 int p_pad, int epi, void* stream) {
  return launch_dw<float, float>(x, w, vec, res, out, n, c, c_pad, x_rows,
                                 yp, r, s, stride, q, p_pad, epi, stream);
}

int fold_conv_dw_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, int n, int c, int c_pad,
                    int x_rows, int yp, int r, int s, int stride, int q,
                    int p_pad, int epi, void* stream) {
  return launch_dw<int8_t, int>(x, w, vec, res, out, n, c, c_pad, x_rows,
                                yp, r, s, stride, q, p_pad, epi, stream);
}

int fold_conv_psum(const void* x, const void* w, void* psum, int n,
                   int c_pad, int x_rows, int yp, int nf_pad, int r, int s,
                   int stride, int q, int p_pad, int nf_b, int c_b, int p_b,
                   void* stream) {
  return launch_psum(x, w, psum, n, c_pad, x_rows, yp, nf_pad, r, s, stride,
                     q, p_pad, nf_b, c_b, p_b, stream);
}

}  // extern "C"

// The bf16 weight-stationary and psum-staging fold kernels on Hopper's
// tensor cores (sm_90a): ws_tc_kernel replaces the Pallas TPU kernel
// repro/kernels/conv2d_ws.py:_ws_kernel and psum_tc_kernel :_ws_psum_kernel
// on bf16 operands (which the JAX package's _fold_partial widens to fp32,
// so its sums are fp32 of exact bf16 products, as here).  fold_conv_bf16.cu
// holds their entry points; fold_conv.cuh the geometry (Geom, Dims), the
// k -> offset table, the epilogue and the stores they share with the FFMA
// tile core, which still runs every fp32 and int8 kernel and the bf16 OS
// and depthwise ones.
//
// The same implicit GEMM as the FFMA core: M = output pixels flattened over
// (n, p, q) (2x2 quads of them where the pool is fused), N = one group's
// filters, K = the group's (c, r, s) taps, a depth fold of Kf = c_b*R*S of
// them at a time.  A CTA tile (TcTile) is BM pixels x BN filters, WM x WN
// warps, each warp a WTM x WTN block of m16n8 fp32 accumulators:
//   - per depth fold a CTA stages its filter tile once, bf16, as
//     [BN][kpad + 8] (kpad = Kf rounded up to 16; the taps past Kf are
//     zeros), k contiguous per filter, so B's fragments come from
//     ldmatrix.x4 without .trans; the row is 16 bytes longer than the taps
//     so that the 8 rows of an ldmatrix fall in 8 different bank groups;
//   - it walks its share of the M tiles past it (the paper's Filter Fold
//     held while the Image Folds stream), the input gathered TC_BK = 64
//     taps at a time into a two-stage ring [TC_BK][BM + 8] of bf16,
//     pixels contiguous per tap (A's fragments by ldmatrix.x4.trans);
//   - each warp runs mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (mma.cuh)
//     per 16-tap step: its A fragments and B fragments by ldmatrix, then
//     its MI x NJ MMAs.
// The gather is the FFMA core's: the k -> offset table fill_koff, each
// pixel's first input element in a register, the pixels of one tap across
// a warp, one 2-byte load per tap and pixel (the pre-padded rows, Yp 226,
// 34 or 18, are not 16-byte aligned: no TMA, no vector copy); a thread
// gathers two neighbouring pixels into registers two chunks ahead of the
// MMAs and packs each pair into one 32-bit shared store; the filter tile
// is staged by 16-byte cp.async, in flight while the first chunk gathers.
// The epilogue stages the finished fp32 tile through shared memory (the
// input ring's bytes, [BN][BM + 4]): an m16n8 fragment gives a lane rows
// g and g+8, not a 2x2 quad.  From there the FFMA core's steps run per
// output: bias -> scale/shift -> residual -> ReLU(6) -> 2x2 max, each step
// rounded on its own (__fmul_rn / __fadd_rn), one bf16 rounding at the
// store, neighbouring pixels on neighbouring lanes.  With g_c > 1 depth
// folds the sums go through an fp32 slab between folds (exact), which only
// the CTA that owns the tile touches; psum stores each fold's sums rounded
// to bf16 into its own slice of the staging buffer, as the JAX package's
// staging buffer has the output's type.
//
// The sum order, the bitwise contract: each output's sum is a chain of
// MMAs over 16-tap steps.  The chain starts from 0 at its first depth
// fold's first tap, runs in ascending k (c, then r, then s) and carries the
// accumulator in registers within a fold, and through the fp32 slab from
// one fold to the next; the taps past Kf in a fold's last step are zero
// weights times zero inputs.  The step boundaries depend on (C/G, R, S,
// c_b) alone: never on N, BM, BN, the grid, m_per_cta or the epilogue, and
// an MMA computes each output from its own row, column and accumulator.
// No split K, no atomics.  So a bf16 trunk gives the same bits at every
// batch width and with every tile; it does not give the bits of the FFMA
// OS kernel on the same layer (one fmaf a tap).
//
// Bound: the bf16 tensor-core rate (989 TFLOP/s dense) for every dense
// layer of the zoo; what binds these kernels is the gather, one 2-byte
// load (and its share of an address add and a shared store) per tap,
// pixel and filter tile, BN multiply-adds per load, and on the deepest
// layers its latency: a chunk takes about as long whatever its work, and
// two chunks of loads in flight (tc_run) only partly hide it.  The loads
// stay straight-line and predicated: a per-tap branch to one 32-bit load
// for an aligned pixel pair ran 1.8x slower (PERF.md).  The tile set
// trades BN against shared memory: the resident filter tile takes
// 2*BN*(kpad + 8) bytes, 147 KB at Kf 4608 and BN 16, so VGG-16's deepest
// layers run BN 16 and BN 64 fits up to Kf 1152.

#pragma once

#include "fold_conv.cuh"
#include "mma.cuh"

namespace {

// Taps a chunk of the gather.  The gather is latency-bound on the deep
// layers (VGG-16's Kf 4608 ones spent ~1,750 cycles a chunk with one
// chunk of 32 taps in flight, PERF.md): a thread keeps two chunks of 64
// taps of its two pixels in flight (tc_run)
constexpr int TC_BK = 64;

// A tensor-core CTA tile: WM x WN warps, each owning WTM pixels x WTN
// filters of the tile in m16n8 accumulators (MI x NJ of them).  A thread
// gathers two neighbouring pixels of the tile, every KSTEP-th tap of a
// chunk.
template <int WTM_, int WTN_, int WM_, int WN_>
struct TcTile {
  static constexpr int WTM = WTM_, WTN = WTN_, WM = WM_, WN = WN_;
  static constexpr int BM = WTM * WM, BN = WTN * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = WTM / 16, NJ = WTN / 8;
  static constexpr int LDA = BM + 8;   // bf16 row of the input ring: a tap
  static constexpr int LDC = BM + 4;   // fp32 row of the staged tile
  static constexpr int PAIRS = BM / 2;
  static constexpr int KSTEP = THREADS / PAIRS;
  static constexpr int TAPS = TC_BK / KSTEP;  // taps a thread gathers
  static_assert(WTM % 16 == 0 && WTN % 16 == 0,
                "a warp's block is whole m16 rows and ldmatrix.x4 n16 pairs");
  static_assert(THREADS % PAIRS == 0 && TC_BK % KSTEP == 0 &&
                    TC_BK % 16 == 0,
                "each thread gathers one pixel pair of the tile");
};

// The tiles the wrapper picks from (TC_TILES in conv2d_ws.py, same order)
using TcTile0 = TcTile<16, 16, 4, 1>;   //  64 x 16, 128 threads
using TcTile1 = TcTile<16, 16, 8, 1>;   // 128 x 16, 256
using TcTile2 = TcTile<16, 32, 4, 1>;   //  64 x 32, 128
using TcTile3 = TcTile<32, 16, 4, 2>;   // 128 x 32, 256
using TcTile4 = TcTile<32, 32, 2, 2>;   //  64 x 64, 128
using TcTile5 = TcTile<32, 32, 4, 2>;   // 128 x 64, 256

// A depth fold's taps rounded up to whole 16-tap MMA steps
__host__ __device__ inline int tc_kpad(int kf) { return (kf + 15) / 16 * 16; }

// Shared memory of a launch: the resident filter tile, the input ring
// (which also holds the staged fp32 tile), the k offset table
template <class TC>
__host__ __device__ inline size_t tc_ring_bytes() {
  const size_t ring = 2ull * 2 * TC_BK * TC::LDA;
  const size_t tile = 4ull * TC::BN * TC::LDC;
  return ring > tile ? ring : tile;
}
template <class TC>
size_t tc_smem(const Dims& d) {
  return 2ull * TC::BN * (tc_kpad(d.Kf) + 8) + tc_ring_bytes<TC>() +
         4ull * d.K;
}

// The filter tile's depth fold [k0, k0 + Kf) into b_s as [BN][kpad + 8],
// zeros past Kf and past the real filters: 16-byte cp.async copies, all in
// flight at once, where every row of the fold starts on a 16-byte boundary
// (tc_run waits for them), else pairs of 2-byte loads.
template <class TC>
__device__ void tc_load_b(bf16* b_s, const bf16* __restrict__ w, int K,
                          int Kf, int k0, int f0, int nvalid) {
  const int kp = tc_kpad(Kf);
  const int ld = kp + 8;
  if (K % 8 == 0 && Kf % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    const int per = kp / 8;
    for (int e = threadIdx.x; e < TC::BN * per; e += TC::THREADS) {
      const int n = e / per;
      const int k = 8 * (e - n * per);
      const bool ok = n < nvalid && k < Kf;
      cp_async16(b_s + n * ld + k,
                 ok ? w + static_cast<size_t>(f0 + n) * K + k0 + k : w, ok);
    }
    cp_async_commit();
  } else {
    const int per = kp / 2;
    for (int e = threadIdx.x; e < TC::BN * per; e += TC::THREADS) {
      const int n = e / per;
      const int k = 2 * (e - n * per);
      unsigned lo = 0u, hi = 0u;
      if (n < nvalid) {
        const auto* row = reinterpret_cast<const unsigned short*>(
            w + static_cast<size_t>(f0 + n) * K + k0);
        if (k < Kf) lo = __ldg(row + k);
        if (k + 1 < Kf) hi = __ldg(row + k + 1);
      }
      *reinterpret_cast<unsigned*>(b_s + n * ld + k) = lo | (hi << 16);
    }
  }
}

// The input taps [kbeg, kbeg + TC_BK) of this thread's two pixels (first
// elements mb0, mb1; -1 past M) into registers, zeros at or past kend
template <class TC>
__device__ __forceinline__ void tc_fetch(unsigned (&r)[2][TC::TAPS],
                                         const bf16* __restrict__ x,
                                         const int* koff, int mb0, int mb1,
                                         int kbeg, int kend) {
  const auto* xs = reinterpret_cast<const unsigned short*>(x);
  const int kl0 = threadIdx.x / TC::PAIRS;
#pragma unroll
  for (int i = 0; i < TC::TAPS; ++i) {
    const int k = kbeg + kl0 + i * TC::KSTEP;
    const bool in = k < kend;
    const int o = in ? koff[k] : 0;
    r[0][i] = in && mb0 >= 0 ? __ldg(xs + mb0 + o) : 0u;
    r[1][i] = in && mb1 >= 0 ? __ldg(xs + mb1 + o) : 0u;
  }
}

// ... and into a ring stage [TC_BK][LDA], the pair as one 32-bit store
template <class TC>
__device__ __forceinline__ void tc_store(bf16* a_s,
                                         const unsigned (&r)[2][TC::TAPS]) {
  const int ml = 2 * (threadIdx.x % TC::PAIRS);
  const int kl0 = threadIdx.x / TC::PAIRS;
#pragma unroll
  for (int i = 0; i < TC::TAPS; ++i) {
    *reinterpret_cast<unsigned*>(a_s + (kl0 + i * TC::KSTEP) * TC::LDA + ml) =
        r[0][i] | (r[1][i] << 16);
  }
}

// The MMAs of one chunk: `steps` 16-tap steps, in k order.  a_s is the
// chunk's ring stage, b_s the resident tile at the chunk's first tap.
template <class TC>
__device__ __forceinline__ void tc_mma(float (&acc)[TC::MI][TC::NJ][4],
                                       const bf16* a_s, const bf16* b_s,
                                       int ldb, int steps, int wm0, int wn0,
                                       int lane) {
  // ldmatrix.x4 rows: A (.trans) matrices (m0, k0), (m0+8, k0), (m0,
  // k0+8), (m0+8, k0+8); B matrices (n0, k0), (n0, k0+8), (n0+8, k0),
  // (n0+8, k0+8)
  const int lr = (lane & 7) + ((lane >> 4) << 3);
  const int lc = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kk = 0; kk < TC_BK / 16; ++kk) {
    if (kk < steps) {
      uint32_t a[TC::MI][4], b[TC::NJ / 2][4];
#pragma unroll
      for (int i = 0; i < TC::MI; ++i) {
        ldsm_x4_trans(a[i], a_s + (16 * kk + lr) * TC::LDA + wm0 + 16 * i + lc);
      }
#pragma unroll
      for (int j = 0; j < TC::NJ / 2; ++j) {
        ldsm_x4(b[j], b_s + (wn0 + 16 * j + lr) * ldb + 16 * kk + lc);
      }
#pragma unroll
      for (int i = 0; i < TC::MI; ++i) {
#pragma unroll
        for (int j = 0; j < TC::NJ; ++j) {
          mma_bf16(acc[i][j], a[i], b[j / 2][2 * (j & 1)],
                   b[j / 2][2 * (j & 1) + 1]);
        }
      }
    }
  }
}

// One depth fold [kbeg, kbeg + Kf) of the tile's sums: the input's two-stage
// ring, chunk kc+2 gathered into registers while chunk kc's MMAs issue and
// chunk kc+1 is stored, one barrier a chunk (the last one too: the ring is
// free when this returns).
template <class TC>
__device__ void tc_run(float (&acc)[TC::MI][TC::NJ][4],
                       const bf16* __restrict__ x, bf16* a_ring,
                       const bf16* b_res, int ldb, const int* koff, int mb0,
                       int mb1, int kbeg, int Kf, int wm0, int wn0,
                       int lane) {
  const int kend = kbeg + Kf;
  const int steps = tc_kpad(Kf) / 16;
  const int nk = (steps * 16 + TC_BK - 1) / TC_BK;
  // two register sets: chunk kc+2's loads are in flight while chunk kc's
  // MMAs issue and chunk kc+1 is stored (the loop is unrolled by two so
  // that each set stays in registers)
  unsigned ra[2][TC::TAPS], rb[2][TC::TAPS];
  tc_fetch<TC>(ra, x, koff, mb0, mb1, kbeg, kend);
  tc_store<TC>(a_ring, ra);
  if (nk > 1) tc_fetch<TC>(rb, x, koff, mb0, mb1, kbeg + TC_BK, kend);
  cp_async_wait_all();  // the resident filter tile, on a fold's first tile
  __syncthreads();
  bf16* const stage1 = a_ring + TC_BK * TC::LDA;
  for (int kc = 0; kc < nk; kc += 2) {
    if (kc + 2 < nk) {
      tc_fetch<TC>(ra, x, koff, mb0, mb1, kbeg + (kc + 2) * TC_BK, kend);
    }
    tc_mma<TC>(acc, a_ring, b_res + kc * TC_BK, ldb,
               steps - kc * (TC_BK / 16), wm0, wn0, lane);
    if (kc + 1 < nk) tc_store<TC>(stage1, rb);
    __syncthreads();
    if (kc + 1 >= nk) break;
    if (kc + 3 < nk) {
      tc_fetch<TC>(rb, x, koff, mb0, mb1, kbeg + (kc + 3) * TC_BK, kend);
    }
    tc_mma<TC>(acc, stage1, b_res + (kc + 1) * TC_BK, ldb,
               steps - (kc + 1) * (TC_BK / 16), wm0, wn0, lane);
    if (kc + 2 < nk) tc_store<TC>(a_ring, ra);
    __syncthreads();
  }
}

// The accumulators to (STAGE) or from the staged tile c_s [BN][LDC]
template <class TC, bool STAGE>
__device__ __forceinline__ void tc_tile_io(float (&acc)[TC::MI][TC::NJ][4],
                                           float* c_s, int wm0, int wn0,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < TC::MI; ++i) {
#pragma unroll
    for (int j = 0; j < TC::NJ; ++j) {
      float* c = c_s + (wn0 + 8 * j + 2 * t) * TC::LDC + wm0 + 16 * i + g;
      float* e[4] = {c, c + TC::LDC, c + 8, c + TC::LDC + 8};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if constexpr (STAGE) {
          *e[v] = acc[i][j][v];
        } else {
          acc[i][j][v] = *e[v];
        }
      }
    }
  }
}

// The staged tile's raw sums to their pixels of dst (N, NF_pad, P_pad, Q):
// the WS slab (fp32) or a psum fold's slice (bf16, rounded once); or
// (LOAD) the slab's partial sums into the staged tile, zeros where there
// is no output
template <class TC, bool LOAD, typename S>
__device__ void tc_slab_io(float* c_s, S* __restrict__ dst, const Geom& g,
                           const Dims& d, int m0, int f0, int nvalid) {
  for (int e = threadIdx.x; e < TC::BN * TC::BM; e += TC::THREADS) {
    const int fl = e / TC::BM;
    const int ml = e - fl * TC::BM;
    float* c = c_s + fl * TC::LDC + ml;
    if (m0 + ml >= d.M || fl >= nvalid) {
      if constexpr (LOAD) *c = 0.f;
      continue;
    }
    int n, p, q;
    pixel(g, d, m0 + ml, n, p, q);
    S* s = dst + ((static_cast<size_t>(n) * g.nf_pad + f0 + fl) * g.p_pad +
                  p) * g.q + q;
    if constexpr (LOAD) {
      *c = *s;
    } else {
      put(s, *c);
    }
  }
}

// _flush_value on the staged tile: the epilogue of each finished sum, the
// 2x2 max of each quad where the pool is fused, one bf16 store an output
template <class TC>
__device__ void tc_flush(const float* c_s, bf16* __restrict__ out,
                         const float* __restrict__ vec,
                         const bf16* __restrict__ res, const Geom& g,
                         const Dims& d, int m0, int f0, int nvalid) {
  const bool residual = g.epi & EPI_RESIDUAL;
  if (d.pool) {
    constexpr int QUADS = TC::BM / 4;
    const size_t oplane = static_cast<size_t>(d.po) * d.qo;
    for (int e = threadIdx.x; e < TC::BN * QUADS; e += TC::THREADS) {
      const int fl = e / QUADS;
      const int u = e - fl * QUADS;
      const int m = m0 + 4 * u;
      if (m >= d.M || fl >= nvalid) continue;
      const int f = f0 + fl;
      const float4 s4 =
          *reinterpret_cast<const float4*>(c_s + fl * TC::LDC + 4 * u);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      float v[4];
      int n, p, q;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pixel(g, d, m + k, n, p, q);
        const float r =
            residual
                ? widen(res[((static_cast<size_t>(n) * g.nf_pad + f) * g.p_pad +
                             p) * g.q + q])
                : 0.f;
        v[k] = epilogue(s[k], vec, f, g.epi, r);
      }
      // (p, q) is the quad's last pixel: p / 2 and q / 2 are its window
      put(out + (static_cast<size_t>(n) * g.nf_pad + f) * oplane +
                static_cast<size_t>(p / 2) * d.qo + q / 2,
          fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])));
    }
    return;
  }
  for (int e = threadIdx.x; e < TC::BN * TC::BM; e += TC::THREADS) {
    const int fl = e / TC::BM;
    const int ml = e - fl * TC::BM;
    if (m0 + ml >= d.M || fl >= nvalid) continue;
    const int f = f0 + fl;
    int n, p, q;
    pixel(g, d, m0 + ml, n, p, q);
    const size_t at =
        ((static_cast<size_t>(n) * g.nf_pad + f) * g.p_pad + p) * g.q + q;
    const float r = residual ? widen(res[at]) : 0.f;
    put(out + at, epilogue(c_s[fl * TC::LDC + ml], vec, f, g.epi, r));
  }
}

// What both kernels share: the CTA's filter tile and shared memory
struct TcCta {
  int f0, nvalid, cbase, ldb;
  bf16* b_res;
  bf16* a_ring;
  float* c_s;
  int* koff;
};

template <class TC>
__device__ __forceinline__ TcCta tc_cta(void* smem, const Geom& g,
                                        const Dims& d) {
  TcCta c;
  filter_tile(d, TC::BN, c.f0, c.nvalid, c.cbase);
  c.ldb = tc_kpad(d.Kf) + 8;
  c.b_res = static_cast<bf16*>(smem);
  c.a_ring = c.b_res + TC::BN * c.ldb;
  c.c_s = reinterpret_cast<float*>(c.a_ring);
  c.koff = reinterpret_cast<int*>(reinterpret_cast<char*>(c.a_ring) +
                                  tc_ring_bytes<TC>());
  fill_koff(c.koff, g, d, TC::THREADS);
  return c;
}

template <class TC>
__device__ __forceinline__ void tc_zero(float (&acc)[TC::MI][TC::NJ][4]) {
#pragma unroll
  for (int i = 0; i < TC::MI; ++i) {
#pragma unroll
    for (int j = 0; j < TC::NJ; ++j) {
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    }
  }
}

// Weight-stationary: grid (M-tile shares, groups x filter tiles).  Per
// depth fold a CTA stages its filter tile, then walks its m_per_cta M tiles
// past it; with g_c > 1 the partial sums go through the slab.
template <class TC>
__global__ void __launch_bounds__(TC::THREADS)
ws_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ vec, const bf16* __restrict__ res,
             bf16* __restrict__ out, float* __restrict__ slab, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TC::BN);
  const TcCta c = tc_cta<TC>(smem4, g, d);
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const int g_c = d.cg / g.c_b;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm0 = warp % TC::WM * TC::WTM;
  const int wn0 = warp / TC::WM * TC::WTN;
  const int pl = 2 * (threadIdx.x % TC::PAIRS);
  for (int cf = 0; cf < g_c; ++cf) {
    __syncthreads();  // the previous depth fold's tile is no longer read
    tc_load_b<TC>(c.b_res, w, d.K, d.Kf, cf * d.Kf, c.f0, c.nvalid);
    for (int mt = mt_lo; mt < mt_hi; ++mt) {
      const int m0 = mt * TC::BM;
      const int mb0 = row_base(g, d, m0 + pl, c.cbase);
      const int mb1 = row_base(g, d, m0 + pl + 1, c.cbase);
      float acc[TC::MI][TC::NJ][4];
      tc_zero<TC>(acc);
      __syncthreads();  // the last tile's staged sums are no longer read
      if (cf > 0) {
        tc_slab_io<TC, true>(c.c_s, slab, g, d, m0, c.f0, c.nvalid);
        __syncthreads();
        tc_tile_io<TC, false>(acc, c.c_s, wm0, wn0, lane);
        __syncthreads();  // before the ring, the same bytes, is written
      }
      tc_run<TC>(acc, x, c.a_ring, c.b_res, c.ldb, c.koff, mb0, mb1,
                 cf * d.Kf, d.Kf, wm0, wn0, lane);
      tc_tile_io<TC, true>(acc, c.c_s, wm0, wn0, lane);
      __syncthreads();
      if (cf == g_c - 1) {
        tc_flush<TC>(c.c_s, out, vec, res, g, d, m0, c.f0, c.nvalid);
      } else {
        tc_slab_io<TC, false>(c.c_s, slab, g, d, m0, c.f0, c.nvalid);
      }
    }
  }
}

// Partial-sum staging (the paper's Fig. 5 formulation): grid (M-tile
// shares, filter tiles, depth folds).  A CTA stages depth fold blockIdx.z's
// filter tile, runs that fold's taps from zero for each of its M tiles and
// stores the sums, rounded to bf16, to the fold's own slice of the (g_c, N,
// NF_pad, P_pad, Q) staging buffer; the caller sums the folds.  Dense,
// identity epilogue.
template <class TC>
__global__ void __launch_bounds__(TC::THREADS)
psum_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               bf16* __restrict__ psum, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TC::BN);
  const TcCta c = tc_cta<TC>(smem4, g, d);
  const int cf = blockIdx.z;
  bf16* fold = psum + static_cast<size_t>(cf) * g.n * g.nf_pad * g.p_pad * g.q;
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm0 = warp % TC::WM * TC::WTM;
  const int wn0 = warp / TC::WM * TC::WTN;
  const int pl = 2 * (threadIdx.x % TC::PAIRS);
  tc_load_b<TC>(c.b_res, w, d.K, d.Kf, cf * d.Kf, c.f0, c.nvalid);
  for (int mt = mt_lo; mt < mt_hi; ++mt) {
    const int m0 = mt * TC::BM;
    const int mb0 = row_base(g, d, m0 + pl, c.cbase);
    const int mb1 = row_base(g, d, m0 + pl + 1, c.cbase);
    float acc[TC::MI][TC::NJ][4];
    tc_zero<TC>(acc);
    __syncthreads();  // the last tile's staged sums are no longer read
    tc_run<TC>(acc, x, c.a_ring, c.b_res, c.ldb, c.koff, mb0, mb1,
               cf * d.Kf, d.Kf, wm0, wn0, lane);
    tc_tile_io<TC, true>(acc, c.c_s, wm0, wn0, lane);
    __syncthreads();
    tc_slab_io<TC, false>(c.c_s, fold, g, d, m0, c.f0, c.nvalid);
  }
}

template <class TC>
int launch_tc_tile(int kind, const void* x, const void* w, const void* vec,
                   const void* res, void* out, void* slab, const Geom& g,
                   cudaStream_t stream) {
  const Dims d = make_dims(g, TC::BN);
  const size_t smem = tc_smem<TC>(d);
  if (kind == KIND_OS || smem > SMEM_LIMIT || g.c_pad % g.groups ||
      g.nf_pad % g.groups || d.cg % g.c_b || g.m_per_cta < 1 ||
      (kind == KIND_PSUM && (g.groups != 1 || g.epi != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int gx = (m_tiles + g.m_per_cta - 1) / g.m_per_cta;
  const dim3 grid(gx, g.groups * d.tiles_per_group,
                  kind == KIND_PSUM ? d.cg / g.c_b : 1);
  if (gx == 0) return static_cast<int>(cudaSuccess);
  const auto* xt = static_cast<const bf16*>(x);
  const auto* wt = static_cast<const bf16*>(w);
  cudaError_t err;
  if (kind == KIND_PSUM) {
    err = allow_smem(psum_tc_kernel<TC>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    psum_tc_kernel<TC><<<grid, TC::THREADS, smem, stream>>>(
        xt, wt, static_cast<bf16*>(slab), g);
  } else {
    err = allow_smem(ws_tc_kernel<TC>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ws_tc_kernel<TC><<<grid, TC::THREADS, smem, stream>>>(
        xt, wt, static_cast<const float*>(vec), static_cast<const bf16*>(res),
        static_cast<bf16*>(out), static_cast<float*>(slab), g);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 WS (KIND_WS) or psum (KIND_PSUM) launch with tensor-core tile
// `tile` (TcTile0..TcTile5)
int launch_fold_tc(int tile, int kind, const void* x, const void* w,
                   const void* vec, const void* res, void* out, void* slab,
                   const Geom& g, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tc_tile<TcTile0>(kind, x, w, vec, res, out, slab, g, s);
    case 1: return launch_tc_tile<TcTile1>(kind, x, w, vec, res, out, slab, g, s);
    case 2: return launch_tc_tile<TcTile2>(kind, x, w, vec, res, out, slab, g, s);
    case 3: return launch_tc_tile<TcTile3>(kind, x, w, vec, res, out, slab, g, s);
    case 4: return launch_tc_tile<TcTile4>(kind, x, w, vec, res, out, slab, g, s);
    case 5: return launch_tc_tile<TcTile5>(kind, x, w, vec, res, out, slab, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The bf16 fold kernels on Hopper's tensor cores (sm_90a): ws_tc_kernel
// replaces the Pallas TPU kernel repro/kernels/conv2d_ws.py:_ws_kernel,
// os_tc_kernel :_os_kernel and psum_tc_kernel :_ws_psum_kernel on bf16
// operands (which the JAX package's _fold_partial widens to fp32, so its
// sums are fp32 of exact bf16 products, as here).  fold_conv_bf16.cu holds
// their entry points; fold_conv.cuh the geometry (Geom, Dims), the k ->
// offset table, the epilogue and the stores they share with the FFMA tile
// core, which runs every fp32 and int8 kernel and the bf16 depthwise one.
//
// The same implicit GEMM as the FFMA core: M = output pixels flattened over
// (n, p, q) (2x2 quads of them where the pool is fused), N = one group's
// filters, K = the group's (c, r, s) taps, a depth fold of Kf = c_b*R*S of
// them at a time.  A CTA tile (TcTile) is BM pixels x BN filters, WM x WN
// warps, each warp a WTM x WTN block of m16n8 fp32 accumulators.  The input
// is gathered BK taps at a time (TC_BK = 64; OS up to TC_OS_BK = 128) into a
// two-stage ring [BK][BM + 8] of bf16, pixels contiguous per tap (A's
// fragments by ldmatrix.x4.trans); the filter tile sits in shared memory
// as rows of k
// contiguous per filter, 16 bytes longer than their taps so that the 8
// rows of an ldmatrix fall in 8 different bank groups (B's fragments by
// ldmatrix.x4, no .trans); each warp runs
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 (mma.cuh) per 16-tap step:
// its A fragments and B fragments by ldmatrix, then its MI x NJ MMAs.  The
// three kernels differ in where B comes from and where the sums go:
//   - WS: per depth fold a CTA stages its filter tile once, [BN][kpad + 8]
//     (kpad = Kf rounded up to 16; the taps past Kf are zeros), then walks
//     its share of the M tiles past it (the paper's Filter Fold held while
//     the Image Folds stream); with g_c > 1 depth folds the sums go
//     through an fp32 slab between folds (exact), which only the CTA that
//     owns the tile touches;
//   - OS: a CTA owns one (M tile, filter tile) and keeps its accumulators
//     in registers across the whole depth; the filter tile streams a
//     chunk (TcOs) at a time through a TC_STAGES ring of [BN][BK + 8],
//     each chunk copied TC_AHEAD chunks before its MMAs, a thread's
//     16-byte pieces at offsets computed once (no fold is resident: Kf 4608
//     x BN 64 would not fit, and would hold the first MMA until the whole
//     fold arrived);
//   - psum: one depth fold a CTA, as WS, the folds side by side on the
//     grid; each fold's sums are stored rounded to bf16 into its own slice
//     of the staging buffer, as the JAX package's staging buffer has the
//     output's type.
// tc_run is the one walk all three run, the gather and the MMA steps; only
// the source of B's fragments (TcResidentB, TcStreamB) differs.
// The gather is the FFMA core's: the k -> offset table fill_koff, each
// pixel's first input element in a register, the pixels of one tap across
// a warp, one 2-byte load per tap and pixel (the pre-padded rows, Yp 226,
// 34 or 18, are not 16-byte aligned: no TMA, no vector copy); a thread
// gathers two neighbouring pixels into registers two chunks ahead of the
// MMAs and packs each pair into one 32-bit shared store.  The filter tile
// is copied by 16-byte cp.async wherever K and Kf are multiples of 8 (every
// layer of the zoo), else by pairs of 2-byte loads.  The epilogue stages
// the finished fp32 tile through shared memory (the input ring's bytes,
// [BN][BM + 4]): an m16n8 fragment gives a lane rows g and g+8, not a 2x2
// quad.  From there the FFMA core's steps run per output: bias ->
// scale/shift -> residual -> ReLU(6) -> 2x2 max, each step rounded on its
// own (__fmul_rn / __fadd_rn), one bf16 rounding at the store,
// neighbouring pixels on neighbouring lanes.
//
// The sum order, the bitwise contract: each output's sum is a chain of
// MMAs over 16-tap steps.  The chain starts from 0 at its first depth
// fold's first tap, runs in ascending k (c, then r, then s), each fold's
// steps from the fold's own first tap, the taps past Kf in a fold's last
// step zero weights times zero inputs; WS carries the accumulator from one
// fold to the next through the fp32 slab, OS in registers, both exactly.
// The step boundaries depend on (C/G, R, S, c_b) alone: never on N, BM,
// BN, the grid, m_per_cta, the dataflow or the epilogue, and an MMA
// computes each output from its own row, column and accumulator.  No split
// K, no atomics.  So a bf16 trunk gives the same bits at every batch width
// and with every tile, and bf16 WS and bf16 OS give the same bits on the
// same layer and plan.
//
// Bound: the bf16 tensor-core rate (989 TFLOP/s dense) for every dense
// layer of the zoo; what binds these kernels is the gather, one 2-byte
// load (and its share of an address add and a shared store) per tap,
// pixel and filter tile, BN multiply-adds per load, and on the deepest
// layers its latency: a chunk takes about as long whatever its work, and
// two chunks of loads in flight (tc_run) only partly hide it.  The loads
// stay straight-line and predicated: a per-tap branch to one 32-bit load
// for an aligned pixel pair ran 1.8x slower (PERF.md).  WS's tile set
// trades BN against shared memory: the resident filter tile takes
// 2*BN*(kpad + 8) bytes, 147 KB at Kf 4608 and BN 16, so VGG-16's deepest
// layers run BN 16 and BN 64 fits up to Kf 1152.  OS's ring takes 52 KB at
// BN 64 whatever the depth; its small-M layers (16 to 64 pixels at 32 b4)
// run the tiles of BM 16 and 32 (TcTile6, TcTile7), one 4-warp CTA an SM
// or fewer, where what a chunk costs whatever its work binds: the
// barrier, the waits, the copies' issue (PERF.md), so OS walks 128-tap
// chunks and keeps each thread's weight copies to an add and a predicate.

#pragma once

#include "fold_conv.cuh"
#include "mma.cuh"

namespace {

// Taps a chunk of the gather.  The gather is latency-bound on the deep
// layers (VGG-16's Kf 4608 ones spent ~1,750 cycles a chunk with one
// chunk of 32 taps in flight, PERF.md): a thread keeps two chunks of 64
// taps of its two pixels in flight (tc_run)
constexpr int TC_BK = 64;
// OS walks chunks of up to TC_OS_BK taps: on its small-M layers (one 4-warp
// CTA an SM) a chunk's fixed costs, the barrier, the waits and the
// weights' copies, are issued by few warps and bind (PERF.md)
constexpr int TC_OS_BK = 128;
// OS: stages of the weight ring, and the chunks of weights in flight ahead
// of the chunk whose MMAs issue
constexpr int TC_STAGES = 3;
constexpr int TC_AHEAD = TC_STAGES - 1;

// A tensor-core CTA tile: WM x WN warps, each owning WTM pixels x WTN
// filters of the tile in m16n8 accumulators (MI x NJ of them), walking the
// taps in chunks of BK.  A thread gathers two neighbouring pixels of the
// tile, every KSTEP-th tap of a chunk.
template <int WTM_, int WTN_, int WM_, int WN_, int BK_ = TC_BK>
struct TcTile {
  static constexpr int WTM = WTM_, WTN = WTN_, WM = WM_, WN = WN_;
  static constexpr int BK = BK_;
  static constexpr int BM = WTM * WM, BN = WTN * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = WTM / 16, NJ = WTN / 8;
  static constexpr int LDA = BM + 8;   // bf16 row of the input ring: a tap
  static constexpr int LDC = BM + 4;   // fp32 row of the staged tile
  static constexpr int PAIRS = BM / 2;
  static constexpr int KSTEP = THREADS / PAIRS;
  static constexpr int TAPS = BK / KSTEP;  // taps a thread gathers
  static_assert(WTM % 16 == 0 && WTN % 16 == 0,
                "a warp's block is whole m16 rows and ldmatrix.x4 n16 pairs");
  static_assert(THREADS % PAIRS == 0 && BK % KSTEP == 0 && BK % 16 == 0,
                "each thread gathers one pixel pair of the tile");
};

// The OS kernel's instance of a tile: chunks of TC_OS_BK taps where a
// thread then gathers at most 16 taps of its two pixels (the tiles of 16
// and 32 pixels), else of TC_BK as WS (more would take 200-236 registers)
template <class TC>
using TcOs = TcTile<TC::WTM, TC::WTN, TC::WM, TC::WN,
                    16 * TC::KSTEP < TC_OS_BK ? 16 * TC::KSTEP : TC_OS_BK>;

// The tiles the wrapper picks from (TC_TILES in conv2d_ws.py, same order);
// WS and psum run the first TC_WS_TILES, OS all of them
using TcTile0 = TcTile<16, 16, 4, 1>;   //  64 x 16, 128 threads
using TcTile1 = TcTile<16, 16, 8, 1>;   // 128 x 16, 256
using TcTile2 = TcTile<16, 32, 4, 1>;   //  64 x 32, 128
using TcTile3 = TcTile<32, 16, 4, 2>;   // 128 x 32, 256
using TcTile4 = TcTile<32, 32, 2, 2>;   //  64 x 64, 128
using TcTile5 = TcTile<32, 32, 4, 2>;   // 128 x 64, 256
using TcTile6 = TcTile<16, 16, 1, 4>;   //  16 x 64, 128: OS at small M
using TcTile7 = TcTile<16, 32, 2, 2>;   //  32 x 64, 128: OS at small M
constexpr int TC_WS_TILES = 6;

// A depth fold's taps rounded up to whole 16-tap MMA steps, and the
// chunks of the gather they take
__host__ __device__ inline int tc_kpad(int kf) { return (kf + 15) / 16 * 16; }
template <class TC>
__host__ __device__ inline int tc_chunks(int kf) {
  return (tc_kpad(kf) + TC::BK - 1) / TC::BK;
}

// Shared memory of a launch: the filter tile (WS, psum: a depth fold,
// resident; OS: the weight ring), the input ring (which also holds the
// staged fp32 tile), the k offset table
template <class TC>
__host__ __device__ inline size_t tc_ring_bytes() {
  const size_t ring = 2ull * 2 * TC::BK * TC::LDA;
  const size_t tile = 4ull * TC::BN * TC::LDC;
  return ring > tile ? ring : tile;
}
template <class TC>
__host__ __device__ inline size_t tc_b_elems(int kind, const Dims& d) {
  return kind == KIND_OS
             ? static_cast<size_t>(TC_STAGES) * TC::BN * (TC::BK + 8)
             : static_cast<size_t>(TC::BN) * (tc_kpad(d.Kf) + 8);
}
template <class TC>
size_t tc_smem(int kind, const Dims& d) {
  return 2 * tc_b_elems<TC>(kind, d) + tc_ring_bytes<TC>() + 4ull * d.K;
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

// OS, where a row of the fold is not on a 16-byte boundary: the filter
// tile's taps [k0, k0 + BK) into a ring stage [BN][BK + 8] by pairs of
// 2-byte loads, zeros at or past kend (the fold's end) and past the real
// filters, as tc_load_b stages a whole fold
template <class TC>
__device__ void tc_load_chunk_pairs(bf16* b_s, const bf16* __restrict__ w,
                                    int K, int k0, int kend, int f0,
                                    int nvalid) {
  constexpr int LD = TC::BK + 8;
  constexpr int PER = TC::BK / 2;
  const bf16* base = w + static_cast<size_t>(f0) * K + k0;
  for (int e = threadIdx.x; e < TC::BN * PER; e += TC::THREADS) {
    const int n = e / PER;
    const int k = 2 * (e - n * PER);
    unsigned lo = 0u, hi = 0u;
    if (n < nvalid) {
      const auto* row = reinterpret_cast<const unsigned short*>(
          base + static_cast<size_t>(n) * K);
      if (k0 + k < kend) lo = __ldg(row + k);
      if (k0 + k + 1 < kend) hi = __ldg(row + k + 1);
    }
    *reinterpret_cast<unsigned*>(b_s + n * LD + k) = lo | (hi << 16);
  }
}

// The input taps [kbeg, kbeg + BK) of this thread's two pixels (first
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
// chunk's ring stage, b_s the filter tile's rows at the chunk's first tap.
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
  for (int kk = 0; kk < TC::BK / 16; ++kk) {
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

// A chunk of a walk: its first tap, the end of its depth fold, and the
// 16-tap steps of the fold from its first tap on.  next() moves to the
// following chunk: BK taps on, or (a walk of several folds, FOLDS) the
// next fold's first tap after a fold's last chunk.
template <class TC, bool FOLDS>
struct TcChunk {
  int k0, kend, left;
  __device__ __forceinline__ void next(int Kf, int steps) {
    k0 += TC::BK;
    left -= TC::BK / 16;
    if constexpr (FOLDS) {
      if (left <= 0) {
        k0 = kend;
        kend += Kf;
        left = steps;
      }
    }
  }
};

// Where the B fragments of a chunk come from.  WS, psum: the depth fold's
// filter tile, resident since before the walk (ready: its cp.async copies
// have landed); chunk j of the fold starts at its column j * BK.
template <class TC>
struct TcResidentB {
  static constexpr bool FOLDS = false;   // one depth fold a walk
  const bf16* b;
  int ldb;
  __device__ __forceinline__ const bf16* chunk(int j) const {
    return b + j * TC::BK;
  }
  __device__ __forceinline__ void fetch(int,
                                        const TcChunk<TC, FOLDS>&) const {}
  __device__ __forceinline__ void ready() const { cp_async_wait_all(); }
  __device__ __forceinline__ void wait() const {}
};

// OS: chunk j of the walk streams through stage j % TC_STAGES of the
// weight ring [BN][BK + 8]; fetch(j, c) copies it (one cp.async group a
// chunk, empty past the last), wait() lets the newest TC_AHEAD - 1 groups
// stay in flight.  A thread's 16-byte pieces are fixed for the whole walk:
// taps k .. k + 8 of rows n0, n0 + ROWSTEP, ...; their offsets are
// computed once, so a chunk costs a thread an add and a predicate a piece.
template <class TC>
struct TcStreamB {
  static constexpr bool FOLDS = true;    // every depth fold in one walk
  static constexpr int ldb = TC::BK + 8;
  static constexpr int PER = TC::BK / 8;        // pieces a row
  static constexpr int ROWSTEP = TC::THREADS / PER;
  static constexpr int PIECES = (TC::BN + ROWSTEP - 1) / ROWSTEP;
  static_assert(TC::THREADS % PER == 0, "a thread copies one tap range");
  bf16* ring;
  const bf16* w;
  int K, chunks, f0, nvalid;
  bool vec;    // every row of a fold on a 16-byte boundary
  int k, n0, src, dst;
  __device__ TcStreamB(bf16* ring_, const bf16* w_, int K_, int Kf,
                       int chunks_, int f0_, int nvalid_)
      : ring(ring_), w(w_), K(K_), chunks(chunks_), f0(f0_),
        nvalid(nvalid_) {
    vec = K % 8 == 0 && Kf % 8 == 0 &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0;
    k = 8 * (threadIdx.x % PER);
    n0 = threadIdx.x / PER;
    src = (f0 + n0) * K + k;
    dst = n0 * ldb + k;
  }
  __device__ __forceinline__ const bf16* chunk(int j) const {
    return ring + (j % TC_STAGES) * TC::BN * ldb;
  }
  __device__ __forceinline__ void fetch(int j,
                                        const TcChunk<TC, FOLDS>& c) const {
    if (j < chunks) {
      bf16* stage = ring + (j % TC_STAGES) * TC::BN * ldb;
      if (vec) {
        const bool in = c.k0 + k < c.kend;
        const bf16* from = w + src + c.k0;
#pragma unroll
        for (int i = 0; i < PIECES; ++i) {
          const int n = n0 + i * ROWSTEP;
          if (PIECES * ROWSTEP <= TC::BN || n < TC::BN) {
            const bool ok = in && n < nvalid;
            cp_async16(stage + dst + i * ROWSTEP * ldb,
                       ok ? from + i * ROWSTEP * K : w, ok);
          }
        }
      } else {
        tc_load_chunk_pairs<TC>(stage, w, K, c.k0, c.kend, f0, nvalid);
      }
    }
    cp_async_commit();
  }
  __device__ __forceinline__ void ready() const {
    cp_async_wait<TC_AHEAD - 1>();
  }
  __device__ __forceinline__ void wait() const {
    cp_async_wait<TC_AHEAD - 1>();
  }
};

// The tile's sums over `folds` depth folds of Kf taps from tap kbeg (WS,
// psum: one fold; OS: all of them): the walk all three kernels run.  Each
// fold's taps go in chunks of BK from the fold's own first tap (the chunks
// pace the loads; the sum's order is its 16-tap steps alone), each chunk
// in 16-tap MMA steps, zeros past the fold's end; three cursors (TcChunk)
// follow the gather, the MMAs and B's copies.  The input's two-stage ring:
// chunk j+2 gathered into registers while chunk j's MMAs issue and chunk
// j+1 is stored, one barrier a chunk (the last one too: the ring is free
// when this returns).  B's chunk j + TC_AHEAD is fetched (OS) as chunk j's
// MMAs issue, into the stage chunk j-1 left.
template <class TC, class B>
__device__ __forceinline__ void tc_run(float (&acc)[TC::MI][TC::NJ][4],
                                       const bf16* __restrict__ x,
                                       bf16* a_ring, const B b,
                                       const int* koff, int mb0, int mb1,
                                       int kbeg, int Kf, int folds, int wm0,
                                       int wn0, int lane) {
  const int steps = tc_kpad(Kf) / 16;
  const int nc = folds * tc_chunks<TC>(Kf);
  TcChunk<TC, B::FOLDS> ca{kbeg, kbeg + Kf, steps};  // the gather's next
  TcChunk<TC, B::FOLDS> cm = ca;                     // the MMAs'
  TcChunk<TC, B::FOLDS> cb = ca;                     // B's next copy
  // two register sets: chunk j+2's loads are in flight while chunk j's
  // MMAs issue and chunk j+1 is stored (the loop is unrolled by two so
  // that each set stays in registers)
  unsigned ra[2][TC::TAPS], rb[2][TC::TAPS];
  for (int j = 0; j < TC_AHEAD; ++j) {
    b.fetch(j, cb);
    cb.next(Kf, steps);
  }
  tc_fetch<TC>(ra, x, koff, mb0, mb1, ca.k0, ca.kend);
  ca.next(Kf, steps);
  tc_store<TC>(a_ring, ra);
  if (nc > 1) tc_fetch<TC>(rb, x, koff, mb0, mb1, ca.k0, ca.kend);
  ca.next(Kf, steps);
  b.ready();
  __syncthreads();
  bf16* const stage1 = a_ring + TC::BK * TC::LDA;
  for (int j = 0; j < nc; j += 2) {
    b.fetch(j + TC_AHEAD, cb);
    cb.next(Kf, steps);
    if (j + 2 < nc) tc_fetch<TC>(ra, x, koff, mb0, mb1, ca.k0, ca.kend);
    ca.next(Kf, steps);
    tc_mma<TC>(acc, a_ring, b.chunk(j), b.ldb, cm.left, wm0, wn0, lane);
    cm.next(Kf, steps);
    if (j + 1 < nc) tc_store<TC>(stage1, rb);
    b.wait();
    __syncthreads();
    if (j + 1 >= nc) break;
    b.fetch(j + 1 + TC_AHEAD, cb);
    cb.next(Kf, steps);
    if (j + 3 < nc) tc_fetch<TC>(rb, x, koff, mb0, mb1, ca.k0, ca.kend);
    ca.next(Kf, steps);
    tc_mma<TC>(acc, stage1, b.chunk(j + 1), b.ldb, cm.left, wm0, wn0, lane);
    cm.next(Kf, steps);
    if (j + 2 < nc) tc_store<TC>(a_ring, ra);
    b.wait();
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

// What the kernels share: the CTA's filter tile and shared memory (b: the
// resident depth fold, ldb its row; OS: the weight ring)
struct TcCta {
  int f0, nvalid, cbase, ldb;
  bf16* b;
  bf16* a_ring;
  float* c_s;
  int* koff;
};

template <class TC>
__device__ __forceinline__ TcCta tc_cta(void* smem, int kind, const Geom& g,
                                        const Dims& d) {
  TcCta c;
  filter_tile(d, TC::BN, c.f0, c.nvalid, c.cbase);
  c.ldb = tc_kpad(d.Kf) + 8;
  c.b = static_cast<bf16*>(smem);
  c.a_ring = c.b + tc_b_elems<TC>(kind, d);
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

// A thread's place in the tile: its warp's block and its pixel pair
struct TcLane {
  int lane, wm0, wn0, pl;
};
template <class TC>
__device__ __forceinline__ TcLane tc_lane() {
  const int warp = threadIdx.x >> 5;
  return {static_cast<int>(threadIdx.x & 31), warp % TC::WM * TC::WTM,
          warp / TC::WM * TC::WTN, 2 * static_cast<int>(threadIdx.x % TC::PAIRS)};
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
  const TcCta c = tc_cta<TC>(smem4, KIND_WS, g, d);
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const int g_c = d.cg / g.c_b;
  const TcLane t = tc_lane<TC>();
  const TcResidentB<TC> b{c.b, c.ldb};
  for (int cf = 0; cf < g_c; ++cf) {
    __syncthreads();  // the previous depth fold's tile is no longer read
    tc_load_b<TC>(c.b, w, d.K, d.Kf, cf * d.Kf, c.f0, c.nvalid);
    for (int mt = mt_lo; mt < mt_hi; ++mt) {
      const int m0 = mt * TC::BM;
      const int mb0 = row_base(g, d, m0 + t.pl, c.cbase);
      const int mb1 = row_base(g, d, m0 + t.pl + 1, c.cbase);
      float acc[TC::MI][TC::NJ][4];
      tc_zero<TC>(acc);
      __syncthreads();  // the last tile's staged sums are no longer read
      if (cf > 0) {
        tc_slab_io<TC, true>(c.c_s, slab, g, d, m0, c.f0, c.nvalid);
        __syncthreads();
        tc_tile_io<TC, false>(acc, c.c_s, t.wm0, t.wn0, t.lane);
        __syncthreads();  // before the ring, the same bytes, is written
      }
      tc_run<TC>(acc, x, c.a_ring, b, c.koff, mb0, mb1, cf * d.Kf, d.Kf, 1,
                 t.wm0, t.wn0, t.lane);
      tc_tile_io<TC, true>(acc, c.c_s, t.wm0, t.wn0, t.lane);
      __syncthreads();
      if (cf == g_c - 1) {
        tc_flush<TC>(c.c_s, out, vec, res, g, d, m0, c.f0, c.nvalid);
      } else {
        tc_slab_io<TC, false>(c.c_s, slab, g, d, m0, c.f0, c.nvalid);
      }
    }
  }
}

// Output-stationary: grid (M tiles, groups x filter tiles).  A CTA owns one
// output tile: it walks every depth fold with its accumulators in
// registers, the filter tile streamed through the weight ring, then stages
// the finished tile and flushes it as WS's last fold does.
template <class TC>
__global__ void __launch_bounds__(TC::THREADS)
os_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ vec, const bf16* __restrict__ res,
             bf16* __restrict__ out, Geom g) {
  extern __shared__ float4 smem4[];
  const Dims d = make_dims(g, TC::BN);
  const TcCta c = tc_cta<TC>(smem4, KIND_OS, g, d);
  const int g_c = d.cg / g.c_b;
  const TcLane t = tc_lane<TC>();
  const TcStreamB<TC> b(c.b, w, d.K, d.Kf, g_c * tc_chunks<TC>(d.Kf), c.f0,
                        c.nvalid);
  const int m0 = blockIdx.x * TC::BM;
  const int mb0 = row_base(g, d, m0 + t.pl, c.cbase);
  const int mb1 = row_base(g, d, m0 + t.pl + 1, c.cbase);
  float acc[TC::MI][TC::NJ][4];
  tc_zero<TC>(acc);
  __syncthreads();  // the k offset table
  tc_run<TC>(acc, x, c.a_ring, b, c.koff, mb0, mb1, 0, d.Kf, g_c, t.wm0,
             t.wn0, t.lane);
  tc_tile_io<TC, true>(acc, c.c_s, t.wm0, t.wn0, t.lane);
  __syncthreads();
  tc_flush<TC>(c.c_s, out, vec, res, g, d, m0, c.f0, c.nvalid);
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
  const TcCta c = tc_cta<TC>(smem4, KIND_PSUM, g, d);
  const int cf = blockIdx.z;
  bf16* fold = psum + static_cast<size_t>(cf) * g.n * g.nf_pad * g.p_pad * g.q;
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int mt_lo = blockIdx.x * g.m_per_cta;
  const int mt_hi = min(m_tiles, mt_lo + g.m_per_cta);
  const TcLane t = tc_lane<TC>();
  const TcResidentB<TC> b{c.b, c.ldb};
  tc_load_b<TC>(c.b, w, d.K, d.Kf, cf * d.Kf, c.f0, c.nvalid);
  for (int mt = mt_lo; mt < mt_hi; ++mt) {
    const int m0 = mt * TC::BM;
    const int mb0 = row_base(g, d, m0 + t.pl, c.cbase);
    const int mb1 = row_base(g, d, m0 + t.pl + 1, c.cbase);
    float acc[TC::MI][TC::NJ][4];
    tc_zero<TC>(acc);
    __syncthreads();  // the last tile's staged sums are no longer read
    tc_run<TC>(acc, x, c.a_ring, b, c.koff, mb0, mb1, cf * d.Kf, d.Kf, 1,
               t.wm0, t.wn0, t.lane);
    tc_tile_io<TC, true>(acc, c.c_s, t.wm0, t.wn0, t.lane);
    __syncthreads();
    tc_slab_io<TC, false>(c.c_s, fold, g, d, m0, c.f0, c.nvalid);
  }
}

// One launch with tile TC, TcTile<INDEX>; the tiles past TC_WS_TILES have
// no WS or psum instance
template <class TC, int INDEX>
int launch_tc_tile(int kind, const void* x, const void* w, const void* vec,
                   const void* res, void* out, void* slab, const Geom& g,
                   cudaStream_t stream) {
  constexpr bool OS_ONLY = INDEX >= TC_WS_TILES;
  const Dims d = make_dims(g, TC::BN);
  const size_t smem =
      kind == KIND_OS ? tc_smem<TcOs<TC>>(kind, d) : tc_smem<TC>(kind, d);
  if ((OS_ONLY && kind != KIND_OS) || smem > SMEM_LIMIT ||
      g.c_pad % g.groups || g.nf_pad % g.groups || d.cg % g.c_b ||
      g.m_per_cta < 1 ||
      (kind == KIND_PSUM && (g.groups != 1 || g.epi != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m_tiles = (d.M + TC::BM - 1) / TC::BM;
  const int gx = kind == KIND_OS ? m_tiles
                                 : (m_tiles + g.m_per_cta - 1) / g.m_per_cta;
  const dim3 grid(gx, g.groups * d.tiles_per_group,
                  kind == KIND_PSUM ? d.cg / g.c_b : 1);
  if (gx == 0) return static_cast<int>(cudaSuccess);
  const auto* xt = static_cast<const bf16*>(x);
  const auto* wt = static_cast<const bf16*>(w);
  const auto* vf = static_cast<const float*>(vec);
  const auto* rt = static_cast<const bf16*>(res);
  auto* ot = static_cast<bf16*>(out);
  cudaError_t err;
  if (kind == KIND_OS) {
    using OT = TcOs<TC>;
    err = allow_smem(os_tc_kernel<OT>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    os_tc_kernel<OT><<<grid, TC::THREADS, smem, stream>>>(xt, wt, vf, rt, ot,
                                                          g);
  } else if constexpr (!OS_ONLY) {
    if (kind == KIND_PSUM) {
      err = allow_smem(psum_tc_kernel<TC>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      psum_tc_kernel<TC><<<grid, TC::THREADS, smem, stream>>>(
          xt, wt, static_cast<bf16*>(slab), g);
    } else {
      err = allow_smem(ws_tc_kernel<TC>, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      ws_tc_kernel<TC><<<grid, TC::THREADS, smem, stream>>>(
          xt, wt, vf, rt, ot, static_cast<float*>(slab), g);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 WS (KIND_WS), OS (KIND_OS) or psum (KIND_PSUM) launch with
// tensor-core tile `tile` (TcTile0..TcTile7; WS and psum the first
// TC_WS_TILES)
int launch_fold_tc(int tile, int kind, const void* x, const void* w,
                   const void* vec, const void* res, void* out, void* slab,
                   const Geom& g, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 0: return launch_tc_tile<TcTile0, 0>(kind, x, w, vec, res, out, slab, g, s);
    case 1: return launch_tc_tile<TcTile1, 1>(kind, x, w, vec, res, out, slab, g, s);
    case 2: return launch_tc_tile<TcTile2, 2>(kind, x, w, vec, res, out, slab, g, s);
    case 3: return launch_tc_tile<TcTile3, 3>(kind, x, w, vec, res, out, slab, g, s);
    case 4: return launch_tc_tile<TcTile4, 4>(kind, x, w, vec, res, out, slab, g, s);
    case 5: return launch_tc_tile<TcTile5, 5>(kind, x, w, vec, res, out, slab, g, s);
    case 6: return launch_tc_tile<TcTile6, 6>(kind, x, w, vec, res, out, slab, g, s);
    case 7: return launch_tc_tile<TcTile7, 7>(kind, x, w, vec, res, out, slab, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

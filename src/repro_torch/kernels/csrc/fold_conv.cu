// Fold-streamed convolution for Hopper (sm_90a): the weight-stationary
// and output-stationary dataflows of the paper and the depthwise fold, with
// the fused bias -> BN scale/shift -> residual add -> ReLU or ReLU6 ->
// 2x2/2 max-pool epilogue, in fp32 and int8; and the partial-sum staging
// formulation of the weight-stationary dataflow (the paper's Fig. 5).
//
// Replaces the Pallas TPU kernels repro/kernels/conv2d_ws.py:_ws_kernel,
// :_os_kernel, :_dw_kernel and :_ws_psum_kernel (all launched from
// conv2d_folded).  The Python wrapper (repro_torch/kernels/conv2d_ws.py)
// pads every operand to the fold plan (fold_kernel_spec), allocates the
// output and the WS slab, and checks the error code each entry returns.
//
// Operands (contiguous; x and w are fp32, or int8 for the *_i8 entries):
//   x    (N, C_pad, X_rows, Yp)   pre-padded input
//   w    (NF_pad, C_pad, R, S)    dense; (C_pad, 1, R, S) depthwise
//   vec  (NF_pad, 3)              bias, BN scale, BN shift per filter (fp32)
//   res  (N, NF_pad, P_pad, Q)    the fp32 shortcut, or null
//   out  (N, NF_pad, P_pad or P_pad/2, Q or Q/2), fp32
//   slab (N, NF_pad, P_pad, Q)     WS partial sums while g_c > 1, else null
//                                  (fp32, or int32 for int8)
//   psum (g_c, N, NF_pad, P_pad, Q) fold_conv_psum's staging buffer, fp32
//
// Int8 (the *_i8 entries, the JAX kernels' acc_dtype=int32 bodies): each
// int8 operand is widened to int32 before the multiply (IMAD on the CUDA
// cores), the sums and the WS slab are int32, and the flush converts the
// finished sum with __int2float_rn and applies the requant affine the
// caller put in the scale/shift columns (core/quant.py: requant_affine),
// then the fp32 epilogue as for fp32.  Integer sums are exact in any
// order.  The fp32 and int8 kernels are one template on the operand type T
// and the accumulator type A; the fp32 instances compile to the code they
// had before the int8 ones existed.
//
// Bound: FFMA throughput for the dense kernels (see the wrapper's note).
// Each thread owns a 2x2 output micro-tile for NFT filters, 4*NFT
// accumulators in registers.  The sum of one output element runs over
// channels ascending, then R, then S, and nothing else: no split of the
// depth across threads or CTAs, so the result does not depend on N, the
// grid, or the CTA tile.  The depthwise kernel is bound by bytes; one
// thread owns one output element and sums its R*S taps, R then S.
//
// The WS kernel is compiled twice: for epilogues of bias, ReLU and pool
// alone (VGG-16's, ResNet-18's without a shortcut) and for every step.  The
// first needs 128 registers, so two 256-thread CTAs fit an SM; the second
// needs 166, and one CTA fits.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NFT = 8;        // filters per CTA sub-fold
constexpr int OS_CHUNK = 32;  // channels per output-stationary weight restage
constexpr int MAX_THREADS = 256;

// Epilogue steps, one bit each (EPI_* in conv2d_ws.py)
constexpr int EPI_BIAS = 1;
constexpr int EPI_SCALE = 2;
constexpr int EPI_RESIDUAL = 4;
constexpr int EPI_RELU = 8;
constexpr int EPI_RELU6 = 16;
constexpr int EPI_POOL = 32;
constexpr int EPI_ALL = 63;
constexpr int EPI_PLAIN = EPI_BIAS | EPI_RELU | EPI_POOL;

struct Geom {
  int n, c_pad, x_rows, yp;
  int nf_pad, r, s, stride;
  int q, p_pad;
  int nf_b, c_b, p_b;
  int epi;       // EPI_* bits
  int mq;        // micro-tile columns per CTA tile
  int q_tiles;   // CTA tiles along Q
  int p_chunk;   // WS: P folds one CTA walks
};

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

// Four accumulator-typed weights: one 16-byte shared-memory word
template <typename A> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<int> { using type = int4; };

// One 2x2 micro-tile of the CTA tile: where it sits and which of its four
// outputs are real (rows past the P fold and columns past Q are not).
struct Micro {
  int prow, qcol;
  bool rv1, cv1;
};

// Copy the weight sub-fold [f0, f0+nvalid) x [c0, c0+nch) x R x S into
// shared memory as [c][r][s][NFT], widened to the accumulator type: one tap
// of all NFT filters is two 16-byte words, read as a broadcast.  Missing
// filters are zeros.
template <typename T, typename A>
__device__ void stage_weights(A* w_s, const T* __restrict__ w,
                              const Geom& g, int f0, int nvalid, int c0,
                              int nch) {
  const int rs = g.r * g.s;
  const int total = nch * rs * NFT;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i % NFT;
    const int crs = i / NFT;
    const int c = crs / rs;
    const int k = crs % rs;
    w_s[i] = j < nvalid
        ? static_cast<A>(
              w[(static_cast<size_t>(f0 + j) * g.c_pad + c0 + c) * rs + k])
        : A(0);
  }
}

// _fold_partial: R*S stationary taps of nch channels against the strided
// input window of one micro-tile, accumulated into acc in fixed order.
template <typename T, typename A>
__device__ __forceinline__ void fold_partial(A (&acc)[NFT][4],
                                             const T* __restrict__ xc0,
                                             const A* w_s, int nch,
                                             const Geom& g, const Micro& m) {
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  const int col0 = m.qcol * g.stride;
  using V4 = typename Vec4<A>::type;
  for (int c = 0; c < nch; ++c) {
    const T* xc = xc0 + c * plane;
    for (int r = 0; r < g.r; ++r) {
      const T* row0 =
          xc + static_cast<size_t>(m.prow * g.stride + r) * g.yp + col0;
      const T* row1 = row0 + static_cast<size_t>(g.stride) * g.yp;
      for (int s = 0; s < g.s; ++s) {
        const V4* wp = reinterpret_cast<const V4*>(
            w_s + ((c * g.r + r) * g.s + s) * NFT);
        const V4 wa = wp[0];
        const V4 wb = wp[1];
        const A wv[NFT] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        A xv[4];
        xv[0] = static_cast<A>(__ldg(row0 + s));
        xv[1] = m.cv1 ? static_cast<A>(__ldg(row0 + s + g.stride)) : A(0);
        xv[2] = m.rv1 ? static_cast<A>(__ldg(row1 + s)) : A(0);
        xv[3] = (m.rv1 && m.cv1) ? static_cast<A>(__ldg(row1 + s + g.stride))
                                 : A(0);
#pragma unroll
        for (int f = 0; f < NFT; ++f) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[f][k] = mac(wv[f], xv[k], acc[f][k]);
        }
      }
    }
  }
}

// _flush_value: the epilogue, an optional 2x2 max, then the one write of
// each finished output element.  MASK is the EPI_* bits this instance can
// run; which of them run is read from g.epi.
template <int MASK, typename A>
__device__ __forceinline__ void flush_value(const A (&acc)[NFT][4],
                                            float* __restrict__ out,
                                            const float* __restrict__ vec,
                                            const float* __restrict__ res,
                                            const Geom& g, int nidx, int f0,
                                            int nvalid, const Micro& m) {
  const int epi = g.epi & MASK;
  const bool pool = epi & EPI_POOL;
  const int qo = pool ? g.q / 2 : g.q;
  const int po = pool ? g.p_pad / 2 : g.p_pad;
#pragma unroll
  for (int j = 0; j < NFT; ++j) {
    if (j >= nvalid) break;
    const size_t plane = static_cast<size_t>(nidx) * g.nf_pad + f0 + j;
    const float* rp = (epi & EPI_RESIDUAL)
        ? res + plane * g.p_pad * g.q : nullptr;
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // output k of the micro-tile sits at row prow + k/2, column
      // qcol + k%2, and is real unless that row or column is not
      const bool real = ((k & 1) == 0 || m.cv1) && ((k >> 1) == 0 || m.rv1);
      const float r = rp && real
          ? rp[(m.prow + (k >> 1)) * g.q + m.qcol + (k & 1)] : 0.f;
      v[k] = epilogue(to_float(acc[j][k]), vec, f0 + j, epi, r);
    }
    float* o = out + plane * po * qo;
    if (pool) {
      // p_b is even, so both rows lie in the fold; the tile's pooled
      // column exists only when both of its columns are real
      if (m.cv1) {
        o[(m.prow / 2) * qo + m.qcol / 2] =
            fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
      }
    } else {
      o[m.prow * qo + m.qcol] = v[0];
      if (m.cv1) o[m.prow * qo + m.qcol + 1] = v[1];
      if (m.rv1) o[(m.prow + 1) * qo + m.qcol] = v[2];
      if (m.rv1 && m.cv1) o[(m.prow + 1) * qo + m.qcol + 1] = v[3];
    }
  }
}

__device__ __forceinline__ bool micro_tile(const Geom& g, int t, int q_tile,
                                           int pf, Micro& m) {
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

__device__ __forceinline__ void sub_fold(const Geom& g, int& f0, int& nvalid) {
  const int subs = (g.nf_b + NFT - 1) / NFT;
  const int fold = blockIdx.y / subs;
  const int sub = blockIdx.y % subs;
  f0 = fold * g.nf_b + sub * NFT;
  nvalid = min(NFT, g.nf_b - sub * NFT);
}

// Weight-stationary: grid (Q tiles x P chunks, filter sub-folds, N).  For
// each depth fold the CTA stages its filter sub-fold once and walks its P
// folds past it; with g_c > 1 the partial sums of the walked rows go to
// the slab, which no other CTA touches.
template <typename T, typename A, int MASK>
__global__ void __launch_bounds__(MAX_THREADS)
ws_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const float* __restrict__ res,
          float* __restrict__ out, A* __restrict__ slab, Geom g) {
  extern __shared__ float4 smem4[];
  A* w_s = reinterpret_cast<A*>(smem4);
  int f0, nvalid;
  sub_fold(g, f0, nvalid);
  const int nidx = blockIdx.z;
  const int q_tile = blockIdx.x % g.q_tiles;
  const int chunk = blockIdx.x / g.q_tiles;
  const int g_c = g.c_pad / g.c_b;
  const int g_p = g.p_pad / g.p_b;
  const int pf_lo = chunk * g.p_chunk;
  const int pf_hi = min(g_p, pf_lo + g.p_chunk);
  const int tile = ((g.p_b + 1) / 2) * g.mq;
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  for (int cf = 0; cf < g_c; ++cf) {
    __syncthreads();
    stage_weights(w_s, w, g, f0, nvalid, cf * g.c_b, g.c_b);
    __syncthreads();
    const T* xc0 =
        x + (static_cast<size_t>(nidx) * g.c_pad + cf * g.c_b) * plane;
    for (int pf = pf_lo; pf < pf_hi; ++pf) {
      for (int t = threadIdx.x; t < tile; t += blockDim.x) {
        Micro m;
        if (!micro_tile(g, t, q_tile, pf, m)) continue;
        A acc[NFT][4];
#pragma unroll
        for (int j = 0; j < NFT; ++j) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[j][k] = A(0);
        }
        if (cf > 0) {
          for (int j = 0; j < nvalid; ++j) {
            const A* sl = slab + (static_cast<size_t>(nidx) * g.nf_pad +
                                      f0 + j) * g.p_pad * g.q;
            acc[j][0] = sl[m.prow * g.q + m.qcol];
            if (m.cv1) acc[j][1] = sl[m.prow * g.q + m.qcol + 1];
            if (m.rv1) acc[j][2] = sl[(m.prow + 1) * g.q + m.qcol];
            if (m.rv1 && m.cv1) acc[j][3] = sl[(m.prow + 1) * g.q + m.qcol + 1];
          }
        }
        fold_partial(acc, xc0, w_s, g.c_b, g, m);
        if (cf == g_c - 1) {
          flush_value<MASK>(acc, out, vec, res, g, nidx, f0, nvalid, m);
        } else {
          for (int j = 0; j < nvalid; ++j) {
            A* sl = slab + (static_cast<size_t>(nidx) * g.nf_pad + f0 + j) *
                                   g.p_pad * g.q;
            sl[m.prow * g.q + m.qcol] = acc[j][0];
            if (m.cv1) sl[m.prow * g.q + m.qcol + 1] = acc[j][1];
            if (m.rv1) sl[(m.prow + 1) * g.q + m.qcol] = acc[j][2];
            if (m.rv1 && m.cv1) sl[(m.prow + 1) * g.q + m.qcol + 1] = acc[j][3];
          }
        }
      }
    }
  }
}

// Output-stationary: grid (Q tiles x P folds, filter sub-folds, N).  Each
// thread holds one micro-tile's accumulators across every depth fold; the
// weights are restaged OS_CHUNK channels at a time for this P tile.
template <typename T, typename A>
__global__ void __launch_bounds__(MAX_THREADS)
os_kernel(const T* __restrict__ x, const T* __restrict__ w,
          const float* __restrict__ vec, const float* __restrict__ res,
          float* __restrict__ out, Geom g) {
  extern __shared__ float4 smem4[];
  A* w_s = reinterpret_cast<A*>(smem4);
  int f0, nvalid;
  sub_fold(g, f0, nvalid);
  const int nidx = blockIdx.z;
  const int q_tile = blockIdx.x % g.q_tiles;
  const int pf = blockIdx.x / g.q_tiles;
  const int g_c = g.c_pad / g.c_b;
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  Micro m;
  const bool active = micro_tile(g, threadIdx.x, q_tile, pf, m);
  A acc[NFT][4];
#pragma unroll
  for (int j = 0; j < NFT; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = A(0);
  }
  for (int cf = 0; cf < g_c; ++cf) {
    for (int ch0 = 0; ch0 < g.c_b; ch0 += OS_CHUNK) {
      const int nch = min(OS_CHUNK, g.c_b - ch0);
      const int c0 = cf * g.c_b + ch0;
      __syncthreads();
      stage_weights(w_s, w, g, f0, nvalid, c0, nch);
      __syncthreads();
      if (active) {
        fold_partial(acc, x + (static_cast<size_t>(nidx) * g.c_pad + c0) * plane,
                     w_s, nch, g, m);
      }
    }
  }
  if (active) flush_value<EPI_ALL>(acc, out, vec, res, g, nidx, f0, nvalid, m);
}

// Partial-sum staging (replaces _ws_psum_kernel, the paper's Fig. 5
// formulation): grid (Q tiles x P folds, filter sub-folds, N x depth
// folds).  A CTA stages one depth fold of its filter sub-fold, sums that
// fold's c_b channels x R x S taps for each micro-tile in the order
// ws_kernel sums them, and writes the fold's partial sums to its own slice
// of the staging buffer (g_c, N, NF_pad, P_pad, Q).  Nothing is flushed:
// the caller sums the folds afterwards, through device memory.
__global__ void __launch_bounds__(MAX_THREADS)
psum_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ psum, Geom g) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  int f0, nvalid;
  sub_fold(g, f0, nvalid);
  const int g_c = g.c_pad / g.c_b;
  const int cf = blockIdx.z % g_c;
  const int nidx = blockIdx.z / g_c;
  const int q_tile = blockIdx.x % g.q_tiles;
  const int pf = blockIdx.x / g.q_tiles;
  const int tile = ((g.p_b + 1) / 2) * g.mq;
  const size_t plane = static_cast<size_t>(g.x_rows) * g.yp;
  stage_weights(w_s, w, g, f0, nvalid, cf * g.c_b, g.c_b);
  __syncthreads();
  const float* xc0 =
      x + (static_cast<size_t>(nidx) * g.c_pad + cf * g.c_b) * plane;
  float* fold =
      psum + static_cast<size_t>(cf) * g.n * g.nf_pad * g.p_pad * g.q;
  for (int t = threadIdx.x; t < tile; t += blockDim.x) {
    Micro m;
    if (!micro_tile(g, t, q_tile, pf, m)) continue;
    float acc[NFT][4];
#pragma unroll
    for (int j = 0; j < NFT; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;
    }
    fold_partial(acc, xc0, w_s, g.c_b, g, m);
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

Geom make_geom(int n, int c_pad, int x_rows, int yp, int nf_pad, int r,
               int s, int stride, int q, int p_pad, int nf_b, int c_b,
               int p_b, int epi, int mq, int p_chunk) {
  Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, nf_b, c_b,
         p_b, epi, mq, 0, p_chunk};
  g.q_tiles = ((q + 1) / 2 + mq - 1) / mq;
  return g;
}

int sub_folds(const Geom& g) {
  return (g.nf_pad / g.nf_b) * ((g.nf_b + NFT - 1) / NFT);
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

template <typename T, typename A>
int launch_ws(const void* x, const void* w, const void* vec, const void* res,
              void* out, void* slab, int n, int c_pad, int x_rows, int yp,
              int nf_pad, int r, int s, int stride, int q, int p_pad,
              int nf_b, int c_b, int p_b, int epi, int mq, int p_chunk,
              int threads, void* stream) {
  const Geom g = make_geom(n, c_pad, x_rows, yp, nf_pad, r, s, stride, q,
                           p_pad, nf_b, c_b, p_b, epi, mq, p_chunk);
  const int g_p = p_pad / p_b;
  const int chunks = (g_p + p_chunk - 1) / p_chunk;
  const size_t smem = sizeof(A) * NFT * c_b * r * s;
  const auto kernel = (epi & ~EPI_PLAIN) ? ws_kernel<T, A, EPI_ALL>
                                         : ws_kernel<T, A, EPI_PLAIN>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.q_tiles * chunks, sub_folds(g), n);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(vec), static_cast<const float*>(res),
      static_cast<float*>(out), static_cast<A*>(slab), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename A>
int launch_os(const void* x, const void* w, const void* vec, const void* res,
              void* out, int n, int c_pad, int x_rows, int yp, int nf_pad,
              int r, int s, int stride, int q, int p_pad, int nf_b, int c_b,
              int p_b, int epi, int mq, int threads, void* stream) {
  const Geom g = make_geom(n, c_pad, x_rows, yp, nf_pad, r, s, stride, q,
                           p_pad, nf_b, c_b, p_b, epi, mq, 1);
  const size_t smem = sizeof(A) * NFT * OS_CHUNK * r * s;
  const cudaError_t err = allow_smem(os_kernel<T, A>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.q_tiles * (p_pad / p_b), sub_folds(g), n);
  os_kernel<T, A><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(vec), static_cast<const float*>(res),
      static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" {

const char* fold_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int fold_conv_ws(const void* x, const void* w, const void* vec,
                 const void* res, void* out, void* slab, int n, int c_pad,
                 int x_rows, int yp, int nf_pad, int r, int s, int stride,
                 int q, int p_pad, int nf_b, int c_b, int p_b, int epi,
                 int mq, int p_chunk, int threads, void* stream) {
  return launch_ws<float, float>(x, w, vec, res, out, slab, n, c_pad, x_rows,
                                 yp, nf_pad, r, s, stride, q, p_pad, nf_b,
                                 c_b, p_b, epi, mq, p_chunk, threads, stream);
}

int fold_conv_ws_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, void* slab, int n, int c_pad,
                    int x_rows, int yp, int nf_pad, int r, int s, int stride,
                    int q, int p_pad, int nf_b, int c_b, int p_b, int epi,
                    int mq, int p_chunk, int threads, void* stream) {
  return launch_ws<int8_t, int>(x, w, vec, res, out, slab, n, c_pad, x_rows,
                                yp, nf_pad, r, s, stride, q, p_pad, nf_b,
                                c_b, p_b, epi, mq, p_chunk, threads, stream);
}

int fold_conv_os(const void* x, const void* w, const void* vec,
                 const void* res, void* out, int n, int c_pad, int x_rows,
                 int yp, int nf_pad, int r, int s, int stride, int q,
                 int p_pad, int nf_b, int c_b, int p_b, int epi, int mq,
                 int threads, void* stream) {
  return launch_os<float, float>(x, w, vec, res, out, n, c_pad, x_rows, yp,
                                 nf_pad, r, s, stride, q, p_pad, nf_b, c_b,
                                 p_b, epi, mq, threads, stream);
}

int fold_conv_os_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, int n, int c_pad, int x_rows,
                    int yp, int nf_pad, int r, int s, int stride, int q,
                    int p_pad, int nf_b, int c_b, int p_b, int epi, int mq,
                    int threads, void* stream) {
  return launch_os<int8_t, int>(x, w, vec, res, out, n, c_pad, x_rows, yp,
                                nf_pad, r, s, stride, q, p_pad, nf_b, c_b,
                                p_b, epi, mq, threads, stream);
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
                   int mq, int threads, void* stream) {
  const Geom g = make_geom(n, c_pad, x_rows, yp, nf_pad, r, s, stride, q,
                           p_pad, nf_b, c_b, p_b, 0, mq, 1);
  const size_t smem = sizeof(float) * NFT * c_b * r * s;
  const cudaError_t err = allow_smem(psum_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(g.q_tiles * (p_pad / p_b), sub_folds(g), n * (c_pad / c_b));
  psum_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(psum), g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

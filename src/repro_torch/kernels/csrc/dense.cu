// The dense head y = x @ w + b for Hopper (sm_90a), fp32 or bf16, with one
// order of sum per output whatever the number of rows, in one launch.
//
// No TPU kernel stands behind it: in the JAX package the head runs inside
// the one compiled program of a forward (XLA), which keeps the served
// logits bitwise equal to a direct forward.  A library GEMM picks its
// algorithm by the row count, so a row's logits could change with the
// bucket its batch was padded to; this kernel restores the invariant.
//
// Operands (contiguous, fp32; bf16 x, w, b and out for dense_bf16): x (B,
// K), w (K, N), b (N), out (B, N); part (groups, B, N) holds the group sums
// (fp32); counters holds one int per (row tile, column tile), 0 between
// launches.
//
// bf16 (dense_bf16; the JAX package's bf16 head, x @ w + b): x, w and b
// are widened to fp32 as they are loaded, and the sums run as in fp32.  The
// JAX package rounds the product to bf16 and rounds again after the bias,
// so the last step rounds the finished sum to bf16, widens it, adds the
// widened bias in fp32 and rounds to bf16 (finish).  A lane owns V = 8
// consecutive bf16 columns and reads them as one 16-byte load, so a warp
// reads 512 contiguous bytes of a w row, as in fp32; and a CTA keeps the
// sums of ROWS = 1, 2, 4 or 8 rows, the fewest that hold the call's rows
// (up to 8), so that batch 1 issues one FFMA a weight, not 8.
//
// Sum order: K is cut into chunks of kc taps, kc a function of (K, N)
// alone (dense.py: k_chunk), and the chunks into groups of GROUP.  The sum
// of chunk j of output (i, n) starts at 0 and runs k ascending, one fmaf
// per tap, in one thread.  The chunk sums of a group are added in
// ascending order, then the group sums in ascending order, each add
// rounded on its own, and the bias last (one group: its chunk sums, then
// the bias).  No float atomics, and nothing depends on B, on the row tile
// a row falls into, the rows a CTA keeps, or on which CTA finishes first,
// so row i gives the same bits at every batch width.
//
// Bound: bytes.  At batch 1-8 the head does 2B flops per weight of 4
// bytes, far below the card's ridge, so the weights' read sets the time
// (VGG-16's fc1 at 224 is 25088 x 4096, 411 MB).  The design reads w
// once per call for up to ROWS rows: a CTA owns 32 V columns and one
// group of chunks, a warp one chunk; a lane owns V consecutive columns
// (4 fp32 or 8 bf16, 16 bytes) and keeps ROWS x V sums in registers, the
// warp's x rows sit in shared memory (broadcast reads of ROWS floats a
// tap), the w rows stream by 16-byte loads UNROLL taps ahead, and a warp
// reads 512 contiguous bytes of a w row.
// The K split puts enough warps on the card to keep its memory busy where
// N alone gives only a few thousand threads.  More than ROWS rows are
// tiled, each tile reading w again.
//
// One launch, and the chunk sums reduced where they are made: the warps
// of a CTA meet in shared memory, where each thread adds one output's
// group, in warp order.  A layer of one group is then done.  Otherwise
// each CTA stores its group sums, fences, and takes a ticket from its
// tile's counter; the CTA that arrives last adds the tile's group sums
// (from L2, one round trip: each of its threads owns one output), the
// bias, stores the outputs and sets the counter back to 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int GROUP = 8;             // chunks per group = warps per CTA
constexpr int THREADS = 32 * GROUP;  // V columns a lane
constexpr int MAX_ROWS = 8;          // rows of x per CTA (a row tile), at most
// largest chunk: the CTA stages GROUP x MAX_ROWS x KC_MAX floats of x, and
// two CTAs share an SM
constexpr int KC_MAX = 448;

static_assert(MAX_ROWS <= GROUP,
              "the group sums give each of the first ROWS warps one row");

// V consecutive values of type T as one load, split into fp32 (a bf16's
// 16 bits are the top half of its fp32 word, so widening is exact)
template <typename T, int V> struct WVec;
template <> struct WVec<float, 4> {
  using type = float4;
  static __device__ __forceinline__ void split(const float4& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <> struct WVec<float, 1> {
  using type = float;
  static __device__ __forceinline__ void split(const float& t, float (&v)[1]) {
    v[0] = t;
  }
};
template <> struct WVec<__nv_bfloat16, 8> {
  using type = uint4;
  static __device__ __forceinline__ void split(const uint4& t, float (&v)[8]) {
    const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};
template <> struct WVec<__nv_bfloat16, 1> {
  using type = unsigned short;
  static __device__ __forceinline__ void split(const unsigned short& t,
                                               float (&v)[1]) {
    v[0] = __uint_as_float(static_cast<unsigned>(t) << 16);
  }
};

// V group sums of one output row from the part buffer, past L1 (which is
// not coherent with the other SMs' stores): 16-byte loads where V allows
template <int V>
__device__ __forceinline__ void load_part(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldcg(p + i);
  }
}

// ROWS floats of x, one tap's rows, to and from shared memory as 16-, 8-
// or 4-byte words
template <int ROWS>
__device__ __forceinline__ void put_rows(float* d, const float (&v)[ROWS]) {
  if constexpr (ROWS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < ROWS / 4; ++i) {
      reinterpret_cast<float4*>(d)[i] =
          make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  } else if constexpr (ROWS == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
  } else {
    d[0] = v[0];
  }
}
template <int ROWS>
__device__ __forceinline__ void get_rows(const float* s, float (&v)[ROWS]) {
  if constexpr (ROWS % 4 == 0) {
#pragma unroll
    for (int i = 0; i < ROWS / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(s)[i];
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else if constexpr (ROWS == 2) {
    const float2 t = *reinterpret_cast<const float2*>(s);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = s[0];
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The output: the sum plus the bias, rounded on its own (fp32); or the sum
// rounded to bf16, then the bias added in fp32 and rounded to bf16 (the
// JAX package's two bf16 roundings)
__device__ __forceinline__ void finish(float* o, float s, float b) {
  *o = __fadd_rn(s, b);
}
__device__ __forceinline__ void finish(__nv_bfloat16* o, float s,
                                       __nv_bfloat16 b) {
  const float p = __bfloat162float(__float2bfloat16_rn(s));
  *o = __float2bfloat16_rn(__fadd_rn(p, __bfloat162float(b)));
}

// Whether this CTA is the last of `expected` to take a ticket from
// *ticket (which it then sets back to 0); every thread of the CTA calls
// it after its stores, and learns the same answer.  The fences order the
// CTAs' sums before the ticket and the last CTA's reads after it.
__device__ __forceinline__ bool arrive_last(int* ticket, int expected) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == expected - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  const bool out = last;
  if (out) __threadfence();
  return out;
}

// grid (column tiles, groups, row tiles).  Warp w of group g sums chunk
// g * GROUP + w over the tile's columns: lane l owns columns n0 .. n0 + V,
// for ROWS rows.  Shared memory: each warp's x rows as [k][ROWS] (zeros
// past B; only the chunk's taps are read), then, reused, each warp's chunk
// sums.
template <typename T, int V, int ROWS>
__global__ void __launch_bounds__(THREADS, 2)
dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
             const T* __restrict__ b, float* __restrict__ part,
             T* __restrict__ out, int* __restrict__ counters, int rows,
             int k_len, int n_len, int kc, int splits) {
  using WT = typename WVec<T, V>::type;
  constexpr int COLS = 32 * V;  // the tile's columns
  // w rows loaded ahead: fewer where the sums take many registers
  constexpr int UNROLL = ROWS * V > 32 ? 8 : 16;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.y;
  const int groups = gridDim.y;
  const int chunk = g * GROUP + warp;
  const int r0 = blockIdx.z * ROWS;
  const int k0 = chunk * kc;
  const int kn = chunk < splits ? min(kc, k_len - k0) : 0;
  // the chunk's x rows, a lane a tap: coalesced loads, the rows past B
  // zero, each tap's ROWS values stored together
  float* xs = sm + warp * ROWS * kc;
  const T* xb = x + static_cast<size_t>(r0) * k_len + k0;
#pragma unroll 2
  for (int k = lane; k < kn; k += 32) {
    float v[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      v[r] = r0 + r < rows ? widen(xb[static_cast<size_t>(r) * k_len + k])
                           : 0.f;
    }
    put_rows<ROWS>(xs + k * ROWS, v);
  }
  __syncwarp();
  const int n0 = (blockIdx.x * 32 + lane) * V;
  const bool live = n0 < n_len;
  float acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  if (live) {
    const WT* wp = reinterpret_cast<const WT*>(
        w + static_cast<size_t>(k0) * n_len + n0);
    const int stride = n_len / V;   // one w row, in WT words
    for (int k = 0; k < kn; k += UNROLL) {
      WT wv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < kn) {
          wv[u] = __ldg(wp + static_cast<size_t>(k + u) * stride);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (k + u < kn) {
          float wf[V];
          WVec<T, V>::split(wv[u], wf);
          float xv[ROWS];
          get_rows<ROWS>(xs + (k + u) * ROWS, xv);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
#pragma unroll
            for (int j = 0; j < V; ++j) {
              acc[r][j] = fmaf(xv[r], wf[j], acc[r][j]);
            }
          }
        }
      }
    }
  }

  // the group's chunk sums meet in shared memory, [warp][row][column]
  __syncthreads();  // every warp is done with its x rows
  float* red = sm;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      red[(warp * ROWS + r) * COLS + lane * V + j] = acc[r][j];
    }
  }
  __syncthreads();

  // thread (row = warp, lane) of the first ROWS warps: its output's group
  // sum, chunks ascending
  const bool has_row = warp < ROWS;
  const int row = r0 + warp;
  const bool mine = live && has_row && row < rows;
  const size_t at = static_cast<size_t>(row) * n_len + n0;
  const int members = min(GROUP, splits - g * GROUP);
  float s[V];
#pragma unroll
  for (int j = 0; j < V; ++j) s[j] = 0.f;
  if (has_row) {
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = red[warp * COLS + lane * V + j];
    for (int m = 1; m < members; ++m) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] = __fadd_rn(s[j], red[(m * ROWS + warp) * COLS + lane * V + j]);
      }
    }
  }
  if (groups == 1) {
    if (mine) {
#pragma unroll
      for (int j = 0; j < V; ++j) finish(out + at + j, s[j], b[n0 + j]);
    }
    return;
  }
  const size_t plane = static_cast<size_t>(rows) * n_len;
  if (mine) {
#pragma unroll
    for (int j = 0; j < V; ++j) part[g * plane + at + j] = s[j];
  }

  // the last group of the tile adds the group sums, ascending, then the
  // bias; the loads run GROUP ahead and bypass L1, which is not coherent
  // with the other SMs' stores
  if (!arrive_last(counters + blockIdx.z * gridDim.x + blockIdx.x, groups) ||
      !mine) {
    return;
  }
  const float* p = part + at;
  for (int u0 = 0; u0 < groups; u0 += GROUP) {
    float pv[GROUP][V];
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      if (u0 + u < groups) load_part<V>(p + (u0 + u) * plane, pv[u]);
    }
#pragma unroll
    for (int u = 0; u < GROUP; ++u) {
      if (u0 + u < groups) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s[j] = u0 + u == 0 ? pv[u][j] : __fadd_rn(s[j], pv[u][j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) finish(out + at + j, s[j], b[n0 + j]);
}

template <typename T, int V, int ROWS>
int launch(const T* x, const T* w, const T* b, float* part, T* out,
           int* counters, int rows, int k_len, int n_len, int kc,
           cudaStream_t stream) {
  const int splits = (k_len + kc - 1) / kc;
  const dim3 grid((n_len + 32 * V - 1) / (32 * V),
                  (splits + GROUP - 1) / GROUP, (rows + ROWS - 1) / ROWS);
  const size_t smem = sizeof(float) * GROUP * ROWS * max(kc, 32 * V);
  const auto kernel = dense_kernel<T, V, ROWS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, stream>>>(x, w, b, part, out, counters, rows,
                                          k_len, n_len, kc, splits);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 instance with the fewest rows a CTA (1, 2, 4, 8) that hold the
// call's rows, up to 8 (more are tiled by 8)
template <int V>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const __nv_bfloat16* b, float* part, __nv_bfloat16* out,
                int* counters, int rows, int k_len, int n_len, int kc,
                cudaStream_t s) {
  using T = __nv_bfloat16;
  if (rows == 1) {
    return launch<T, V, 1>(x, w, b, part, out, counters, rows, k_len, n_len,
                           kc, s);
  }
  if (rows == 2) {
    return launch<T, V, 2>(x, w, b, part, out, counters, rows, k_len, n_len,
                           kc, s);
  }
  if (rows <= 4) {
    return launch<T, V, 4>(x, w, b, part, out, counters, rows, k_len, n_len,
                           kc, s);
  }
  return launch<T, V, MAX_ROWS>(x, w, b, part, out, counters, rows, k_len,
                                n_len, kc, s);
}

// x (rows, k_len), w (k_len, n_len), b (n_len), out (rows, n_len); part
// (groups = ceil(ceil(k_len / kc) / 8), rows, n_len), the group sums;
// counters (row tiles x ceil(n_len / 32) ints, as many as the narrowest
// instance's column tiles), all 0, and left at 0.  The wide instance (16
// bytes of w a lane) where N is a multiple of its columns and w and part
// are 16-byte aligned, else one column a lane.
template <typename T>
int dense_entry(const void* x, const void* w, const void* b, void* part,
                void* out, void* counters, int rows, int k_len, int n_len,
                int kc, void* stream) {
  if (rows < 1 || k_len < 1 || n_len < 1 || kc < 1 || kc > KC_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const T*>(x);
  const auto* wt = static_cast<const T*>(w);
  const auto* bt = static_cast<const T*>(b);
  auto* pf = static_cast<float*>(part);
  auto* ot = static_cast<T*>(out);
  auto* cf = static_cast<int*>(counters);
  constexpr int V = 16 / sizeof(T);
  const bool wide = n_len % V == 0 &&
                    reinterpret_cast<size_t>(w) % 16 == 0 &&
                    reinterpret_cast<size_t>(part) % 16 == 0;
  if constexpr (std::is_same<T, float>::value) {
    if (wide) {
      return launch<T, V, MAX_ROWS>(xt, wt, bt, pf, ot, cf, rows, k_len,
                                    n_len, kc, s);
    }
    return launch<T, 1, MAX_ROWS>(xt, wt, bt, pf, ot, cf, rows, k_len, n_len,
                                  kc, s);
  } else {
    if (wide) {
      return launch_bf16<V>(xt, wt, bt, pf, ot, cf, rows, k_len, n_len, kc,
                            s);
    }
    return launch_bf16<1>(xt, wt, bt, pf, ot, cf, rows, k_len, n_len, kc, s);
  }
}

}  // namespace

extern "C" {

int dense_f32(const void* x, const void* w, const void* b, void* part,
              void* out, void* counters, int rows, int k_len, int n_len,
              int kc, void* stream) {
  return dense_entry<float>(x, w, b, part, out, counters, rows, k_len, n_len,
                            kc, stream);
}

// as dense_f32, with bf16 x, w, b and out (part stays fp32)
int dense_bf16(const void* x, const void* w, const void* b, void* part,
               void* out, void* counters, int rows, int k_len, int n_len,
               int kc, void* stream) {
  return dense_entry<__nv_bfloat16>(x, w, b, part, out, counters, rows, k_len,
                                    n_len, kc, stream);
}

}  // extern "C"

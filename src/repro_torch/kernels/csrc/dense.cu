// The dense head y = x @ w + b for Hopper (sm_90a), fp32, with one order
// of sum per output whatever the number of rows.
//
// No TPU kernel stands behind it: in the JAX package the head runs inside
// the one compiled program of a forward (XLA), which keeps the served
// logits bitwise equal to a direct forward.  A library GEMM picks its
// algorithm by the row count, so a row's logits could change with the
// bucket its batch was padded to; this kernel restores the invariant.
//
// Operands (contiguous, fp32): x (B, K), w (K, N), b (N), out (B, N);
// part (splits, B, N) holds the chunk sums.
//
// Sum order: K is cut into chunks of kc taps, kc a function of (K, N)
// alone (dense.py: k_chunk).  The sum of chunk j of output (i, n) starts
// at 0 and runs k ascending, one fmaf per tap, in one thread; the chunks
// are then added in ascending order, each add rounded on its own, and the
// bias last.  No atomics, and nothing depends on B or on which row tile a
// row falls into, so row i gives the same bits at every batch width.
//
// Bound: bytes.  At batch 1-8 the head does 2B flops per weight of 4
// bytes, far below the card's ridge, so the weights' read sets the time
// (VGG-16's fc1 at 224 is 25088 x 4096, 411 MB).  The design reads w
// once per call for up to ROWS rows: a thread owns V consecutive columns
// of one chunk and keeps ROWS x V sums in registers, the chunk's x rows
// sit in shared memory (two 16-byte broadcast reads a tap), the w rows
// stream by 16-byte loads UNROLL taps ahead, and a warp reads 512
// contiguous bytes of a w row.  The K split puts enough CTAs on the card
// to keep its memory busy where N alone gives only a few thousand
// threads.  More than ROWS rows are tiled, each tile reading w again.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 128;  // threads per CTA, V columns each
constexpr int ROWS = 8;       // rows of x per CTA (a row tile)
constexpr int UNROLL = 8;     // w rows loaded ahead
constexpr int KC_MAX = 1024;  // largest chunk: ROWS x KC_MAX floats of x

template <int V> struct WVec;
template <> struct WVec<4> {
  using type = float4;
  static __device__ __forceinline__ void split(const float4& t, float (&v)[4]) {
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};
template <> struct WVec<1> {
  using type = float;
  static __device__ __forceinline__ void split(const float& t, float (&v)[1]) {
    v[0] = t;
  }
};

// grid (column tiles, K chunks, row tiles).  Shared memory: the chunk's x
// rows as [k][ROWS], zeros past B and past K.
template <int V>
__global__ void __launch_bounds__(THREADS)
dense_chunk(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ part, int rows, int k_len, int n_len,
            int kc) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int r0 = blockIdx.z * ROWS;
  const int k0 = blockIdx.y * kc;
  const int kn = min(kc, k_len - k0);
  for (int e = threadIdx.x; e < ROWS * kc; e += THREADS) {
    const int k = e / ROWS;
    const int r = e - k * ROWS;
    xs[e] = (r0 + r < rows && k < kn)
        ? x[static_cast<size_t>(r0 + r) * k_len + k0 + k] : 0.f;
  }
  __syncthreads();
  const int n0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (n0 >= n_len) return;
  float acc[ROWS][V];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[r][j] = 0.f;
  }
  using WT = typename WVec<V>::type;
  const WT* wp = reinterpret_cast<const WT*>(
      w + static_cast<size_t>(k0) * n_len + n0);
  const int stride = n_len / V;   // one w row, in WT words
  for (int k = 0; k < kn; k += UNROLL) {
    WT wv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k + u < kn) wv[u] = __ldg(wp + static_cast<size_t>(k + u) * stride);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (k + u < kn) {
        float wf[V];
        WVec<V>::split(wv[u], wf);
        const float4* xr = reinterpret_cast<const float4*>(xs + (k + u) * ROWS);
        const float4 xa = xr[0], xb = xr[1];
        const float xv[ROWS] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
#pragma unroll
          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(xv[r], wf[j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r0 + r >= rows) break;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[(static_cast<size_t>(blockIdx.y) * rows + r0 + r) * n_len + n0 +
           j] = acc[r][j];
    }
  }
}

// The chunk sums of each output in ascending order, then the bias; the
// loads run UNROLL chunks ahead of the adds
__global__ void __launch_bounds__(256)
dense_sum(const float* __restrict__ part, const float* __restrict__ b,
          float* __restrict__ out, int rows, int n_len, int splits) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= rows * n_len) return;
  const size_t plane = static_cast<size_t>(rows) * n_len;
  const float* p = part + i;
  float acc = p[0];
  int s = 1;
  for (; s + UNROLL <= splits; s += UNROLL) {
    float v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = p[(s + u) * plane];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, v[u]);
  }
  for (; s < splits; ++s) acc = __fadd_rn(acc, p[s * plane]);
  out[i] = __fadd_rn(acc, b[i % n_len]);
}

template <int V>
int launch(const float* x, const float* w, const float* b, float* part,
           float* out, int rows, int k_len, int n_len, int kc,
           cudaStream_t stream) {
  const int splits = (k_len + kc - 1) / kc;
  const dim3 grid((n_len + THREADS * V - 1) / (THREADS * V), splits,
                  (rows + ROWS - 1) / ROWS);
  const size_t smem = sizeof(float) * ROWS * kc;
  dense_chunk<V><<<grid, THREADS, smem, stream>>>(x, w, part, rows, k_len,
                                                  n_len, kc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_sum<<<(rows * n_len + 255) / 256, 256, 0, stream>>>(part, b, out,
                                                            rows, n_len,
                                                            splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (rows, k_len), w (k_len, n_len), b (n_len), out (rows, n_len); part
// (ceil(k_len / kc), rows, n_len), the chunk sums
int dense_f32(const void* x, const void* w, const void* b, void* part,
              void* out, int rows, int k_len, int n_len, int kc,
              void* stream) {
  if (rows < 1 || k_len < 1 || n_len < 1 || kc < 1 || kc > KC_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* pf = static_cast<float*>(part);
  auto* of = static_cast<float*>(out);
  if (n_len % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0) {
    return launch<4>(xf, wf, bf, pf, of, rows, k_len, n_len, kc, s);
  }
  return launch<1>(xf, wf, bf, pf, of, rows, k_len, n_len, kc, s);
}

}  // extern "C"

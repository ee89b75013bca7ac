// Causal depthwise conv1d for Hopper (sm_90a): the Mamba2 mixer's
// short convolution in front of (x, B, C),
//   out[b, t, d] = sum_k w[k, d] * x[b, t - K + 1 + k, d],
// with x[b, t', d] = 0 for t' < 0.
//
// Replaces the Pallas TPU kernel repro/kernels/conv1d_causal.py:_kernel
// (launched from conv1d_causal_folded).  There the whole time axis of one
// (batch, channel-fold) block sits in VMEM and the wrapper pads x in front
// (K - 1 zero rows) and in D.  Here nothing is padded: the causal edge and
// the ragged D edge are masked in the kernel.
//
// Operands (contiguous): x (B, T, D) and out (B, T, D) in fp32 or bf16,
// w (K, D) in fp32, or in bf16 beside a bf16 x (the model's type: the
// kernel widens it, exactly, as it loads it), K <= KMAX.
//
// Bound: bytes.  Each output element costs K multiply-adds on 2 (bf16) or
// 4 (fp32) bytes read and written, far below the card's ridge point, so
// the kernel has to keep enough bytes in flight to cover the latency of
// device memory.  Two paths, both this kernel, picked by the launcher from
// the operands (vector_ok):
//
// * The vector path (D a multiple of V = 16 / sizeof(T), x, w and out on
//   16-byte boundaries): a thread owns V channels (one 16-byte word) of
//   one batch row over a tile of TT = 8 consecutive steps.  It issues the
//   TT + K - 1 word loads of its window (the K - 1 rows in front of the
//   tile, from L2 where the tile before has read them, then the tile's
//   own rows) before any math, so TT + K - 1 16-byte loads are in flight
//   a thread, then computes and stores the TT outputs, one 16-byte store
//   each.  Neighbouring threads own neighbouring words of one row, so a
//   warp moves 512 contiguous bytes per instruction.  The (word, tile,
//   batch) index is flattened over the grid, so no CTA idles on a ragged
//   D and the grid fills the card at zamba2's prefill shape ((2, 2048,
//   4224) bf16: 528 words x 256 tiles x 2 rows, 1056 CTAs of 256
//   threads).  K is a template parameter and TT a constant, so the window
//   and the K x V taps live in registers (110 at K = 4 for a bf16 x and
//   w).  A sweep of 8, 16 and 32 steps on an H100 found 16 and 32 no
//   faster, and 32 spilled registers at K = 7 and 8.  At the prefill
//   shape the kernel runs within a few percent of torch's copy of x (the
//   same bytes moved, no halo, no math; chip_smoke.py times both), so the
//   memory system's copy rate, not the kernel, is what binds it.
// * The scalar path (any other D, a storage offset off the 16-byte grid):
//   a thread owns one channel and walks T_TILE steps with the K taps and
//   the last K - 1 inputs in registers; one 2- or 4-byte access a step.
//
// Sum order (both paths): the sum starts at 0.0f and adds the taps k = 0
// .. K-1, each product and each sum rounded on its own (__fmul_rn,
// __fadd_rn, never a fused multiply-add), w in fp32.  That is the order
// and rounding of the plain PyTorch version
// (kernels/ref.py:conv1d_causal_ref), so the two agree bit for bit; bf16
// output narrows with __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KMAX = 8;         // the largest K either path holds
constexpr int THREADS = 128;    // scalar path: channels per CTA
constexpr int T_TILE = 64;      // scalar path: time steps per thread
constexpr int VEC_THREADS = 256;  // vector path: threads per CTA
constexpr int TT = 8;             // vector path: time steps per thread

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One 16-byte word of V channels: element j widened to fp32, and V fp32
// sums narrowed into a word.
__device__ __forceinline__ uint32_t lane_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float get(const uint4& v, int j) {
    return __uint_as_float(lane_word(v, j));
  }
  static __device__ __forceinline__ uint4 put(const float (&a)[V]) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int V = 8;
  // element 2i sits in the low half of 32-bit word i, 2i + 1 in the high
  // half; a bf16's fp32 value is its bits in the high half (exact)
  static __device__ __forceinline__ float get(const uint4& v, int j) {
    const uint32_t u = lane_word(v, j >> 1);
    return __uint_as_float((j & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return static_cast<uint32_t>(
               __bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
  }
  static __device__ __forceinline__ uint4 put(const float (&a)[V]) {
    return make_uint4(pack(a[0], a[1]), pack(a[2], a[3]), pack(a[4], a[5]),
                      pack(a[6], a[7]));
  }
};

// The taps of V channels of row k of w, widened to fp32: 16-byte loads
// of fp32 taps, or one 16-byte word of 8 bf16 taps (V = 8: bf16 x).
template <int V>
__device__ __forceinline__ void load_taps(const float* w, float (&t)[V]) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(w) + q);
    t[4 * q] = f.x;
    t[4 * q + 1] = f.y;
    t[4 * q + 2] = f.z;
    t[4 * q + 3] = f.w;
  }
}
template <int V>
__device__ __forceinline__ void load_taps(const __nv_bfloat16* w,
                                          float (&t)[V]) {
  static_assert(V == Word<__nv_bfloat16>::V, "a bf16 w goes with a bf16 x");
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(w));
#pragma unroll
  for (int j = 0; j < V; ++j) t[j] = Word<__nv_bfloat16>::get(u, j);
}

// The vector path.  Thread i of the grid owns word v = i % dv of batch
// row b = i / (dv * n_tiles) over the steps t0 .. t0 + TT - 1 of tile
// (i / dv) % n_tiles; dv = D / V words a row.
template <typename T, typename WT, int K>
__global__ void __launch_bounds__(VEC_THREADS)
conv1d_causal_vec_kernel(const T* __restrict__ x,
                         const WT* __restrict__ w, T* __restrict__ out,
                         int t_len, int dv, int n_tiles,
                         long long threads) {
  using W = Word<T>;
  constexpr int V = W::V;
  constexpr int ROWS = TT + K - 1;  // the window: K - 1 in front, the tile
  const long long i =
      static_cast<long long>(blockIdx.x) * VEC_THREADS + threadIdx.x;
  if (i >= threads) return;
  const int v = static_cast<int>(i % dv);
  const long long r = i / dv;
  const int t0 = static_cast<int>(r % n_tiles) * TT;
  const long long row0 = (r / n_tiles) * t_len;  // the batch row's step 0
  const uint4* xw = reinterpret_cast<const uint4*>(x) + row0 * dv + v;
  uint4* ow = reinterpret_cast<uint4*>(out) + row0 * dv + v;

  // every load of the window first: rows before 0 or past T are zeros
  uint4 win[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int t = t0 - (K - 1) + j;
    win[j] = (t >= 0 && t < t_len)
                 ? __ldg(xw + static_cast<long long>(t) * dv)
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  float taps[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    load_taps(w + static_cast<long long>(k) * dv * V
                  + static_cast<long long>(v) * V, taps[k]);
  }
#pragma unroll
  for (int s = 0; s < TT; ++s) {
    if (t0 + s >= t_len) break;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    // output step t0 + s reads window rows s .. s + K - 1
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(W::get(win[s + k], j),
                                             taps[k][j]));
      }
    }
    ow[static_cast<long long>(t0 + s) * dv] = W::put(acc);
  }
}

// The scalar path: a thread owns channel d of one batch row over T_TILE
// steps, the K taps and the last K - 1 inputs in registers.
template <typename T, typename WT>
__global__ void __launch_bounds__(THREADS)
conv1d_causal_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                     T* __restrict__ out, int t_len, int d_len, int k_len) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= d_len) return;
  const int t0 = blockIdx.y * T_TILE;
  const long long row = static_cast<long long>(blockIdx.z) * t_len;
  const T* xb = x + row * d_len + d;
  T* ob = out + row * d_len + d;

  float taps[KMAX];
  float win[KMAX];  // win[k] = x[t - K + 1 + k] for the step t at hand
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    taps[k] = k < k_len ? widen(w[k * d_len + d]) : 0.0f;
    win[k] = 0.0f;
  }
  // the K - 1 inputs in front of the tile; zero before t = 0
#pragma unroll
  for (int k = 0; k < KMAX - 1; ++k) {
    const int t = t0 - k_len + 1 + k;
    if (k < k_len - 1 && t >= 0) win[k] = widen(xb[static_cast<long long>(t) * d_len]);
  }
  const int t_end = min(t0 + T_TILE, t_len);
  for (int t = t0; t < t_end; ++t) {
    // the newest input enters the window at k = K - 1
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k == k_len - 1) win[k] = widen(xb[static_cast<long long>(t) * d_len]);
    }
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      if (k < k_len) acc = __fadd_rn(acc, __fmul_rn(win[k], taps[k]));
    }
    narrow(ob + static_cast<long long>(t) * d_len, acc);
    // shift the window by one step
#pragma unroll
    for (int k = 0; k < KMAX - 1; ++k) win[k] = win[k + 1];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Whether the vector path takes these operands.
template <typename T>
bool vector_ok(const void* x, const void* w, const void* out, int d_len) {
  return d_len % Word<T>::V == 0 && aligned16(x) && aligned16(w) &&
         aligned16(out);
}

template <typename T, typename WT, int K>
int launch_vec(const void* x, const void* w, void* out, int b, int t_len,
               int d_len, cudaStream_t stream) {
  const int dv = d_len / Word<T>::V;
  const int n_tiles = (t_len + TT - 1) / TT;
  const long long threads = static_cast<long long>(b) * n_tiles * dv;
  const long long ctas = (threads + VEC_THREADS - 1) / VEC_THREADS;
  if (ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  conv1d_causal_vec_kernel<T, WT, K>
      <<<static_cast<unsigned>(ctas), VEC_THREADS, 0, stream>>>(
          static_cast<const T*>(x), static_cast<const WT*>(w),
          static_cast<T*>(out), t_len, dv, n_tiles, threads);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename WT>
int launch(const void* x, const void* w, void* out, int b, int t_len,
           int d_len, int k_len, void* stream_) {
  if (k_len < 1 || k_len > KMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || t_len == 0 || d_len == 0) return 0;
  const auto stream = static_cast<cudaStream_t>(stream_);
  if (vector_ok<T>(x, w, out, d_len)) {
    switch (k_len) {
      case 1: return launch_vec<T, WT, 1>(x, w, out, b, t_len, d_len, stream);
      case 2: return launch_vec<T, WT, 2>(x, w, out, b, t_len, d_len, stream);
      case 3: return launch_vec<T, WT, 3>(x, w, out, b, t_len, d_len, stream);
      case 4: return launch_vec<T, WT, 4>(x, w, out, b, t_len, d_len, stream);
      case 5: return launch_vec<T, WT, 5>(x, w, out, b, t_len, d_len, stream);
      case 6: return launch_vec<T, WT, 6>(x, w, out, b, t_len, d_len, stream);
      case 7: return launch_vec<T, WT, 7>(x, w, out, b, t_len, d_len, stream);
      default: return launch_vec<T, WT, 8>(x, w, out, b, t_len, d_len, stream);
    }
  }
  const dim3 grid((d_len + THREADS - 1) / THREADS,
                  (t_len + T_TILE - 1) / T_TILE, b);
  conv1d_causal_kernel<T, WT><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const WT*>(w),
      static_cast<T*>(out), t_len, d_len, k_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x fp32, w fp32
int conv1d_causal_f32(const void* x, const void* w, void* out, int b,
                      int t_len, int d_len, int k_len, void* stream) {
  return launch<float, float>(x, w, out, b, t_len, d_len, k_len, stream);
}

// x bf16, w fp32
int conv1d_causal_bf16(const void* x, const void* w, void* out, int b,
                       int t_len, int d_len, int k_len, void* stream) {
  return launch<__nv_bfloat16, float>(x, w, out, b, t_len, d_len, k_len,
                                      stream);
}

// x bf16, w bf16
int conv1d_causal_bf16_wbf16(const void* x, const void* w, void* out, int b,
                             int t_len, int d_len, int k_len, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, b, t_len, d_len,
                                              k_len, stream);
}

// 1 where the launcher takes the vector path for these operands (elem_bytes
// 4 for fp32 x, 2 for bf16), else 0.
int conv1d_causal_vector_path(const void* x, const void* w, const void* out,
                              int d_len, int elem_bytes) {
  return elem_bytes == 2 ? vector_ok<__nv_bfloat16>(x, w, out, d_len)
                         : vector_ok<float>(x, w, out, d_len);
}

}  // extern "C"

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
// w (K, D) in fp32 (the wrapper widens a bf16 w, exactly), K <= KMAX.
//
// Bound: bytes.  Each output element costs K multiply-adds on 2 (bf16) or
// 4 (fp32) bytes read and written, far below the card's ridge point.  The
// design reads each x element once from device memory: a thread owns one
// channel d of one batch row and walks a tile of T_TILE consecutive steps,
// keeping the K taps and the last K - 1 inputs in registers.  Neighbouring
// threads own neighbouring channels, so every load and store of a warp is
// one contiguous run along D.  Only the K - 1 rows in front of each tile
// are read twice (by the tile before it too), from L2.
//
// Sum order: the sum starts at 0.0f and adds the taps k = 0 .. K-1, each
// product and each sum rounded on its own (__fmul_rn, __fadd_rn, never a
// fused multiply-add), w in fp32.  That is the order and rounding
// of the plain PyTorch version (kernels/ref.py:conv1d_causal_ref), so the
// two agree bit for bit; bf16 output narrows with __float2bfloat16_rn.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // channels per CTA
constexpr int T_TILE = 64;    // time steps per thread
constexpr int KMAX = 8;       // the largest K the register window holds

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1d_causal_kernel(const T* __restrict__ x, const float* __restrict__ w,
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
    taps[k] = k < k_len ? w[k * d_len + d] : 0.0f;
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

template <typename T>
int launch(const void* x, const void* w, void* out, int b, int t_len,
           int d_len, int k_len, void* stream) {
  if (k_len < 1 || k_len > KMAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (b == 0 || t_len == 0 || d_len == 0) return 0;
  const dim3 grid((d_len + THREADS - 1) / THREADS,
                  (t_len + T_TILE - 1) / T_TILE, b);
  conv1d_causal_kernel<T>
      <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<T*>(out), t_len, d_len, k_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int conv1d_causal_f32(const void* x, const void* w, void* out, int b,
                      int t_len, int d_len, int k_len, void* stream) {
  return launch<float>(x, w, out, b, t_len, d_len, k_len, stream);
}

int conv1d_causal_bf16(const void* x, const void* w, void* out, int b,
                       int t_len, int d_len, int k_len, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, b, t_len, d_len, k_len, stream);
}

}  // extern "C"

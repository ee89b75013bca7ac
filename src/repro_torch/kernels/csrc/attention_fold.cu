// Fold-streamed attention for Hopper (sm_90a): online-softmax attention
// with grouped KV heads and causal / sliding-window masks,
//   out[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h / G] * hd^-1/2 | mask)
//                  @ v[b, s, h / G],                  G = H / KV.
//
// Replaces the Pallas TPU kernel repro/kernels/attention_fold.py:_kernel
// (launched from flash_attention_folded).  There the grid walks
// (B, H, Tq/qb, Tkv/kb) with the kv blocks innermost and in order, the q
// block resident and the running (max, denominator, accumulator) in VMEM
// scratch.  Here a CTA owns one (batch, head, q tile of QT rows) and walks
// the kv tiles itself, in order; each thread owns one query row and keeps
// its scaled q, its accumulator, its running max and its denominator in
// registers.  The kv head is h / (H / KV): no copy of K or V is made.
//
// Operands (contiguous, one type, fp32 or bf16): q (B, T, H, hd),
// k and v (B, S, KV, hd), out (B, T, H, hd); hd in {16, 32, 64, 128}.
// The math is fp32 whatever the operand type: q is scaled by hd^-1/2 in
// fp32, masked scores are -1e30 (not -inf, whose exp(-inf - -inf) would be
// NaN before the first visible key), the output is acc / max(d, 1e-30) in
// the operands' type.
//
// Bound: operations.  Each (query, key) pair costs 2*hd multiply-adds and
// the operands are read once per CTA, so at zamba2's shape (T = S = 2048,
// hd = 64) the fp32 arithmetic binds long before device memory does.  The
// design keeps every operand of the inner loops on chip: a K tile and a V
// tile of KT rows are staged in shared memory as fp32, read by every
// thread at the same address (a broadcast, four values per load), and the
// KT scores of a row wait in shared memory between the max pass and the
// exponent pass.  A kv tile that the causal or window mask hides from
// every row of the q tile is skipped; that changes no bit of the result,
// since a row's first visible key sets its correction factor to 0 and the
// hidden keys' p = exp(-1e30 - m) is 0 after it.  The tensor-core
// (mma / wgmma) design is a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 64;  // query rows per CTA, one per thread
constexpr int KT = 64;  // kv rows per staged tile
constexpr float NEG = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * KT * HD + KT * QT);
}

template <typename T, int HD>
__global__ void __launch_bounds__(QT)
attention_fold_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      int t_len, int s_len, int heads, int kv_heads,
                      int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // (KT, HD)
  float* vs = ks + KT * HD;                     // (KT, HD)
  float* sc = vs + KT * HD;                     // (KT, QT) scores

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.x * QT;
  const int row = q0 + tid;
  const bool live = row < t_len;
  const int q_last = min(q0 + QT, t_len) - 1;

  float qr[HD];
  float acc[HD];
  const T* qp = q + ((static_cast<long long>(b) * t_len + row) * heads + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qr[d] = live ? __fmul_rn(widen(qp[d]), scale) : 0.0f;
    acc[d] = 0.0f;
  }
  float m = NEG;
  float den = 0.0f;

  // the kv tiles any row of this q tile can see
  int k_hi = s_len;
  if (causal) k_hi = min(k_hi, q_last + 1);
  int k_lo = 0;
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const long long kv_stride = static_cast<long long>(kv_heads) * HD;
  const T* kb = k + static_cast<long long>(b) * s_len * kv_stride + kh * HD;
  const T* vb = v + static_cast<long long>(b) * s_len * kv_stride + kh * HD;

  for (int k0 = (k_lo / KT) * KT; k0 < k_hi; k0 += KT) {
    const int kt_n = min(KT, s_len - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kt_n * HD; i += QT) {
      const int j = i / HD, d = i - j * HD;
      const long long off = (k0 + j) * kv_stride + d;
      ks[i] = widen(kb[off]);
      vs[i] = widen(vb[off]);
    }
    __syncthreads();

    float mt = NEG;
    for (int j = 0; j < kt_n; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * HD);
      float s = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 kk = kr[d4];
        s += qr[4 * d4] * kk.x + qr[4 * d4 + 1] * kk.y +
             qr[4 * d4 + 2] * kk.z + qr[4 * d4 + 3] * kk.w;
      }
      const int kpos = k0 + j;
      const bool visible = (!causal || kpos <= row) &&
                           (window <= 0 || kpos > row - window);
      s = visible ? s : NEG;
      sc[j * QT + tid] = s;
      mt = fmaxf(mt, s);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= corr;
    float psum = 0.0f;
    for (int j = 0; j < kt_n; ++j) {
      const float p = expf(sc[j * QT + tid] - m_new);
      psum += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * HD);
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 vv = vr[d4];
        acc[4 * d4] += p * vv.x;
        acc[4 * d4 + 1] += p * vv.y;
        acc[4 * d4 + 2] += p * vv.z;
        acc[4 * d4 + 3] += p * vv.w;
      }
    }
    den = den * corr + psum;
    m = m_new;
  }

  if (!live) return;
  const float denom = fmaxf(den, 1e-30f);
  T* op = out + ((static_cast<long long>(b) * t_len + row) * heads + h) * HD;
#pragma unroll
  for (int d = 0; d < HD; ++d) narrow(op + d, acc[d] / denom);
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int t_len, int s_len, int heads, int kv_heads, int causal,
              int window, float scale, void* stream) {
  const auto kernel = attention_fold_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t_len + QT - 1) / QT, heads, b);
  kernel<<<grid, QT, smem, static_cast<cudaStream_t>(stream)>>>(
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

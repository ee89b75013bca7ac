// Fold-streamed convolution for Hopper (sm_90a): the bf16 entry points of
// the WS, OS, depthwise and psum kernels.  WS, OS and psum run on the
// tensor cores (fold_conv_tc.cuh: bf16 operands, fp32 sums, one rounding to
// bf16 at the store, one chain of 16-tap MMA steps per output whatever the
// dataflow); depthwise on fold_conv.cuh's FFMA kernel (T = __nv_bfloat16,
// A = float: each bf16 value widened to fp32 as it loads, two a load).

#include "fold_conv_tc.cuh"

extern "C" {

// The bf16 instances: the same arguments as their fp32 counterparts; x, w,
// res, out (and psum) are bf16, vec fp32, the WS slab fp32.  The tile is
// one of TcTile0..TcTile7 for OS, of the first TC_WS_TILES for WS and psum.

int fold_conv_ws_bf16(const void* x, const void* w, const void* vec,
                      const void* res, void* out, void* slab, int n,
                      int c_pad, int x_rows, int yp, int nf_pad, int r, int s,
                      int stride, int q, int p_pad, int groups, int c_b,
                      int epi, int tile, int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, m_per_cta};
  return launch_fold_tc(tile, KIND_WS, x, w, vec, res, out, slab, g, stream);
}

int fold_conv_os_bf16(const void* x, const void* w, const void* vec,
                      const void* res, void* out, int n, int c_pad,
                      int x_rows, int yp, int nf_pad, int r, int s,
                      int stride, int q, int p_pad, int groups, int c_b,
                      int epi, int tile, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, 1};
  return launch_fold_tc(tile, KIND_OS, x, w, vec, res, out, nullptr, g,
                        stream);
}

int fold_conv_dw_bf16(const void* x, const void* w, const void* vec,
                      const void* res, void* out, int n, int c, int c_pad,
                      int x_rows, int yp, int r, int s, int stride, int q,
                      int p_pad, int epi, int tq, int rows, int chans,
                      int pairs, void* stream) {
  return launch_dw<__nv_bfloat16, float>(x, w, vec, res, out, n, c, c_pad,
                                         x_rows, yp, r, s, stride, q, p_pad,
                                         epi, tq, rows, chans, pairs, stream);
}

int fold_conv_psum_bf16(const void* x, const void* w, void* psum, int n,
                        int c_pad, int x_rows, int yp, int nf_pad, int r,
                        int s, int stride, int q, int p_pad, int c_b,
                        int tile, int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, 1,
               c_b, 0, m_per_cta};
  return launch_fold_tc(tile, KIND_PSUM, x, w, nullptr, nullptr, nullptr,
                        psum, g, stream);
}

}  // extern "C"

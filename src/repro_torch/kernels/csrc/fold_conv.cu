// Fold-streamed convolution for Hopper (sm_90a): the fp32 and int8 entry
// points of the WS, OS, depthwise and psum kernels (fold_conv.cuh holds
// the kernels and says what they compute and how; fold_conv_bf16.cu the
// bf16 entries).

#include "fold_conv.cuh"

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
  return launch_fold<float, float>(tile, KIND_WS, x, w, vec, res, out, slab, g,
                                   stream);
}

int fold_conv_ws_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, void* slab, int n, int c_pad,
                    int x_rows, int yp, int nf_pad, int r, int s, int stride,
                    int q, int p_pad, int groups, int c_b, int epi, int tile,
                    int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, m_per_cta};
  return launch_fold<int8_t, int>(tile, KIND_WS, x, w, vec, res, out, slab, g,
                                  stream);
}

int fold_conv_os(const void* x, const void* w, const void* vec,
                 const void* res, void* out, int n, int c_pad, int x_rows,
                 int yp, int nf_pad, int r, int s, int stride, int q,
                 int p_pad, int groups, int c_b, int epi, int tile,
                 void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, 1};
  return launch_fold<float, float>(tile, KIND_OS, x, w, vec, res, out, nullptr,
                                   g, stream);
}

int fold_conv_os_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, int n, int c_pad, int x_rows,
                    int yp, int nf_pad, int r, int s, int stride, int q,
                    int p_pad, int groups, int c_b, int epi, int tile,
                    void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, groups,
               c_b, epi, 1};
  return launch_fold<int8_t, int>(tile, KIND_OS, x, w, vec, res, out, nullptr,
                                  g, stream);
}

// The depthwise entries: the operands, then n, c, c_pad, x_rows, yp, r, s,
// stride, q, p_pad, epi and the geometry dw_geometry picks: the outputs a
// thread owns along Q, the output rows and channels a CTA, and whether the
// window loads two elements at a time.

int fold_conv_dw(const void* x, const void* w, const void* vec,
                 const void* res, void* out, int n, int c, int c_pad,
                 int x_rows, int yp, int r, int s, int stride, int q,
                 int p_pad, int epi, int tq, int rows, int chans,
                 int pairs, void* stream) {
  return launch_dw<float, float>(x, w, vec, res, out, n, c, c_pad, x_rows,
                                 yp, r, s, stride, q, p_pad, epi, tq, rows,
                                 chans, pairs, stream);
}

int fold_conv_dw_i8(const void* x, const void* w, const void* vec,
                    const void* res, void* out, int n, int c, int c_pad,
                    int x_rows, int yp, int r, int s, int stride, int q,
                    int p_pad, int epi, int tq, int rows, int chans,
                    int pairs, void* stream) {
  return launch_dw<int8_t, int>(x, w, vec, res, out, n, c, c_pad, x_rows,
                                yp, r, s, stride, q, p_pad, epi, tq, rows,
                                chans, pairs, stream);
}

// n .. p_pad as above, then c_b, the tile and the M tiles one CTA walks
int fold_conv_psum(const void* x, const void* w, void* psum, int n,
                   int c_pad, int x_rows, int yp, int nf_pad, int r, int s,
                   int stride, int q, int p_pad, int c_b, int tile,
                   int m_per_cta, void* stream) {
  const Geom g{n, c_pad, x_rows, yp, nf_pad, r, s, stride, q, p_pad, 1,
               c_b, 0, m_per_cta};
  return launch_fold<float, float>(tile, KIND_PSUM, x, w, nullptr, nullptr,
                                   nullptr, psum, g, stream);
}

}  // extern "C"

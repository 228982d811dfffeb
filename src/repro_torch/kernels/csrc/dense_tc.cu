// Dense-backend kernels for Hopper (sm_90a): the bit planes decoded to
// +-1/0 int8 in shared memory and multiplied on the tensor cores, with the
// eq. (2) epilogue in-kernel.  TNN, TBN and BNN.
//
// Replaces the Pallas kernels of the JAX package's dense backend
// (kernels/dense_fused.py):
//   dense_matmul_fused_pallas  -> dense_gemm_kernel
//   dense_conv_fused_pallas    -> dense_conv_kernel
//
// GeMM: C[m, n] = sum_k A[m, k] B[n, k] over the decoded planes A (m, kw)
// and B^T (n, kw), then acc * row[m] * col[n] (+ bias[n]) in float32.
// Conv: the implicit-im2col product of x (B, H, W, C) float32 NHWC with
// the positional weight planes (cout, kh*kw*ceil(C/32)), the A values
// gathered and quantized in-kernel with the per-tensor statistics, then
// acc * scale * col[n] (+ bias[n]).
//
// The count is exact: the products are +-1/0 and the int32 accumulators
// hold every partial sum, so it is the integer the reference's f32 dot
// and the popcount kernels give.  With --fmad=false and __fmul_rn /
// __fadd_rn the epilogue rounds as the plain version does, so dense ==
// popcount == plain, bit for bit.
//
// Padding:
//   * BNN pad bits past k_valid decode to +1 on both operands; the GeMM
//     zeroes the A values at depth >= k_valid (the reference masks A the
//     same way).  Ternary pads are (0, 0) = 0 and need no mask.
//   * Conv: a pixel outside the image is the value 0.0 and is quantized
//     with the same predicate (BNN: +1), as the materializing im2col
//     oracle pads with zeros; a channel past C within a position's word
//     run is 0 on the A side, which cancels the weights' in-word pads.
//
// What bounds it on this card: at the paper's CNN widths the work is far
// below the int8 tensor rate (1,979 TOP/s dense), so the bound is the
// bytes a call must move (x read once, the float32 output written once)
// at 3.35 TB/s; on the GEMM_GRID shapes it is launch latency.  What the
// kernel spends its time on instead is the operand staging: the GeMM
// decodes every plane word once per CTA, and the conv gathers each input
// value once per patch position that holds it and per 64-column block,
// as lowbit_conv.cu does.  The design keeps the decoded tiles and the
// accumulators on chip (shared memory, tensor-core fragments), so neither
// the +-1/0 matrices nor the im2col matrix ever reach device memory.  Not
// done yet (later work): wgmma with TMA-fed, double-buffered staging, and
// quantizing each input pixel once per CTA.
//
// Built with --fmad=false (see _build.py).

#include "tc_core.cuh"

namespace tc {

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dense_gemm_kernel(const uint32_t* __restrict__ a0,
                  const uint32_t* __restrict__ a1,
                  const uint32_t* __restrict__ b0,
                  const uint32_t* __restrict__ b1, int m, int n, int kw,
                  int k_valid, const float* __restrict__ row,
                  const float* __restrict__ col,
                  const float* __restrict__ bias, float* __restrict__ out) {
  using lowbit::BNN;
  using lowbit::TNN;
  __shared__ Smem<int8_t> s;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  constexpr int kNoMask = 0x7fffffff;
  Acc acc[2][2];
  zero_acc(acc);
  for (int w0 = 0; w0 < kw; w0 += BKW) {
    stage_planes<MODE != BNN, BM>(s.in.a, a0, a1, m0, m, w0, kw,
                                  MODE == BNN ? k_valid : kNoMask);
    stage_planes<MODE == TNN, BN>(s.in.b, b0, b1, n0, n, w0, kw, kNoMask);
    __syncthreads();
    mma_step(s, wr, wc, acc);
    __syncthreads();
  }
  store_acc(s, wr, wc, acc);
  store_scaled(s, m0, n0, m, n, row, 1, col, bias, out);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dense_conv_kernel(const float* __restrict__ x, int H, int W, int C, int KW,
                  int stride, int pad_top, int pad_left, int OH, int OW,
                  int m, const uint32_t* __restrict__ b0,
                  const uint32_t* __restrict__ b1, int cout, int words,
                  int cw, const float* __restrict__ thr_p,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ col,
                  const float* __restrict__ bias, float* __restrict__ out) {
  using lowbit::BNN;
  using lowbit::TNN;
  __shared__ Smem<int8_t> s;
  __shared__ int s_b[BM], s_h[BM], s_w[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / 2, wc = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // Output pixel of each tile row: image, and the top-left input pixel of
  // its patch (before padding is removed); b = -1 past m.
  if (tid < BM) {
    const int gm = m0 + tid;
    if (gm < m) {
      const int b = gm / (OH * OW), rem = gm - b * (OH * OW);
      const int oh = rem / OW, ow = rem - oh * OW;
      s_b[tid] = b;
      s_h[tid] = oh * stride - pad_top;
      s_w[tid] = ow * stride - pad_left;
    } else {
      s_b[tid] = -1;
      s_h[tid] = 0;
      s_w[tid] = 0;
    }
  }
  float thr = 0.f;
  if constexpr (MODE != BNN) thr = __ldg(thr_p);
  __syncthreads();

  Acc acc[2][2];
  zero_acc(acc);
  for (int w0 = 0; w0 < words; w0 += BKW) {
    // A: one warp per (row, word); lane i gathers channel 32*wi + i of
    // the word's patch position (one coalesced 128-byte load) and stores
    // its +-1/0 value at depth 32*w + i of the step.
    for (int idx = warp; idx < BM * BKW; idx += THREADS / 32) {
      const int w = idx / BM, r = idx % BM;
      const int gk = w0 + w, b = s_b[r];
      int q = 0;
      if (gk < words && b >= 0) {
        const int p = gk / cw, wi = gk - p * cw;
        const int ch = wi * 32 + lane;
        if (ch < C) {
          const int dy = p / KW, dx = p - dy * KW;
          const int h = s_h[r] + dy, ww = s_w[r] + dx;
          float v = 0.f;
          if (h >= 0 && h < H && ww >= 0 && ww < W)
            v = __ldg(x + ((static_cast<size_t>(b) * H + h) * W + ww) * C + ch);
          if constexpr (MODE == BNN)
            q = v < 0.f ? -1 : 1;
          else
            q = fabsf(v) > thr ? (v > 0.f ? 1 : (v < 0.f ? -1 : 0)) : 0;
        }
      }
      s.in.a.v[2 * w + (lane >> 4)][r][lane & 15] = static_cast<int8_t>(q);
    }
    stage_planes<MODE == TNN, BN>(s.in.b, b0, b1, n0, cout, w0, words,
                                  0x7fffffff);
    __syncthreads();
    mma_step(s, wr, wc, acc);
    __syncthreads();
  }
  store_acc(s, wr, wc, acc);
  store_scaled(s, m0, n0, m, cout, scale_p, 0, col, bias, out);
}

}  // namespace tc

// mode: 0 BNN, 1 TNN, 2 TBN.  a0/a1 (m, kw), b0/b1 (n, kw) int32 words
// (a1 / b1 ignored for one plane); row (m,), col (n,), bias (n,) or null;
// out (m, n) float32, row-major.  Returns cudaGetLastError() after the
// launch.
extern "C" int dense_gemm_launch(int mode, const void* a0, const void* a1,
                                 const void* b0, const void* b1, int m, int n,
                                 int kw, int k_valid, const void* row,
                                 const void* col, const void* bias, void* out,
                                 void* stream) {
  using namespace tc;
  if (m <= 0 || n <= 0 || kw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  auto st = static_cast<cudaStream_t>(stream);
#define DENSE_GEMM_CASE(MODE)                                                 \
  case MODE:                                                                  \
    dense_gemm_kernel<MODE><<<grid, THREADS, 0, st>>>(                        \
        static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),   \
        static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1),   \
        m, n, kw, k_valid, static_cast<const float*>(row),                    \
        static_cast<const float*>(col), static_cast<const float*>(bias),      \
        static_cast<float*>(out));                                            \
    break;
  switch (mode) {
    DENSE_GEMM_CASE(lowbit::BNN)
    DENSE_GEMM_CASE(lowbit::TNN)
    DENSE_GEMM_CASE(lowbit::TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DENSE_GEMM_CASE
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 BNN, 1 TNN, 2 TBN.  x (B, H, W, C) float32; b0/b1 (cout, words)
// positional planes with words == KH*KW*ceil(C/32) (b1 ignored for one
// plane); thr (ignored for BNN) and scale float32 device scalars; col
// (cout,), bias (cout,) or null; out (B*OH*OW, cout) float32.  Returns
// cudaGetLastError() after the launch.
extern "C" int dense_conv_launch(int mode, const void* x, int B, int H, int W,
                                 int C, int KH, int KW, int stride,
                                 int pad_top, int pad_left, int OH, int OW,
                                 const void* b0, const void* b1, int cout,
                                 int words, const void* thr,
                                 const void* scale, const void* col,
                                 const void* bias, void* out, void* stream) {
  using namespace tc;
  const int cw = (C + 31) / 32;
  if (B <= 0 || OH <= 0 || OW <= 0 || cout <= 0 || C <= 0 || stride <= 0 ||
      words != KH * KW * cw)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = B * OH * OW;
  const dim3 grid((m + BM - 1) / BM, (cout + BN - 1) / BN);
  auto st = static_cast<cudaStream_t>(stream);
#define DENSE_CONV_CASE(MODE)                                                 \
  case MODE:                                                                  \
    dense_conv_kernel<MODE><<<grid, THREADS, 0, st>>>(                        \
        static_cast<const float*>(x), H, W, C, KW, stride, pad_top, pad_left, \
        OH, OW, m, static_cast<const uint32_t*>(b0),                          \
        static_cast<const uint32_t*>(b1), cout, words, cw,                    \
        static_cast<const float*>(thr), static_cast<const float*>(scale),     \
        static_cast<const float*>(col), static_cast<const float*>(bias),      \
        static_cast<float*>(out));                                            \
    break;
  switch (mode) {
    DENSE_CONV_CASE(lowbit::BNN)
    DENSE_CONV_CASE(lowbit::TNN)
    DENSE_CONV_CASE(lowbit::TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DENSE_CONV_CASE
  return static_cast<int>(cudaGetLastError());
}

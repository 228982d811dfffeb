// Implicit-im2col low-bit convolution for Hopper (sm_90a): TNN, TBN, BNN.
//
// Replaces the Pallas kernel conv_fused._conv_pallas_fused
// (kernels/conv_fused.py) of the JAX package.
//
// out[b, oh, ow, co] for x (B, H, W, C) float32 NHWC and positional weight
// planes (cout, kh*kw*ceil(C/32)) — patch position p = dy*kw + dx owns
// ceil(C/32) words, channel c of that position is bit c%32 of word c/32.
// Per CTA (BM output pixels x BN output channels):
//   1. the pixels' (b, oh, ow) come from blockIdx; each warp gathers one
//      32-channel run of one patch position straight from global memory
//      (lane i reads channel 32*w + i: one coalesced 128-byte load);
//   2. each lane quantizes its value with the per-tensor statistics
//      (thr, scale are device scalars from conv_act_stats, read through
//      pointers so no host sync happens per layer) and __ballot_sync
//      packs the predicate into the word: lane i -> bit i, LSB first;
//   3. the packed A tile stays in shared memory and the popcount core of
//      lowbit_core.cuh runs it against the staged weight words;
//   4. eq. (6) for BNN and eq. (2) (acc * scale * col (+ bias)) in-kernel.
//
// Padding: a SAME-padding pixel, like a channel past C, is the value 0.0
// and is quantized as one: BNN packs it as bit 0 (+1), exactly as the
// reference packs the zero-padded input (pack_bits(xp < 0)); TNN/TBN pack
// (0,0).  The weights' in-word pads are bit 0 / (0,0), so both contribute
// what the materializing im2col oracle sums.
//
// What bounds it on this card: the integer pipe, as for lowbit_gemm.cu
// (POPC at 16 results per clock per SM on compute capability 9.0), plus
// the gather: each input element is read once per patch position that
// holds it (kh*kw times) per BN-column block, from L2 after the first
// time; the bytes a conv must move (x once, the output once) are far
// below 3.35 TB/s.  The design keeps the packed tile in shared memory so
// the 32x smaller words, not floats, feed the popcount loop.  Not done
// yet (later work): quantize and pack each input pixel once per CTA
// instead of once per patch position, double-buffer the staging, and the
// tensor-core route (+-1/0 int8 or bf16 operands through wgmma, as the
// reference's dense conv kernel does on the MXU).
//
// Built with --fmad=false; the epilogue uses __fmul_rn/__fadd_rn, so the
// output is bit for bit the plain PyTorch version's.

#include "lowbit_core.cuh"

namespace lowbit {

template <int MODE>
__global__ void __launch_bounds__(THREADS)
lowbit_conv_kernel(const float* __restrict__ x, int H, int W, int C, int KW,
                   int stride, int pad_top, int pad_left, int OH, int OW,
                   int m, const uint32_t* __restrict__ b0,
                   const uint32_t* __restrict__ b1, int cout, int words,
                   int cw, int k_valid, const float* __restrict__ thr_p,
                   const float* __restrict__ scale_p,
                   const float* __restrict__ col,
                   const float* __restrict__ bias, float* __restrict__ out) {
  __shared__ Tile<MODE> s;
  __shared__ int s_b[BM], s_h[BM], s_w[BM];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // Output pixel of each tile row: image, and the top-left input pixel
  // of its patch (before padding is removed); b = -1 past m.
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

  int acc[TM][TN] = {};
  for (int k0 = 0; k0 < words; k0 += BK) {
    const int wn = min(BK, words - k0);
    // A tile: one warp per (row, word), gathered, quantized and packed.
    for (int idx = warp; idx < BM * wn; idx += THREADS / 32) {
      const int c = idx / BM, r = idx % BM;
      const int gk = k0 + c;
      const int b = s_b[r];
      float v = 0.f;
      if (b >= 0) {
        const int p = gk / cw, wi = gk - p * cw;
        const int dy = p / KW, dx = p - dy * KW;
        const int h = s_h[r] + dy, w = s_w[r] + dx, ch = wi * 32 + lane;
        if (h >= 0 && h < H && w >= 0 && w < W && ch < C)
          v = __ldg(x + ((static_cast<size_t>(b) * H + h) * W + w) * C + ch);
      }
      if constexpr (MODE == BNN) {
        const unsigned bits = __ballot_sync(0xffffffffu, v < 0.f);
        if (lane == 0) s.a[0][c][r] = bits;
      } else {
        const bool nz = fabsf(v) > thr;
        const unsigned plus = __ballot_sync(0xffffffffu, nz && v > 0.f);
        const unsigned minus = __ballot_sync(0xffffffffu, nz && v < 0.f);
        if (lane == 0) {
          s.a[0][c][r] = plus;
          s.a[1][c][r] = minus;
        }
      }
    }
    stage_rows<Planes<MODE>::B, BN>(s.b, b0, b1, n0, cout, k0, wn, words);
    __syncthreads();
    mac_tile<MODE>(s, wn, ty, tx, acc);
    __syncthreads();
  }
  store_tile<MODE, true>(acc, m0, n0, ty, tx, m, cout, k_valid, scale_p, 0,
                         col, bias, out);
}

template <int MODE>
void launch(const void* x, int B, int H, int W, int C, int KW, int stride,
            int pad_top, int pad_left, int OH, int OW, const void* b0,
            const void* b1, int cout, int words, int cw, int k_valid,
            const void* thr, const void* scale, const void* col,
            const void* bias, void* out, cudaStream_t stream) {
  const int m = B * OH * OW;
  const dim3 grid((m + BM - 1) / BM, (cout + BN - 1) / BN);
  lowbit_conv_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), H, W, C, KW, stride, pad_top, pad_left,
      OH, OW, m, static_cast<const uint32_t*>(b0),
      static_cast<const uint32_t*>(b1), cout, words, cw, k_valid,
      static_cast<const float*>(thr), static_cast<const float*>(scale),
      static_cast<const float*>(col), static_cast<const float*>(bias),
      static_cast<float*>(out));
}

}  // namespace lowbit

// mode: 0 BNN, 1 TNN, 2 TBN.  x (B, H, W, C) float32; b0/b1 (cout, words)
// positional planes with words == kh*kw*ceil(C/32) (b1 ignored for one
// plane); thr (ignored for BNN) and scale are float32 device scalars;
// col (cout,), bias (cout,) or null; out (B*OH*OW, cout) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int lowbit_conv_launch(int mode, const void* x, int B, int H,
                                  int W, int C, int KH, int KW, int stride,
                                  int pad_top, int pad_left, int OH, int OW,
                                  const void* b0, const void* b1, int cout,
                                  int words, int k_valid, const void* thr,
                                  const void* scale, const void* col,
                                  const void* bias, void* out, void* stream) {
  using namespace lowbit;
  const int cw = (C + 31) / 32;
  if (B <= 0 || OH <= 0 || OW <= 0 || cout <= 0 || C <= 0 || stride <= 0 ||
      words != KH * KW * cw)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define LOWBIT_CONV_CASE(MODE)                                                \
  case MODE:                                                                  \
    launch<MODE>(x, B, H, W, C, KW, stride, pad_top, pad_left, OH, OW, b0,    \
                 b1, cout, words, cw, k_valid, thr, scale, col, bias, out, st); \
    break;
  switch (mode) {
    LOWBIT_CONV_CASE(BNN)
    LOWBIT_CONV_CASE(TNN)
    LOWBIT_CONV_CASE(TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOWBIT_CONV_CASE
  return static_cast<int>(cudaGetLastError());
}

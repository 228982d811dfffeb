// Implicit-im2col low-bit convolution for Hopper (sm_90a): TNN, TBN, BNN.
//
// Replaces the Pallas kernel conv_fused._conv_pallas_fused
// (kernels/conv_fused.py) of the JAX package, as two kernels on one stream:
//
//   conv_pack_kernel   the in-kernel quantize + pack of the Pallas kernel,
//                      done once per input pixel: x (B, H, W, C) float32
//                      NHWC -> bit planes (B, Hp, Wp, ceil(C/32)) of the
//                      spatially padded input (BNN one plane, bit = v < 0;
//                      TNN/TBN two, v > thr and v < -thr where |v| > thr).
//                      A pad pixel, like a channel past C, is 0.0 and packs
//                      as word 0 in every mode (BNN +1 = bit 0, ternary
//                      (0,0)), which is what the plain version packs.  One
//                      warp per 32 consecutive (pixel, word) items: lane i
//                      reads channel 32*w + i (one coalesced 128-byte load;
//                      the 32 items' loads in flight together),
//                      __ballot_sync packs the predicate, and lane j keeps
//                      item j's word, so the words are stored coalesced.
//   lowbit_conv_kernel out[b, oh, ow, co] from those planes and the
//                      positional weight planes (cout, kh*kw*ceil(C/32))
//                      (patch position p = dy*kw + dx owns ceil(C/32)
//                      words; channel c is bit c%32 of word c/32).
//
// The conv kernel (CTA = BM output pixels; 256 threads) fills the per-CTA
// tables (lowbit_core.cuh conv_tables: the A word of (row r, depth word gk)
// is planes[base[r] + off[gk]], one 4-byte load with no bounds check, no
// quantization and no ballot) and runs lowbit_core.cuh's popcount_body, as
// the GeMM kernel (lowbit_gemm.cu) does with a 1x1 geometry:
//   1. the CTA loops over its column blocks (all of cout unless the row
//      blocks alone do not fill the card) with the A tile staged ONCE for
//      the whole depth in shared memory (resident) and reused by every
//      column block; depths too deep for that (A over 64 KB) stream A
//      through a two-slot ring per step instead, re-staged per column block;
//   2. staging is cp.async (4-byte copies into the depth-major tiles that
//      the popcount core reads conflict-free), double-buffered: the copies
//      of step t+1 are in flight while step t runs the popcount loop;
//   3. mac_tile, then eq. (6) for BNN and eq. (2) (acc * scale * col
//      (+ bias)) in store_tile.
//
// The weight rows are staged with 4-byte copies too: mac_tile's depth-major
// tile holds no 4 consecutive words of one row, so a 16-byte copy has no
// destination there (dense_tc.cu's row-major staging takes 16-byte ones).
//
// What bounds it on this card: the integer pipe (POPC at 16 results per
// clock per SM on compute capability 9.0).  The pack reads x once and
// writes 1/32 (BNN) or 1/16 (ternary) of it; the conv gathers packed words
// from L2, 32x fewer bytes than the floats the previous design gathered,
// once per CTA instead of once per 64-column block.
//
// Built with --fmad=false; the epilogue uses __fmul_rn/__fadd_rn, so the
// output is bit for bit the plain PyTorch version's.

#include "lowbit_core.cuh"

namespace lowbit {

template <int MODE>
__global__ void __launch_bounds__(THREADS)
conv_pack_kernel(const float* __restrict__ x, int H, int W, int C, int Hp,
                 int Wp, int pad_top, int pad_left, int cw, int items,
                 const float* __restrict__ thr_p, uint32_t* __restrict__ p0,
                 uint32_t* __restrict__ p1) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * THREADS + (threadIdx.x & ~31);
  const int n = min(32, items - first);           // the warp's items
  // (b, hp, wp, wi) of the warp's first item, then stepped item by item:
  // the 32 loads are issued before the first ballot waits on one.
  int pix = first / cw, wi = first - pix * cw;
  int b = pix / (Hp * Wp), rem = pix - b * (Hp * Wp);
  int hp = rem / Wp, wp = rem - hp * Wp;
  float v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int h = hp - pad_top, w = wp - pad_left, ch = wi * 32 + lane;
    v[j] = 0.f;
    if (j < n && h >= 0 && h < H && w >= 0 && w < W && ch < C)
      v[j] = __ldg(x + ((static_cast<size_t>(b) * H + h) * W + w) * C + ch);
    if (++wi == cw) {
      wi = 0;
      if (++wp == Wp) {
        wp = 0;
        if (++hp == Hp) {
          hp = 0;
          ++b;
        }
      }
    }
  }
  float thr = 0.f;
  if constexpr (MODE != BNN) thr = __ldg(thr_p);
  uint32_t mine0 = 0, mine1 = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if constexpr (MODE == BNN) {
      const unsigned bits = __ballot_sync(0xffffffffu, v[j] < 0.f);
      if (lane == j) mine0 = bits;
    } else {
      const bool nz = fabsf(v[j]) > thr;
      const unsigned plus = __ballot_sync(0xffffffffu, nz && v[j] > 0.f);
      const unsigned minus = __ballot_sync(0xffffffffu, nz && v[j] < 0.f);
      if (lane == j) {
        mine0 = plus;
        mine1 = minus;
      }
    }
  }
  if (lane < n) {
    p0[first + lane] = mine0;
    if constexpr (MODE != BNN) p1[first + lane] = mine1;
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
lowbit_conv_kernel(const uint32_t* __restrict__ a0,
                   const uint32_t* __restrict__ a1, int Hp, int Wp, int cw,
                   int KW, int stride, int OH, int OW, int m,
                   const uint32_t* __restrict__ b0,
                   const uint32_t* __restrict__ b1, int cout, int words,
                   int k_valid, int blocks_per_cta, int resident,
                   const float* __restrict__ scale_p,
                   const float* __restrict__ col,
                   const float* __restrict__ bias, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  int* off = body_tables<MODE, BM, BN>(smem, words, resident);
  conv_tables<BM>(off, off + words, words, cw, KW, Wp, Hp, stride, OH, OW,
                  blockIdx.x * BM, m);
  __syncthreads();
  popcount_body<MODE, true, BM, BN>(smem, a0, a1, m, b0, b1, cout, words,
                                    k_valid, blocks_per_cta, resident, scale_p,
                                    0, col, bias, out);
}

}  // namespace lowbit

// mode: 0 BNN, 1 TNN, 2 TBN.  x (B, H, W, C) float32; p0/p1 (B, Hp, Wp,
// ceil(C/32)) int32 planes of the input padded by pad_top/pad_left (p1
// ignored for BNN); thr a float32 device scalar (ignored for BNN).
// Returns cudaGetLastError() after the launch.
extern "C" int conv_pack_launch(int mode, const void* x, int B, int H, int W,
                                int C, int Hp, int Wp, int pad_top,
                                int pad_left, const void* thr, void* p0,
                                void* p1, void* stream) {
  using namespace lowbit;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || Hp < H || Wp < W ||
      pad_top < 0 || pad_left < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cw = (C + 31) / 32;
  const long long items = static_cast<long long>(B) * Hp * Wp * cw;
  if (items + THREADS >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((items + THREADS - 1) / THREADS);
  auto st = static_cast<cudaStream_t>(stream);
#define CONV_PACK_CASE(MODE)                                                  \
  case MODE:                                                                  \
    conv_pack_kernel<MODE><<<blocks, THREADS, 0, st>>>(                       \
        static_cast<const float*>(x), H, W, C, Hp, Wp, pad_top, pad_left, cw, \
        static_cast<int>(items), static_cast<const float*>(thr),              \
        static_cast<uint32_t*>(p0),                                           \
        static_cast<uint32_t*>(p1));                                          \
    break;
  switch (mode) {
    CONV_PACK_CASE(BNN)
    CONV_PACK_CASE(TNN)
    CONV_PACK_CASE(TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CONV_PACK_CASE
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 BNN, 1 TNN, 2 TBN.  a0/a1 (B, Hp, Wp, ceil(C/32)) packed planes
// from conv_pack_launch (a1 ignored for BNN); b0/b1 (cout, words)
// positional weight planes with words == KH*KW*ceil(C/32) (b1 ignored for
// one plane); scale a float32 device scalar; col (cout,), bias (cout,) or
// null; out (B*OH*OW, cout) float32.  Returns cudaGetLastError() after the
// launch.
extern "C" int lowbit_conv_launch(int mode, const void* a0, const void* a1,
                                  int B, int Hp, int Wp, int C, int KH, int KW,
                                  int stride, int OH, int OW, const void* b0,
                                  const void* b1, int cout, int words,
                                  int k_valid, const void* scale,
                                  const void* col, const void* bias, void* out,
                                  void* stream) {
  using namespace lowbit;
  const int cw = (C + 31) / 32;
  if (B <= 0 || OH <= 0 || OW <= 0 || cout <= 0 || C <= 0 || stride <= 0 ||
      KH > Hp || KW > Wp || words != KH * KW * cw ||
      (OH - 1) * stride + KH > Hp || (OW - 1) * stride + KW > Wp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = B * OH * OW;
  auto st = static_cast<cudaStream_t>(stream);
#define LOWBIT_CONV_CASE(MODE)                                                \
  case MODE: {                                                                \
    const auto p = lowbit_host::popcount_plan<MODE, BM, BN>(                  \
        m, cout, words, true);                                                \
    if (!lowbit_host::allow_smem(lowbit_conv_kernel<MODE>, p.smem))           \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    lowbit_conv_kernel<MODE><<<p.grid, THREADS, p.smem, st>>>(                \
        static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),   \
        Hp, Wp, cw, KW, stride, OH, OW, m, static_cast<const uint32_t*>(b0),  \
        static_cast<const uint32_t*>(b1), cout, words, k_valid, p.per_cta,    \
        p.resident, static_cast<const float*>(scale),                         \
        static_cast<const float*>(col), static_cast<const float*>(bias),      \
        static_cast<float*>(out));                                            \
    break;                                                                    \
  }
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

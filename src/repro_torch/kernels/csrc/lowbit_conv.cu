// Implicit-im2col low-bit convolution for Hopper (sm_90a): TNN, TBN, BNN.
//
// Replaces the Pallas kernel conv_fused._conv_pallas_fused
// (kernels/conv_fused.py) of the JAX package, as two kernels on one stream
// (act_stats_kernel, further down, computes the per-tensor statistics that
// the packing pass quantizes with):
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

// ---------------------------------------------------------------------------
// act_stats_kernel: the activation statistics of the implicit im2col matrix
// (conv_fused.conv_act_stats on CUDA operands).
//
// Replaces no TPU kernel: the JAX package leaves these statistics to XLA.
// Every element of the padded input appears in m(h) * m(w) patches, m the
// per-axis patch multiplicity (axis_multiplicity), so over the unpadded x
// (B, H, W, C) float32:
//   pass 1  S = sum m |x|  ->  mean_abs = S / (B OH OW KH KW C) and, for
//           TNN/TBN, thr = 0.7f * mean_abs; BNN stops here;
//   pass 2  N = sum m [|x| > thr], A = sum m |x| [|x| > thr], thr read on the
//           device  ->  alpha = A / max(N, 1).
// A pad pixel is 0 and adds nothing to any sum, so no padded copy is made and
// no multiplicity map is read: each block builds the per-axis tables in
// shared memory.
//
// What bounds it: bytes, one read of x a pass (pass 2 needs thr, hence all of
// pass 1, before its first element).  Loads are float4 where C % 4 == 0 and x
// is 16-byte aligned (one coalesced 512-byte load a warp), scalar otherwise;
// each thread keeps STATS_UNROLL loads in flight.  Sums are float64 and
// weighted counts 64-bit integers; each block writes its partial, and the
// block that finishes last (an integer ticket, no float atomics) adds the
// partials in index order.  The grid depends on the shape alone, so a rerun
// gives the same bits; each result is rounded to float32 once.

constexpr int STATS_BLOCKS = 1024;   // the most blocks a pass runs
constexpr int STATS_UNROLL = 4;      // loads in flight a thread
constexpr int STATS_TABLE = 8192;    // the most H + W (per-axis tables)

// Patches along one axis (k taps, stride, out outputs) that hold padded
// position p: the o in [0, out) with o * stride <= p <= o * stride + k - 1.
__device__ inline int axis_multiplicity(int p, int k, int stride, int out) {
  const int hi = p / stride < out - 1 ? p / stride : out - 1;
  const int lo = p < k ? 0 : (p - k + stride) / stride;
  return hi >= lo ? hi - lo + 1 : 0;
}

// n / d for n, d < 2^31 by a multiply-high and a shift, d fixed for a launch.
struct Divider {
  uint32_t d, magic, shift;
  explicit Divider(uint32_t divisor) : d(divisor), shift(0) {
    while ((1u << shift) < d) ++shift;
    magic = static_cast<uint32_t>(((1ull << 32) * ((1ull << shift) - d)) / d + 1);
  }
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, magic) + n) >> shift;
  }
};

struct StatsShape {
  uint32_t nvec;                       // VEC-float vectors in x
  Divider per_pixel, per_image, per_row;   // C / VEC, H * W, W
  int H, W, KH, KW, stride, OH, OW, pad_top, pad_left;
};

// Sum over the block in a fixed order (shuffles, then the warps in order);
// the total is thread 0's.
template <typename T>
__device__ T block_sum(T v, T* warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < THREADS / 32; ++i) total += warps[i];
  return total;
}

// out: mean_abs, thr (pass 1), alpha (pass 2).
template <int PASS, int VEC>
__global__ void __launch_bounds__(THREADS)
act_stats_kernel(const float* __restrict__ x, StatsShape s, double count,
                 double* __restrict__ part_sum,
                 unsigned long long* __restrict__ part_n,
                 unsigned int* __restrict__ ticket, float* __restrict__ out) {
  extern __shared__ int mult[];        // m(h) for h < H, then m(w)
  __shared__ double warp_sum[THREADS / 32];
  __shared__ unsigned long long warp_n[THREADS / 32];
  __shared__ bool last;
  const int W = s.W;
  const int* mh = mult;
  const int* mw = mult + s.H;
  for (int i = threadIdx.x; i < s.H + W; i += THREADS)
    mult[i] = i < s.H ? axis_multiplicity(i + s.pad_top, s.KH, s.stride, s.OH)
                      : axis_multiplicity(i - s.H + s.pad_left, s.KW, s.stride,
                                          s.OW);
  __syncthreads();
  float thr = 0.f;
  if constexpr (PASS == 2) thr = out[1];
  double sum = 0.0;
  unsigned long long n = 0;
  const uint32_t step = gridDim.x * THREADS;
  for (uint32_t base = blockIdx.x * THREADS + threadIdx.x; base < s.nvec;
       base += step * STATS_UNROLL) {
    float v[STATS_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      const uint32_t i = base + u * step;
      if constexpr (VEC == 4) {
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < s.nvec) q = __ldg(reinterpret_cast<const float4*>(x) + i);
        v[u][0] = q.x;
        v[u][1] = q.y;
        v[u][2] = q.z;
        v[u][3] = q.w;
      } else {
        v[u][0] = i < s.nvec ? __ldg(x + i) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < STATS_UNROLL; ++u) {
      const uint32_t i = base + u * step;
      if (i >= s.nvec) continue;
      const uint32_t pix = s.per_pixel.div(i);
      const uint32_t img = pix - s.per_image.div(pix) * s.per_image.d;
      const uint32_t h = s.per_row.div(img);
      const int m = mh[h] * mw[img - h * s.per_row.d];
      double a = 0.0;
      int c = 0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = fabsf(v[u][j]);
        if (PASS == 1 || f > thr) {
          a += static_cast<double>(f);
          ++c;
        }
      }
      sum += static_cast<double>(m) * a;
      if constexpr (PASS == 2) n += static_cast<unsigned long long>(m * c);
    }
  }
  const double block_total = block_sum(sum, warp_sum);
  unsigned long long block_n = 0;
  if constexpr (PASS == 2) block_n = block_sum(n, warp_n);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = block_total;
    if constexpr (PASS == 2) part_n[blockIdx.x] = block_n;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // The last block: every partial, in index order (read past L1).
  double t_sum = 0.0;
  unsigned long long t_n = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += THREADS) {
    t_sum += __ldcg(part_sum + b);
    if constexpr (PASS == 2) t_n += __ldcg(part_n + b);
  }
  const double total = block_sum(t_sum, warp_sum);
  unsigned long long total_n = 0;
  if constexpr (PASS == 2) total_n = block_sum(t_n, warp_n);
  if (threadIdx.x == 0) {
    if constexpr (PASS == 1) {
      const float mean = static_cast<float>(total / count);
      out[0] = mean;
      out[1] = __fmul_rn(0.7f, mean);
    } else {
      out[2] = static_cast<float>(
          total / static_cast<double>(total_n > 0 ? total_n : 1ull));
    }
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

// mode: 0 BNN, 1 TNN, 2 TBN.  x (B, H, W, C) float32, the input of a conv of
// KH x KW taps at `stride` with OH x OW outputs, padded by pad_top/pad_left
// (conv_fused.conv_out_hw); scratch of scratch_bytes >= STATS_BLOCKS * 16 + 8
// bytes (partials and the two passes' tickets); out 3 float32: mean_abs, thr,
// alpha (BNN writes mean_abs and an unused thr).  Pass 1, then for TNN/TBN
// pass 2, on `stream`.  An empty x runs one block a pass over nothing and
// writes what the plain version gives: mean_abs and thr 0/0 (NaN), alpha 0.
// Returns cudaGetLastError() after the launches.
extern "C" int conv_stats_launch(int mode, const void* x, int B, int H, int W,
                                 int C, int KH, int KW, int stride, int OH,
                                 int OW, int pad_top, int pad_left,
                                 void* scratch, int scratch_bytes, void* out,
                                 void* stream) {
  using namespace lowbit;
  if (mode < BNN || mode > TBN || B < 0 || H < 0 || W < 0 || C < 0 ||
      KH <= 0 || KW <= 0 || stride <= 0 || OH < 0 || OW < 0 ||
      pad_top < 0 || pad_left < 0 || H + W > STATS_TABLE ||
      scratch_bytes < STATS_BLOCKS * 16 + 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long numel = static_cast<long long>(B) * H * W * C;
  if (numel >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int vec =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 ? 4 : 1;
  // (a divisor of an empty x's zero extent is taken as 1: nothing divides)
  auto divider = [](int d) {
    return Divider(static_cast<uint32_t>(d > 0 ? d : 1));
  };
  StatsShape s{static_cast<uint32_t>(numel / vec), divider(C / vec),
               divider(H * W), divider(W),
               H, W, KH, KW, stride, OH, OW, pad_top, pad_left};
  const long long per_block = static_cast<long long>(THREADS) * STATS_UNROLL;
  const long long want = (s.nvec + per_block - 1) / per_block;
  const int blocks = static_cast<int>(
      want < 1 ? 1 : want < STATS_BLOCKS ? want : STATS_BLOCKS);
  const double count = static_cast<double>(static_cast<long long>(B) * OH *
                                           OW * KH * KW * C);
  const size_t smem = static_cast<size_t>(H + W) * sizeof(int);
  auto* part_sum = static_cast<double*>(scratch);
  auto* part_n =
      reinterpret_cast<unsigned long long*>(part_sum + STATS_BLOCKS);
  auto* ticket = reinterpret_cast<unsigned int*>(part_n + STATS_BLOCKS);
  auto* o = static_cast<float*>(out);
  auto* xf = static_cast<const float*>(x);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(ticket, 0, 2 * sizeof(unsigned int), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
#define ACT_STATS_PASS(PASS, T)                                               \
  if (vec == 4)                                                               \
    act_stats_kernel<PASS, 4><<<blocks, THREADS, smem, st>>>(                 \
        xf, s, count, part_sum, part_n, T, o);                                \
  else                                                                        \
    act_stats_kernel<PASS, 1><<<blocks, THREADS, smem, st>>>(                 \
        xf, s, count, part_sum, part_n, T, o);
  ACT_STATS_PASS(1, ticket)
  if (mode != BNN) {
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ACT_STATS_PASS(2, ticket + 1)
  }
#undef ACT_STATS_PASS
  return static_cast<int>(cudaGetLastError());
}

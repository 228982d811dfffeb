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
// and B^T (n, kw), then acc * row[m * row_stride] * col[n] (+ bias[n]) in
// float32 (row_stride 0: one per-tensor activation scale, never expanded).
// Conv: the implicit-im2col product of the packed activation planes
// (B, Hp, Wp, ceil(C/32)) that lowbit_conv.cu's conv_pack_kernel writes
// (each input pixel quantized and packed once, with the per-tensor
// statistics) with the positional weight planes (cout, kh*kw*ceil(C/32)),
// then acc * scale * col[n] (+ bias[n]).  The conv is the dense GeMM with
// an implicit-im2col row address: the A word of (row r, depth word gk) is
// planes[base[r] + off[gk]] (lowbit_core.cuh conv_tables).
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
//   * Conv: a pixel outside the image was packed as the value 0.0 (BNN:
//     +1), as the materializing im2col oracle pads with zeros; a channel
//     past C within a position's last word is zeroed on the A side at
//     decode, which cancels the weights' in-word pads.
//
// The GeMM kernel (CTA = TILE x TILE outputs, TILE 64 where the grid fills
// the card and 32 where it would not, chosen by the caller:
// _matmul_common.gemm_tile; 4 warps): each step decodes 4 packed words
// per row of both operands into +-1/0 int8 slabs in shared memory
// (tc_core.cuh decode_word: four values per lane op) and runs wmma s8 ->
// s32.  The packed words of step t+1 are loaded straight into registers
// right after step t's are decoded, so their latency overlaps step t's
// products and they never pass through shared memory.  (The conv's CTA
// body below, with its cp.async ring and resident A, was measured as the
// GeMM's too: it halved the GEMM_GRID diagonal's device time but was
// 13-19% slower at the CNN's im2col GeMM shapes, where many CTAs per SM
// already hide synchronous loads and the extra shared-memory round trip
// of the packed words is what remains.)
//
// The conv kernel (CTA = 64 output pixels, 4 warps):
//   * the packed A words of the CTA's rows are staged once for the whole
//     depth (up to 64 KB; deeper convs stream them through a two-slot ring
//     per step) and reused by every column block the CTA loops over (all of
//     cout unless the row blocks alone do not fill the card);
//   * the weight words of step t+1 (16-byte cp.async per row when
//     words % 4 == 0) and, streaming, A's are in flight while step t
//     decodes and multiplies;
//   * each step decodes 4 packed words per row to +-1/0 int8 slabs in
//     shared memory (decode_word, the slab layout of the GeMM) and runs
//     wmma s8 -> s32.
//
// What bounds it on this card: at the paper's CNN widths and the CNN's
// im2col GeMM shapes the work is far below the int8 tensor rate (1,979
// TOP/s dense), so the bound is the bytes a call must move (the operands
// read once, the float32 output written once) at 3.35 TB/s; on the
// GEMM_GRID shapes it is launch and memory latency, which the GeMM meets
// with a 32 x 32 tile (up to 4x the CTAs of a 64 x 64 one, each with a
// quarter of the serial decode and epilogue) and the one-step register
// prefetch.  Neither the +-1/0 matrices nor the im2col matrix ever reach
// device memory.  Not done yet (later work): wgmma with TMA-fed staging,
// or decoding straight into mma.sync fragments.
//
// Built with --fmad=false (see _build.py).

#include "tc_core.cuh"

namespace tc {

constexpr int RESIDENT_A_BYTES = 64 * 1024;   // packed A for the whole depth

// The decode mask of depth word gw of an operand row (ok: the row exists
// and gw < kw): BNN A values at depth >= k_live are zeroed (their pad bits
// decode to +1); k_live = INT_MAX masks nothing.
__device__ __forceinline__ uint32_t live_mask(bool ok, int k_live, int gw) {
  if (!ok) return 0u;
  const long long left = static_cast<long long>(k_live) - 32LL * gw;
  return left >= 32 ? 0xffffffffu : (left <= 0 ? 0u : (1u << left) - 1u);
}

template <int MODE, int TILE>
__global__ void __launch_bounds__(THREADS)
dense_gemm_kernel(const uint32_t* __restrict__ a0,
                  const uint32_t* __restrict__ a1, int m,
                  const uint32_t* __restrict__ b0,
                  const uint32_t* __restrict__ b1, int n, int kw, int k_live,
                  const float* __restrict__ row, int row_stride,
                  const float* __restrict__ col,
                  const float* __restrict__ bias, float* __restrict__ out) {
  using lowbit::BNN;
  using lowbit::TNN;
  constexpr bool TA = MODE != BNN, TB = MODE == TNN;
  // (row, word) pairs of one operand a thread loads and decodes per step:
  // consecutive threads take consecutive words of a row (16 bytes per 4
  // threads)
  constexpr int PAIRS = TILE * BKW / THREADS;
  static_assert(PAIRS * THREADS == TILE * BKW, "tile must divide");
  __shared__ Smem<int8_t, TILE, TILE> s;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / 2, wc = warp % 2;
  const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
  uint32_t ap[PAIRS], am[PAIRS], bp[PAIRS], bm[PAIRS];

  // The packed words of the step at w0 into the registers (0 where the
  // row or the word does not exist).
  auto load = [&](int w0) {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int i = tid + j * THREADS, r = i / BKW, gw = w0 + i % BKW;
      const bool oka = m0 + r < m && gw < kw, okb = n0 + r < n && gw < kw;
      const size_t oa = static_cast<size_t>(m0 + r) * kw + gw;
      const size_t ob = static_cast<size_t>(n0 + r) * kw + gw;
      ap[j] = oka ? __ldg(a0 + oa) : 0u;
      am[j] = TA && oka ? __ldg(a1 + oa) : 0u;
      bp[j] = okb ? __ldg(b0 + ob) : 0u;
      bm[j] = TB && okb ? __ldg(b1 + ob) : 0u;
    }
  };

  Acc acc[Frags<TILE, TILE>::I][Frags<TILE, TILE>::J];
  zero_acc(acc);
  load(0);
  for (int w0 = 0; w0 < kw; w0 += BKW) {
#pragma unroll
    for (int j = 0; j < PAIRS; ++j) {
      const int i = tid + j * THREADS, r = i / BKW, w = i % BKW, gw = w0 + w;
      decode_word<TA>(ap[j], am[j], live_mask(m0 + r < m && gw < kw, k_live, gw),
                      &s.in.a.v[2 * w][r][0], &s.in.a.v[2 * w + 1][r][0]);
      decode_word<TB>(bp[j], bm[j], live_mask(n0 + r < n && gw < kw, 0x7fffffff, gw),
                      &s.in.b.v[2 * w][r][0], &s.in.b.v[2 * w + 1][r][0]);
    }
    if (w0 + BKW < kw) load(w0 + BKW);
    __syncthreads();
    mma_step(s, wr, wc, acc);
    __syncthreads();
  }
  store_acc(s, wr, wc, acc);
  store_scaled(s, m0, n0, m, n, row, row_stride, col, bias, out);
}

// Shared-memory words per row of the packed A tile: at least the words it
// holds, and 4 mod 8, so the decode's reads (8 rows x 4 words per warp) hit
// 32 distinct banks.
__host__ __device__ constexpr int a_stride(int held) {
  return (held + 3) / 8 * 8 + 4;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
dense_conv_kernel(const uint32_t* __restrict__ a0,
                  const uint32_t* __restrict__ a1, int Hp, int Wp, int cw,
                  int C, int KW, int stride, int OH, int OW, int m,
                  const uint32_t* __restrict__ b0,
                  const uint32_t* __restrict__ b1, int cout, int words,
                  int blocks_per_cta, int resident, int b_vec4,
                  const float* __restrict__ scale_p,
                  const float* __restrict__ col,
                  const float* __restrict__ bias, float* __restrict__ out) {
  using lowbit::BNN;
  using lowbit::TNN;
  constexpr bool TA = MODE != BNN, TB = MODE == TNN;
  constexpr int NA = TA ? 2 : 1, NB = TB ? 2 : 1;
  static_assert(BKW == 4, "one 16-byte weight copy per row and step");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  auto& s = *reinterpret_cast<Smem<int8_t>*>(smem_raw);
  const int sa = a_stride(resident ? words : 2 * BKW);
  // packed words: B [2][NB][BN][BKW] (double buffer), A [NA][BM][sa]
  uint32_t* s_bw = reinterpret_cast<uint32_t*>(smem_raw + sizeof(Smem<int8_t>));
  uint32_t* s_aw = s_bw + 2 * NB * BN * BKW;
  int* s_off = reinterpret_cast<int*>(s_aw + NA * BM * sa);
  uint32_t* s_live = reinterpret_cast<uint32_t*>(s_off + words);
  int* s_base = reinterpret_cast<int*>(s_live + words);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wr = warp / 2, wc = warp % 2;
  const int m0 = blockIdx.x * BM;
  lowbit::conv_tables<BM>(s_off, s_base, words, cw, KW, Wp, Hp, stride, OH,
                          OW, m0, m);
  // Channels past C within a position's last word: the weights' in-word
  // pads decode to +1 (BNN), so the A side zeroes them.
  for (int c = tid; c < words; c += THREADS) {
    const int left = C - 32 * (c % cw);
    s_live[c] = left >= 32 ? 0xffffffffu : (1u << left) - 1u;
  }
  __syncthreads();

  const int nblk = (cout + BN - 1) / BN;
  const int nb0 = blockIdx.y * blocks_per_cta;
  const int nb_end = min(nblk, nb0 + blocks_per_cta);
  const int ks = (words + BKW - 1) / BKW;
  const int steps = (nb_end - nb0) * ks;

  // The packed words of step t as one cp.async group: A (every step when
  // streaming, the first column block's steps when resident) and the
  // weight rows into buffer t & 1 — one 16-byte copy per row when
  // words % 4 == 0, else one 4-byte copy per word.
  auto stage = [&](int t) {
    const int nb = nb0 + t / ks, w0 = (t % ks) * BKW;
    const int wn = min(BKW, words - w0);
    if (!resident || nb == nb0) {
      const int slot = resident ? w0 : (t & 1) * BKW;
      for (int i = tid; i < BM * BKW; i += THREADS) {
        const int r = i / BKW, w = i % BKW;
        if (w >= wn) continue;
        const int src = s_base[r] + s_off[w0 + w];
        lowbit::cp_async4(s_aw + r * sa + slot + w, a0 + src, true);
        if constexpr (NA == 2)
          lowbit::cp_async4(s_aw + (BM + r) * sa + slot + w, a1 + src, true);
      }
    }
    uint32_t* sb = s_bw + (t & 1) * NB * BN * BKW;
    const int n0 = nb * BN;
    if (b_vec4) {
      for (int r = tid; r < BN; r += THREADS) {
        const bool ok = n0 + r < cout;
        const size_t off = ok ? static_cast<size_t>(n0 + r) * words + w0 : 0;
        lowbit::cp_async16(sb + r * BKW, b0 + off, ok);
        if constexpr (NB == 2)
          lowbit::cp_async16(sb + (BN + r) * BKW, b1 + off, ok);
      }
    } else {
      for (int i = tid; i < BN * BKW; i += THREADS) {
        const int r = i / BKW, w = i % BKW;
        const bool ok = n0 + r < cout && w < wn;
        const size_t off = ok ? static_cast<size_t>(n0 + r) * words + w0 + w : 0;
        lowbit::cp_async4(sb + r * BKW + w, b0 + off, ok);
        if constexpr (NB == 2)
          lowbit::cp_async4(sb + (BN + r) * BKW + w, b1 + off, ok);
      }
    }
    lowbit::cp_async_commit();
  };

  Acc acc[2][2];
  zero_acc(acc);
  if (steps > 0) stage(0);
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) {
      stage(t + 1);
      lowbit::cp_async_wait<1>();
    } else {
      lowbit::cp_async_wait<0>();
    }
    __syncthreads();
    const int kstep = t % ks, w0 = kstep * BKW;
    const int slot = resident ? w0 : (t & 1) * BKW;
    const uint32_t* sb = s_bw + (t & 1) * NB * BN * BKW;
    // Decode the step's packed words into the int8 slabs (as stage_planes
    // lays them out): depth words past `words` decode to 0 on both sides.
    for (int i = tid; i < BM * BKW; i += THREADS) {
      const int r = i / BKW, w = i % BKW, gk = w0 + w;
      uint32_t plus = 0, minus = 0, live = 0;
      if (gk < words) {
        plus = s_aw[r * sa + slot + w];
        if constexpr (TA) minus = s_aw[(BM + r) * sa + slot + w];
        live = s_live[gk];
      }
      decode_word<TA>(plus, minus, live, &s.in.a.v[2 * w][r][0],
                      &s.in.a.v[2 * w + 1][r][0]);
    }
    for (int i = tid; i < BN * BKW; i += THREADS) {
      const int r = i / BKW, w = i % BKW;
      uint32_t plus = 0, minus = 0, live = 0;
      if (w0 + w < words) {
        plus = sb[r * BKW + w];
        if constexpr (TB) minus = sb[(BN + r) * BKW + w];
        live = 0xffffffffu;
      }
      decode_word<TB>(plus, minus, live, &s.in.b.v[2 * w][r][0],
                      &s.in.b.v[2 * w + 1][r][0]);
    }
    __syncthreads();
    mma_step(s, wr, wc, acc);
    if (kstep == ks - 1) {
      __syncthreads();                 // s.c overlays the slabs
      store_acc(s, wr, wc, acc);
      store_scaled(s, m0, (nb0 + t / ks) * BN, m, cout, scale_p, 0, col, bias,
                   out);
      zero_acc(acc);
    }
    __syncthreads();
  }
}

}  // namespace tc

// mode: 0 BNN, 1 TNN, 2 TBN.  a0/a1 (m, kw), b0/b1 (n, kw) int32 words
// (a1 / b1 ignored for one plane); tile 64 or 32 (the square CTA tile);
// row read at row[i * row_stride] (0: one per-tensor scale, 1: one per
// row), col (n,), bias (n,) or null; out (m, n) float32, row-major.
// Returns cudaGetLastError() after the launch.
extern "C" int dense_gemm_launch(int mode, const void* a0, const void* a1,
                                 const void* b0, const void* b1, int m, int n,
                                 int kw, int k_valid, int tile,
                                 const void* row, int row_stride,
                                 const void* col, const void* bias, void* out,
                                 void* stream) {
  using namespace tc;
  if (m <= 0 || n <= 0 || kw <= 0 || row_stride < 0 || row_stride > 1 ||
      (tile != 64 && tile != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + tile - 1) / tile, (n + tile - 1) / tile);
  auto st = static_cast<cudaStream_t>(stream);
#define DENSE_GEMM_CASE(MODE, TILE)                                           \
  if (mode == MODE && tile == TILE)                                           \
    dense_gemm_kernel<MODE, TILE><<<grid, THREADS, 0, st>>>(                  \
        static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),   \
        m, static_cast<const uint32_t*>(b0),                                  \
        static_cast<const uint32_t*>(b1), n, kw,                              \
        MODE == lowbit::BNN ? k_valid : 0x7fffffff,                           \
        static_cast<const float*>(row), row_stride,                           \
        static_cast<const float*>(col), static_cast<const float*>(bias),      \
        static_cast<float*>(out));
  DENSE_GEMM_CASE(lowbit::BNN, 64)
  DENSE_GEMM_CASE(lowbit::BNN, 32)
  DENSE_GEMM_CASE(lowbit::TNN, 64)
  DENSE_GEMM_CASE(lowbit::TNN, 32)
  DENSE_GEMM_CASE(lowbit::TBN, 64)
  DENSE_GEMM_CASE(lowbit::TBN, 32)
#undef DENSE_GEMM_CASE
  if (mode < lowbit::BNN || mode > lowbit::TBN)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 BNN, 1 TNN, 2 TBN.  a0/a1 (B, Hp, Wp, ceil(C/32)) packed planes
// from lowbit_conv's conv_pack_launch (a1 ignored for BNN); b0/b1 (cout,
// words) positional planes with words == KH*KW*ceil(C/32) (b1 ignored for
// one plane); scale a float32 device scalar; col (cout,), bias (cout,) or
// null; out (B*OH*OW, cout) float32.  Returns cudaGetLastError() after
// the launch.
extern "C" int dense_conv_launch(int mode, const void* a0, const void* a1,
                                 int B, int Hp, int Wp, int C, int KH, int KW,
                                 int stride, int OH, int OW, const void* b0,
                                 const void* b1, int cout, int words,
                                 const void* scale, const void* col,
                                 const void* bias, void* out, void* stream) {
  using namespace tc;
  const int cw = (C + 31) / 32;
  if (B <= 0 || OH <= 0 || OW <= 0 || cout <= 0 || C <= 0 || stride <= 0 ||
      KH > Hp || KW > Wp || words != KH * KW * cw ||
      (OH - 1) * stride + KH > Hp || (OW - 1) * stride + KW > Wp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = B * OH * OW;
  const int m_blocks = (m + BM - 1) / BM, nblk = (cout + BN - 1) / BN;
  const int per_cta = lowbit_host::conv_blocks_per_cta(m_blocks, nblk);
  const dim3 grid(m_blocks, (nblk + per_cta - 1) / per_cta);
  const int b_vec4 = words % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(b0) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b1) % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
#define DENSE_CONV_CASE(MODE)                                                 \
  case MODE: {                                                                \
    constexpr int NA = MODE == lowbit::BNN ? 1 : 2;                           \
    constexpr int NB = MODE == lowbit::TNN ? 2 : 1;                           \
    const int resident =                                                      \
        static_cast<size_t>(NA) * BM * a_stride(words) * 4 <= RESIDENT_A_BYTES; \
    const int sa = a_stride(resident ? words : 2 * BKW);                      \
    const size_t smem = sizeof(Smem<int8_t>) +                                \
                        4 * (static_cast<size_t>(2) * NB * BN * BKW +         \
                             static_cast<size_t>(NA) * BM * sa + 2 * words + BM); \
    if (!lowbit_host::allow_smem(dense_conv_kernel<MODE>, smem))              \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    dense_conv_kernel<MODE><<<grid, THREADS, smem, st>>>(                     \
        static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),   \
        Hp, Wp, cw, C, KW, stride, OH, OW, m,                                 \
        static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1),   \
        cout, words, per_cta, resident, b_vec4,                               \
        static_cast<const float*>(scale), static_cast<const float*>(col),     \
        static_cast<const float*>(bias), static_cast<float*>(out));           \
    break;                                                                    \
  }
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

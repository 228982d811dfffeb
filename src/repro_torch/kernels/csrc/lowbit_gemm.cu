// Low-bit popcount GeMM for Hopper (sm_90a): TNN, TBN and BNN, with the
// eq. (2) epilogue fused in or the int32 core alone.
//
// Replaces the Pallas kernels of the JAX package:
//   tnn_matmul_fused_pallas / tnn_matmul_pallas  (kernels/tnn_matmul.py)
//   tbn_matmul_fused_pallas / tbn_matmul_pallas  (kernels/tbn_matmul.py)
//   bnn_matmul_fused_pallas / bnn_matmul_pallas  (kernels/bnn_matmul.py)
// all of which run through _matmul_common.lowbit_matmul_call.
//
// C[m, n] from A planes (m, kw) and B^T planes (n, kw) of 32-bit words:
//   BNN  k_valid - 2 * sum popc(a ^ b)                                  eq. (6)
//   TNN  sum popc((a+ & b+) | (a- & b-)) - popc((a+ & b-) | (a- & b+))  eq. (7)
//   TBN  sum popc((a+ | b) & (a- | ~b)) - popc((a+ | ~b) & (a- | b))    Table I
// then, when fused, acc * row[i * row_stride] * col[j] (+ bias[j]) in
// float32 (row_stride 0: one per-tensor activation scale, never expanded).
//
// What bounds it on this card: at the paper's GEMM_GRID sizes (m <= 360,
// n <= 96, kw <= 16) the work is under a microsecond, so a call is bound
// by latency: the launch, one memory round trip per staging wait, and the
// POPC work of the busiest SM.  At the CNN's im2col sizes (m up to
// 262,144) it is the integer pipe: POPC issues at 16 results per clock per
// SM on compute capability 9.0, and each output word costs 1 (BNN) or 2
// (TNN/TBN) POPC plus logic ops and an add.  Bytes are far below 3.35 TB/s
// in both: a word of A is reused across the CTA's columns, a word of B
// across its rows, from shared memory.
//
// What the design does about it: a GeMM is the implicit-im2col conv of a
// 1x1 filter over m "pixels" of kw words, so this kernel runs the conv's
// CTA body (lowbit_core.cuh popcount_body) with that geometry: base[r] =
// r * kw, off[gk] = gk.  The CTA's A rows are staged once for the whole
// depth with cp.async (one wait, not one synchronous round trip per
// staging round); the B rows come through a double-buffered cp.async
// ring; the loops are sized to kw, not to the 32-word step.  Unlike the
// conv, a GeMM CTA owns one column block: its A rows are contiguous and
// cheap to stage again, and the larger grid balances better.  The tile is
// 64 x 64 where the grid fills the card and 32 x 32 or 16 x 16 where it
// would not (the caller chooses: _matmul_common.gemm_tile), so the POPC
// work of a small product spreads over up to 132 SMs instead of 2-12.
// 32-bit popcounts of whole words (not bytes, as the paper's NEON CNT)
// keep the POPC count at its minimum.
// The tensor-core route is the dense backend's kernel, dense_tc.cu.
//
// Built with --fmad=false; the epilogue also uses __fmul_rn/__fadd_rn, so
// each multiply and the add round on their own and the output is bit for
// bit the plain PyTorch version's.

#include "lowbit_core.cuh"

namespace lowbit {

template <int MODE, bool FUSED, int ROWS, int COLS>
__global__ void __launch_bounds__(THREADS)
lowbit_gemm_kernel(const uint32_t* __restrict__ a0,
                   const uint32_t* __restrict__ a1, int m,
                   const uint32_t* __restrict__ b0,
                   const uint32_t* __restrict__ b1, int n, int kw,
                   int k_valid, int blocks_per_cta, int resident,
                   const float* __restrict__ row, int row_stride,
                   const float* __restrict__ col,
                   const float* __restrict__ bias, void* out) {
  extern __shared__ uint32_t smem[];
  int* off = body_tables<MODE, ROWS, COLS>(smem, kw, resident);
  // the conv tables of a 1x1 filter, stride 1, over (m, 1, 1, kw words)
  conv_tables<ROWS>(off, off + kw, kw, kw, 1, 1, 1, 1, 1, 1,
                    blockIdx.x * ROWS, m);
  __syncthreads();
  popcount_body<MODE, FUSED, ROWS, COLS>(smem, a0, a1, m, b0, b1, n, kw,
                                         k_valid, blocks_per_cta, resident,
                                         row, row_stride, col, bias, out);
}

template <int MODE, bool FUSED, int TILE>
int launch(const void* a0, const void* a1, const void* b0, const void* b1,
           int m, int n, int kw, int k_valid, const void* row, int row_stride,
           const void* col, const void* bias, void* out, cudaStream_t stream) {
  // one column block per CTA: no A reuse loop
  const auto p = lowbit_host::popcount_plan<MODE, TILE, TILE>(m, n, kw, false);
  auto kernel = lowbit_gemm_kernel<MODE, FUSED, TILE, TILE>;
  if (!lowbit_host::allow_smem(kernel, p.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<p.grid, THREADS, p.smem, stream>>>(
      static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1), m,
      static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1), n,
      kw, k_valid, p.per_cta, p.resident, static_cast<const float*>(row),
      row_stride, static_cast<const float*>(col),
      static_cast<const float*>(bias), out);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool FUSED>
int launch_tile(int tile, const void* a0, const void* a1, const void* b0,
                const void* b1, int m, int n, int kw, int k_valid,
                const void* row, int row_stride, const void* col,
                const void* bias, void* out, cudaStream_t stream) {
  switch (tile) {
    case 64:
      return launch<MODE, FUSED, 64>(a0, a1, b0, b1, m, n, kw, k_valid, row,
                                     row_stride, col, bias, out, stream);
    case 32:
      return launch<MODE, FUSED, 32>(a0, a1, b0, b1, m, n, kw, k_valid, row,
                                     row_stride, col, bias, out, stream);
    case 16:
      return launch<MODE, FUSED, 16>(a0, a1, b0, b1, m, n, kw, k_valid, row,
                                     row_stride, col, bias, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace lowbit

// mode: 0 BNN, 1 TNN, 2 TBN.  a0/a1 (m, kw), b0/b1 (n, kw) int32 words
// (a1 / b1 ignored for single-plane operands); tile 64, 32 or 16 (the
// square CTA tile); row / col / bias are ignored unless fused (bias may be
// null): row is read at row[i * row_stride] (0: one per-tensor scale, 1:
// one per row), col (n,), bias (n,).  out is float32 (fused) or int32
// (m, n), row-major.  Returns cudaGetLastError() after the launch.
extern "C" int lowbit_gemm_launch(int mode, int fused, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, int m, int n, int kw,
                                  int k_valid, int tile, const void* row,
                                  int row_stride, const void* col,
                                  const void* bias, void* out, void* stream) {
  using namespace lowbit;
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || kw <= 0 || row_stride < 0 || row_stride > 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define LOWBIT_GEMM_CASE(MODE)                                                \
  case MODE:                                                                  \
    return fused ? launch_tile<MODE, true>(tile, a0, a1, b0, b1, m, n, kw,    \
                                           k_valid, row, row_stride, col,     \
                                           bias, out, st)                     \
                 : launch_tile<MODE, false>(tile, a0, a1, b0, b1, m, n, kw,   \
                                            k_valid, row, row_stride, col,    \
                                            bias, out, st);
  switch (mode) {
    LOWBIT_GEMM_CASE(BNN)
    LOWBIT_GEMM_CASE(TNN)
    LOWBIT_GEMM_CASE(TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOWBIT_GEMM_CASE
}

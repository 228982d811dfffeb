// Grouped popcount GeMM for Hopper (sm_90a): G fused TNN or TBN products
// in one launch, group g its own rows, weights and scales.  The routed
// experts of a mixture-of-experts layer are the groups (models/moe.py).
//
// Group g: C[g, i, :] for i < counts[g] from the A planes (G, rows, kw),
// rows [g * rows, g * rows + counts[g]) of them, against the B^T planes
// (G, n, kw) of entry g, then acc * row[g] * col[g * n + j] (+ bias[g * n
// + j]) in float32: one activation scale a group, one column scale a
// column.  Rows from counts[g] to rows are read into no product and
// written as zeros, what the product of a zero row gives.
//
// What bounds it: one expert's product at ~550 rows fills a few dozen
// CTAs of 64 x 64, and launched one by one (three a routed expert, 180 a
// layer) the host's launches set the pace, not the card.  What the design
// does about it: one launch for every group, the group on blockIdx.z, a
// CTA whose row block lies past its group's count writing its zeros and
// leaving; each other CTA runs lowbit_gemm.cu's body (lowbit_core.cuh popcount_body, the 1x1
// conv tables) on its group's planes and scales, so the numbers are bit
// for bit those of one lowbit_gemm_launch a group in the same tile.
//
// Built with --fmad=false, as lowbit_gemm.cu.

#include "lowbit_core.cuh"

namespace lowbit {

template <int MODE, int ROWS, int COLS>
__global__ void __launch_bounds__(THREADS)
lowbit_gemm_kernel_grouped(const uint32_t* __restrict__ a0,
                           const uint32_t* __restrict__ a1, int rows,
                           const int* __restrict__ counts,
                           const uint32_t* __restrict__ b0,
                           const uint32_t* __restrict__ b1, int n, int kw,
                           int k_valid, int resident,
                           const float* __restrict__ row,
                           const float* __restrict__ col,
                           const float* __restrict__ bias, float* out) {
  const int g = blockIdx.z;
  const int m = counts[g];
  const int m0 = blockIdx.x * ROWS, n0 = blockIdx.y * COLS;
  float* o = out + static_cast<size_t>(g) * rows * n;
  // this CTA's tile (one column block: popcount_plan without A reuse) at
  // the group's rows past its count
  for (int i = threadIdx.x; i < ROWS * COLS; i += THREADS) {
    const int r = m0 + i / COLS, c = n0 + i % COLS;
    if (r >= m && r < rows && c < n) o[static_cast<size_t>(r) * n + c] = 0.f;
  }
  if (m0 >= m) return;   // the whole CTA
  extern __shared__ uint32_t smem[];
  int* off = body_tables<MODE, ROWS, COLS>(smem, kw, resident);
  conv_tables<ROWS>(off, off + kw, kw, kw, 1, 1, 1, 1, 1, 1, m0, m);
  __syncthreads();
  const size_t a_at = static_cast<size_t>(g) * rows * kw;
  const size_t b_at = static_cast<size_t>(g) * n * kw;
  popcount_body<MODE, true, ROWS, COLS>(
      smem, a0 + a_at, a1 + a_at, m, b0 + b_at, b1 + b_at, n, kw, k_valid, 1,
      resident, row + g, 0, col + static_cast<size_t>(g) * n,
      bias == nullptr ? nullptr : bias + static_cast<size_t>(g) * n, o);
}

template <int MODE, int TILE>
int launch_grouped(const void* a0, const void* a1, int rows,
                   const void* counts, int groups, const void* b0,
                   const void* b1, int n, int kw, int k_valid,
                   const void* row, const void* col, const void* bias,
                   void* out, cudaStream_t stream) {
  auto p = lowbit_host::popcount_plan<MODE, TILE, TILE>(rows, n, kw, false);
  p.grid.z = groups;
  auto kernel = lowbit_gemm_kernel_grouped<MODE, TILE, TILE>;
  if (!lowbit_host::allow_smem(kernel, p.smem))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<p.grid, THREADS, p.smem, stream>>>(
      static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),
      rows, static_cast<const int*>(counts),
      static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1), n,
      kw, k_valid, p.resident, static_cast<const float*>(row),
      static_cast<const float*>(col), static_cast<const float*>(bias),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_grouped_tile(int tile, const void* a0, const void* a1, int rows,
                        const void* counts, int groups, const void* b0,
                        const void* b1, int n, int kw, int k_valid,
                        const void* row, const void* col, const void* bias,
                        void* out, cudaStream_t stream) {
  switch (tile) {
    case 64:
      return launch_grouped<MODE, 64>(a0, a1, rows, counts, groups, b0, b1, n,
                                      kw, k_valid, row, col, bias, out, stream);
    case 32:
      return launch_grouped<MODE, 32>(a0, a1, rows, counts, groups, b0, b1, n,
                                      kw, k_valid, row, col, bias, out, stream);
    case 16:
      return launch_grouped<MODE, 16>(a0, a1, rows, counts, groups, b0, b1, n,
                                      kw, k_valid, row, col, bias, out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace lowbit

// mode: 1 TNN, 2 TBN.  a0/a1 (groups, rows, kw) int32 words; counts
// (groups,) int32, each at most rows; b0/b1 (groups, n, kw) (b1 ignored
// for TBN); tile 64, 32 or 16; row (groups,), col (groups, n) and bias
// (groups, n) or null, float32; out (groups, rows, n) float32, zero at
// each group's rows from its count on.  Returns cudaGetLastError()
// after the launch.
extern "C" int lowbit_gemm_grouped_launch(int mode, const void* a0,
                                          const void* a1, int rows,
                                          const void* counts, int groups,
                                          const void* b0, const void* b1,
                                          int n, int kw, int k_valid, int tile,
                                          const void* row, const void* col,
                                          const void* bias, void* out,
                                          void* stream) {
  using namespace lowbit;
  auto st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || groups <= 0 || groups > 65535 || n <= 0 || kw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case TNN:
      return launch_grouped_tile<TNN>(tile, a0, a1, rows, counts, groups, b0,
                                      b1, n, kw, k_valid, row, col, bias, out,
                                      st);
    case TBN:
      return launch_grouped_tile<TBN>(tile, a0, a1, rows, counts, groups, b0,
                                      b1, n, kw, k_valid, row, col, bias, out,
                                      st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

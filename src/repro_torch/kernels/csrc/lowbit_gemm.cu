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
// then, when fused, acc * row[i] * col[j] (+ bias[j]) in float32.
//
// What bounds it on this card: the integer pipe.  POPC issues at 16
// results per clock per SM on compute capability 9.0 (CUDA programming
// guide, arithmetic instruction throughput), a quarter of the 32-bit
// logic rate, and each output word costs 1 (BNN) or 2 (TNN/TBN) POPC plus
// 1-6 logic ops and an add.  Bytes are far below 3.35 TB/s at the
// paper's shapes: a word of A is reused across BN = 64 columns and a
// word of B across BM = 64 rows from shared memory.
//
// What the design does about it: every operand word is loaded once into
// registers and reused TN = 4 (A) or TM = 4 (B) times, so the inner loop
// is POPC and logic with few shared-memory loads; 32-bit popcounts of
// whole words (not bytes, as the paper's NEON CNT) keep the POPC count at
// its minimum.  Not done yet (later work): double-buffered cp.async/TMA
// staging, and the tensor-core route — unpack the planes to +-1/0 int8 or
// bf16 in shared memory and run wgmma, as the reference's dense backend
// does on the MXU — which trades the POPC bound for the much higher
// int8 tensor rate.
//
// Built with --fmad=false; the epilogue also uses __fmul_rn/__fadd_rn, so
// each multiply and the add round on their own and the output is bit for
// bit the plain PyTorch version's.

#include "lowbit_core.cuh"

namespace lowbit {

template <int MODE, bool FUSED>
__global__ void __launch_bounds__(THREADS)
lowbit_gemm_kernel(const uint32_t* __restrict__ a0,
                   const uint32_t* __restrict__ a1,
                   const uint32_t* __restrict__ b0,
                   const uint32_t* __restrict__ b1, int m, int n, int kw,
                   int k_valid, const float* __restrict__ row,
                   const float* __restrict__ col,
                   const float* __restrict__ bias, void* out) {
  __shared__ Tile<MODE> s;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  int acc[TM][TN] = {};
  for (int k0 = 0; k0 < kw; k0 += BK) {
    const int wn = min(BK, kw - k0);
    stage_rows<Planes<MODE>::A, BM>(s.a, a0, a1, m0, m, k0, wn, kw);
    stage_rows<Planes<MODE>::B, BN>(s.b, b0, b1, n0, n, k0, wn, kw);
    __syncthreads();
    mac_tile<MODE>(s, wn, ty, tx, acc);
    __syncthreads();
  }
  store_tile<MODE, FUSED>(acc, m0, n0, ty, tx, m, n, k_valid, row, 1, col,
                          bias, out);
}

template <int MODE, bool FUSED>
void launch(const void* a0, const void* a1, const void* b0, const void* b1,
            int m, int n, int kw, int k_valid, const void* row,
            const void* col, const void* bias, void* out,
            cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  lowbit_gemm_kernel<MODE, FUSED><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(a0), static_cast<const uint32_t*>(a1),
      static_cast<const uint32_t*>(b0), static_cast<const uint32_t*>(b1), m,
      n, kw, k_valid, static_cast<const float*>(row),
      static_cast<const float*>(col), static_cast<const float*>(bias), out);
}

}  // namespace lowbit

// mode: 0 BNN, 1 TNN, 2 TBN.  a1 / b1 are ignored for single-plane
// operands; row / col / bias are ignored unless fused (bias may be null).
// out is float32 (fused) or int32 (m, n), row-major.  Returns
// cudaGetLastError() after the launch.
extern "C" int lowbit_gemm_launch(int mode, int fused, const void* a0,
                                  const void* a1, const void* b0,
                                  const void* b1, int m, int n, int kw,
                                  int k_valid, const void* row,
                                  const void* col, const void* bias,
                                  void* out, void* stream) {
  using namespace lowbit;
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0 || kw <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define LOWBIT_GEMM_CASE(MODE)                                               \
  case MODE:                                                                 \
    if (fused)                                                               \
      launch<MODE, true>(a0, a1, b0, b1, m, n, kw, k_valid, row, col, bias,  \
                         out, st);                                           \
    else                                                                     \
      launch<MODE, false>(a0, a1, b0, b1, m, n, kw, k_valid, row, col, bias, \
                          out, st);                                          \
    break;
  switch (mode) {
    LOWBIT_GEMM_CASE(BNN)
    LOWBIT_GEMM_CASE(TNN)
    LOWBIT_GEMM_CASE(TBN)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LOWBIT_GEMM_CASE
  return static_cast<int>(cudaGetLastError());
}

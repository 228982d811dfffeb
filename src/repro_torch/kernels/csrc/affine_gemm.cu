// u8 and u4 GeMM for Hopper (sm_90a): the raw unsigned accumulator
// A_q @ B_q in int32, the first term of the paper's eq. (3) — the
// gemmlowp-style U8 and U4 baselines of Table III.
//
// Replaces the Pallas kernels of the JAX package:
//   int8_matmul_pallas  (kernels/int8_matmul.py)  -> affine_gemm_kernel<false>
//   int4_matmul_pallas  (kernels/int4_matmul.py)  -> affine_gemm_kernel<true>
//
// u8: A (m, k) and B (k, n) uint8, row-major.  u4: the nibble-packed
// operands of int4_matmul.pack_nibbles_rows / _cols — A (m, k2) with
// element 2t in the low nibble of byte t along k, B (k2, n) packed the
// same way along k (axis 0); the depth is 2*k2 (an odd logical depth is
// padded with a 0 nibble on both sides).  The zero-point terms of eq. (3)
// are rank-1 and stay outside, in PyTorch, as the reference applies them
// outside Pallas.
//
// Both run on the tensor cores with unsigned 8-bit operands (wmma
// 16x16x16 unsigned char, int32 accumulators); the u4 entry unpacks the
// nibbles to u8 while staging and then shares the u8 tile loop (Hopper
// has no int4 tensor-core rate worth targeting).  The accumulators wrap
// modulo 2^32, as XLA's int32 dot does.
//
// What bounds it on this card: at the paper's GEMM_GRID shapes (m <= 360,
// n <= 96, k <= 512) a call is a few CTAs and is bound by launch latency
// and the staging loads; the operations (2*m*n*k at 1,979 TOP/s) and the
// bytes (A and B once, the int32 output once, at 3.35 TB/s) are each
// under a microsecond.  The design keeps staging simple and exact (byte
// loads, zero fill at the ragged edges, B transposed into column-major
// slabs on its way into shared memory).  Not done yet (later work):
// vectorized or TMA staging, double buffering, wgmma.

#include "tc_core.cuh"

namespace tc {

template <bool U4>
__global__ void __launch_bounds__(THREADS)
affine_gemm_kernel(const uint8_t* __restrict__ a,
                   const uint8_t* __restrict__ b, int m, int n, int k,
                   int* __restrict__ out) {
  __shared__ Smem<uint8_t> s;
  const int warp = threadIdx.x / 32, wr = warp / 2, wc = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // Row stride of A in bytes: k (u8) or k / 2 (u4, k even).
  const int lda = U4 ? k / 2 : k;
  Acc acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < k; k0 += BK) {
    // A: consecutive threads along k (coalesced bytes of one row).
    for (int i = threadIdx.x; i < BM * BK; i += THREADS) {
      const int r = i / BK, d = i % BK;
      const int gm = m0 + r, gk = k0 + d;
      uint32_t v = 0;
      if (gm < m && gk < k) {
        if constexpr (U4)
          v = (__ldg(a + static_cast<size_t>(gm) * lda + gk / 2) >> (4 * (gk & 1))) & 0xFu;
        else
          v = __ldg(a + static_cast<size_t>(gm) * lda + gk);
      }
      s.in.a.v[d / 16][r][d % 16] = static_cast<uint8_t>(v);
    }
    // B: consecutive threads along n (coalesced bytes of one depth row),
    // transposed into the column-major slabs.
    for (int i = threadIdx.x; i < BK * BN; i += THREADS) {
      const int d = i / BN, c = i % BN;
      const int gk = k0 + d, gn = n0 + c;
      uint32_t v = 0;
      if (gk < k && gn < n) {
        if constexpr (U4)
          v = (__ldg(b + static_cast<size_t>(gk / 2) * n + gn) >> (4 * (gk & 1))) & 0xFu;
        else
          v = __ldg(b + static_cast<size_t>(gk) * n + gn);
      }
      s.in.b.v[d / 16][c][d % 16] = static_cast<uint8_t>(v);
    }
    __syncthreads();
    mma_step(s, wr, wc, acc);
    __syncthreads();
  }
  store_acc(s, wr, wc, acc);
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < m && gn < n) out[static_cast<size_t>(gm) * n + gn] = s.c[r][c];
  }
}

}  // namespace tc

// u4: 0 for u8 operands a (m, k), b (k, n); 1 for nibble-packed operands
// a (m, k2), b (k2, n) with k = 2*k2.  out (m, n) int32, row-major.
// Returns cudaGetLastError() after the launch.
extern "C" int affine_gemm_launch(int u4, const void* a, const void* b, int m,
                                  int n, int k, void* out, void* stream) {
  using namespace tc;
  if (m <= 0 || n <= 0 || k <= 0 || (u4 && k % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* pa = static_cast<const uint8_t*>(a);
  const auto* pb = static_cast<const uint8_t*>(b);
  if (u4)
    affine_gemm_kernel<true><<<grid, THREADS, 0, st>>>(pa, pb, m, n, k,
                                                       static_cast<int*>(out));
  else
    affine_gemm_kernel<false><<<grid, THREADS, 0, st>>>(pa, pb, m, n, k,
                                                        static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

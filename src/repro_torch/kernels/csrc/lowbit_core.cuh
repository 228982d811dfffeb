// Popcount core shared by the Hopper low-bit kernels (lowbit_gemm.cu,
// lowbit_conv.cu): the CTA tile, the per-word products of the three
// modes, shared-memory staging of bit-plane rows, the register-tile
// multiply-accumulate and the eq. (6) / eq. (2) epilogue.
//
// Bit planes are 32-bit words, LSB first (depth k = 32*w + i is bit i of
// word w).  A CTA of 256 threads owns one BM x BN output tile and loops
// over the depth words itself, BK words per step staged in shared memory;
// each thread keeps a TM x TN block of int32 counts in registers.  A word
// past the depth is staged as 0 on both operands, which contributes 0 in
// every mode (BNN: 0 ^ 0; TNN: no bit set; TBN: a+ = a- = 0 forces
// z+ = b & ~b = 0 and z- = ~b & b = 0).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lowbit {

constexpr int BM = 64;        // output rows per CTA
constexpr int BN = 64;        // output columns per CTA
constexpr int BK = 32;        // depth words staged per step
constexpr int THREADS = 256;
constexpr int TX = 16;        // threads along n; THREADS / TX along m
constexpr int TY = THREADS / TX;
constexpr int TM = BM / TY;   // rows per thread
constexpr int TN = BN / TX;   // columns per thread
static_assert(TM * TY == BM && TN * TX == BN, "tile must divide");

enum Mode : int { BNN = 0, TNN = 1, TBN = 2 };

template <int MODE> struct Planes {
  static constexpr int A = MODE == BNN ? 1 : 2;   // activation planes
  static constexpr int B = MODE == TNN ? 2 : 1;   // weight planes
};

// Shared-memory tile, depth-major so a warp's reads along m or n hit
// distinct banks; rows padded by one word so the transposing stores do too.
template <int MODE> struct Tile {
  uint32_t a[Planes<MODE>::A][BK][BM + 1];
  uint32_t b[Planes<MODE>::B][BK][BN + 1];
};

// Signed contribution of one word: BNN the XOR popcount (finalized by
// eq. (6) in the epilogue), TNN eq. (7), TBN the Table I identities.
template <int MODE>
__device__ __forceinline__ int product(uint32_t ap, uint32_t am, uint32_t bp,
                                       uint32_t bm) {
  if constexpr (MODE == BNN) {
    return __popc(ap ^ bp);
  } else if constexpr (MODE == TNN) {
    return __popc((ap & bp) | (am & bm)) - __popc((ap & bm) | (am & bp));
  } else {
    const uint32_t nb = ~bp;
    return __popc((ap | bp) & (am | nb)) - __popc((ap | nb) & (am | bp));
  }
}

// Stage words [k0, k0 + wn) of rows [row0, row0 + ROWS) of NP planes
// (row-major, kw words per row) into dst[plane][word][row]; rows past
// nrows are staged as 0.
template <int NP, int ROWS>
__device__ __forceinline__ void stage_rows(uint32_t (&dst)[NP][BK][ROWS + 1],
                                           const uint32_t* __restrict__ p0,
                                           const uint32_t* __restrict__ p1,
                                           int row0, int nrows, int k0,
                                           int wn, int kw) {
  for (int i = threadIdx.x; i < ROWS * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    if (c >= wn) continue;
    const int gr = row0 + r;
    const bool ok = gr < nrows;
    const size_t off = static_cast<size_t>(gr) * kw + k0 + c;
    dst[0][c][r] = ok ? __ldg(p0 + off) : 0u;
    if constexpr (NP == 2) dst[1][c][r] = ok ? __ldg(p1 + off) : 0u;
  }
}

// acc[i][j] += sum over the wn staged words of product(A row, B column),
// for rows ty + TY*i and columns tx + TX*j of the tile.
template <int MODE>
__device__ __forceinline__ void mac_tile(const Tile<MODE>& s, int wn, int ty,
                                         int tx, int (&acc)[TM][TN]) {
  constexpr int NA = Planes<MODE>::A, NB = Planes<MODE>::B;
#pragma unroll 4
  for (int w = 0; w < wn; ++w) {
    uint32_t ap[TM], am[TM], bp[TN], bm[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      ap[i] = s.a[0][w][ty + TY * i];
      am[i] = s.a[NA - 1][w][ty + TY * i];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      bp[j] = s.b[0][w][tx + TX * j];
      bm[j] = s.b[NB - 1][w][tx + TX * j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] += product<MODE>(ap[i], am[i], bp[j], bm[j]);
  }
}

// Finalize and write the thread's outputs.  BNN: k_valid - 2*acc
// (eq. (6)).  FUSED: eq. (2) as acc * row * col (+ bias), each step
// rounded on its own, in the reference's order; row is read at
// row[gm * row_stride] (stride 0: one per-tensor scale).  Otherwise the
// int32 count is written.
template <int MODE, bool FUSED>
__device__ __forceinline__ void store_tile(const int (&acc)[TM][TN], int m0,
                                           int n0, int ty, int tx, int m,
                                           int n, int k_valid,
                                           const float* __restrict__ row,
                                           int row_stride,
                                           const float* __restrict__ col,
                                           const float* __restrict__ bias,
                                           void* out) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= m) continue;
    float rs = 0.f;
    if constexpr (FUSED) rs = __ldg(row + static_cast<size_t>(gm) * row_stride);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn >= n) continue;
      int v = acc[i][j];
      if constexpr (MODE == BNN) v = k_valid - 2 * v;
      const size_t o = static_cast<size_t>(gm) * n + gn;
      if constexpr (FUSED) {
        float y = __fmul_rn(__fmul_rn(__int2float_rn(v), rs), __ldg(col + gn));
        if (bias != nullptr) y = __fadd_rn(y, __ldg(bias + gn));
        static_cast<float*>(out)[o] = y;
      } else {
        static_cast<int*>(out)[o] = v;
      }
    }
  }
}

}  // namespace lowbit

extern "C" const char* lowbit_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

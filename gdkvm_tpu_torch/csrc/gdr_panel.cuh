// Building blocks shared by gdr_fwd.cu and gdr_bwd.cu: a register-tiled
// product over the thread block, and the panel-blocked unit-triangular
// solves of the GDR's WY system.
//
// In the solves A = strict_tril(diag(eta) K K^T) is never formed.  The rows
// are taken in panels of kPanel; the rows of earlier panels enter a panel
// through one dk x m matrix held in shared memory,
//
//   forward     (I + A)   X = R:  x_r = r_r - eta_r k_r^T G - (in-panel rows),
//               G = sum over solved rows j of k_j x_j^T;
//   transposed  (I + A)^T Y = R:  y_r = r_r - k_r^T H - (in-panel rows),
//               H = sum over solved rows j of eta_j k_j y_j^T,
//
// and the rows of the same panel through its kPanel x kPanel block of A, by
// substitution with one thread per right-hand-side column.  Only that
// in-panel substitution is serial: kPanel dependent rows instead of N.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>

namespace gdr {

constexpr int kPanel = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// out(i, j, s) receives s = sum_{kk < K} a(i, kk) * b(kk, j) for every
// i < R, j < C, computed on all threads of the block.  A warp takes TI
// consecutive rows and a group of 32*TJ columns; lane l owns columns
// l, l+32, ..., l+32*(TJ-1) of the group.  So a warp reads a's values by
// broadcast and b's rows in consecutive words (b's rows may be padded, its
// columns are not), each value of a serves TJ products and each value of b
// TI: a fraction of the shared-memory loads of one product per thread.
// out is called once per (i, j), by the thread that computed it.
template <int TI, int TJ, typename FA, typename FB, typename FO>
__device__ __forceinline__ void block_mm(int R, int C, int K, FA a, FB b,
                                         FO out) {
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int groups = (C + 32 * TJ - 1) / (32 * TJ);
  const int items = (R + TI - 1) / TI * groups;
  for (int it = threadIdx.x >> 5; it < items; it += n_warps) {
    const int i0 = it / groups * TI;
    const int j0 = it % groups * 32 * TJ + lane;
    float acc[TI][TJ];
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      float av[TI], bv[TJ];
#pragma unroll
      for (int ii = 0; ii < TI; ++ii) av[ii] = i0 + ii < R ? a(i0 + ii, kk) : 0.f;
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
        bv[jj] = j0 + 32 * jj < C ? b(kk, j0 + 32 * jj) : 0.f;
#pragma unroll
      for (int ii = 0; ii < TI; ++ii)
#pragma unroll
        for (int jj = 0; jj < TJ; ++jj) acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
#pragma unroll
    for (int ii = 0; ii < TI; ++ii)
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj)
        if (i0 + ii < R && j0 + 32 * jj < C) out(i0 + ii, j0 + 32 * jj, acc[ii][jj]);
  }
}

// Shared-memory floats of panel_solve's workspace: the dk x m accumulator
// (rows padded to m+1), the panel's K rows (padded to dk+1), its A block,
// its X rows and its eta.
__host__ __device__ inline size_t panel_floats(int dk, int m) {
  return static_cast<size_t>(dk) * (m + 1) + kPanel * (dk + 1) +
         kPanel * kPanel + static_cast<size_t>(kPanel) * m + kPanel;
}

// Solve in place: x (n, m) row-major, in shared or global memory, holds the
// right-hand side on entry and the solution on return.  K's row r is
// k[r * k_ld : r * k_ld + dk].  ws: panel_floats(dk, m) floats of shared
// memory.  With kTrans and t2 non-null, also
//   t2[r] = -(sum over j > r of eta_j k_j y_j^T) xo_r = (dA^T (eta K))[r]
// for the adjoint, where xo (n, m) is the forward solve and xb a further
// kPanel * (m + 1) floats of shared memory.  Every thread of the block
// calls it; it begins and ends with a barrier.
template <bool kTrans, typename KT>
__device__ void panel_solve(float* x, int n, int m, const KT* k, int k_ld,
                            const float* eta, int dk, float* ws,
                            float* t2 = nullptr, const float* xo = nullptr,
                            float* xb = nullptr) {
  const int ldp = dk + 1;                // kpan's row stride
  const int lda = m + 1;                 // acc's and xb's row stride
  float* acc = ws;                       // G or H (dk, lda)
  float* kpan = acc + dk * lda;          // (kPanel, ldp)
  float* ap = kpan + kPanel * ldp;       // (kPanel, kPanel), A's block
  float* pb = ap + kPanel * kPanel;      // (kPanel, m), the panel's rows
  float* epan = pb + kPanel * m;         // (kPanel)
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  __syncthreads();  // x's right-hand side is complete
  for (int i = tid; i < dk * lda; i += nthr) acc[i] = 0.f;
  const int n_pan = (n + kPanel - 1) / kPanel;
  for (int pi = 0; pi < n_pan; ++pi) {
    const int lo = (kTrans ? n_pan - 1 - pi : pi) * kPanel;
    const int np = min(kPanel, n - lo);
    const size_t off = static_cast<size_t>(lo) * m;
    __syncthreads();  // the previous panel is done with the buffers

    for (int i = tid; i < np * dk; i += nthr) {
      const int r = i / dk, d = i - r * dk;
      kpan[r * ldp + d] = to_f32(k[static_cast<size_t>(lo + r) * k_ld + d]);
    }
    for (int i = tid; i < np; i += nthr) epan[i] = eta[lo + i];
    for (int i = tid; i < np * m; i += nthr) pb[i] = x[off + i];
    if (t2) {
      for (int i = tid; i < np * m; i += nthr) {
        const int r = i / m, c = i - r * m;
        xb[r * lda + c] = xo[off + i];
      }
    }
    __syncthreads();

    // A's block, and the earlier panels' contribution.
    block_mm<4, 1>(
        np, np, dk, [&](int i, int d) { return kpan[i * ldp + d]; },
        [&](int d, int j) { return kpan[j * ldp + d]; },
        [&](int i, int j, float s) { ap[i * kPanel + j] = j < i ? epan[i] * s : 0.f; });
    block_mm<4, 4>(
        np, m, dk, [&](int i, int d) { return kpan[i * ldp + d]; },
        [&](int d, int c) { return acc[d * lda + c]; },
        [&](int i, int c, float s) { pb[i * m + c] -= kTrans ? s : epan[i] * s; });
    __syncthreads();

    // In-panel substitution, one column per thread.
    for (int c = tid; c < m; c += nthr) {
      if (!kTrans) {
        for (int r = 1; r < np; ++r) {
          float v = pb[r * m + c];
          for (int j = 0; j < r; ++j) v = fmaf(-ap[r * kPanel + j], pb[j * m + c], v);
          pb[r * m + c] = v;
        }
      } else {
        for (int r = np - 2; r >= 0; --r) {
          float v = pb[r * m + c];
          for (int j = r + 1; j < np; ++j) v = fmaf(-ap[j * kPanel + r], pb[j * m + c], v);
          pb[r * m + c] = v;
        }
      }
    }
    __syncthreads();

    if (t2) {
      // ap[j][r] <- y_j . xo_r for j > r within the panel; then
      // t2_r = -H xo_r - sum_{j > r} (y_j . xo_r) eta_j k_j, H still
      // excluding this panel.
      block_mm<4, 1>(
          np, np, m, [&](int j, int c) { return pb[j * m + c]; },
          [&](int c, int r) { return xb[r * lda + c]; },
          [&](int j, int r, float s) { ap[j * kPanel + r] = j > r ? s : 0.f; });
      __syncthreads();
      block_mm<4, 2>(
          np, dk, m, [&](int r, int c) { return xb[r * lda + c]; },
          [&](int c, int d) { return acc[d * lda + c]; },
          [&](int r, int d, float s) {
            for (int j = r + 1; j < np; ++j)
              s = fmaf(ap[j * kPanel + r] * epan[j], kpan[j * ldp + d], s);
            t2[static_cast<size_t>(lo + r) * dk + d] = -s;
          });
      __syncthreads();
    }

    // Write the panel back and add it to the accumulator.
    for (int i = tid; i < np * m; i += nthr) x[off + i] = pb[i];
    block_mm<4, 4>(
        dk, m, np,
        [&](int d, int r) { return kTrans ? epan[r] * kpan[r * ldp + d] : kpan[r * ldp + d]; },
        [&](int r, int c) { return pb[r * m + c]; },
        [&](int d, int c, float s) { acc[d * lda + c] += s; });
  }
  __syncthreads();
}

}  // namespace gdr

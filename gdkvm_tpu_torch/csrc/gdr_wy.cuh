// The GDR's WY solve of every frame at once, for Hopper (sm_90a): the first
// step of the forward (gdr_fwd.cu) and of the backward (gdr_bwd.cu), which
// recomputes it.  Per frame (one block each, B*H*T blocks):
//
//   A = strict_tril(diag(eta) K K^T)
//   [U | W] = (I + A)^-1 [beta*V | eta*K]     (exact substitution)
//
// written fp32 to u and w, and, when u16 and w16 are not null, also as bf16
// copies (the stored backward's residuals under GDKVM_GDR_SAVE_DTYPE=bf16;
// the chain reads the fp32 ones).
//
// Up to N=157 at d=64 K, [U | W], A and the inverses of A's 16 x 16
// diagonal blocks sit in shared memory (52 KB at N=49: four blocks an SM),
// and the solve goes by 16-row blocks:
//   X_b = (I + A_bb)^-1 (R_b - A_b,<b X_<b),
// so the serial depth is ceil(N/16) block steps, not N rows.  A and both
// products of a step run on the tensor cores in fp32-accurate 3xTF32
// (gdr_mma.cuh); only the 16 x 16 inverses are substitutions, all blocks at
// once.  Above that (the training shape, N=256) A no longer fits: the
// 32-row panel solve of gdr_panel.cuh, in fp32 FMAs, which never forms A.

#pragma once

#include "gdr_mma.cuh"
#include "gdr_panel.cuh"

namespace gdr {
namespace wy {

constexpr int kThreads = 256;
constexpr int kBlk = 16;               // diagonal block of the small solve
constexpr int kInv = kBlk + 4;         // row stride of a block's inverse
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// Row strides (floats) of the small layout's matrices, chosen so that the
// tensor cores' fragment reads (8 rows x 4 columns, or 4 rows x 8) fall in
// distinct banks: K (n, dk) and A (n, n) rows are 4 mod 8 floats apart, X
// rows 8 mod 32.  The panel layout keeps X unpadded (gdr_panel.cuh's
// stride).  `region`: K until A is formed, then the diagonal blocks'
// inverses (ceil(n/16), 16, kInv) and one block's right-hand side (16, x).
struct Strides {
  int k, a, x, region;
  __host__ __device__ Strides(int n, int dk, int dv, bool panels) {
    const int m = dv + dk, nb = (n + kBlk - 1) / kBlk;
    k = (dk + 7) / 8 * 8 + 4;
    a = (n + 7) / 8 * 8 + 4;
    x = panels ? m : (m + 7) / 8 * 8 + 8;
    const int inv = nb * kBlk * kInv + kBlk * x;
    region = n * k > inv ? n * k : inv;
  }
};

// Small layout, in floats: the region, X (n, m), A (n, n), beta and eta (n
// each).  At the serving shape (N=49, d=64) that is 52 KB, so four blocks
// share an SM.
__host__ __device__ inline size_t small_floats(int n, int dk, int dv) {
  const Strides ld(n, dk, dv, false);
  return static_cast<size_t>(ld.region) + static_cast<size_t>(n) * (ld.x + ld.a) +
         2 * static_cast<size_t>(n);
}

// Panel layout: X (n, m), the panel workspace, and beta, eta.
__host__ __device__ inline size_t panel_layout_floats(int n, int dk, int dv) {
  return static_cast<size_t>(n) * (dv + dk) + gdr::panel_floats(dk, dv + dk) +
         2 * static_cast<size_t>(n);
}

// True when the small layout does not fit: solve by panels.
__host__ __device__ inline bool uses_panels(int n, int dk, int dv) {
  return small_floats(n, dk, dv) * sizeof(float) > kSmemLimit;
}

__host__ __device__ inline size_t smem_floats(int n, int dk, int dv) {
  return uses_panels(n, dk, dv) ? panel_layout_floats(n, dk, dv)
                                : small_floats(n, dk, dv);
}

// Four blocks an SM in the small layout (64 registers a thread); the panel
// layout's shared memory allows one.
template <typename T, bool kPanels>
__global__ void __launch_bounds__(kThreads, kPanels ? 1 : 4)
wy_kernel(const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ beta, const float* __restrict__ eta,
          float* __restrict__ u, float* __restrict__ w,
          __nv_bfloat16* __restrict__ u16, __nv_bfloat16* __restrict__ w16,
          int n, int dk, int dv) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 K: exact in TF32
  extern __shared__ float smem[];
  const int m = dv + dk;
  const Strides ld(n, dk, dv, kPanels);
  const int nb = (n + kBlk - 1) / kBlk;
  const int tid = threadIdx.x;
  const size_t fr = blockIdx.x;  // frame index in (B*H*T)
  const T* kp = k + fr * n * dk;
  const T* vp = v + fr * n * dv;
  // Small layout: the K / inverses region, X, A, gates.  Panel layout: X,
  // workspace, gates.
  float* ks = smem;
  float* dinv = smem;
  float* rb = dinv + nb * kBlk * kInv;
  float* x = smem + (kPanels ? 0 : ld.region);
  float* a = x + n * ld.x;
  float* gates = a + (kPanels ? gdr::panel_floats(dk, m) : n * ld.a);
  const float* ep = gates + n;   // eta, in shared memory

  // The gated right-hand side [beta*V | eta*K], K and the gates.  A warp
  // takes kLoadRows rows at a time, lanes across 64 columns of each, and
  // loads all of them before it stores any, so their latencies overlap.
  const int warp = tid >> 5, lane = tid & 31;
  constexpr int kLoadRows = 4, kLoadCols = 2;   // per lane: 4 rows x 2 columns
  for (int r0 = warp; r0 < n; r0 += kLoadRows * (kThreads / 32)) {
    for (int c0 = 0; c0 < (dk > dv ? dk : dv); c0 += 32 * kLoadCols) {
      float kv[kLoadRows][kLoadCols], vv[kLoadRows][kLoadCols], b_r[kLoadRows], e_r[kLoadRows];
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        const int r = r0 + i * (kThreads / 32);
        b_r[i] = r < n ? beta[fr * n + r] : 0.f;
        e_r[i] = r < n ? eta[fr * n + r] : 0.f;
#pragma unroll
        for (int j = 0; j < kLoadCols; ++j) {
          const int c = c0 + lane + 32 * j;
          kv[i][j] = r < n && c < dk ? gdr::to_f32(kp[r * dk + c]) : 0.f;
          vv[i][j] = r < n && c < dv ? gdr::to_f32(vp[r * dv + c]) : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kLoadRows; ++i) {
        const int r = r0 + i * (kThreads / 32);
        if (r >= n) continue;
#pragma unroll
        for (int j = 0; j < kLoadCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < dk) {
            if (!kPanels) ks[r * ld.k + c] = kv[i][j];
            x[r * ld.x + dv + c] = e_r[i] * kv[i][j];
          }
          if (c < dv) x[r * ld.x + c] = b_r[i] * vv[i][j];
        }
        if (lane == 0 && c0 == 0) {
          gates[r] = b_r[i];
          gates[n + r] = e_r[i];
        }
      }
    }
  }
  __syncthreads();

  if (kPanels) {
    gdr::panel_solve(x, n, m, kp, dk, ep, dk, a);  // barriers inside
  } else {
    // A = strict_tril((eta*K) K^T) on the tensor cores (exact products for
    // bf16 K).
    gdr::block_mma<kExact, kExact>(
        n, n, dk, [&](int i, int d) { return ks[i * ld.k + d]; },
        [&](int d, int j) { return ks[j * ld.k + d]; },
        [&](int i, int j, float s) { a[i * ld.a + j] = j < i ? ep[i] * s : 0.f; });
    __syncthreads();

    // (I + A_bb)^-1 of every diagonal block, by exact substitution: one
    // thread per (block, column), the column in registers.  K is dead from
    // here on: the inverses and R take its place.
    for (int i = tid; i < nb * kBlk; i += kThreads) {
      const int bi = i / kBlk, j = i - bi * kBlk;
      const int lo = bi * kBlk, rows = min(kBlk, n - lo);
      float z[kBlk];
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
        float acc = 0.f;
        if (r > j && r < rows) {
#pragma unroll
          for (int l = 0; l < r; ++l)
            acc = fmaf(a[(lo + r) * ld.a + lo + l], z[l], acc);
        }
        z[r] = r == j ? 1.f : -acc;
      }
#pragma unroll
      for (int r = 0; r < kBlk; ++r) dinv[(bi * kBlk + r) * kInv + j] = z[r];
    }
    __syncthreads();

    // Block forward substitution: R = X_b - A_b,<b X_<b, then X_b = inv R,
    // both on the tensor cores in 3xTF32.
    for (int bi = 0; bi < nb; ++bi) {
      const int lo = bi * kBlk, rows = min(kBlk, n - lo);
      gdr::block_mma<false, false>(
          rows, m, lo, [&](int i, int l) { return a[(lo + i) * ld.a + l]; },
          [&](int l, int c) { return x[l * ld.x + c]; },
          [&](int i, int c, float s) { rb[i * ld.x + c] = x[(lo + i) * ld.x + c] - s; });
      __syncthreads();
      const float* inv = dinv + bi * kBlk * kInv;
      gdr::block_mma<false, false>(
          rows, m, rows, [&](int i, int l) { return inv[i * kInv + l]; },
          [&](int l, int c) { return rb[l * ld.x + c]; },
          [&](int i, int c, float s) { x[(lo + i) * ld.x + c] = s; });
      __syncthreads();
    }
  }

  float* up = u + fr * n * dv;
  float* wp = w + fr * n * dk;
  for (int r = warp; r < n; r += kThreads / 32) {
    for (int c = lane; c < dv; c += 32) up[r * dv + c] = x[r * ld.x + c];
    for (int d = lane; d < dk; d += 32) wp[r * dk + d] = x[r * ld.x + dv + d];
  }
  if (u16) {
    __nv_bfloat16* up16 = u16 + fr * n * dv;
    __nv_bfloat16* wp16 = w16 + fr * n * dk;
    for (int r = warp; r < n; r += kThreads / 32) {
      for (int c = lane; c < dv; c += 32) up16[r * dv + c] = __float2bfloat16(x[r * ld.x + c]);
      for (int d = lane; d < dk; d += 32)
        wp16[r * dk + d] = __float2bfloat16(x[r * ld.x + dv + d]);
    }
  }
}

template <typename T, bool kPanels>
int launch_layout(const void* k, const void* v, const void* beta, const void* eta,
                  void* u, void* w, void* u16, void* w16, int frames, int n,
                  int dk, int dv, cudaStream_t stream) {
  const size_t bytes = smem_floats(n, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wy_kernel<T, kPanels>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wy_kernel<T, kPanels><<<frames, kThreads, bytes, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(eta),
      static_cast<float*>(u), static_cast<float*>(w),
      static_cast<__nv_bfloat16*>(u16), static_cast<__nv_bfloat16*>(w16), n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

// The solve of `frames` frames on `stream`: k (frames, n, dk), v (frames,
// n, dv) of type T; beta, eta (frames, n) fp32 → u (frames, n, dv), w
// (frames, n, dk) fp32, and the bf16 copies u16, w16 unless null.  Returns
// a cudaError_t.
template <typename T>
int launch(const void* k, const void* v, const void* beta, const void* eta,
           void* u, void* w, void* u16, void* w16, int frames, int n, int dk,
           int dv, cudaStream_t stream) {
  if (frames < 1 || n < 1 || dk < 1 || dv < 1 ||
      smem_floats(n, dk, dv) * sizeof(float) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (uses_panels(n, dk, dv))
    return launch_layout<T, true>(k, v, beta, eta, u, w, u16, w16, frames, n, dk,
                                  dv, stream);
  return launch_layout<T, false>(k, v, beta, eta, u, w, u16, w16, frames, n, dk,
                                 dv, stream);
}

}  // namespace wy
}  // namespace gdr

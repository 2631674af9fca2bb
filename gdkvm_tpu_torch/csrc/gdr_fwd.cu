// Gated delta-rule (GDR) forward scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_pallas_flat`), with its
// optional residual outputs.  Per (b, h) and frame t:
//
//   A = strict_tril(diag(eta) K K^T)
//   [U | W] = (I + A)^-1 [beta*V | eta*K]     (exact substitution)
//   S~ = alpha_t * S                          (forget gate)
//   O_t = Q_t S~                              (read the decayed pre-write state)
//   S = S~ + K^T (U - W S~)                   (N delta-rule writes at once)
//
// and S_T is written after the last frame.  Products run on the tensor cores
// in fp32-accurate 3xTF32 (gdr_mma.cuh), except the 16 x 16 inverses and the
// panel solve, which use fp32 FMAs; every sum is fp32, whatever the input
// type.
//
// The same library exports the chain alone (`gdr_chain`): the port of the
// Pallas TPU kernel `_gdr_chain_kernel` (launched by `_gdr_chain_flat`), the
// forward split that GDKVM_GDR_FWD=chain selects, which takes every frame's
// U, W from a batched triangular solve in PyTorch (the JAX package leaves
// that solve to XLA) and runs only step 2 below.
//
// What bounds it on this card: not FLOPs or bytes (the streaming shape,
// B=8 H=4 T=32 N=49 d=64, is 1.7 GFLOP, ~8 us as 3xTF32 passes at the
// tensor cores' peak, and 34 MB, ~10 us at the memory rate) but latency: T
// dependent frames, each with an N-row triangular solve.  The TPU kernel solves inside its frame loop; here the solve does
// not depend on S, so it comes off the serial path:
//
// 1. `wy_kernel`, one block per frame (B*H*T blocks: 1,024 at the
//    streaming shape), solves [U | W] for every frame at once and writes
//    them, fp32, to u and w: the stored backward's residuals when it saves
//    them, else a scratch that the wrapper allocates.  Up to N=157 at d=64
//    K, [U | W], A and the inverses of A's 16 x 16 diagonal blocks sit in
//    shared memory (52 KB at N=49: four blocks an SM), and the solve goes
//    by 16-row blocks:
//      X_b = (I + A_bb)^-1 (R_b - A_b,<b X_<b),
//    so the serial depth is ceil(N/16) block steps, not N rows.  A and both
//    products of a step run on the tensor cores in fp32-accurate 3xTF32
//    (gdr_mma.cuh); only the 16 x 16 inverses are substitutions, all blocks
//    at once.  Above that (the training shape, N=256) A no longer fits: the
//    32-row panel solve of gdr_panel.cuh, in fp32 FMAs, which never forms A.
// 2. The chain of gdr_chain.cuh (grid B*H x dv/16: 128 blocks), which reads
//    Q, K, U and W through a cp.async ring and keeps S on chip over T.
//
// Both launch on the caller's stream in one C call.  U and W make a round
// trip through device memory between them (12.8 MB at the serving shape,
// which the 50 MB L2 holds).  No library solve or GEMM.

#include "gdr_chain.cuh"
#include "gdr_mma.cuh"
#include "gdr_panel.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlk = 16;               // diagonal block of the small solve
constexpr int kInv = kBlk + 4;         // row stride of a block's inverse
using gdr::chain::kSmemLimit;          // dynamic shared memory of a block

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
          float* __restrict__ u, float* __restrict__ w, int n, int dk, int dv) {
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
    gdr::panel_solve<false>(x, n, m, kp, dk, ep, dk, a);  // barriers inside
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
}

template <typename T, bool kPanels>
int launch_wy(const void* k, const void* v, const void* beta, const void* eta,
              void* u, void* w, int frames, int n, int dk, int dv,
              cudaStream_t stream) {
  const size_t bytes = smem_floats(n, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wy_kernel<T, kPanels>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wy_kernel<T, kPanels><<<frames, kThreads, bytes, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(eta),
      static_cast<float*>(u), static_cast<float*>(w), n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wy(const void* k, const void* v, const void* beta, const void* eta,
       void* u, void* w, int frames, int n, int dk, int dv,
       cudaStream_t stream) {
  if (frames < 1 || n < 1 || dk < 1 || dv < 1 ||
      smem_floats(n, dk, dv) * sizeof(float) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (uses_panels(n, dk, dv))
    return launch_wy<T, true>(k, v, beta, eta, u, w, frames, n, dk, dv, stream);
  return launch_wy<T, false>(k, v, beta, eta, u, w, frames, n, dk, dv, stream);
}

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* beta,
        const void* eta, const void* alpha, const void* s0, void* o,
        void* s_out, void* states, void* u, void* w, int b, int h, int t,
        int n, int dk, int dv, cudaStream_t stream) {
  const int err = wy<T>(k, v, beta, eta, u, w, b * h * t, n, dk, dv, stream);
  if (err != 0) return err;
  return gdr::chain::launch<T>(q, k, u, w, alpha, s0, o, s_out, states, b, h,
                               t, n, dk, dv, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one solve block takes at (n, dk, dv).
size_t gdr_wy_smem_bytes(int n, int dk, int dv) {
  return smem_floats(n, dk, dv) * sizeof(float);
}

// 1 when the solve goes by panels at (n, dk, dv), else 0.
int gdr_wy_uses_panels(int n, int dk, int dv) {
  return uses_panels(n, dk, dv) ? 1 : 0;
}

// Largest d_k the chain takes.
int gdr_chain_max_dk() { return gdr::chain::kMaxDk; }

// State columns of one chain block: its grid is (B*H, ceil(dv / this)).
int gdr_chain_cols() { return gdr::chain::kCols; }

// Bytes of dynamic shared memory one chain block takes at d_k, for bf16
// (nonzero) or fp32 q and k.
size_t gdr_chain_smem_bytes(int dk, int bf16) {
  const int elem = bf16 ? 2 : 4;
  return gdr::chain::smem_bytes(dk, elem, gdr::chain::ring_stages(dk, elem));
}

// The chain alone, given every frame's WY solve.  q, k: (B, H, T, N, dk)
// contiguous, bf16 when `bf16` is nonzero, else fp32.  u: (B, H, T, N, dv)
// fp32.  w: (B, H, T, N, dk) fp32.  alpha: (B, H, T) fp32.  s0, s_out: (B,
// H, dk, dv) fp32.  o: (B, H, T, N, dv) fp32.  states: (B, H, T, dk, dv)
// fp32, or null to skip.  Returns a cudaError_t.
int gdr_chain(const void* q, const void* k, const void* u, const void* w,
              const void* alpha, const void* s0, void* o, void* s_out,
              void* states, int b, int h, int t, int n, int dk, int dv,
              int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return gdr::chain::launch<__nv_bfloat16>(q, k, u, w, alpha, s0, o, s_out,
                                             states, b, h, t, n, dk, dv, st);
  return gdr::chain::launch<float>(q, k, u, w, alpha, s0, o, s_out, states, b,
                                   h, t, n, dk, dv, st);
}

// The forward: the solve, then the chain, on `stream`.  q, k, v: (B, H, T,
// N, d) contiguous, bf16 when `bf16` is nonzero, else fp32.  beta, eta:
// (B, H, T, N) fp32.  alpha: (B, H, T) fp32.  s0, s_out: (B, H, dk, dv)
// fp32.  o: (B, H, T, N, dv) fp32.  u_out (B, H, T, N, dv) and w_out (B, H,
// T, N, dk), fp32, required: they receive the frames' WY solves (the
// residuals, or the caller's scratch).  states (B, H, T, dk, dv) fp32, or
// null to skip.  Returns a cudaError_t.
int gdr_fwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* s0, void* o,
            void* s_out, void* states, void* u_out, void* w_out, int b, int h,
            int t, int n, int dk, int dv, int bf16, void* stream) {
  if (!u_out || !w_out) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd<__nv_bfloat16>(q, k, v, beta, eta, alpha, s0, o, s_out, states,
                              u_out, w_out, b, h, t, n, dk, dv, st);
  return fwd<float>(q, k, v, beta, eta, alpha, s0, o, s_out, states, u_out,
                    w_out, b, h, t, n, dk, dv, st);
}

const char* gdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

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
// 1. `wy_kernel` (gdr_wy.cuh, which the backward shares), one block per
//    frame (B*H*T blocks: 1,024 at the streaming shape), solves [U | W] for
//    every frame at once and writes them, fp32, to u and w: the stored
//    backward's residuals when it saves them, else a scratch that the
//    wrapper allocates; under GDKVM_GDR_SAVE_DTYPE=bf16 also bf16 copies,
//    the residuals then, while the chain reads the fp32 scratch.  16-row
//    block substitution on the tensor cores up to N=157 at d=64, 32-row
//    panels in fp32 FMAs above (the training shape, N=256).
// 2. The chain of gdr_chain.cuh (grid B*H x dv/16: 128 blocks), which reads
//    Q, K, U and W through a cp.async ring and keeps S on chip over T; it
//    writes S_{t-1} in bf16 under GDKVM_GDR_SAVE_DTYPE=bf16.
//
// Both launch on the caller's stream in one C call.  U and W make a round
// trip through device memory between them (12.8 MB at the serving shape,
// which the 50 MB L2 holds).  No library solve or GEMM.

#include "gdr_chain.cuh"
#include "gdr_wy.cuh"

namespace {

template <typename T>
int fwd(const void* q, const void* k, const void* v, const void* beta,
        const void* eta, const void* alpha, const void* s0, void* o,
        void* s_out, void* states, void* u, void* w, void* u16, void* w16,
        int b, int h, int t, int n, int dk, int dv, int save_bf16,
        cudaStream_t stream) {
  const int err = gdr::wy::launch<T>(k, v, beta, eta, u, w, u16, w16, b * h * t,
                                     n, dk, dv, stream);
  if (err != 0) return err;
  return gdr::chain::launch<T>(q, k, u, w, alpha, s0, o, s_out, states,
                               save_bf16, b, h, t, n, dk, dv, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one solve block takes at (n, dk, dv).
size_t gdr_wy_smem_bytes(int n, int dk, int dv) {
  return gdr::wy::smem_floats(n, dk, dv) * sizeof(float);
}

// 1 when the solve goes by panels at (n, dk, dv), else 0.
int gdr_wy_uses_panels(int n, int dk, int dv) {
  return gdr::wy::uses_panels(n, dk, dv) ? 1 : 0;
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
                                             states, 0, b, h, t, n, dk, dv, st);
  return gdr::chain::launch<float>(q, k, u, w, alpha, s0, o, s_out, states, 0,
                                   b, h, t, n, dk, dv, st);
}

// The forward: the solve, then the chain, on `stream`.  q, k, v: (B, H, T,
// N, d) contiguous, bf16 when `bf16` is nonzero, else fp32.  beta, eta:
// (B, H, T, N) fp32.  alpha: (B, H, T) fp32.  s0, s_out: (B, H, dk, dv)
// fp32.  o: (B, H, T, N, dv) fp32.  u_out (B, H, T, N, dv) and w_out (B, H,
// T, N, dk), fp32, required: they receive the frames' WY solves (the
// residuals, or the caller's scratch, which the chain reads).  states (B,
// H, T, dk, dv), or null to skip.  With save_bf16 nonzero (the stored
// backward's bf16 residuals), states is bf16 and u16, w16 (shaped as u_out,
// w_out) receive bf16 copies of the solves; else states is fp32 and u16,
// w16 are null.  Returns a cudaError_t.
int gdr_fwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* s0, void* o,
            void* s_out, void* states, void* u_out, void* w_out, void* u16,
            void* w16, int b, int h, int t, int n, int dk, int dv, int bf16,
            int save_bf16, void* stream) {
  if (!u_out || !w_out || (save_bf16 && (!u16 || !w16)) ||
      (!save_bf16 && (u16 || w16)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fwd<__nv_bfloat16>(q, k, v, beta, eta, alpha, s0, o, s_out, states,
                              u_out, w_out, u16, w16, b, h, t, n, dk, dv,
                              save_bf16, st);
  return fwd<float>(q, k, v, beta, eta, alpha, s0, o, s_out, states, u_out,
                    w_out, u16, w16, b, h, t, n, dk, dv, save_bf16, st);
}

const char* gdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

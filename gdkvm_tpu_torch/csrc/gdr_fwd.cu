// Gated delta-rule (GDR) forward scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_pallas_flat`), with its
// optional residual outputs.  Per (b, h) and frame t:
//
//   S~ = alpha_t * S                          (forget gate)
//   O_t = Q_t S~                              (read the decayed pre-write state)
//   A = strict_tril(diag(eta) K K^T)
//   [U | W] = (I + A)^-1 [beta*V | eta*K]     (exact substitution)
//   S = S~ + K^T (U - W S~)                   (N delta-rule writes at once)
//
// and S_T is written after the last frame.  The state stays in shared memory
// for the whole T loop; every product is an fp32 FMA, whatever the input type.
//
// Residual outputs for the backward (the kSave instantiation; each skipped
// when its pointer is null): `states` gets S_{t-1} of every frame, before
// its decay (the TPU kernel's save_states); `u_out` and `w_out` get the
// frame's own WY solve U and W (save_uw), stored before U is overwritten by
// U - W S~.  The TPU kernel's lane-packed block inverses have no
// counterpart.  Without residuals (streaming inference) the kernel is the
// one of the first port, unchanged.
//
// Design (simple first, not yet fast):
// - One thread block per (b, h): 32 blocks at the streaming shape (B=8,
//   H=4, N=49) and at the training shape (N=256), a quarter of the H100's
//   132 SMs.  The card is bound by that occupancy and by the serial frame
//   loop and substitution, not by bytes: the training shape (T=10, d=64)
//   is about 7.4 GFLOP a call over those 32 blocks.
// - Two layouts.  Up to N=137 at d=64 (the streaming shapes) Q, K, [U | W]
//   and A all sit in shared memory beside S, and the substitution runs one
//   thread per right-hand-side column down all N rows.  Above that (the
//   training shape, N=256) A, N x N, no longer fits: the substitution goes
//   by panels of 32 rows (gdr_panel.cuh), which never forms A and leaves 32
//   serial rows instead of N; Q and K are read from global memory; S,
//   [U | W] and the panel workspace take 209 KB at N=256, d=64.  There
//   every product is a register-tiled block_mm, each thread 4 x 2 or 4 x 4
//   outputs, to cut the shared-memory loads per FMA.
// - Gates are applied here (beta*V, eta*K); a ragged N needs no padding,
//   since the loops run over exactly N tokens.
// - No tensor cores (wgmma), no TMA yet: fp32 FMAs over shared memory.

#include "gdr_panel.cuh"

namespace {

using gdr::to_f32;

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// Shared-memory layouts, in floats.  K rows are padded to dk+1 so that
// threads reading different rows at one column hit different banks.
__host__ __device__ inline size_t small_floats(int n, int dk, int dv) {
  const size_t m = static_cast<size_t>(dv) + dk;
  return static_cast<size_t>(dk) * dv      // S
         + static_cast<size_t>(n) * dk      // Q
         + static_cast<size_t>(n) * (dk + 1)  // K (padded rows)
         + static_cast<size_t>(n) * m       // X = [U | W]
         + static_cast<size_t>(n) * n;      // A
}

__host__ __device__ inline size_t panel_layout_floats(int n, int dk, int dv) {
  return static_cast<size_t>(dk) * dv + static_cast<size_t>(n) * (dv + dk) +
         gdr::panel_floats(dk, dv + dk);
}

// True when the small layout does not fit: solve by panels.
__host__ __device__ inline bool uses_panels(int n, int dk, int dv) {
  return small_floats(n, dk, dv) * sizeof(float) > kSmemLimit;
}

__host__ __device__ inline size_t smem_floats(int n, int dk, int dv) {
  return uses_panels(n, dk, dv) ? panel_layout_floats(n, dk, dv)
                                : small_floats(n, dk, dv);
}

template <typename T, bool kPanels, bool kSave>
__global__ void __launch_bounds__(kThreads)
gdr_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ beta,
               const float* __restrict__ eta, const float* __restrict__ alpha,
               const float* __restrict__ s0, float* __restrict__ o,
               float* __restrict__ s_out, float* __restrict__ states,
               float* __restrict__ u_out, float* __restrict__ w_out, int n_t,
               int n, int dk, int dv) {
  extern __shared__ float smem[];
  const int m = dv + dk;
  const int ldk = dk + 1;
  // Small layout: S, Q, K, X, A.  Panel layout: S, X, panel workspace.
  float* s = smem;                                   // (dk, dv)
  float* qs = s + dk * dv;                           // (n, dk)
  float* ks = qs + n * dk;                           // (n, ldk)
  float* x = kPanels ? s + dk * dv : ks + n * ldk;   // (n, m) [U | W]
  float* a = x + n * m;                              // (n, n) or workspace

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const size_t bh = blockIdx.x;

  const float* s0p = s0 + bh * dk * dv;
  for (int i = tid; i < dk * dv; i += nthr) s[i] = s0p[i];

  for (int t = 0; t < n_t; ++t) {
    const size_t fr = bh * n_t + t;  // frame index in (B*H*T)
    const T* qp = q + fr * n * dk;
    const T* kp = k + fr * n * dk;
    const T* vp = v + fr * n * dv;
    const float* bp = beta + fr * n;
    const float* ep = eta + fr * n;
    float* op = o + fr * n * dv;
    const float a_t = alpha[fr];
    __syncthreads();  // the previous frame's state update is complete

    // Load this frame's tiles, form the gated right-hand side, decay S
    // (after saving S_{t-1}).
    for (int i = tid; i < n * dk; i += nthr) {
      const int r = i / dk, d = i - r * dk;
      const float kv = to_f32(kp[i]);
      if (!kPanels) {
        qs[i] = to_f32(qp[i]);
        ks[r * ldk + d] = kv;
      }
      x[r * m + dv + d] = ep[r] * kv;
    }
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      x[r * m + c] = bp[r] * to_f32(vp[i]);
    }
    float* stp = kSave && states ? states + fr * dk * dv : nullptr;
    for (int i = tid; i < dk * dv; i += nthr) {
      if (kSave && stp) stp[i] = s[i];
      s[i] *= a_t;
    }
    __syncthreads();

    if (kPanels) {
      // O = Q S~, Q from global memory; then the solve by panels.
      gdr::block_mm<4, 2>(
          n, dv, dk, [&](int r, int d) { return to_f32(qp[r * dk + d]); },
          [&](int d, int c) { return s[d * dv + c]; },
          [&](int r, int c, float v) { op[r * dv + c] = v; });
      gdr::panel_solve<false>(x, n, m, kp, dk, ep, dk, a);
    } else {
      // O = Q S~.
      for (int i = tid; i < n * dv; i += nthr) {
        const int r = i / dv, c = i - r * dv;
        float acc = 0.f;
        for (int d = 0; d < dk; ++d) acc = fmaf(qs[r * dk + d], s[d * dv + c], acc);
        op[i] = acc;
      }

      // A = strict_tril((eta*K) K^T).
      for (int i = tid; i < n * n; i += nthr) {
        const int r = i / n, c = i - r * n;
        float acc = 0.f;
        if (c < r) {
          for (int d = 0; d < dk; ++d)
            acc = fmaf(x[r * m + dv + d], ks[c * ldk + d], acc);
        }
        a[i] = acc;
      }
      __syncthreads();

      // (I + A) X = RHS by forward substitution.  Each right-hand-side
      // column depends only on itself, so one thread owns a column and
      // needs no barrier inside the solve.
      for (int c = tid; c < m; c += nthr) {
        for (int r = 1; r < n; ++r) {
          float acc = x[r * m + c];
          for (int j = 0; j < r; ++j) acc = fmaf(-a[r * n + j], x[j * m + c], acc);
          x[r * m + c] = acc;
        }
      }
      __syncthreads();
    }

    // Save U and W; then U <- U - W S~, in place (each element reads only W
    // and its own U, and the thread that saves U[i] is the one that
    // overwrites it).
    float* up = kSave && u_out ? u_out + fr * n * dv : nullptr;
    float* wp = kSave && w_out ? w_out + fr * n * dk : nullptr;
    if (kSave && wp) {
      for (int i = tid; i < n * dk; i += nthr) {
        const int r = i / dk, d = i - r * dk;
        wp[i] = x[r * m + dv + d];
      }
    }
    if (kPanels) {
      gdr::block_mm<4, 2>(
          n, dv, dk, [&](int r, int d) { return x[r * m + dv + d]; },
          [&](int d, int c) { return s[d * dv + c]; },
          [&](int r, int c, float v) {
            if (kSave && up) up[r * dv + c] = x[r * m + c];
            x[r * m + c] -= v;
          });
      __syncthreads();
      // S <- S~ + K^T (U - W S~), K from global memory.
      gdr::block_mm<4, 2>(
          dk, dv, n, [&](int d, int r) { return to_f32(kp[r * dk + d]); },
          [&](int r, int c) { return x[r * m + c]; },
          [&](int d, int c, float v) { s[d * dv + c] += v; });
    } else {
      for (int i = tid; i < n * dv; i += nthr) {
        const int r = i / dv, c = i - r * dv;
        float acc = x[r * m + c];
        if (kSave && up) up[i] = acc;
        for (int d = 0; d < dk; ++d)
          acc = fmaf(-x[r * m + dv + d], s[d * dv + c], acc);
        x[r * m + c] = acc;
      }
      __syncthreads();

      // S <- S~ + K^T (U - W S~).
      for (int i = tid; i < dk * dv; i += nthr) {
        const int d = i / dv, c = i - d * dv;
        float acc = s[i];
        for (int r = 0; r < n; ++r) acc = fmaf(ks[r * ldk + d], x[r * m + c], acc);
        s[i] = acc;
      }
    }
  }
  __syncthreads();
  float* sp = s_out + bh * dk * dv;
  for (int i = tid; i < dk * dv; i += nthr) sp[i] = s[i];
}

template <typename T, bool kPanels, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* beta,
           const void* eta, const void* alpha, const void* s0, void* o,
           void* s_out, void* states, void* u_out, void* w_out, int b, int h,
           int t, int n, int dk, int dv, cudaStream_t stream) {
  const size_t bytes = smem_floats(n, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdr_fwd_kernel<T, kPanels, kSave>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gdr_fwd_kernel<T, kPanels, kSave><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(beta),
      static_cast<const float*>(eta), static_cast<const float*>(alpha),
      static_cast<const float*>(s0), static_cast<float*>(o),
      static_cast<float*>(s_out), static_cast<float*>(states),
      static_cast<float*>(u_out), static_cast<float*>(w_out), t, n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* beta,
             const void* eta, const void* alpha, const void* s0, void* o,
             void* s_out, void* states, void* u_out, void* w_out, int b,
             int h, int t, int n, int dk, int dv, cudaStream_t stream) {
  const bool panels = uses_panels(n, dk, dv);
  const bool save = states || u_out || w_out;
#define GDR_LAUNCH(P, S)                                                     \
  return launch<T, P, S>(q, k, v, beta, eta, alpha, s0, o, s_out, states,    \
                         u_out, w_out, b, h, t, n, dk, dv, stream)
  if (panels) {
    if (save) GDR_LAUNCH(true, true);
    GDR_LAUNCH(true, false);
  }
  if (save) GDR_LAUNCH(false, true);
  GDR_LAUNCH(false, false);
#undef GDR_LAUNCH
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at (n, dk, dv).
size_t gdr_fwd_smem_bytes(int n, int dk, int dv) {
  return smem_floats(n, dk, dv) * sizeof(float);
}

// 1 when the kernel solves by panels at (n, dk, dv), else 0.
int gdr_fwd_uses_panels(int n, int dk, int dv) {
  return uses_panels(n, dk, dv) ? 1 : 0;
}

// q, k, v: (B, H, T, N, d) contiguous, bf16 when `bf16` is nonzero, else
// fp32.  beta, eta: (B, H, T, N) fp32.  alpha: (B, H, T) fp32.  s0, s_out:
// (B, H, dk, dv) fp32.  o: (B, H, T, N, dv) fp32.  Optional (null to skip):
// states (B, H, T, dk, dv), u_out (B, H, T, N, dv), w_out (B, H, T, N, dk),
// all fp32.  Returns a cudaError_t.
int gdr_fwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* s0, void* o,
            void* s_out, void* states, void* u_out, void* w_out, int b, int h,
            int t, int n, int dk, int dv, int bf16, void* stream) {
  if (smem_floats(n, dk, dv) * sizeof(float) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, beta, eta, alpha, s0, o, s_out,
                                   states, u_out, w_out, b, h, t, n, dk, dv,
                                   st);
  return dispatch<float>(q, k, v, beta, eta, alpha, s0, o, s_out, states,
                         u_out, w_out, b, h, t, n, dk, dv, st);
}

const char* gdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

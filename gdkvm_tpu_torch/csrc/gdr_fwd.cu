// Gated delta-rule (GDR) forward scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_pallas_flat`), without its
// optional residual outputs (save_states / save_uw).  Per (b, h) and frame t:
//
//   S~ = alpha_t * S                          (forget gate)
//   O_t = Q_t S~                              (read the decayed pre-write state)
//   A = strict_tril(diag(eta) K K^T)
//   [U | W] = (I + A)^-1 [beta*V | eta*K]     (exact forward substitution)
//   S = S~ + K^T (U - W S~)                   (N delta-rule writes at once)
//
// and S_T is written after the last frame.  The state stays in shared memory
// for the whole T loop; every product is an fp32 FMA, whatever the input type.
//
// Design (simple first, not yet fast):
// - One thread block per (b, h).  At the streaming bench shape (B=8, H=4)
//   that is 32 blocks, about a quarter of the H100's 132 SMs.  The card is
//   bound by that occupancy and by the serial frame loop, not by bytes.
// - The dv columns of the state are independent once W is known: a later
//   change can split dv across blocks (and the forward substitution across
//   the dv+dk right-hand-side columns it already runs in parallel) to fill
//   the card.
// - Gates are applied here (beta*V, eta*K); a ragged N needs no padding,
//   since the loops run over exactly N tokens.
// - No wgmma or TMA yet: plain loops over shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstddef>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory layout, in floats.  K rows are padded to dk+1 so that
// threads reading different rows at one column hit different banks.
__host__ __device__ inline size_t smem_floats(int n, int dk, int dv) {
  const size_t m = static_cast<size_t>(dv) + dk;
  return static_cast<size_t>(dk) * dv      // S
         + static_cast<size_t>(n) * dk      // Q
         + static_cast<size_t>(n) * (dk + 1)  // K (padded rows)
         + static_cast<size_t>(n) * m       // X = [U | W]
         + static_cast<size_t>(n) * n;      // A
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gdr_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ beta,
               const float* __restrict__ eta, const float* __restrict__ alpha,
               const float* __restrict__ s0, float* __restrict__ o,
               float* __restrict__ s_out, int n_t, int n, int dk, int dv) {
  extern __shared__ float smem[];
  const int m = dv + dk;
  const int ldk = dk + 1;
  float* s = smem;               // (dk, dv)
  float* qs = s + dk * dv;       // (n, dk)
  float* ks = qs + n * dk;       // (n, ldk)
  float* x = ks + n * ldk;       // (n, m): [beta*V | eta*K] -> [U | W]
  float* a = x + n * m;          // (n, n)

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

    // Load this frame's tiles, form the gated right-hand side, decay S.
    for (int i = tid; i < n * dk; i += nthr) {
      const int r = i / dk, d = i - r * dk;
      const float kv = to_f32(kp[i]);
      qs[i] = to_f32(qp[i]);
      ks[r * ldk + d] = kv;
      x[r * m + dv + d] = ep[r] * kv;
    }
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      x[r * m + c] = bp[r] * to_f32(vp[i]);
    }
    for (int i = tid; i < dk * dv; i += nthr) s[i] *= a_t;
    __syncthreads();

    // O = Q S~, and A = strict_tril((eta*K) K^T).
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      float acc = 0.f;
      for (int d = 0; d < dk; ++d) acc = fmaf(qs[r * dk + d], s[d * dv + c], acc);
      op[i] = acc;
    }
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

    // (I + A) X = RHS by forward substitution.  Each right-hand-side column
    // depends only on itself, so one thread owns a column and needs no
    // barrier inside the solve.
    for (int c = tid; c < m; c += nthr) {
      for (int r = 1; r < n; ++r) {
        float acc = x[r * m + c];
        for (int j = 0; j < r; ++j) acc = fmaf(-a[r * n + j], x[j * m + c], acc);
        x[r * m + c] = acc;
      }
    }
    __syncthreads();

    // U <- U - W S~, in place (each element reads only W and its own U).
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      float acc = x[r * m + c];
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
  __syncthreads();
  float* sp = s_out + bh * dk * dv;
  for (int i = tid; i < dk * dv; i += nthr) sp[i] = s[i];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* beta,
           const void* eta, const void* alpha, const void* s0, void* o,
           void* s_out, int b, int h, int t, int n, int dk, int dv,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(n, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdr_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gdr_fwd_kernel<T><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(beta),
      static_cast<const float*>(eta), static_cast<const float*>(alpha),
      static_cast<const float*>(s0), static_cast<float*>(o),
      static_cast<float*>(s_out), t, n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at (n, dk, dv).
size_t gdr_fwd_smem_bytes(int n, int dk, int dv) {
  return smem_floats(n, dk, dv) * sizeof(float);
}

// q, k, v: (B, H, T, N, d) contiguous, bf16 when `bf16` is nonzero, else
// fp32.  beta, eta: (B, H, T, N) fp32.  alpha: (B, H, T) fp32.  s0, s_out:
// (B, H, dk, dv) fp32.  o: (B, H, T, N, dv) fp32.  Returns a cudaError_t.
int gdr_fwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* s0, void* o,
            void* s_out, int b, int h, int t, int n, int dk, int dv, int bf16,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, beta, eta, alpha, s0, o, s_out, b,
                                 h, t, n, dk, dv, st);
  return launch<float>(q, k, v, beta, eta, alpha, s0, o, s_out, b, h, t, n,
                       dk, dv, st);
}

const char* gdr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

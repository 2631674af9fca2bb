// Gated delta-rule (GDR) backward scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_bwd_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_pallas_bwd_flat`; the
// GDKVM_GDR_BWD=fused backward).  One thread block per (b, h) walks the
// frames from T-1 down to 0 with the state cotangent dS held in shared
// memory; this loop takes the place of the TPU's reversed sequential grid.
// Per frame, from the forward's checkpoint S_{t-1} and the cotangents dO_t
// and g = dS_t:
//
//   S~ = alpha_t S_{t-1};  A = strict_tril(diag(eta) K K^T)
//   X = [U | W] = (I + A)^-1 [beta*V | eta*K]      (recomputed)
//   M = U - W S~;  KG = K g;  dQ = dO S~^T
//   dS~ = g + Q^T dO - W^T KG
//   dX = [KG | -KG S~^T];  Y = (I + A)^-T dX
//   dA = -strict_tril(Y X^T)
//   dKe = dA K + Y_k
//   dK = M g^T + dA^T (eta*K) + eta * dKe;  dV = beta * Y_v
//   dbeta = sum_dv Y_v * V;  deta = sum_dk dKe * K;  dalpha_t = <dS~, S_{t-1}>
//   carry dS_{t-1} = alpha_t dS~, and dS_0 after frame 0.
//
// All math is fp32 FMAs; every output is fp32.  dalpha is written as
// (B, H, T): the TPU kernel's 128-lane broadcast row is a TPU layout.
//
// Design (simple first, not yet fast):
// - One block per (b, h): 32 blocks at the training shape (B=8, H=4), a
//   quarter of the H100's 132 SMs.  About three times the forward's work per
//   frame in dependent phases, so it is latency-bound like the forward, not
//   bound by bytes.
// - Neither A nor dA (N x N) is formed.  Both solves go by panels of 32 rows
//   (gdr_panel.cuh).  dA enters only through dA K and dA^T (eta K), and
//     (dA K)_r      = -(sum_{j<r} k_j x_j^T) y_r   (prefix sums, top down),
//     (dA^T eta K)_r = -(sum_{j>r} eta_j k_j y_j^T) x_r   (suffix sums),
//   whose dk x m sums are the two solves' own accumulators; within a panel
//   the 32 x 32 block of Y X^T is formed.
// - Shared memory holds S~, dS, dS~, K (rows padded to dk+1), the gates and
//   the panel workspace, 205 KB at N=256, d=64.  X, Y, M, KG and
//   (dA^T eta K) live in a scratch slab the caller allocates, 448 KB per
//   block at N=256 (14 MB for 32 blocks, which stays in the 50 MB L2); the
//   phases that read it run in parallel over its rows.
// - Every product is a register-tiled block_mm (gdr_panel.cuh), each thread
//   4 x 1 to 4 x 4 outputs.  No tensor cores (wgmma), no TMA yet.

#include "gdr_panel.cuh"

namespace {

using gdr::kPanel;
using gdr::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of a block

// Shared memory, in floats: S~, dS, dS~ (rows padded to dv+1), K (rows
// padded to dk+1), beta, eta, one partial sum per warp for dalpha, the
// panel workspace, and two more panel buffers (the panel's X rows, padded to
// m+1; its dKe rows).
__host__ __device__ inline size_t smem_floats(int n, int dk, int dv) {
  const int m = dv + dk;
  return 3 * static_cast<size_t>(dk) * (dv + 1) +
         static_cast<size_t>(n) * (dk + 1) + 2 * static_cast<size_t>(n) +
         kWarps + gdr::panel_floats(dk, m) +
         static_cast<size_t>(kPanel) * (m + 1) + static_cast<size_t>(kPanel) * dk;
}

// Scratch of one block, in floats: X, Y (n, m); M, KG (n, dv); T2 (n, dk).
__host__ __device__ inline size_t scratch_floats(int n, int dk, int dv) {
  const size_t m = static_cast<size_t>(dv) + dk;
  return 2 * static_cast<size_t>(n) * m + 2 * static_cast<size_t>(n) * dv +
         static_cast<size_t>(n) * dk;
}

// Scratch pointers carry no __restrict__ and no const: one phase writes what
// another phase of the same block reads after a barrier, so they must not go
// through the read-only cache.  Every product is a register-tiled
// gdr::block_mm; its operands are read as a(i, kk) and b(kk, j).
template <typename T>
__global__ void __launch_bounds__(kThreads)
gdr_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ beta,
               const float* __restrict__ eta, const float* __restrict__ alpha,
               const float* __restrict__ states,
               const float* __restrict__ d_o, const float* __restrict__ ds_t,
               float* __restrict__ dq, float* __restrict__ dk_out,
               float* __restrict__ dv_out, float* __restrict__ dbeta,
               float* __restrict__ deta, float* __restrict__ dalpha,
               float* __restrict__ ds0, float* scratch, int n_t, int n,
               int dk, int dv) {
  extern __shared__ float smem[];
  const int m = dv + dk;
  const int ldk = dk + 1;        // K's row stride
  const int ldv = dv + 1;        // S~'s, dS's and dS~'s row stride
  const int ldx = m + 1;         // the accumulator's and xb's row stride
  const int kv = dk * dv;
  const size_t bh = blockIdx.x;
  float* sd = smem;              // S~ (dk, ldv)
  float* g = sd + dk * ldv;      // dS_t (dk, ldv), the carry
  float* dsd = g + dk * ldv;     // dS~ (dk, ldv)
  float* ks = dsd + dk * ldv;    // K (n, ldk)
  float* bet = ks + n * ldk;     // beta (n)
  float* et = bet + n;           // eta (n)
  float* red = et + n;           // (kWarps)
  float* ws = red + kWarps;      // panel workspace
  float* xb = ws + gdr::panel_floats(dk, m);  // (kPanel, ldx)
  float* dkeb = xb + kPanel * ldx;            // (kPanel, dk)
  // Inside the workspace (gdr_panel.cuh's layout), reused by the dKe sweep.
  float* acc = ws;                            // (dk, ldx)
  float* kpan = acc + dk * ldx;               // (kPanel, ldk)
  float* ap = kpan + kPanel * ldk;            // (kPanel, kPanel)
  float* pb = ap + kPanel * kPanel;           // (kPanel, m)

  float* x = scratch + bh * scratch_floats(n, dk, dv);  // [U | W] (n, m)
  float* y = x + n * m;          // dX -> Y (n, m)
  float* mm = y + n * m;         // M (n, dv)
  float* kg = mm + n * dv;       // K g (n, dv)
  float* t2 = kg + n * dv;       // dA^T (eta K) (n, dk)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  const float* dstp = ds_t + bh * kv;
  for (int i = tid; i < kv; i += nthr) g[i / dv * ldv + i % dv] = dstp[i];

  for (int t = n_t - 1; t >= 0; --t) {
    const size_t fr = bh * n_t + t;
    const T* qp = q + fr * n * dk;
    const T* kp = k + fr * n * dk;
    const T* vp = v + fr * n * dv;
    const float* bp = beta + fr * n;
    const float* ep = eta + fr * n;
    const float* sp = states + fr * kv;
    const float* dop = d_o + fr * n * dv;
    const float a_t = alpha[fr];
    __syncthreads();  // the later frame's carry update is complete

    // P0: S~, K, gates, and the solve's right-hand side.
    for (int i = tid; i < kv; i += nthr) sd[i / dv * ldv + i % dv] = a_t * sp[i];
    for (int i = tid; i < n * dk; i += nthr) {
      const int r = i / dk, d = i - r * dk;
      const float kval = to_f32(kp[i]);
      ks[r * ldk + d] = kval;
      x[r * m + dv + d] = ep[r] * kval;
    }
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      x[r * m + c] = bp[r] * to_f32(vp[i]);
    }
    for (int i = tid; i < n; i += nthr) {
      bet[i] = bp[i];
      et[i] = ep[i];
    }
    __syncthreads();

    // P1: KG = K g, dQ = dO S~^T.
    gdr::block_mm<4, 2>(
        n, dv, dk, [&](int r, int d) { return ks[r * ldk + d]; },
        [&](int d, int c) { return g[d * ldv + c]; },
        [&](int r, int c, float s) { kg[r * dv + c] = s; });
    float* dqp = dq + fr * n * dk;
    gdr::block_mm<4, 2>(
        n, dk, dv, [&](int r, int c) { return dop[r * dv + c]; },
        [&](int c, int d) { return sd[d * ldv + c]; },
        [&](int r, int d, float s) { dqp[r * dk + d] = s; });

    // P2: X = (I + A)^-1 RHS (begins and ends with a barrier).
    gdr::panel_solve<false>(x, n, m, ks, ldk, et, dk, ws);

    // P3: M = U - W S~ and dX's first half KG;  dX's second half -KG S~^T;
    // dS~ = g + Q^T dO - W^T KG.
    gdr::block_mm<4, 2>(
        n, dv, dk, [&](int r, int e) { return x[r * m + dv + e]; },
        [&](int e, int c) { return sd[e * ldv + c]; },
        [&](int r, int c, float s) {
          mm[r * dv + c] = x[r * m + c] - s;
          y[r * m + c] = kg[r * dv + c];
        });
    gdr::block_mm<4, 2>(
        n, dk, dv, [&](int r, int c) { return kg[r * dv + c]; },
        [&](int c, int d) { return sd[d * ldv + c]; },
        [&](int r, int d, float s) { y[r * m + dv + d] = -s; });
    gdr::block_mm<4, 2>(
        dk, dv, n, [&](int d, int r) { return to_f32(qp[r * dk + d]); },
        [&](int r, int c) { return dop[r * dv + c]; },
        [&](int d, int c, float s) { dsd[d * ldv + c] = g[d * ldv + c] + s; });
    gdr::block_mm<4, 2>(
        dk, dv, n, [&](int d, int r) { return x[r * m + dv + d]; },
        [&](int r, int c) { return kg[r * dv + c]; },
        [&](int d, int c, float s) { dsd[d * ldv + c] -= s; });

    // P4: Y = (I + A)^-T dX, bottom up, with T2 = dA^T (eta K) on the way
    // (begins and ends with a barrier).
    gdr::panel_solve<true>(y, n, m, ks, ldk, et, dk, ws, t2, x, xb);

    // P5: dV = beta Y_v;  dbeta;  each warp's share of dalpha_t =
    // <dS~, S_{t-1}>.
    float* dvp = dv_out + fr * n * dv;
    for (int i = tid; i < n * dv; i += nthr) {
      const int r = i / dv, c = i - r * dv;
      dvp[i] = bet[r] * y[r * m + c];
    }
    for (int r = tid; r < n; r += nthr) {
      float s = 0.f;
      for (int c = 0; c < dv; ++c) s = fmaf(y[r * m + c], to_f32(vp[r * dv + c]), s);
      dbeta[fr * n + r] = s;
    }
    float part = 0.f;
    for (int i = tid; i < kv; i += nthr) part = fmaf(dsd[i / dv * ldv + i % dv], sp[i], part);
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if ((tid & 31) == 0) red[tid >> 5] = part;

    // P6: top down by panels, G = sum_{j < panel} k_j x_j^T:
    //   dKe_r = Y_k[r] - G y_r - sum_{j<r in panel} (y_r . x_j) k_j,
    //   dK_r = M_r g^T + T2_r + eta_r dKe_r,  deta_r = dKe_r . k_r.
    for (int i = tid; i < dk * ldx; i += nthr) acc[i] = 0.f;
    float* dkp = dk_out + fr * n * dk;
    const int n_pan = (n + kPanel - 1) / kPanel;
    for (int pi = 0; pi < n_pan; ++pi) {
      const int lo = pi * kPanel;
      const int np = min(kPanel, n - lo);
      const size_t off = static_cast<size_t>(lo) * m;
      __syncthreads();  // buffers free; acc holds the earlier panels
      for (int i = tid; i < np * dk; i += nthr) {
        const int r = i / dk, d = i - r * dk;
        kpan[r * ldk + d] = ks[(lo + r) * ldk + d];
      }
      for (int i = tid; i < np * m; i += nthr) {
        const int r = i / m, c = i - r * m;
        pb[i] = y[off + i];
        xb[r * ldx + c] = x[off + i];
      }
      __syncthreads();
      gdr::block_mm<4, 1>(
          np, np, m, [&](int r, int c) { return pb[r * m + c]; },
          [&](int c, int j) { return xb[j * ldx + c]; },
          [&](int r, int j, float s) { ap[r * kPanel + j] = j < r ? s : 0.f; });
      __syncthreads();
      gdr::block_mm<4, 2>(
          np, dk, m, [&](int r, int c) { return pb[r * m + c]; },
          [&](int c, int d) { return acc[d * ldx + c]; },
          [&](int r, int d, float s) {
            s = pb[r * m + dv + d] - s;
            for (int j = 0; j < r; ++j) s = fmaf(-ap[r * kPanel + j], kpan[j * ldk + d], s);
            dkeb[r * dk + d] = s;
          });
      __syncthreads();
      gdr::block_mm<4, 2>(
          np, dk, dv, [&](int r, int c) { return mm[(lo + r) * dv + c]; },
          [&](int c, int d) { return g[d * ldv + c]; },
          [&](int r, int d, float s) {
            const size_t row = static_cast<size_t>(lo + r);
            dkp[row * dk + d] = s + t2[row * dk + d] + et[lo + r] * dkeb[r * dk + d];
          });
      for (int r = tid; r < np; r += nthr) {
        float s = 0.f;
        for (int d = 0; d < dk; ++d) s = fmaf(dkeb[r * dk + d], kpan[r * ldk + d], s);
        deta[fr * n + lo + r] = s;
      }
      gdr::block_mm<4, 4>(
          dk, m, np, [&](int d, int r) { return kpan[r * ldk + d]; },
          [&](int r, int c) { return xb[r * ldx + c]; },
          [&](int d, int c, float s) { acc[d * ldx + c] += s; });
    }
    __syncthreads();

    // P7: dalpha; carry dS_{t-1} = alpha_t dS~.
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[w];
      dalpha[fr] = s;
    }
    for (int i = tid; i < dk * ldv; i += nthr) g[i] = a_t * dsd[i];
  }
  __syncthreads();
  float* ds0p = ds0 + bh * kv;
  for (int i = tid; i < kv; i += nthr) ds0p[i] = g[i / dv * ldv + i % dv];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* beta,
           const void* eta, const void* alpha, const void* states,
           const void* d_o, const void* ds_t, void* dq, void* dk_out,
           void* dv_out, void* dbeta, void* deta, void* dalpha, void* ds0,
           void* scratch, int b, int h, int t, int n, int dk, int dv,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(n, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdr_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  gdr_bwd_kernel<T><<<b * h, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(beta),
      static_cast<const float*>(eta), static_cast<const float*>(alpha),
      static_cast<const float*>(states), static_cast<const float*>(d_o),
      static_cast<const float*>(ds_t), static_cast<float*>(dq),
      static_cast<float*>(dk_out), static_cast<float*>(dv_out),
      static_cast<float*>(dbeta), static_cast<float*>(deta),
      static_cast<float*>(dalpha), static_cast<float*>(ds0),
      static_cast<float*>(scratch), t, n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block takes at (n, dk, dv).
size_t gdr_bwd_smem_bytes(int n, int dk, int dv) {
  return smem_floats(n, dk, dv) * sizeof(float);
}

// Floats of scratch one block needs at (n, dk, dv).
size_t gdr_bwd_scratch_floats(int n, int dk, int dv) {
  return scratch_floats(n, dk, dv);
}

// q, k, v: (B, H, T, N, d) contiguous, bf16 when `bf16` is nonzero, else
// fp32.  beta, eta: (B, H, T, N) fp32.  alpha: (B, H, T) fp32.  states:
// (B, H, T, dk, dv) fp32, S_{t-1} per frame.  d_o: (B, H, T, N, dv) fp32.
// ds_t, ds0: (B, H, dk, dv) fp32.  Outputs, fp32: dq, dk_out (B, H, T, N,
// dk), dv_out (B, H, T, N, dv), dbeta, deta (B, H, T, N), dalpha (B, H, T).
// scratch: B*H*gdr_bwd_scratch_floats(n, dk, dv) floats.  Returns a
// cudaError_t.
int gdr_bwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* states,
            const void* d_o, const void* ds_t, void* dq, void* dk_out,
            void* dv_out, void* dbeta, void* deta, void* dalpha, void* ds0,
            void* scratch, int b, int h, int t, int n, int dk, int dv,
            int bf16, void* stream) {
  if (smem_floats(n, dk, dv) * sizeof(float) > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, beta, eta, alpha, states, d_o, ds_t,
                                 dq, dk_out, dv_out, dbeta, deta, dalpha, ds0,
                                 scratch, b, h, t, n, dk, dv, st);
  return launch<float>(q, k, v, beta, eta, alpha, states, d_o, ds_t, dq,
                       dk_out, dv_out, dbeta, deta, dalpha, ds0, scratch, b, h,
                       t, n, dk, dv, st);
}

const char* gdr_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

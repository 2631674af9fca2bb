// Gated delta-rule (GDR) chain forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_chain_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_chain_flat`): the forward
// split that GDKVM_GDR_FWD=chain selects.  Each frame's WY solve U, W is
// computed beforehand for all frames at once (a batched triangular solve in
// PyTorch, as the JAX package leaves it to XLA); this kernel runs only the
// sequential part.  Per (b, h) and frame t:
//
//   S~ = alpha_t * S                  (forget gate)
//   O_t = Q_t S~                      (read the decayed pre-write state)
//   S = S~ + K_t^T (U_t - W_t S~)     (the frame's N delta-rule writes)
//
// S_T is written after the last frame, and S_{t-1} of every frame (before
// its decay) when `states` is not null.  Every product is an fp32 FMA,
// whatever the type of q and k; u and w are fp32.
//
// Design (simple first, not yet fast):
// - Given U and W, column j of S evolves on its own:
//     O[:, j] = Q S~[:, j];   S[:, j] = S~[:, j] + K^T (U[:, j] - W S~[:, j]).
//   So one thread block owns kCols columns of one (b, h) state, and the
//   grid is (B*H, ceil(dv / kCols)): 128 blocks at the serving and the
//   training shape (B=8, H=4, dv=64), where the monolith forward has 32.
// - The block's state columns (dk x kCols) stay in shared memory for the
//   whole T loop.  Q, W and K are read from global memory in tiles of kRows
//   tokens (rows padded to dk+1 so that threads on neighbouring rows hit
//   neighbouring banks); the blocks of one (b, h) read the same tiles, which
//   L2 serves.  Shared memory is ~31 KB at dk=64, whatever N is.
// - Per tile: O and M = U - W S~ for its rows (each thread 2 rows of one
//   column), then K^T M accumulated in registers (each thread 4 state
//   elements of one column at dk=64).  S takes the sum after the last tile.
// - No padding of N: the loops run over exactly N tokens.  No tensor cores
//   and no TMA: at these sizes the chain is bound by the latency of its
//   dependent frames and barriers, not by FLOPs or bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cstddef>

namespace {

constexpr int kCols = 16;              // state columns of one block
constexpr int kGroups = 16;            // row (or d) groups: kCols x kGroups threads
constexpr int kThreads = kCols * kGroups;
constexpr int kRows = 32;              // tokens of one tile
constexpr int kRowsPer = kRows / kGroups;
constexpr int kMaxDk = 128;
constexpr int kMaxDPer = kMaxDk / kGroups;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

inline size_t smem_floats(int dk) {
  return static_cast<size_t>(dk) * kCols               // S columns
         + 3 * static_cast<size_t>(kRows) * (dk + 1)   // Q, W, K tiles
         + static_cast<size_t>(kRows) * kCols;         // M tile
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gdr_chain_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ u, const float* __restrict__ w,
                 const float* __restrict__ alpha, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ s_out,
                 float* __restrict__ states, int n_t, int n, int dk, int dv) {
  extern __shared__ float smem[];
  const int ld = dk + 1;
  float* s = smem;                    // (dk, kCols)
  float* qs = s + dk * kCols;         // (kRows, ld)
  float* ws = qs + kRows * ld;        // (kRows, ld)
  float* ks = ws + kRows * ld;        // (kRows, ld)
  float* ms = ks + kRows * ld;        // (kRows, kCols)

  const int tid = threadIdx.x;
  const int c = tid % kCols;          // this thread's column of the tile
  const int g = tid / kCols;          // its row group (tokens, or d of S)
  const size_t bh = blockIdx.x;
  const int col = blockIdx.y * kCols + c;
  const bool valid = col < dv;
  const int n_d = (dk + kGroups - 1) / kGroups;

  // The thread owns S[d, c] for d = g, g + kGroups, ...: it loads, decays,
  // updates and writes exactly those, so only the reads of S~ across the
  // column need barriers.
  const size_t sbase = bh * dk * dv;
  for (int i = 0; i < n_d; ++i) {
    const int d = g + i * kGroups;
    if (d < dk) s[d * kCols + c] = valid ? s0[sbase + d * dv + col] : 0.f;
  }

  for (int t = 0; t < n_t; ++t) {
    const size_t fr = bh * n_t + t;   // frame index in (B*H*T)
    const float a_t = alpha[fr];
    float* stp = states ? states + fr * dk * dv : nullptr;
    for (int i = 0; i < n_d; ++i) {
      const int d = g + i * kGroups;
      if (d < dk) {
        if (stp && valid) stp[d * dv + col] = s[d * kCols + c];
        s[d * kCols + c] *= a_t;
      }
    }

    float acc[kMaxDPer];
#pragma unroll
    for (int i = 0; i < kMaxDPer; ++i) acc[i] = 0.f;

    for (int r0 = 0; r0 < n; r0 += kRows) {
      const int rows = min(kRows, n - r0);
      const size_t tok = fr * n + r0;  // first token of the tile
      // The decay (first tile) or the previous tile's reads are complete.
      __syncthreads();
      for (int i = tid; i < rows * dk; i += kThreads) {
        const int r = i / dk, d = i - r * dk;
        qs[r * ld + d] = to_f32(q[tok * dk + i]);
        ws[r * ld + d] = w[tok * dk + i];
        ks[r * ld + d] = to_f32(k[tok * dk + i]);
      }
      __syncthreads();

      // O = Q S~ and M = U - W S~ for the tile's rows.
#pragma unroll
      for (int j = 0; j < kRowsPer; ++j) {
        const int r = g + j * kGroups;
        if (r < rows) {
          float acc_o = 0.f, acc_w = 0.f;
          for (int d = 0; d < dk; ++d) {
            const float sv = s[d * kCols + c];
            acc_o = fmaf(qs[r * ld + d], sv, acc_o);
            acc_w = fmaf(ws[r * ld + d], sv, acc_w);
          }
          float m = 0.f;
          if (valid) {
            o[(tok + r) * dv + col] = acc_o;
            m = u[(tok + r) * dv + col] - acc_w;
          }
          ms[r * kCols + c] = m;
        }
      }
      __syncthreads();

      // K^T M, accumulated over the tiles.
#pragma unroll
      for (int i = 0; i < kMaxDPer; ++i) {
        const int d = g + i * kGroups;
        if (i < n_d && d < dk) {
          float a = acc[i];
          for (int r = 0; r < rows; ++r)
            a = fmaf(ks[r * ld + d], ms[r * kCols + c], a);
          acc[i] = a;
        }
      }
    }

    // S = S~ + K^T M.  Every read of S~ came before the last tile's barrier.
#pragma unroll
    for (int i = 0; i < kMaxDPer; ++i) {
      const int d = g + i * kGroups;
      if (i < n_d && d < dk) s[d * kCols + c] += acc[i];
    }
    // The next frame's first tile begins with a barrier before S~ is read.
  }

  if (valid) {
    for (int i = 0; i < n_d; ++i) {
      const int d = g + i * kGroups;
      if (d < dk) s_out[sbase + d * dv + col] = s[d * kCols + c];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* u, const void* w,
           const void* alpha, const void* s0, void* o, void* s_out,
           void* states, int b, int h, int t, int n, int dk, int dv,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(dk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gdr_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (dv + kCols - 1) / kCols);
  gdr_chain_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out),
      static_cast<float*>(states), t, n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest d_k the kernel takes.
int gdr_chain_max_dk() { return kMaxDk; }

// q, k: (B, H, T, N, dk) contiguous, bf16 when `bf16` is nonzero, else fp32.
// u: (B, H, T, N, dv) fp32.  w: (B, H, T, N, dk) fp32.  alpha: (B, H, T)
// fp32.  s0, s_out: (B, H, dk, dv) fp32.  o: (B, H, T, N, dv) fp32.
// states: (B, H, T, dk, dv) fp32, or null to skip.  Returns a cudaError_t.
int gdr_chain(const void* q, const void* k, const void* u, const void* w,
              const void* alpha, const void* s0, void* o, void* s_out,
              void* states, int b, int h, int t, int n, int dk, int dv,
              int bf16, void* stream) {
  if (dk < 1 || dk > kMaxDk || dv < 1 || n < 1 || t < 1 || b * h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, u, w, alpha, s0, o, s_out, states, b,
                                 h, t, n, dk, dv, st);
  return launch<float>(q, k, u, w, alpha, s0, o, s_out, states, b, h, t, n,
                       dk, dv, st);
}

const char* gdr_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

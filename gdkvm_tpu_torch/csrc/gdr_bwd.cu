// Gated delta-rule (GDR) backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gdr_bwd_kernel` in
// gdkvm_tpu/ops/gdr_pallas.py (launched by `_gdr_pallas_bwd_flat`; the
// GDKVM_GDR_BWD=fused backward): the backward from the forward's S_{t-1}
// checkpoints, recomputing each frame's WY solve.  Per frame, with
// g = dS_t and S~ = alpha_t S_{t-1}:
//
//   A = strict_tril(diag(eta) K K^T);  X = [U | W] = (I + A)^-1 [beta*V | eta*K]
//   M = U - W S~;  KG = K g;  dQ = dO S~^T
//   dS~ = g + Q^T dO - W^T KG;  carry dS_{t-1} = alpha_t dS~, dS_0 at the end
//   dX = [KG | -KG S~^T];  Y = (I + A)^-T dX;  dA = -strict_tril(Y X^T)
//   dKe = dA K + Y_k;  dK = M g^T + dA^T (eta*K) + eta * dKe;  dV = beta * Y_v
//   dbeta = sum_dv Y_v * V;  deta = sum_dk dKe * K;  dalpha_t = <dS~, S_{t-1}>
//
// Every output is fp32; dalpha is (B, H, T) (the TPU kernel's 128-lane row
// is a TPU layout).
//
// What bounds it on this card: at the training shape (B=8 H=4 T=10 N=256
// d=64, bf16 q/k/v) the function's products, the recomputed solve among
// them, come to 44.8 GFLOP of fp32-accurate 3xTF32 passes (0.091 ms at 495
// TFLOP/s; one pass where both operands are bf16); its 123 MB take 0.037 ms.
// What held the first design back (one block per (b, h), 32 blocks, each
// walking T frames with the recompute and the whole adjoint inside its
// frame loop: 10.2 ms) is latency: dependent phases on few blocks.  But
// only the carry dS_{t-1} = alpha_t dS~_t links the frames, and dS~_t needs
// neither the solve nor Y.  So one C call
// (`gdr_bwd`) launches three kernels on the caller's stream:
//
// 1. The forward's WY solve (`wy_kernel`, gdr_wy.cuh), one block a frame
//    (B*H*T blocks: 320 at the training shape), into fp32 U, W scratch.
// 2. `rev_chain_kernel`, the reverse dS chain, the only serial part:
//      g_{t-1} = alpha_t (g_t + Q_t^T dO_t - W_t^T (K_t g_t)).
//    Given W, each column of g evolves on its own, so as in the forward's
//    chain (gdr_chain.cuh, whose tile copies it shares) the grid is
//    (B*H, ceil(dv/16)), 128 blocks; g lives in the warps' tensor-core
//    accumulators across T; Q, K, W tiles and the dO columns stream through
//    a cp.async ring; per 64-token tile KG = K g, then g += Q^T dO - W^T KG,
//    in 3xTF32.  It writes g_t = dS_t and dS~_t of every frame, and dS_0.
// 3. `frame_adjoint_kernel`, one block a frame again: everything else, given
//    X, g_t and dS~_t.  KG, dQ and M g^T (as U g^T - W (S~ g^T), so M is
//    never stored) go straight to the outputs and to Y; then the transposed
//    solve of Y by 32-row panels, bottom up, with dA^T (eta K) accumulated
//    into dK on the way; then a top-down sweep for dKe = dA K + Y_k, which
//    never forms dA.  Every product runs on the tensor cores in
//    fp32-accurate 3xTF32 (gdr_mma.cuh; a bf16 K skips its low part): the
//    panel's A block and Y X^T block, the accumulator products and the
//    sweep.  Inside a panel the substitution is by 16-row blocks: the
//    inverses of the two 16 x 16 diagonal blocks of (I + A) (one thread a
//    column, 15 dependent steps), then three 16-row block products, instead
//    of one thread per right-hand-side column walking 31 dependent rows.
//
// Occupancy of phase 3: shared memory holds the gates, and, in one region
// used first by S~, g and S~ g^T and then by the panel workspace (the
// dk x m accumulator, the panel's K, A block, right-hand side, solution and
// X rows, the two inverses): 105 KB at N=256 d=64, independent of N, so two
// blocks share an SM (320 frames in 1.2 waves on 132 SMs).  K is read from
// device memory (L2) wherever it is needed instead of being kept (N x dk)
// in shared memory.  Splitting a frame's m = dv + dk columns over two
// blocks would also give two blocks an SM, but dA and therefore dK and
// deta sum over all columns: that costs a reduction across blocks, which
// the union of the two phases' buffers avoids.
//
// The adjoint's time is spread over its sections: the first products (KG,
// dQ, M g^T), the dA^T (eta K) rows, the update of H with dV and dbeta, and
// the dKe sweep, none of them most of it.  By count each is more
// instruction stream than tensor-core work:
// for mma.sync each thread loads its fragments and splits every fp32
// operand into TF32 high and low parts itself, some forty instructions for
// a k-step's six products.  The way past it is wgmma with operands split
// once in shared memory.
//
// Scratch, allocated by the caller: U, W (B*H*T*N*(dv + dk) floats), g and
// dS~ (B*H*T*dk*dv each), and Y (B*H*T*N*(dv + dk)).  No library GEMM or
// solve.

#include <cstdint>

#include "gdr_chain.cuh"
#include "gdr_mma.cuh"
#include "gdr_panel.cuh"
#include "gdr_wy.cuh"

namespace {

using gdr::kPanel;
using gdr::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemLimit = 232448;   // dynamic shared memory of a block

// ---------------------------------------------------------------------------
// Phase 2: the reverse dS chain.
// ---------------------------------------------------------------------------

namespace chain = gdr::chain;
using chain::kCols;
using chain::kLdm;
using chain::kRows;

// Bytes of one ring stage: Q and K tiles (kRows, tile_ld) of the input type,
// the W tile (kRows, tile_ld) fp32 and the dO-column tile (kRows, kLdm)
// fp32; each part a multiple of 16 bytes.
__host__ __device__ inline size_t rc_stage_bytes(int dk, int elem) {
  return static_cast<size_t>(kRows) *
         (2 * chain::tile_ld(dk, elem) * elem + 4 * (chain::tile_ld(dk, 4) + kLdm));
}

// Dynamic shared memory: the ring, g transposed (kCols, round16(dk) + 4) and
// the -KG tile (kRows, kLdm).
__host__ __device__ inline size_t rc_smem_bytes(int dk, int elem, int stages) {
  return stages * rc_stage_bytes(dk, elem) +
         4 * (static_cast<size_t>(kCols) * (chain::round16(dk) + 4) + kRows * kLdm);
}

__host__ __device__ inline int rc_stages(int dk, int elem) {
  return rc_smem_bytes(dk, elem, 3) <= kSmemLimit ? 3 : 2;
}

// Copy columns [c0, c0 + kCols) of `rows` rows of x (row stride ld) into a
// tile with rows of kLdm floats; columns at or past ld, and rows from `rows`
// up to the next multiple of 8, as zeros (the products read that far).
__device__ __forceinline__ void copy_cols(float* dst, const float* x, int rows,
                                          int ld, int c0) {
  const int rows8 = (rows + 7) & ~7;
  if (ld % 4 == 0 && chain::aligned16(x)) {
    const int p = threadIdx.x % (kCols / 4), c = c0 + 4 * p;
    for (int r = threadIdx.x / (kCols / 4); r < rows8; r += kThreads / (kCols / 4)) {
      const bool in = c < ld && r < rows;
      chain::cp_async16(dst + r * kLdm + 4 * p,
                        in ? x + static_cast<size_t>(r) * ld + c : x, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows8 * kCols; i += kThreads) {
      const int r = i / kCols, c = c0 + i - r * kCols;
      dst[r * kLdm + i - r * kCols] =
          c < ld && r < rows ? x[static_cast<size_t>(r) * ld + c] : 0.f;
    }
  }
}

template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
rev_chain_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const float* __restrict__ w, const float* __restrict__ d_o,
                 const float* __restrict__ alpha, const float* __restrict__ ds_t,
                 float* __restrict__ g_out, float* __restrict__ dsd_out,
                 float* __restrict__ ds0, int n_t, int n, int dk, int dv) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 q, k: exact in TF32
  extern __shared__ __align__(16) unsigned char rc_smem[];
  const int d16 = chain::round16(dk);
  const int ldq = chain::tile_ld(dk, sizeof(T));
  const int ldw = chain::tile_ld(dk, 4);
  const int lds = d16 + 4;                  // row stride of g transposed
  const size_t stage = rc_stage_bytes(dk, sizeof(T));
  float* gt = reinterpret_cast<float*>(rc_smem + kStages * stage);  // (kCols, lds)
  float* ms = gt + kCols * lds;                                      // (kRows, kLdm)
  auto qs = [&](int i) { return reinterpret_cast<T*>(rc_smem + (i % kStages) * stage); };
  auto ks = [&](int i) { return qs(i) + kRows * ldq; };
  auto ws = [&](int i) { return reinterpret_cast<float*>(ks(i) + kRows * ldq); };
  auto os = [&](int i) { return ws(i) + kRows * ldw; };

  // Fragment coordinates as in gdr_chain.cuh: warp w takes rows 16 (w / 2)
  // .. +16 of a tile's KG, and rows 16 (w / 2 + 4 j) .. +16 of g, all at
  // block columns 8 (w % 2) .. +8.
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int rb = 16 * (warp >> 1);
  const int nb = 8 * (warp & 1);
  const size_t bh = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tiles_f = (n + kRows - 1) / kRows;
  const int n_tiles = n_t * tiles_f;
  const size_t kv = static_cast<size_t>(dk) * dv;

  for (int i = tid; i < static_cast<int>(kStages * stage / 16); i += kThreads)
    reinterpret_cast<float4*>(rc_smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // Tile i is frame n_t - 1 - i / tiles_f, rows (i % tiles_f) * kRows ...
  auto prefetch = [&](int i) {
    const int t = n_t - 1 - i / tiles_f, r0 = (i % tiles_f) * kRows;
    const int rows = min(kRows, n - r0);
    const size_t tok = (bh * n_t + t) * n + r0;
    chain::copy_rows(qs(i), q + tok * dk, rows, dk);
    chain::copy_rows(ks(i), k + tok * dk, rows, dk);
    chain::copy_rows(ws(i), w + tok * dk, rows, dk);
    copy_cols(os(i), d_o + tok * dv, rows, dv, c0);
    chain::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i)
    if (i < n_tiles) prefetch(i);

  // g in the accumulators: s[j][e] is g[d, c] with d = rb + 64 j + gq + 8
  // (e / 2), c = nb + 2 t4 + e % 2; zero past dk and dv.
  float s[chain::kMaxTiles][4];
  auto each = [&](auto f) {
#pragma unroll
    for (int j = 0; j < chain::kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = rb + 64 * j + gq + 8 * (e >> 1);
        const int c = nb + 2 * t4 + (e & 1);
        f(j, e, d, c, d < dk && c0 + c < dv);
      }
  };
  const float* dstp = ds_t + bh * kv;
  each([&](int j, int e, int d, int c, bool in) {
    s[j][e] = in ? dstp[d * dv + c0 + c] : 0.f;
  });
  // Frame start: write g_t and publish it (transposed) for K g.
  auto begin_frame = [&](int t) {
    float* gp = g_out + (bh * n_t + t) * kv;
    each([&](int j, int e, int d, int c, bool in) {
      if (in) gp[d * dv + c0 + c] = s[j][e];
      if (d < d16) gt[c * lds + d] = s[j][e];
    });
  };
  begin_frame(n_t - 1);
  float a_t = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int t = n_t - 1 - i / tiles_f, r0 = (i % tiles_f) * kRows;
    const int rows = min(kRows, n - r0);
    if (i + kStages - 2 < n_tiles) chain::cp_async_wait<kStages - 2>();
    else chain::cp_async_wait<0>();
    // Tile i has landed, g is published, the previous tile's reads are done.
    __syncthreads();
    if (i + kStages - 1 < n_tiles) prefetch(i + kStages - 1);
    if (r0 == 0) a_t = alpha[bh * n_t + t];
    const T* qt = qs(i);
    const T* kt = ks(i);
    const float* wt = ws(i);
    const float* ot = os(i);

    // KG = K g for the warp's 16 x 8 piece, two accumulators.
    float ak[2][4] = {};
    auto kg_step = [&](int kb, float (&acc)[4]) {
      const float b0 = gt[(nb + gq) * lds + kb + t4];
      const float b1 = gt[(nb + gq) * lds + kb + t4 + 4];
      const float a[4] = {to_f32(kt[(rb + gq) * ldq + kb + t4]),
                          to_f32(kt[(rb + gq + 8) * ldq + kb + t4]),
                          to_f32(kt[(rb + gq) * ldq + kb + t4 + 4]),
                          to_f32(kt[(rb + gq + 8) * ldq + kb + t4 + 4])};
      gdr::mma3<kExact, false>(acc, a, b0, b1);
    };
    for (int kb = 0; kb < d16; kb += 16) {
      kg_step(kb, ak[0]);
      kg_step(kb + 8, ak[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rb + gq + 8 * (e >> 1), c = nb + 2 * t4 + (e & 1);
      ms[r * kLdm + c] = r < rows ? -(ak[0][e] + ak[1][e]) : 0.f;
    }
    __syncthreads();   // the -KG tile is complete

    // g += Q^T dO - W^T KG over the tile's rows (dO and -KG are zero past
    // them), odd steps of 8 into a second accumulator.
    const int r8 = (rows + 7) & ~7;
    float s1[chain::kMaxTiles][4] = {};
    auto step = [&](int kb, float (&acc)[chain::kMaxTiles][4]) {
      const float bo0 = ot[(kb + t4) * kLdm + nb + gq];
      const float bo1 = ot[(kb + t4 + 4) * kLdm + nb + gq];
      const float bm0 = ms[(kb + t4) * kLdm + nb + gq];
      const float bm1 = ms[(kb + t4 + 4) * kLdm + nb + gq];
#pragma unroll
      for (int j = 0; j < chain::kMaxTiles; ++j) {
        const int db = rb + 64 * j;
        if (db < d16) {
          const float aq[4] = {to_f32(qt[(kb + t4) * ldq + db + gq]),
                               to_f32(qt[(kb + t4) * ldq + db + gq + 8]),
                               to_f32(qt[(kb + t4 + 4) * ldq + db + gq]),
                               to_f32(qt[(kb + t4 + 4) * ldq + db + gq + 8])};
          const float aw[4] = {wt[(kb + t4) * ldw + db + gq], wt[(kb + t4) * ldw + db + gq + 8],
                               wt[(kb + t4 + 4) * ldw + db + gq],
                               wt[(kb + t4 + 4) * ldw + db + gq + 8]};
          gdr::mma3<kExact, false>(acc[j], aq, bo0, bo1);
          gdr::mma3<false, false>(acc[j], aw, bm0, bm1);
        }
      }
    };
    for (int kb = 0; kb < r8; kb += 16) {
      step(kb, s);
      if (kb + 8 < r8) step(kb + 8, s1);
    }
#pragma unroll
    for (int j = 0; j < chain::kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s1[j][e];

    // After a frame's last tile s holds dS~_t: write it, carry alpha_t dS~_t
    // to the next frame down.  No thread reads gt between the -KG barrier
    // and the next tile's barrier.
    if (r0 + rows == n) {
      float* dp = dsd_out + (bh * n_t + t) * kv;
      each([&](int j, int e, int d, int c, bool in) {
        if (in) dp[d * dv + c0 + c] = s[j][e];
        s[j][e] *= a_t;
      });
      if (t > 0) begin_frame(t - 1);
    }
  }

  float* d0 = ds0 + bh * kv;
  each([&](int j, int e, int d, int c, bool in) {
    if (in) d0[d * dv + c0 + c] = s[j][e];
  });
}

template <typename T, int kStages>
int launch_rev_chain_stages(const void* q, const void* k, const void* w,
                            const void* d_o, const void* alpha, const void* ds_t,
                            void* g, void* dsd, void* ds0, int b, int h, int t,
                            int n, int dk, int dv, cudaStream_t stream) {
  const size_t bytes = rc_smem_bytes(dk, sizeof(T), kStages);
  cudaError_t err = cudaFuncSetAttribute(
      rev_chain_kernel<T, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (dv + kCols - 1) / kCols);
  rev_chain_kernel<T, kStages><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(w), static_cast<const float*>(d_o),
      static_cast<const float*>(alpha), static_cast<const float*>(ds_t),
      static_cast<float*>(g), static_cast<float*>(dsd), static_cast<float*>(ds0),
      t, n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rev_chain(const void* q, const void* k, const void* w, const void* d_o,
                     const void* alpha, const void* ds_t, void* g, void* dsd,
                     void* ds0, int b, int h, int t, int n, int dk, int dv,
                     cudaStream_t stream) {
  if (dk < 1 || dk > chain::kMaxDk || dv < 1 || n < 1 || t < 1 || b * h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc_stages(dk, sizeof(T)) == 3)
    return launch_rev_chain_stages<T, 3>(q, k, w, d_o, alpha, ds_t, g, dsd, ds0,
                                         b, h, t, n, dk, dv, stream);
  return launch_rev_chain_stages<T, 2>(q, k, w, d_o, alpha, ds_t, g, dsd, ds0, b,
                                       h, t, n, dk, dv, stream);
}

// ---------------------------------------------------------------------------
// Phase 3: the per-frame adjoint.
// ---------------------------------------------------------------------------

constexpr int kBlk = 16;            // diagonal block of the in-panel solve
constexpr int kInv = kBlk + 4;      // row stride of a block's inverse
constexpr int kLap = kPanel + 4;    // row stride of the panel's A block

__host__ __device__ inline int up8(int x) { return (x + 7) / 8 * 8; }

// Row strides (floats), padded so that the tensor cores' fragment reads
// fall in distinct banks where they can: S~, g (dk, sv); S~ g^T (dk, sp);
// the accumulator and the panel's rows (x); the panel's K (k).
struct AdjStrides {
  int sv, sp, x, k;
  __host__ __device__ AdjStrides(int dk, int dv)
      : sv(up8(dv) + 4), sp(up8(dk) + 4), x(up8(dv + dk) + 8), k(up8(dk) + 4) {}
};

// The region's two uses, in floats.  Before the solve: S~, g, S~ g^T, and
// one 32-row panel of K (input type, rows of chain::tile_ld), dO, U, W
// (fp32, rows of tile_ld) and KG (rows of sv), staged by cp.async.  From
// the solve on: the accumulator (dk, x), the panel's K (kPanel, k), A block
// (kPanel, kLap), right-hand side, solution and X rows (kPanel, x each),
// the two diagonal blocks' inverses and the panel's eta.  Every part is a
// multiple of 16 bytes.
template <typename T>
__host__ __device__ inline size_t adj_region_floats(int dk, int dv) {
  const AdjStrides ld(dk, dv);
  const size_t stage_k = static_cast<size_t>(kPanel) * chain::tile_ld(dk, sizeof(T)) *
                         sizeof(T) / sizeof(float);
  const size_t before = 2 * static_cast<size_t>(dk) * ld.sv +
                        static_cast<size_t>(dk) * ld.sp + stage_k +
                        static_cast<size_t>(kPanel) *
                            (2 * chain::tile_ld(dv, 4) + chain::tile_ld(dk, 4) + ld.sv);
  const size_t after = static_cast<size_t>(dk) * ld.x + kPanel * ld.k +
                       kPanel * kLap + 3 * kPanel * ld.x + 2 * kBlk * kInv + kPanel;
  return before > after ? before : after;
}

// Shared memory of one block, in floats: the region, then beta and eta (n
// each) and one partial sum a warp for dalpha.
template <typename T>
__host__ __device__ inline size_t adj_smem_floats(int n, int dk, int dv) {
  return adj_region_floats<T>(dk, dv) + 2 * static_cast<size_t>(n) + kWarps;
}

// Copy `rows` rows of `width` floats from src (row stride lds) to dst (row
// stride ldd): by cp.async, 16 bytes at a time, when every row start is
// 16-byte aligned on both sides, else by plain loads.  The caller commits
// and waits.
__device__ __forceinline__ void copy_f32_rows(float* dst, int ldd, const float* src,
                                              int lds, int rows, int width) {
  if (width % 4 == 0 && lds % 4 == 0 && ldd % 4 == 0 && chain::aligned16(src) &&
      chain::aligned16(dst)) {
    const int per_row = width / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, p = i - r * per_row;
      chain::cp_async16(dst + r * ldd + 4 * p, src + static_cast<size_t>(r) * lds + 4 * p, 16);
    }
  } else {
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      dst[r * ldd + c] = src[static_cast<size_t>(r) * lds + c];
    }
  }
}

// out(i, j, s) for every i < R, j < C, s = sum_{kk < K} a(i, kk) b(kk, j),
// on the tensor cores in 3xTF32: as gdr::block_mma, but a warp takes a
// 16 x 16 piece, two 16 x 8 tiles that share A's fragment, so two chains
// of dependent products are in flight and A is read half as often.
template <bool kExactA, bool kExactB, typename FA, typename FB, typename FO>
__device__ __forceinline__ void block_mma16(int R, int C, int K, FA a, FB b, FO out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (C + 15) / 16;
  const int tiles = (R + 15) / 16 * tiles_n;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += kWarps) {
    const int i0 = tile / tiles_n * 16, j0 = tile % tiles_n * 16;
    const int r0 = i0 + g, r1 = i0 + g + 8;
    float c[2][4] = {};
    // A piece inside R x C with K a multiple of 8 reads no bounds.
    const bool full = i0 + 16 <= R && j0 + 16 <= C && K % 8 == 0;
    if (full) {
      for (int k0 = 0; k0 < K; k0 += 8) {
        const int ka = k0 + t, kb = k0 + t + 4;
        const float av[4] = {a(r0, ka), a(r1, ka), a(r0, kb), a(r1, kb)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = j0 + 8 * h + g;
          gdr::mma3<kExactA, kExactB>(c[h], av, b(ka, col), b(kb, col));
        }
      }
    } else {
      for (int k0 = 0; k0 < K; k0 += 8) {
        const int ka = k0 + t, kb = k0 + t + 4;
        const float av[4] = {r0 < R && ka < K ? a(r0, ka) : 0.f,
                             r1 < R && ka < K ? a(r1, ka) : 0.f,
                             r0 < R && kb < K ? a(r0, kb) : 0.f,
                             r1 < R && kb < K ? a(r1, kb) : 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = j0 + 8 * h + g;
          const float b0 = col < C && ka < K ? b(ka, col) : 0.f;
          const float b1 = col < C && kb < K ? b(kb, col) : 0.f;
          gdr::mma3<kExactA, kExactB>(c[h], av, b0, b1);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + g + 8 * (e >> 1), j = j0 + 8 * h + 2 * t + (e & 1);
        if (i < R && j < C) out(i, j, c[h][e]);
      }
  }
}

// Pointers into one frame's slices of the global arrays.  Y and dK are
// written and read again by the same block after a barrier: they carry no
// __restrict__ (they must not go through the read-only cache).
template <typename T>
struct Frame {
  const T* k;
  const T* v;
  const float* u;
  const float* w;
  const float* d_o;
  float* y;     // (n, m): dX, then Y
  float* dk;    // (n, dk): M g^T, + dA^T (eta K), + eta dKe
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
frame_adjoint_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ beta, const float* __restrict__ eta,
                     const float* __restrict__ alpha, const float* __restrict__ states,
                     const float* __restrict__ d_o, const float* __restrict__ u,
                     const float* __restrict__ w, const float* __restrict__ g_all,
                     const float* __restrict__ dsd_all, float* __restrict__ dq,
                     float* dk_out, float* __restrict__ dv_out,
                     float* __restrict__ dbeta, float* __restrict__ deta,
                     float* __restrict__ dalpha, float* y_all, int n, int dk, int dv) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 K: exact in TF32
  extern __shared__ __align__(16) float adj_smem[];
  const int m = dv + dk;
  const AdjStrides ld(dk, dv);
  const size_t fr = blockIdx.x;
  const size_t kv = static_cast<size_t>(dk) * dv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  float* region = adj_smem;
  float* bet = region + adj_region_floats<T>(dk, dv);   // (n)
  float* et = bet + n;             // (n)
  float* red = et + n;             // (kWarps)
  // Before the solve.
  const int ldt = chain::tile_ld(dk, sizeof(T));   // the staged K's row stride
  const int ldo = chain::tile_ld(dv, 4);           // the staged dO's and U's
  const int ldw = chain::tile_ld(dk, 4);           // the staged W's
  float* sd = region;                   // S~ (dk, sv)
  float* gs = sd + dk * ld.sv;          // g (dk, sv)
  float* pm = gs + dk * ld.sv;          // S~ g^T (dk, sp)
  T* kst = reinterpret_cast<T*>(pm + dk * ld.sp);   // (kPanel, ldt)
  float* ost = reinterpret_cast<float*>(kst + kPanel * ldt);   // dO (kPanel, ldo)
  float* ust = ost + kPanel * ldo;      // U (kPanel, ldo)
  float* wst = ust + kPanel * ldo;      // W (kPanel, ldw)
  float* kgs = wst + kPanel * ldw;      // KG (kPanel, sv)
  // From the solve on.
  float* acc = region;                      // (dk, x)
  float* kpan = acc + dk * ld.x;            // (kPanel, k)
  float* ap = kpan + kPanel * ld.k;         // (kPanel, kLap)
  float* pb = ap + kPanel * kLap;           // (kPanel, x)
  float* yb = pb + kPanel * ld.x;           // (kPanel, x)
  float* xb = yb + kPanel * ld.x;           // (kPanel, x)
  float* dinv = xb + kPanel * ld.x;         // (2, kBlk, kInv)
  float* epan = dinv + 2 * kBlk * kInv;     // (kPanel)

  const Frame<T> f{k + fr * n * dk, v + fr * n * dv, u + fr * n * dv,
                   w + fr * n * dk, d_o + fr * n * dv, y_all + fr * n * m,
                   dk_out + fr * n * dk};
  const float* sp = states + fr * kv;
  const float* gp = g_all + fr * kv;
  const float* dsp = dsd_all + fr * kv;
  const float a_t = alpha[fr];
  const int n_pan = (n + kPanel - 1) / kPanel;

  // P0: S~, g, the gates; each warp's share of dalpha_t = <dS~, S_{t-1}>.
  float part = 0.f;
  for (int i = tid; i < static_cast<int>(kv); i += kThreads) {
    const int d = i / dv, c = i - d * dv;
    const float s_prev = sp[i];
    sd[d * ld.sv + c] = a_t * s_prev;
    gs[d * ld.sv + c] = gp[i];
    part = fmaf(dsp[i], s_prev, part);
  }
  for (int i = tid; i < n; i += kThreads) {
    bet[i] = beta[fr * n + i];
    et[i] = eta[fr * n + i];
  }
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i];
    dalpha[fr] = s;
  }
  // S~ g^T, for M g^T = U g^T - W (S~ g^T).
  gdr::block_mma<false, false>(
      dk, dk, dv, [&](int e, int c) { return sd[e * ld.sv + c]; },
      [&](int c, int d) { return gs[d * ld.sv + c]; },
      [&](int e, int d, float s) { pm[e * ld.sp + d] = s; });

  // P1, by 32-row panels staged in shared memory: dX = [KG | -KG S~^T]
  // into Y, dQ = dO S~^T, and dK = M g^T = [U | W] [g^T ; -S~ g^T].
  float* dqp = dq + fr * n * dk;
  for (int pi = 0; pi < n_pan; ++pi) {
    const int lo = pi * kPanel;
    const int np = min(kPanel, n - lo);
    __syncthreads();   // S~ g^T is complete; the previous panel's reads are done
    chain::copy_rows(kst, f.k + lo * dk, np, dk);
    chain::copy_rows(ost, f.d_o + lo * dv, np, dv);
    chain::copy_rows(ust, f.u + lo * dv, np, dv);
    chain::copy_rows(wst, f.w + lo * dk, np, dk);
    chain::cp_async_commit();
    chain::cp_async_wait<0>();
    __syncthreads();
    block_mma16<kExact, false>(
        np, dv, dk, [&](int r, int d) { return to_f32(kst[r * ldt + d]); },
        [&](int d, int c) { return gs[d * ld.sv + c]; },
        [&](int r, int c, float s) {
          kgs[r * ld.sv + c] = s;
          f.y[(lo + r) * m + c] = s;
        });
    block_mma16<false, false>(
        np, dk, dv, [&](int r, int c) { return ost[r * ldo + c]; },
        [&](int c, int d) { return sd[d * ld.sv + c]; },
        [&](int r, int d, float s) { dqp[(lo + r) * dk + d] = s; });
    block_mma16<false, false>(
        np, dk, m,
        [&](int r, int c) { return c < dv ? ust[r * ldo + c] : wst[r * ldw + c - dv]; },
        [&](int c, int d) { return c < dv ? gs[d * ld.sv + c] : -pm[(c - dv) * ld.sp + d]; },
        [&](int r, int d, float s) { f.dk[(lo + r) * dk + d] = s; });
    __syncthreads();   // the panel's KG is complete
    block_mma16<false, false>(
        np, dk, dv, [&](int r, int c) { return kgs[r * ld.sv + c]; },
        [&](int c, int d) { return sd[d * ld.sv + c]; },
        [&](int r, int d, float s) { f.y[(lo + r) * m + dv + d] = -s; });
  }
  __syncthreads();   // Y's right-hand side and dK are complete; the region is free

  // P2: Y = (I + A)^-T dX by panels, bottom up.  H = sum over solved rows j
  // of eta_j k_j y_j^T (acc) carries the panels below into a panel:
  //   y_r = dx_r - H^T k_r - (in-panel rows);
  // and dK += dA^T (eta K): row r gets -H xo_r - sum_{j > r in panel}
  // (y_j . xo_r) eta_j k_j, H still excluding the panel.
  // A panel's rows of K (fp32), of Y (or dX) into `yrows` and of X = [U |
  // W] into xb; the Y and X rows by cp.async, all in flight at once.
  auto load_panel = [&](int lo, int np, float* yrows) {
    copy_f32_rows(yrows, ld.x, f.y + lo * m, m, np, m);
    copy_f32_rows(xb, ld.x, f.u + lo * dv, dv, np, dv);
    copy_f32_rows(xb + dv, ld.x, f.w + lo * dk, dk, np, dk);
    chain::cp_async_commit();
    for (int i = tid; i < np * dk; i += kThreads) {
      const int r = i / dk, d = i - r * dk;
      kpan[r * ld.k + d] = to_f32(f.k[(lo + r) * dk + d]);
    }
    chain::cp_async_wait<0>();
  };
  float* dvp = dv_out + fr * n * dv;
  for (int i = tid; i < dk * ld.x; i += kThreads) acc[i] = 0.f;
  for (int pi = n_pan - 1; pi >= 0; --pi) {
    const int lo = pi * kPanel;
    const int np = min(kPanel, n - lo);
    __syncthreads();   // the previous panel is done with the buffers
    load_panel(lo, np, pb);
    for (int i = tid; i < np; i += kThreads) epan[i] = et[lo + i];
    __syncthreads();

    // A's block, and the panels below.
    gdr::block_mma<kExact, kExact>(
        np, np, dk, [&](int i, int d) { return kpan[i * ld.k + d]; },
        [&](int d, int j) { return kpan[j * ld.k + d]; },
        [&](int i, int j, float s) { ap[i * kLap + j] = j < i ? epan[i] * s : 0.f; });
    block_mma16<kExact, false>(
        np, m, dk, [&](int i, int d) { return kpan[i * ld.k + d]; },
        [&](int d, int c) { return acc[d * ld.x + c]; },
        [&](int i, int c, float s) { pb[i * ld.x + c] -= s; });
    __syncthreads();

    // In-panel: (I + A_pp)^T y = r by 16-row blocks, bottom up.  The
    // inverses of the diagonal blocks first: one thread a (block, column).
    const int nbp = (np + kBlk - 1) / kBlk;
    if (tid < nbp * kBlk) {
      const int bi = tid / kBlk, j = tid - bi * kBlk;
      const int b0 = bi * kBlk, rows = min(kBlk, np - b0);
      float z[kBlk];
#pragma unroll
      for (int r = 0; r < kBlk; ++r) {
        float s = 0.f;
        if (r > j && r < rows) {
#pragma unroll
          for (int l = 0; l < r; ++l) s = fmaf(ap[(b0 + r) * kLap + b0 + l], z[l], s);
        }
        z[r] = r == j ? 1.f : -s;
      }
#pragma unroll
      for (int r = 0; r < kBlk; ++r) dinv[(bi * kBlk + r) * kInv + j] = z[r];
    }
    __syncthreads();
    for (int bi = nbp - 1; bi >= 0; --bi) {
      const int b0 = bi * kBlk, rows = min(kBlk, np - b0);
      const float* inv = dinv + bi * kBlk * kInv;
      // y_b = inv_b^T r_b.
      block_mma16<false, false>(
          rows, m, rows, [&](int i, int l) { return inv[l * kInv + i]; },
          [&](int l, int c) { return pb[(b0 + l) * ld.x + c]; },
          [&](int i, int c, float s) { yb[(b0 + i) * ld.x + c] = s; });
      __syncthreads();
      if (bi > 0) {
        // r_top -= A[bottom, top]^T y_bottom.
        block_mma16<false, false>(
            kBlk, m, rows, [&](int i, int l) { return ap[(b0 + l) * kLap + i]; },
            [&](int l, int c) { return yb[(b0 + l) * ld.x + c]; },
            [&](int i, int c, float s) { pb[i * ld.x + c] -= s; });
        __syncthreads();
      }
    }

    // ap[j][r] <- (y_j . xo_r) eta_j for j > r within the panel; then dK's
    // rows of dA^T (eta K).
    gdr::block_mma<false, false>(
        np, np, m, [&](int j, int c) { return yb[j * ld.x + c]; },
        [&](int c, int r) { return xb[r * ld.x + c]; },
        [&](int j, int r, float s) { ap[j * kLap + r] = j > r ? s * epan[j] : 0.f; });
    __syncthreads();
    block_mma16<false, false>(
        np, dk, m + np,
        [&](int r, int c) { return c < m ? xb[r * ld.x + c] : ap[(c - m) * kLap + r]; },
        [&](int c, int d) { return c < m ? acc[d * ld.x + c] : kpan[(c - m) * ld.k + d]; },
        [&](int r, int d, float s) { f.dk[(lo + r) * dk + d] -= s; });
    __syncthreads();   // every read of acc is done

    // Write the panel back; H += sum_r eta_r k_r y_r^T; the panel's dV =
    // beta Y_v and dbeta = sum_dv Y_v V (a warp a row).
    for (int i = tid; i < np * m; i += kThreads) {
      const int r = i / m, c = i - r * m;
      f.y[(lo + r) * m + c] = yb[r * ld.x + c];
    }
    block_mma16<false, false>(
        dk, m, np, [&](int d, int r) { return epan[r] * kpan[r * ld.k + d]; },
        [&](int r, int c) { return yb[r * ld.x + c]; },
        [&](int d, int c, float s) { acc[d * ld.x + c] += s; });
    for (int r = warp; r < np; r += kWarps) {
      const int row = lo + r;
      float s = 0.f;
      for (int c = lane; c < dv; c += 32) {
        const float yv = yb[r * ld.x + c];
        dvp[row * dv + c] = bet[row] * yv;
        s = fmaf(yv, to_f32(f.v[row * dv + c]), s);
      }
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) dbeta[fr * n + row] = s;
    }
  }
  __syncthreads();

  // P3: top down by panels, G = sum_{j < panel} k_j x_j^T (acc):
  //   dKe_r = Y_k[r] - sum_c y_r[c] G[:, c] - sum_{j < r in panel} (y_r . x_j) k_j,
  //   dK_r += eta_r dKe_r,  deta_r = dKe_r . k_r.
  float* dkeb = pb;   // (kPanel, x), the panel's dKe
  for (int i = tid; i < dk * ld.x; i += kThreads) acc[i] = 0.f;
  for (int pi = 0; pi < n_pan; ++pi) {
    const int lo = pi * kPanel;
    const int np = min(kPanel, n - lo);
    __syncthreads();   // buffers free; acc holds the earlier panels
    load_panel(lo, np, yb);
    __syncthreads();
    gdr::block_mma<false, false>(
        np, np, m, [&](int r, int c) { return yb[r * ld.x + c]; },
        [&](int c, int j) { return xb[j * ld.x + c]; },
        [&](int r, int j, float s) { ap[r * kLap + j] = j < r ? s : 0.f; });
    __syncthreads();
    block_mma16<false, false>(
        np, dk, m + np,
        [&](int r, int c) { return c < m ? yb[r * ld.x + c] : ap[r * kLap + c - m]; },
        [&](int c, int d) { return c < m ? acc[d * ld.x + c] : kpan[(c - m) * ld.k + d]; },
        [&](int r, int d, float s) { dkeb[r * ld.x + d] = yb[r * ld.x + dv + d] - s; });
    __syncthreads();   // dKe is complete and every read of acc is done
    for (int i = tid; i < np * dk; i += kThreads) {
      const int r = i / dk, d = i - r * dk;
      f.dk[(lo + r) * dk + d] += et[lo + r] * dkeb[r * ld.x + d];
    }
    for (int r = warp; r < np; r += kWarps) {
      float s = 0.f;
      for (int d = lane; d < dk; d += 32) s = fmaf(dkeb[r * ld.x + d], kpan[r * ld.k + d], s);
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) deta[fr * n + lo + r] = s;
    }
    block_mma16<kExact, false>(
        dk, m, np, [&](int d, int r) { return kpan[r * ld.k + d]; },
        [&](int r, int c) { return xb[r * ld.x + c]; },
        [&](int d, int c, float s) { acc[d * ld.x + c] += s; });
  }
}

template <typename T>
int launch_frames(const void* k, const void* v, const void* beta,
                  const void* eta, const void* alpha, const void* states,
                  const void* d_o, const void* u, const void* w, const void* g,
                  const void* dsd, void* dq, void* dk_out, void* dv_out,
                  void* dbeta, void* deta, void* dalpha, void* y, int frames,
                  int n, int dk, int dv, cudaStream_t stream) {
  const size_t bytes = adj_smem_floats<T>(n, dk, dv) * sizeof(float);
  if (frames < 1 || n < 1 || dk < 1 || dv < 1 || bytes > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      frame_adjoint_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  frame_adjoint_kernel<T><<<frames, kThreads, bytes, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(beta), static_cast<const float*>(eta),
      static_cast<const float*>(alpha), static_cast<const float*>(states),
      static_cast<const float*>(d_o), static_cast<const float*>(u),
      static_cast<const float*>(w), static_cast<const float*>(g),
      static_cast<const float*>(dsd), static_cast<float*>(dq),
      static_cast<float*>(dk_out), static_cast<float*>(dv_out),
      static_cast<float*>(dbeta), static_cast<float*>(deta),
      static_cast<float*>(dalpha), static_cast<float*>(y), n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* q, const void* k, const void* v, const void* beta,
        const void* eta, const void* alpha, const void* states, const void* d_o,
        const void* ds_t, void* dq, void* dk_out, void* dv_out, void* dbeta,
        void* deta, void* dalpha, void* ds0, void* u, void* w, void* g,
        void* dsd, void* y, int b, int h, int t, int n, int dk, int dv,
        cudaStream_t stream) {
  int err = gdr::wy::launch<T>(k, v, beta, eta, u, w, nullptr, nullptr, b * h * t,
                               n, dk, dv, stream);
  if (err != 0) return err;
  err = launch_rev_chain<T>(q, k, w, d_o, alpha, ds_t, g, dsd, ds0, b, h, t, n,
                            dk, dv, stream);
  if (err != 0) return err;
  return launch_frames<T>(k, v, beta, eta, alpha, states, d_o, u, w, g, dsd,
                          dq, dk_out, dv_out, dbeta, deta, dalpha, y, b * h * t,
                          n, dk, dv, stream);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory of one block of each phase: the solve at
// (n, dk, dv); the reverse chain at dk, for bf16 (nonzero) or fp32 q, k;
// the per-frame adjoint at (n, dk, dv), for bf16 or fp32 k.
size_t gdr_bwd_solve_smem_bytes(int n, int dk, int dv) {
  return gdr::wy::smem_floats(n, dk, dv) * sizeof(float);
}
size_t gdr_bwd_chain_smem_bytes(int dk, int bf16) {
  const int elem = bf16 ? 2 : 4;
  return rc_smem_bytes(dk, elem, rc_stages(dk, elem));
}
size_t gdr_bwd_frames_smem_bytes(int n, int dk, int dv, int bf16) {
  return (bf16 ? adj_smem_floats<__nv_bfloat16>(n, dk, dv) : adj_smem_floats<float>(n, dk, dv)) *
         sizeof(float);
}

// The backward on `stream`, three launches.  q, k, v: (B, H, T, N, d)
// contiguous, bf16 when `bf16` is nonzero, else fp32.  beta, eta: (B, H, T,
// N) fp32.  alpha: (B, H, T) fp32.  states: (B, H, T, dk, dv) fp32, S_{t-1}
// per frame.  d_o: (B, H, T, N, dv) fp32.  ds_t, ds0: (B, H, dk, dv) fp32.
// Outputs, fp32: dq, dk_out (B, H, T, N, dk), dv_out (B, H, T, N, dv),
// dbeta, deta (B, H, T, N), dalpha (B, H, T).  Scratch, fp32: u (B, H, T,
// N, dv), w (B, H, T, N, dk), g and dsd (B, H, T, dk, dv), y (B, H, T, N,
// dv + dk).  Returns a cudaError_t.
int gdr_bwd(const void* q, const void* k, const void* v, const void* beta,
            const void* eta, const void* alpha, const void* states,
            const void* d_o, const void* ds_t, void* dq, void* dk_out,
            void* dv_out, void* dbeta, void* deta, void* dalpha, void* ds0,
            void* u, void* w, void* g, void* dsd, void* y, int b, int h, int t,
            int n, int dk, int dv, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return bwd<__nv_bfloat16>(q, k, v, beta, eta, alpha, states, d_o, ds_t, dq,
                              dk_out, dv_out, dbeta, deta, dalpha, ds0, u, w, g,
                              dsd, y, b, h, t, n, dk, dv, st);
  return bwd<float>(q, k, v, beta, eta, alpha, states, d_o, ds_t, dq, dk_out,
                    dv_out, dbeta, deta, dalpha, ds0, u, w, g, dsd, y, b, h, t,
                    n, dk, dv, st);
}

const char* gdr_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

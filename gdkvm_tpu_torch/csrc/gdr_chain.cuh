// The GDR state chain for Hopper (sm_90a): the sequential part of the
// gated delta-rule forward, and the port of the Pallas TPU kernel
// `_gdr_chain_kernel` (gdkvm_tpu/ops/gdr_pallas.py).  gdr_fwd.cu launches
// it after its WY solve kernel (`gdr_fwd`), and alone after the batched
// solve in PyTorch (`gdr_chain`, the GDKVM_GDR_FWD=chain split).
//
// Given each frame's WY solve U (N x dv) and W (N x dk), per (b, h) and
// frame t:
//
//   S~ = alpha_t * S                  (forget gate)
//   O_t = Q_t S~                      (read the decayed pre-write state)
//   S = S~ + K_t^T (U_t - W_t S~)     (the frame's N delta-rule writes)
//
// S_T is written after the last frame, and S_{t-1} of every frame (before
// its decay) when `states` is not null, in fp32 or (the stored backward's
// GDKVM_GDR_SAVE_DTYPE=bf16) bf16.  S, O and every sum are fp32; u and w are
// fp32; q and k bf16 or fp32.
//
// What bounds it on this card: not FLOPs or bytes (the serving shape,
// B=8 H=4 T=16 N=49 d=64, is 0.62 GFLOP, ~3 us as 3xTF32 passes at the
// tensor cores' peak, and 27 MB, ~8 us at the memory rate) but the latency
// of T dependent frames on few blocks.  The design:
// - Given U and W, column j of S evolves on its own, so one block owns
//   kCols columns of one (b, h) state: the grid is (B*H, ceil(dv/kCols)),
//   128 blocks at B=8 H=4 dv=64.  The block's columns of S live in the
//   tensor-core accumulators of its 8 warps across the whole T loop; S~ is
//   published to shared memory (transposed) once a frame.
// - The frames' Q, K, W and U-column tiles (kRows tokens each) stream
//   through a ring of three stages in shared memory (two at d_k=128):
//   tiles i+1 and i+2 are copied by cp.async while tile i computes, so only
//   the math is on the serial path.
// - Two barriers per tile (one tile a frame up to N=64): "tile i landed,
//   S~ complete" and "M = U - W S~ complete".
// - The three products run on the tensor cores in fp32-accurate 3xTF32
//   (gdr_mma.cuh), each split in two accumulators (even and odd steps of
//   8) to halve the chain of dependent products.  Measured against the same
//   chain in fp32 FMAs (16-byte reads, independent accumulators) on the
//   H100: PERF.md.

#pragma once

#include <cstdint>

#include "gdr_mma.cuh"
#include "gdr_panel.cuh"

namespace gdr {
namespace chain {

constexpr int kCols = 16;                  // state columns of one block
constexpr int kThreads = 256;              // 8 warps
constexpr int kRows = 64;                  // tokens of one tile
constexpr int kMaxDk = 128;
constexpr int kMaxTiles = kMaxDk / 64;     // 16-row tiles of S per warp
constexpr int kLdm = kCols + 8;            // row stride of the M tile

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Row stride, in elements of `elem` bytes, of a tile with d_k columns: d_k
// rounded up to 16 (the tensor cores' steps read that far; the padding is
// zero), plus 16 bytes, so that the eight rows of a fragment start in
// different banks.
__host__ __device__ inline int tile_ld(int dk, int elem) {
  return round16(dk) + 16 / elem;
}

// Bytes of one ring stage: Q and K tiles (kRows, tile_ld) of the input
// type, the W tile (kRows, tile_ld) and the U-column tile (kRows, kCols)
// in fp32.  Each part is a multiple of 16 bytes.
__host__ __device__ inline size_t stage_bytes(int dk, int elem) {
  return static_cast<size_t>(kRows) *
         (2 * tile_ld(dk, elem) * elem + 4 * (tile_ld(dk, 4) + kCols));
}

// Dynamic shared memory of one block: `stages` ring stages, S~ transposed
// (kCols, round16(dk) + 4) and the M tile (kRows, kLdm).
__host__ __device__ inline size_t smem_bytes(int dk, int elem, int stages) {
  return stages * stage_bytes(dk, elem) +
         4 * (static_cast<size_t>(kCols) * (round16(dk) + 4) + kRows * kLdm);
}

// Ring stages: three (tiles i+1 and i+2 in flight while tile i computes)
// where they fit in a block's shared memory, else two.
constexpr size_t kSmemLimit = 232448;
__host__ __device__ inline int ring_stages(int dk, int elem) {
  return smem_bytes(dk, elem, 3) <= kSmemLimit ? 3 : 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most `kPending` of this thread's cp.async groups are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copy `rows` rows of a (rows, dk) row-major tile into shared memory with
// rows of ld = tile_ld(dk): by cp.async, 16 bytes at a time, when d_k is a
// multiple of 16 and the source 16-byte aligned, else by plain loads,
// zero-filling each row from dk to round16(dk).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, int rows, int dk) {
  constexpr int elem = sizeof(T);
  const int ld = tile_ld(dk, elem);
  if (dk % 16 == 0 && aligned16(src)) {
    // Thread -> (first row, 16-byte piece), then every `step` rows.
    const int per_row = dk * elem / 16;
    const int step = kThreads / per_row;
    const int r0 = threadIdx.x / per_row, p = threadIdx.x - r0 * per_row;
    if (r0 >= step) return;
    const char* s = reinterpret_cast<const char*>(src) + 16 * p;
    char* d = reinterpret_cast<char*>(dst) + 16 * p;
    for (int r = r0; r < rows; r += step)
      cp_async16(d + r * ld * elem, s + r * dk * elem, 16);
  } else {
    const int width = round16(dk);
    for (int i = threadIdx.x; i < rows * width; i += kThreads) {
      const int r = i / width, c = i - r * width;
      dst[r * ld + c] = c < dk ? src[r * dk + c] : T(0.f);
    }
  }
}

// Copy columns [c0, c0 + kCols) of `rows` rows of u (row stride dv) into a
// (rows, kCols) tile, columns at or past dv as zeros.
__device__ __forceinline__ void copy_u_cols(float* dst, const float* u, int rows,
                                           int dv, int c0) {
  if (dv % 4 == 0 && aligned16(u)) {
    const int p = threadIdx.x % (kCols / 4), c = c0 + 4 * p;
    const bool in = c < dv;
    for (int r = threadIdx.x / (kCols / 4); r < rows; r += kThreads / (kCols / 4))
      cp_async16(dst + r * kCols + 4 * p, in ? u + static_cast<size_t>(r) * dv + c : u,
                 in ? 16 : 0);
  } else {
    for (int i = threadIdx.x; i < rows * kCols; i += kThreads) {
      const int r = i / kCols, c = c0 + i - r * kCols;
      dst[i] = c < dv ? u[static_cast<size_t>(r) * dv + c] : 0.f;
    }
  }
}

template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads, 1)
chain_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const float* __restrict__ u, const float* __restrict__ w,
             const float* __restrict__ alpha, const float* __restrict__ s0,
             float* __restrict__ o, float* __restrict__ s_out,
             void* __restrict__ states, int states_bf16, int n_t, int n, int dk,
             int dv) {
  constexpr bool kExact = sizeof(T) == 2;   // bf16 q, k: exact in TF32
  extern __shared__ __align__(16) unsigned char chain_smem[];
  const int d16 = round16(dk);
  const int ldq = tile_ld(dk, sizeof(T));  // row stride of the Q, K tiles
  const int ldw = tile_ld(dk, 4);          // row stride of the W tile
  const int lds = d16 + 4;                 // row stride of S~ transposed
  const size_t stage = stage_bytes(dk, sizeof(T));
  float* st = reinterpret_cast<float*>(chain_smem + kStages * stage);  // (kCols, lds)
  float* ms = st + kCols * lds;                                        // (kRows, kLdm)
  auto qs = [&](int i) { return reinterpret_cast<T*>(chain_smem + (i % kStages) * stage); };
  auto ks = [&](int i) { return qs(i) + kRows * ldq; };
  auto ws = [&](int i) { return reinterpret_cast<float*>(ks(i) + kRows * ldq); };
  auto us = [&](int i) { return ws(i) + kRows * ldw; };

  // Fragment coordinates (PTX's m16n8k8 layout): lane = 4 g + t.  Warp w
  // takes rows 16 (w / 2) .. +16 of a tile's O and M, and rows 16 (w / 2 +
  // 4 j) .. +16 of S, all at block columns 8 (w % 2) .. +8.
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rb = 16 * (warp >> 1);        // this warp's rows of the tile
  const int nb = 8 * (warp & 1);          // its columns of the block
  const size_t bh = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tiles_f = (n + kRows - 1) / kRows;   // tiles of one frame
  const int n_tiles = n_t * tiles_f;

  // Zero the ring once: rows past a frame's last token are then stale but
  // finite, and meet M = 0 in K^T M.
  for (int i = tid; i < static_cast<int>(kStages * stage / 16); i += kThreads)
    reinterpret_cast<float4*>(chain_smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  auto prefetch = [&](int i) {
    const int t = i / tiles_f, r0 = (i - t * tiles_f) * kRows;
    const int rows = min(kRows, n - r0);
    const size_t tok = (bh * n_t + t) * n + r0;   // first token of the tile
    copy_rows(qs(i), q + tok * dk, rows, dk);
    copy_rows(ks(i), k + tok * dk, rows, dk);
    copy_rows(ws(i), w + tok * dk, rows, dk);
    copy_u_cols(us(i), u + tok * dv, rows, dv, c0);
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i)
    if (i < n_tiles) prefetch(i);

  // S in the accumulators: s[j][e] is S[d, c] with d = rb + 64 j + g + 8 (e
  // / 2) and c = nb + 2 t4 + e % 2 (block column).  Zero past d_k and dv.
  float s[kMaxTiles][4];
  auto each = [&](auto f) {
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = rb + 64 * j + g + 8 * (e >> 1);
        const int c = nb + 2 * t4 + (e & 1);
        f(j, e, d, c, d < dk && c0 + c < dv);
      }
  };
  const float* s0p = s0 + bh * dk * dv;
  each([&](int j, int e, int d, int c, bool in) {
    s[j][e] = in ? s0p[d * dv + c0 + c] : 0.f;
  });
  // Frame start: save S_{t-1} (fp32, or bf16 when states_bf16), decay by
  // a_t, publish S~.
  auto begin_frame = [&](int t, float a_t) {
    const size_t st0 = (bh * n_t + t) * dk * dv;
    each([&](int j, int e, int d, int c, bool in) {
      if (states && in) {
        const size_t at = st0 + d * dv + c0 + c;
        if (states_bf16)
          static_cast<__nv_bfloat16*>(states)[at] = __float2bfloat16(s[j][e]);
        else
          static_cast<float*>(states)[at] = s[j][e];
      }
      s[j][e] *= a_t;
      if (d < d16) st[c * lds + d] = s[j][e];
    });
  };
  begin_frame(0, alpha[bh * n_t]);
  float a_next = 0.f;   // the next frame's alpha, loaded a tile ahead

  for (int i = 0; i < n_tiles; ++i) {
    const int t = i / tiles_f, r0 = (i - t * tiles_f) * kRows;
    const int rows = min(kRows, n - r0);
    const size_t tok = (bh * n_t + t) * n + r0;
    // This thread's copies of tile i have landed once at most the groups
    // of the tiles after it, up to i + kStages - 2, are in flight.
    if (i + kStages - 2 < n_tiles) cp_async_wait<kStages - 2>(); else cp_async_wait<0>();
    // Tile i has landed for every thread, S~ is published, and every read
    // of tile i-1's stage and of the M tile is complete.
    __syncthreads();
    if (i + kStages - 1 < n_tiles) prefetch(i + kStages - 1);
    if (r0 == 0 && t + 1 < n_t) a_next = alpha[bh * n_t + t + 1];
    const T* qt = qs(i);
    const T* kt = ks(i);
    const float* wt = ws(i);
    const float* ut = us(i);

    // O = Q S~ and W S~ for the warp's 16 x 8 piece of the tile, with two
    // accumulators each (steps of 8 alternate between them): half as long
    // a chain of dependent products.
    float ao[2][4] = {}, aw[2][4] = {};
    auto om_step = [&](int kb, float (&o_acc)[4], float (&w_acc)[4]) {
      const float b0 = st[(nb + g) * lds + kb + t4];
      const float b1 = st[(nb + g) * lds + kb + t4 + 4];
      const float aq[4] = {to_f32(qt[(rb + g) * ldq + kb + t4]),
                           to_f32(qt[(rb + g + 8) * ldq + kb + t4]),
                           to_f32(qt[(rb + g) * ldq + kb + t4 + 4]),
                           to_f32(qt[(rb + g + 8) * ldq + kb + t4 + 4])};
      const float awv[4] = {wt[(rb + g) * ldw + kb + t4], wt[(rb + g + 8) * ldw + kb + t4],
                            wt[(rb + g) * ldw + kb + t4 + 4],
                            wt[(rb + g + 8) * ldw + kb + t4 + 4]};
      mma3<kExact, false>(o_acc, aq, b0, b1);
      mma3<false, false>(w_acc, awv, b0, b1);
    };
    for (int kb = 0; kb < d16; kb += 16) {   // d16 is a multiple of 16
      om_step(kb, ao[0], aw[0]);
      om_step(kb + 8, ao[1], aw[1]);
    }
    // M = U - W S~ into shared memory (zero past the tile's last token);
    // O to device memory.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rb + g + 8 * (e >> 1), c = nb + 2 * t4 + (e & 1);
      ms[r * kLdm + c] = r < rows ? ut[r * kCols + c] - (aw[0][e] + aw[1][e]) : 0.f;
      if (r < rows && c0 + c < dv) o[(tok + r) * dv + c0 + c] = ao[0][e] + ao[1][e];
    }
    __syncthreads();   // the M tile is complete

    // S += K^T M over the tile's rows, in steps of 8 (M is zero past
    // them), odd steps into a second accumulator.
    const int r8 = (rows + 7) & ~7;
    float s1[kMaxTiles][4] = {};
    auto ktm_step = [&](int kb, float (&acc)[kMaxTiles][4]) {
      const float b0 = ms[(kb + t4) * kLdm + nb + g];
      const float b1 = ms[(kb + t4 + 4) * kLdm + nb + g];
#pragma unroll
      for (int j = 0; j < kMaxTiles; ++j) {
        const int db = rb + 64 * j;
        if (db < d16) {
          const float ak[4] = {to_f32(kt[(kb + t4) * ldq + db + g]),
                               to_f32(kt[(kb + t4) * ldq + db + g + 8]),
                               to_f32(kt[(kb + t4 + 4) * ldq + db + g]),
                               to_f32(kt[(kb + t4 + 4) * ldq + db + g + 8])};
          mma3<kExact, false>(acc[j], ak, b0, b1);
        }
      }
    };
    for (int kb = 0; kb < r8; kb += 16) {
      ktm_step(kb, s);
      if (kb + 8 < r8) ktm_step(kb + 8, s1);
    }
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s1[j][e];
    // After a frame's last tile s holds S_t: start the next frame (its
    // first barrier publishes S~), or write S_T.  No thread reads st
    // between the M barrier and the next tile's barrier.
    if (r0 + rows == n && t + 1 < n_t) begin_frame(t + 1, a_next);
  }

  float* sp = s_out + bh * dk * dv;
  each([&](int j, int e, int d, int c, bool in) {
    if (in) sp[d * dv + c0 + c] = s[j][e];
  });
}

template <typename T, int kStages>
int launch_stages(const void* q, const void* k, const void* u, const void* w,
                  const void* alpha, const void* s0, void* o, void* s_out,
                  void* states, int states_bf16, int b, int h, int t, int n,
                  int dk, int dv, cudaStream_t stream) {
  const size_t bytes = smem_bytes(dk, sizeof(T), kStages);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<T, kStages>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * h, (dv + kCols - 1) / kCols);
  chain_kernel<T, kStages><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(u), static_cast<const float*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), states, states_bf16, t,
      n, dk, dv);
  return static_cast<int>(cudaGetLastError());
}

// Launch the chain on `stream`; `states` (S_{t-1} per frame, or null) is
// bf16 when states_bf16 is nonzero, else fp32.  Returns a cudaError_t.
template <typename T>
int launch(const void* q, const void* k, const void* u, const void* w,
           const void* alpha, const void* s0, void* o, void* s_out,
           void* states, int states_bf16, int b, int h, int t, int n, int dk,
           int dv, cudaStream_t stream) {
  if (dk < 1 || dk > kMaxDk || dv < 1 || n < 1 || t < 1 || b * h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ring_stages(dk, sizeof(T)) == 3)
    return launch_stages<T, 3>(q, k, u, w, alpha, s0, o, s_out, states,
                               states_bf16, b, h, t, n, dk, dv, stream);
  return launch_stages<T, 2>(q, k, u, w, alpha, s0, o, s_out, states,
                             states_bf16, b, h, t, n, dk, dv, stream);
}

}  // namespace chain
}  // namespace gdr

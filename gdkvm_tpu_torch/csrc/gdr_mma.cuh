// fp32-accurate products on Hopper's tensor cores, shared by the GDR
// forward's solve (gdr_fwd.cu) and chain (gdr_chain.cuh).
//
// mma.sync m16n8k8 in TF32 with the 3xTF32 split: each fp32 operand x is
// hi + lo, both TF32, and a product is lo*hi + hi*lo + hi*hi (lo*lo is
// below fp32's rounding).  That keeps fp32 accuracy; plain single-pass
// TF32 does not (the GDR drifts ~1e-2 under it).  An operand that is
// already exact in TF32 (a bf16 input) skips its lo part: one product when
// both are.

#pragma once

#include <cstdint>

namespace gdr {

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c += a b, one m16n8k8 TF32 product of the warp (fp32 accumulators).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B to fp32 accuracy from the lane's fragment values (PTX's m16n8k8
// layout, lane = 4 g + t): a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b = B[t][g], B[t+4][g]; c = C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1].  kExactA / kExactB: that operand is exact in TF32.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const float (&a)[4],
                                     float b0, float b1) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    ah[e] = kExactA ? __float_as_uint(a[e]) : tf32(a[e]);
    al[e] = kExactA ? 0u : tf32(a[e] - __uint_as_float(ah[e]));
  }
  const uint32_t bh0 = kExactB ? __float_as_uint(b0) : tf32(b0);
  const uint32_t bh1 = kExactB ? __float_as_uint(b1) : tf32(b1);
  if (!kExactA) mma_tf32(c, al, bh0, bh1);
  if (!kExactB)
    mma_tf32(c, ah, tf32(b0 - __uint_as_float(bh0)), tf32(b1 - __uint_as_float(bh1)));
  mma_tf32(c, ah, bh0, bh1);
}

// out(i, j, s) receives s = sum_{kk < K} a(i, kk) * b(kk, j) for every
// i < R, j < C, computed on the tensor cores by all warps of the block: the
// output is cut into 16 x 8 tiles, dealt to the warps in turn.  a and b
// are read only inside their bounds (i < R, kk < K, j < C; zero outside).
// out is called once per (i, j), by one lane.
template <bool kExactA, bool kExactB, typename FA, typename FB, typename FO>
__device__ __forceinline__ void block_mma(int R, int C, int K, FA a, FB b,
                                          FO out) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = (C + 7) / 8;
  const int tiles = (R + 15) / 16 * tiles_n;
  for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
    const int i0 = tile / tiles_n * 16, j0 = tile % tiles_n * 8;
    const int r0 = i0 + g, r1 = i0 + g + 8, col = j0 + g;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += 8) {
      const int ka = k0 + t, kb = k0 + t + 4;
      const float av[4] = {r0 < R && ka < K ? a(r0, ka) : 0.f,
                           r1 < R && ka < K ? a(r1, ka) : 0.f,
                           r0 < R && kb < K ? a(r0, kb) : 0.f,
                           r1 < R && kb < K ? a(r1, kb) : 0.f};
      const float b0 = col < C && ka < K ? b(ka, col) : 0.f;
      const float b1 = col < C && kb < K ? b(kb, col) : 0.f;
      mma3<kExactA, kExactB>(c, av, b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + 2 * t + (e & 1);
      if (i < R && j < C) out(i, j, c[e]);
    }
  }
}

}  // namespace gdr

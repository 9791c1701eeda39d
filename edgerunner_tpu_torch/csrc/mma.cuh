// Tensor-core building blocks of the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): cp.async copies into padded shared tiles, ldmatrix
// fragment loads, the mma.sync m16n8k16 bf16 product and the m16n8k8 tf32
// product (three of them make one f32-exact product), all with f32
// accumulation, as inline PTX for sm_90a.
//
// Fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16 (row): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..)
//   B 16x8 (col):  b0 (k 2t..2t+1, n g), b1 (k 2t+8..2t+9, n g)
//   C 16x8 f32:    c0 c1 (g, 2t..2t+1), c2 c3 (g+8, 2t..2t+1)
// so the accumulator of two neighbouring n-tiles is, packed to bf16 pairs,
// the A fragment of one k-step: P and dS never leave the registers.
// Fragment layouts of mma.m16n8k8 with tf32 operands (one value a register):
//   A 16x8 (row):  a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   B 8x8 (col):   b0 (k t, n g), b1 (k t+4, n g)
//   C 16x8 f32:    as above
// An f32 tile seen as pairs of b16 loads with plain ldmatrix straight into
// the A fragment of a row-major tile and the B fragment of a tile whose rows
// are the n index (thread (g, t) gets the 32 bits of row g, word t).
#pragma once

#include "common.cuh"

namespace edgerunner {

// A tile of 64 rows of one head in shared memory. Rows are padded by 16
// bytes (8 bf16 or 4 f32 elements): in bf16 a row is 144 bytes at D 64 and
// 208 at D 96, in f32 272 and 400, so the eight 16-byte rows one ldmatrix
// phase reads fall on eight distinct 16-byte bank groups (192 bytes would
// put them on two).
constexpr int kTileRows = 64;
template <int D, typename E = __nv_bfloat16> struct Tile {
  static constexpr int kVec = 16 / sizeof(E);       // elements per 16 bytes
  static constexpr int kStride = D + kVec;          // elements between rows
  static constexpr int kElems = kTileRows * kStride;
  static constexpr int kChunks = D / kVec;          // 16-byte chunks per row
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-fills the 16 bytes when !ok
// (the source is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared (lse and delta rows), zero-filled when !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [r0, r0 + R) of one head (R = 64, or fewer for a shorter tile of
// the same row stride), `stride` elements apart in global memory, into a
// padded shared tile; rows at or past `rows` are zero-filled.
template <int D, int kThreads, int R = kTileRows, typename E>
__device__ __forceinline__ void cp_tile(E* dst, const E* src, int r0, int rows, int64_t stride,
                                        int tid) {
  using T = Tile<D, E>;
  constexpr int kPer = R * T::kChunks / kThreads;
  static_assert(kPer * kThreads == R * T::kChunks, "tile does not split evenly");
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / T::kChunks, c = (e % T::kChunks) * T::kVec;
    const bool ok = r0 + r < rows;
    cp_async16(smem_addr(dst + r * T::kStride + c),
               src + static_cast<int64_t>(ok ? r0 + r : 0) * stride + c, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a b: one m16n8k16 product, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: one m16n8k8 product, tf32 operands (one per register), f32
// accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 value as the sum of two tf32 values: big, x rounded to tf32's 10
// mantissa bits, to nearest with ties away from zero (cvt.rna.tf32.f32's
// value for finite x, in two integer instructions where ptxas emits four),
// and small, the rest x - big (exact in f32), rounded the same way. The
// tensor core reads only the top 19 bits of a tf32 operand, so adding half
// a unit of small's last place rounds it without the mask (ptxas leaves
// the mask out of cvt.rna.tf32.f32 for an mma operand for the same reason).
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big)) + 0x1000u;
}

// d += a b to about f32 accuracy, from the split operands (3xTF32): the
// two small cross products first, then big times big; small times small
// (under 2^-22 of the product) is dropped.
__device__ __forceinline__ void mma_tf32x3(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(d, a_small, b0_big, b1_big);
  mma_tf32(d, a_big, b0_small, b1_small);
  mma_tf32(d, a_big, b0_big, b1_big);
}

// Two floats rounded to a bf16 pair; `lo` takes the lower column.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment addresses inside a padded tile for the three operand shapes.
// A (16 rows from r0; 16 bf16 or 8 f32 columns from c0) of a row-major tile.
template <int D, typename E>
__device__ __forceinline__ uint32_t frag_a(const E* tile, int r0, int c0, int lane) {
  using T = Tile<D, E>;
  return smem_addr(tile + (r0 + (lane & 15)) * T::kStride + c0 + (lane >> 4) * T::kVec);
}
// B of two n-tiles (tile rows n0..n0+15 are the n index, 16 bf16 or 8 f32
// columns from c0 the k index): r[0], r[1] for rows n0..n0+7, r[2], r[3]
// for n0+8..n0+15.
template <int D, typename E>
__device__ __forceinline__ uint32_t frag_b(const E* tile, int n0, int c0, int lane) {
  using T = Tile<D, E>;
  return smem_addr(tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * T::kStride + c0 +
                   ((lane >> 3) & 1) * T::kVec);
}
// B of two n-tiles read transposed (tile rows k0..k0+15 are the k index,
// columns c0..c0+15 the n index), for ldmatrix_x4_trans: r[0], r[1] for
// columns c0..c0+7, r[2], r[3] for c0+8..c0+15.
template <int D>
__device__ __forceinline__ uint32_t frag_bt(const __nv_bfloat16* tile, int k0, int c0, int lane) {
  return smem_addr(tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile<D>::kStride + c0 +
                   (lane >> 4) * 8);
}

// A warp's 16 rows of f32 accumulators (n-tiles of 8 columns, scaled by
// `mul_lo` in row g and `mul_hi` in row g + 8) as bf16 into its rows of a
// padded shared tile, then 16-byte stores of those rows to global memory
// (rows at or past `rows` are not written).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul_lo,
                                           float mul_hi, __nv_bfloat16* stage, int r0, int rows,
                                           __nv_bfloat16* dst, int64_t stride, int lane) {
  using T = Tile<D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(stage + g * T::kStride + 8 * j + 2 * t) =
        pack_bf16(acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * T::kStride + 8 * j + 2 * t) =
        pack_bf16(acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * T::kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / T::kChunks, c = (e % T::kChunks) * 8;
    if (r0 + r < rows) {
      *reinterpret_cast<uint4*>(dst + static_cast<int64_t>(r0 + r) * stride + c) =
          *reinterpret_cast<const uint4*>(stage + r * T::kStride + c);
    }
  }
}

// The same for f32 output: the accumulators scaled, staged as f32 into the
// warp's rows of a padded f32 tile, then 16-byte stores to global memory.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul_lo,
                                           float mul_hi, float* stage, int r0, int rows,
                                           float* dst, int64_t stride, int lane) {
  using T = Tile<D, float>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(stage + g * T::kStride + 8 * j + 2 * t) =
        make_float2(acc[j][0] * mul_lo, acc[j][1] * mul_lo);
    *reinterpret_cast<float2*>(stage + (g + 8) * T::kStride + 8 * j + 2 * t) =
        make_float2(acc[j][2] * mul_hi, acc[j][3] * mul_hi);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * T::kChunks / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = e / T::kChunks, c = (e % T::kChunks) * T::kVec;
    if (r0 + r < rows) {
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(r0 + r) * stride + c) =
          *reinterpret_cast<const float4*>(stage + r * T::kStride + c);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x in one MUFU instruction (denormal results flush to zero, which the
// softmax weights below 2^-126 cannot notice). The kernels take their
// exponentials in base 2, with log2(e) folded into the scale.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads (one quad) that share a fragment row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace edgerunner

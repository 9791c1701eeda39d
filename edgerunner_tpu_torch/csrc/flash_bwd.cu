// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels `_bwd` (edgerunner_tpu/ops/flash_attention.py:520,
// kernels `_bwd_dq_kernel[_tri]` :380/:410 and `_bwd_dkv_kernel[_tri]`
// :462/:494), its transposed-layout twin `_bwd_t` (:1036), and the
// backward of `flash_attention_lse` (:1363, custom_vjp :1220-1246, whose
// lse cotangent the wrapper folds into delta). It computes the same
// function: from q, k, v [B,N|M,H,D], the forward's f32 row log-sum-exp lse
// [B,N,H], the output gradient dO (already zero in rows past q_len) and
// delta = rowsum(dO * O) [B,N,H] f32 (both prepared by the wrapper, as the
// JAX package prepares delta outside its kernels), it recomputes
// p = exp(s - lse) and forms
//   dv = p^T dO,  ds = p * (dO V^T - delta),  dq = scale * ds K,
//   dk = scale * ds^T Q,
// with the forward's masks: keys past kv_len (or M) and, under causal
// masking (N == M), keys after the query carry no weight and no gradient.
// Two kernels, as on the TPU, so that nothing is accumulated across blocks
// and no atomics, f32 scratch or second pass are needed, and the result is
// deterministic: the dq kernel is parallel over (query tile, head, row) and
// loops over the live key tiles; the dk/dv kernel is parallel over (key
// tile, head, row) and loops over the live query tiles. The split computes S
// and dP in both kernels: 7 products where a fused design needs 5.
//
// A row without any valid key (kv_len 0) is the exception. Its logits are
// all the masking constant, so its forward averaged V uniformly over all M
// keys, causal or not. Its lse is -1e30 + log M = -1e30 in f32, so
// exp(s - lse) cannot give these weights back; the dk/dv kernel gives such
// a row the weights 1/M in dv from query 0, and no gradient to q or k (the
// masked logits do not depend on them), which is what autograd through the
// plain version gives.
//
// What bounds it on the H100: operations. The decoder's training shape
// ([2, 6147^2 causal, 16, 96]) needs five products of N*M*D (causal: half)
// and moves a few hundred MB, so it sits far above the card's balance
// point. What the design does about it, for bf16: every product runs as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, and p and ds
// are rounded to bf16 only as the operands of their products, as in the TPU
// kernel's `_dq_compute` / `_dkv_compute`. The dk/dv kernel
// (flash_bwd_dkv_mma_kernel) owns 64 keys on 4 warps (16 keys each) with K
// and V in shared memory for the whole loop; Q, dO, lse and delta tiles of
// 64 query rows stream through a two-stage cp.async ring from the causal
// start. Per tile each warp forms S^T = K Q^T and P^T in f32 fragments,
// dV += P^T dO (dO by ldmatrix.trans), dP^T = V dO^T, dS^T = P^T (dP^T -
// delta) and dK += dS^T Q (Q by ldmatrix.trans); P^T and dS^T become bf16 A
// fragments in registers. The dq kernel (flash_bwd_dq_mma_kernel) owns 64
// query rows, holds their Q and dO fragments in registers, and streams K/V
// tiles of 64 keys: S = Q K^T, dP = dO V^T, dS, dQ += dS K (K by
// ldmatrix.trans). Exponentials are taken in base 2 (ex2.approx, log2(e)
// folded into the scale and lse). Causal tiles above the diagonal are
// skipped, only tiles that reach past kv_len, q_len or the diagonal take
// the mask (one branch per tile), and the dq kernel launches its heaviest
// tiles first. What holds it back: the two repeated products, and shared
// memory: with 16 rows per warp every B fragment read by ldmatrix feeds
// one m-tile, and two 16 x D f32 accumulators (dK and dV) leave no
// registers for a second (232-236 registers at D 96). What is left for the
// wgmma/TMA step: wgmma products on warpgroup tiles (B read by the tensor
// cores from shared memory, accumulators spread over a warpgroup), TMA
// loads and warp specialisation, and perhaps one fused pass (dq by
// atomics) that saves the two repeated products.
//
// f32 inputs (flash_bwd_dq_tf32_mma_kernel, flash_bwd_dkv_tf32_mma_kernel)
// keep the TPU kernel's full-precision f32 dots: one TF32 product keeps
// about three decimal digits and would be another function, so every
// product runs as 3xTF32 on mma.sync.m16n8k8, as kernel A's f32 instance
// runs its two (flash_fwd.cu): each f32 operand splits into big (rounded to
// tf32) and small (the rest, rounded the same way), and each product
// accumulates small*big, big*small and big*big (split_tf32, mma_tf32x3).
// The bound is then the tensor cores' f32-exact rate, 495 / 3 = 165
// TFLOP/s. The split and the roles are the bf16 kernels': the dq kernel
// forms S = Q K^T, dP = dO V^T and dQ += dS K; the dk/dv kernel S^T = K Q^T,
// dP^T = V dO^T, dV += P^T dO and dK += dS^T Q, over 64 owned rows (16 a
// warp; the dq kernel at D 64 owns 128, 32 a warp, as kernel A's f32
// instance does). What differs: the streamed tiles hold 32 rows (see
// kStream), so that two or three blocks fit on an SM and a warp's S and dP
// fragments fit beside its dK and dV accumulators; the f32 rows load with
// plain ldmatrix straight into tf32 A and column-major B fragments (the
// owned tile as A, the streamed one as B of the QK^T-like products); the B
// operand of the three products that sum over the streamed rows (dS K, P^T
// dO, dS^T Q) is read with scalar loads from the padded tile, and the
// weights' accumulator columns are permuted per 8-column chunk so that P
// and dS become tf32 A fragments in registers without a shuffle; those
// three sums over all streamed rows take each tile's products in a fresh
// fragment and add it with a rounded f32 add, as the tensor cores truncate
// what they accumulate (the note at mma_weights_tf32x3). Every operand is
// split where it is read, per warp.
// What holds it back: the splits, the scalar B loads and the softmax are
// four to five instructions per mma.sync, and the two repeated products.

#include "mma.cuh"

namespace edgerunner {
namespace {

// ------------------------------------------------- bf16: tensor cores --

// Each warp owns 16 rows (queries or keys), so a block owns one tile of 64
// and streams tiles of 64 rows of the other side. Eight warps owning 128
// rows, which halves the reads of every streamed tile from device memory,
// measured 4-15% slower on the H100 (one block per SM by registers, against
// two blocks of four warps that need not wait for each other at the tile
// barriers).
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBlock = 16 * kMmaWarps;
static_assert(kBlock == kTileRows, "a block owns one tile of rows");

template <int D> constexpr int dq_smem_bytes() {
  return (2 + 2 * 2) * Tile<D>::kElems * 2;  // Q, dO, and K and V in two stages
}
template <int D> constexpr int dkv_smem_bytes() {
  // K, V, Q and dO in two stages, lse and delta in two stages
  return (2 + 2 * 2) * Tile<D>::kElems * 2 + 2 * 2 * kTileRows * 4;
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                        const int* __restrict__ q_len, const int* __restrict__ kv_len, int N,
                        int M, int H, int causal, float scale) {
  using T = Tile<D>;
  constexpr int kSteps = D / 16;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + T::kElems;
  __nv_bfloat16* ks = dos + T::kElems;     // [2 stages][64][D + 8]
  __nv_bfloat16* vs = ks + 2 * T::kElems;  // [2 stages][64][D + 8]

  // causal: the last query tiles visit the most key tiles, launch them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBlock;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * N * stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  // no gradient to q from a row without any valid key (its logits do not
  // depend on q), nor in a tile of rows wholly past q_len (dO 0)
  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool live = q_len == nullptr || q0 < q_len[b];
  const int kend = klen == 0 || !live ? 0 : causal ? min(klen, q0 + kBlock) : klen;
  const int ntiles = (kend + kBlock - 1) / kBlock;

  if (ntiles > 0) {
    cp_tile<D, kMmaThreads>(qs, q + qoff, q0, N, stride, tid);
    cp_tile<D, kMmaThreads>(dos, dout + qoff, q0, N, stride, tid);
    cp_tile<D, kMmaThreads>(ks, kb, 0, M, stride, tid);
    cp_tile<D, kMmaThreads>(vs, vb, 0, M, stride, tid);
    cp_async_commit();
  }

  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const int64_t soff = static_cast<int64_t>(b) * N * H + h;
  // lse in base 2, as the kernel takes its exponentials
  const float lse_lo = row_lo < N ? lse[soff + static_cast<int64_t>(row_lo) * H] * kLog2e : 0.f;
  const float lse_hi = row_hi < N ? lse[soff + static_cast<int64_t>(row_hi) * H] * kLog2e : 0.f;
  const float dl_lo = row_lo < N ? delta[soff + static_cast<int64_t>(row_lo) * H] : 0.f;
  const float dl_hi = row_hi < N ? delta[soff + static_cast<int64_t>(row_hi) * H] : 0.f;

  uint32_t qf[kSteps][4], df[kSteps][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlock, st = it & 1;
    if (it + 1 < ntiles) {
      cp_tile<D, kMmaThreads>(ks + (st ^ 1) * T::kElems, kb, k0 + kBlock, M, stride, tid);
      cp_tile<D, kMmaThreads>(vs + (st ^ 1) * T::kElems, vb, k0 + kBlock, M, stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        ldmatrix_x4(qf[kk], frag_a<D>(qs, warp * 16, kk * 16, lane));
        ldmatrix_x4(df[kk], frag_a<D>(dos, warp * 16, kk * 16, lane));
      }
    }
    const __nv_bfloat16* kt = ks + st * T::kElems;
    const __nv_bfloat16* vt = vs + st * T::kElems;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys per warp
    float s[kBlock / 8][4], dp[kBlock / 8][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kBlock / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, frag_b<D>(kt, np * 16, kk * 16, lane));
        ldmatrix_x4(bv, frag_b<D>(vt, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[2 * np], df[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], df[kk], bv[2], bv[3]);
      }
    }

    // dS = P (dP - delta) with P = exp(S scale - lse), masked; bf16 A fragments
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ex2(fmaf(s[j][e], scale_log2, -(e < 2 ? lse_lo : lse_hi)));
    }
    if (k0 + kBlock > klen || (causal && k0 + kBlock > q0)) {  // one branch per tile
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          if (key >= klen || (causal && key > (e < 2 ? row_lo : row_hi))) s[j][e] = 0.f;
        }
      }
    }
    uint32_t dsf[kBlock / 16][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      dsf[j / 2][(j & 1) * 2] =
          pack_bf16(s[j][0] * (dp[j][0] - dl_lo), s[j][1] * (dp[j][1] - dl_lo));
      dsf[j / 2][(j & 1) * 2 + 1] =
          pack_bf16(s[j][2] * (dp[j][2] - dl_hi), s[j][3] * (dp[j][3] - dl_hi));
    }

    // dQ += dS K: K's rows are the k index, read transposed
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < kSteps; ++dp2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, frag_bt<D>(kt, kk * 16, dp2 * 16, lane));
        mma_bf16(acc[2 * dp2], dsf[kk], bf[0], bf[1]);
        mma_bf16(acc[2 * dp2 + 1], dsf[kk], bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the warp's own Q rows (read only by this warp, at it == 0) stage dQ
  store_rows<D>(acc, scale, scale, qs + warp * 16 * T::kStride, q0 + warp * 16, N, dq + qoff,
                stride, lane);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, const int* __restrict__ q_len,
                         const int* __restrict__ kv_len, int N, int M, int H, int causal,
                         float scale) {
  using T = Tile<D>;
  constexpr int kSteps = D / 16;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + T::kElems;
  __nv_bfloat16* qs = vs + T::kElems;       // [2 stages][64][D + 8]
  __nv_bfloat16* dos = qs + 2 * T::kElems;  // [2 stages][64][D + 8]
  float* ls = reinterpret_cast<float*>(dos + 2 * T::kElems);  // [2 stages][64]
  float* dls = ls + 2 * kTileRows;                            // [2 stages][64]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBlock;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t koff = static_cast<int64_t>(b) * M * stride + h * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const __nv_bfloat16* db = dout + static_cast<int64_t>(b) * N * stride + h * D;
  const int64_t soff = static_cast<int64_t>(b) * N * H + h;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool dead = klen == 0;  // no valid key: the weights 1/M from query 0
  const int qend = q_len ? min(q_len[b], N) : N;  // dO is zero past q_len
  // under causal masking, rows before this tile see none of its keys
  const int qstart = causal && !dead ? k0 : 0;
  const int qstop = dead || k0 < klen ? qend : qstart;  // keys all past kv_len: nothing
  const int ntiles = qstop > qstart ? (qstop - qstart + kBlock - 1) / kBlock : 0;

  auto load_rows = [&](int st, int r0) {
    cp_tile<D, kMmaThreads>(qs + st * T::kElems, qb, r0, qend, stride, tid);
    cp_tile<D, kMmaThreads>(dos + st * T::kElems, db, r0, qend, stride, tid);
    if (tid < kTileRows) {
      const bool ok = r0 + tid < qend;
      const int64_t o = soff + static_cast<int64_t>(ok ? r0 + tid : 0) * H;
      cp_async4(smem_addr(ls + st * kTileRows + tid), lse + o, ok);
      cp_async4(smem_addr(dls + st * kTileRows + tid), delta + o, ok);
    }
  };
  if (ntiles > 0) {
    cp_tile<D, kMmaThreads>(ks, k + koff, k0, M, stride, tid);
    cp_tile<D, kMmaThreads>(vs, v + koff, k0, M, stride, tid);
    load_rows(0, qstart);
    cp_async_commit();
  }

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const float inv_m = 1.f / static_cast<float>(M);
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * kBlock, st = it & 1;
    if (it + 1 < ntiles) load_rows(st ^ 1, q0 + kBlock);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* qt = qs + st * T::kElems;
    const __nv_bfloat16* dt = dos + st * T::kElems;
    const float* lt = ls + st * kTileRows;
    const float* dlt = dls + st * kTileRows;

    // P^T: 16 keys x 64 queries per warp, in f32 fragments
    float p[kBlock / 8][4];
    if (dead) {
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[j][e] = q0 + 8 * j + 2 * t + (e & 1) < qend ? inv_m : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
      // S^T = K Q^T
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, frag_a<D>(ks, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < kBlock / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, frag_b<D>(qt, np * 16, kk * 16, lane));
          mma_bf16(p[2 * np], af, bf[0], bf[1]);
          mma_bf16(p[2 * np + 1], af, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[j][e] = ex2(fmaf(p[j][e], scale_log2, -kLog2e * ((e & 1) ? l2.y : l2.x)));
        }
      }
      if (q0 + kBlock > qend || k0 + kBlock > klen || (causal && q0 < k0 + kBlock)) {
#pragma unroll
        for (int j = 0; j < kBlock / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = q0 + 8 * j + 2 * t + (e & 1);
            const int key = e < 2 ? key_lo : key_hi;
            if (query >= qend || key >= klen || (causal && key > query)) p[j][e] = 0.f;
          }
        }
      }
    }
    uint32_t pf[kBlock / 16][4];
#pragma unroll
    for (int j = 0; j < kBlock / 8; ++j) {
      pf[j / 2][(j & 1) * 2] = pack_bf16(p[j][0], p[j][1]);
      pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[j][2], p[j][3]);
    }

    // dV += P^T dO: dO's rows are the k index, read transposed
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
      for (int dp2 = 0; dp2 < kSteps; ++dp2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, frag_bt<D>(dt, kk * 16, dp2 * 16, lane));
        mma_bf16(dva[2 * dp2], pf[kk], bf[0], bf[1]);
        mma_bf16(dva[2 * dp2 + 1], pf[kk], bf[2], bf[3]);
      }
    }

    if (!dead) {
      // dP^T = V dO^T
      float dp[kBlock / 8][4];
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t af[4];
        ldmatrix_x4(af, frag_a<D>(vs, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < kBlock / 16; ++np) {
          uint32_t bf[4];
          ldmatrix_x4(bf, frag_b<D>(dt, np * 16, kk * 16, lane));
          mma_bf16(dp[2 * np], af, bf[0], bf[1]);
          mma_bf16(dp[2 * np + 1], af, bf[2], bf[3]);
        }
      }
      // dS^T = P^T (dP^T - delta), from the unrounded p; bf16 A fragments
      uint32_t dsf[kBlock / 16][4];
#pragma unroll
      for (int j = 0; j < kBlock / 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
        dsf[j / 2][(j & 1) * 2] =
            pack_bf16(p[j][0] * (dp[j][0] - d2.x), p[j][1] * (dp[j][1] - d2.y));
        dsf[j / 2][(j & 1) * 2 + 1] =
            pack_bf16(p[j][2] * (dp[j][2] - d2.x), p[j][3] * (dp[j][3] - d2.y));
      }
      // dK += dS^T Q: Q's rows are the k index, read transposed
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
#pragma unroll
        for (int dp2 = 0; dp2 < kSteps; ++dp2) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, frag_bt<D>(qt, kk * 16, dp2 * 16, lane));
          mma_bf16(dka[2 * dp2], dsf[kk], bf[0], bf[1]);
          mma_bf16(dka[2 * dp2 + 1], dsf[kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  cp_async_wait<0>();
  __syncthreads();  // K/V copies landed before their rows stage the output
  // each warp's own K and V rows (read only by this warp) stage dK and dV
  store_rows<D>(dka, scale, scale, ks + warp * 16 * T::kStride, k0 + warp * 16, M, dk + koff,
                stride, lane);
  store_rows<D>(dva, 1.f, 1.f, vs + warp * 16 * T::kStride, k0 + warp * 16, M, dv + koff,
                stride, lane);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv,
               const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
               cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr int kDq = dq_smem_bytes<D>(), kDkv = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDq);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kDkv);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dt = static_cast<const bf16*>(dout);
  flash_bwd_dq_mma_kernel<D><<<dim3((N + kBlock - 1) / kBlock, H, B), kMmaThreads, kDq,
                               stream>>>(qt, kt, vt, dt, lse, delta, static_cast<bf16*>(dq),
                                         q_len, kv_len, N, M, H, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_mma_kernel<D><<<dim3((M + kBlock - 1) / kBlock, H, B), kMmaThreads, kDkv,
                                stream>>>(qt, kt, vt, dt, lse, delta, static_cast<bf16*>(dk),
                                          static_cast<bf16*>(dv), q_len, kv_len, N, M, H,
                                          causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ f32: 3xTF32 on tensor cores --

// The f32 kernels keep the bf16 kernels' split (a block of 4 warps owns the
// rows of one side and streams the other side's rows), with every product
// run as 3xTF32 on mma.sync.m16n8k8 (split_tf32, mma_tf32x3), as kernel A's
// f32 instance runs its two. The streamed tiles hold 32 rows: f32 rows are
// twice bf16's, and with 32 a block's shared memory (its own tiles and two
// stages of the two streamed ones) stays at 70-104 KB, two or three blocks
// an SM, and a warp's S and dP fragments (16 x 32 f32 each) sit beside the
// dK and dV accumulators (2 x 16 x D f32) of the dk/dv kernel without a
// spill at D 96.
constexpr int kStream = 32;
constexpr int kStreamNT = kStream / 8;  // 8-row n-tiles of a streamed tile

template <int D> struct Bwd32Shape {
  using T = Tile<D, float>;
  // 16-row m-tiles per warp of the dq kernel: two at D 64, so that each K
  // or V value a warp splits, and each K value it loads for dS K, feeds two
  // products (kernel A's f32 choice); one at D 96, where two spill
  static constexpr int kDqMT = D == 64 ? 2 : 1;
  static constexpr int kDqRows = 16 * kDqMT * kMmaWarps;  // query rows per dq block
  static constexpr int kStreamElems = kStream * T::kStride;
  // dq: Q and dO, then K and V in two stages
  static constexpr int kDqSmem = (2 * kDqMT * T::kElems + 2 * 2 * kStreamElems) * 4;
  // dk/dv: K and V, then Q and dO in two stages, then lse and delta in two stages
  static constexpr int kDkvSmem = (2 * T::kElems + 2 * 2 * kStreamElems) * 4 + 2 * 2 * kStream * 4;
};

// The warp's MT x 16 x 32 (rows x streamed rows) products X Y^T of two
// tiles that both hold D columns: x (the warp's MT m-tiles of 16 rows from
// row r0, read as A) and y (32 rows read as the column-major B); 3xTF32,
// into acc. Each B fragment, split once, feeds the MT m-tiles.
template <int D, int MT>
__device__ __forceinline__ void mma_rows_tf32x3(float (&acc)[MT][kStreamNT][4], const float* x,
                                                int r0, const float* y, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    uint32_t raw[4], abig[MT][4], asmall[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      ldmatrix_x4(raw, frag_a<D>(x, r0 + 16 * mi, kk * 8, lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], abig[mi][e], asmall[mi][e]);
    }
#pragma unroll
    for (int np = 0; np < kStreamNT / 2; ++np) {
      uint32_t big[4], small[4];
      ldmatrix_x4(raw, frag_b<D>(y, np * 16, kk * 8, lane));
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(raw[e], big[e], small[e]);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_tf32x3(acc[mi][2 * np], abig[mi], asmall[mi], big[0], big[1], small[0], small[1]);
        mma_tf32x3(acc[mi][2 * np + 1], abig[mi], asmall[mi], big[2], big[3], small[2],
                   small[3]);
      }
    }
  }
}

// acc (MT x 16 rows x D) += W Z, W the warp's MT x 16 x 32 weights in
// accumulator fragments (W[row][8 j + 2 t + e] in w[mi][j][e], rows g and
// g + 8 of m-tile mi), Z a streamed tile of 32 rows x D; 3xTF32. W's
// accumulator gives thread (g, t) the columns 2t and 2t + 1 of each 8-column
// chunk where the tf32 A fragment wants t and t + 4, so inside each chunk
// column t stands for 2t and t + 4 for 2t + 1, and Z's B values are read
// from those rows (the product sums over them, so the order changes
// nothing): W needs no shuffle. Z's B values are scalar loads from the
// padded tile (ldmatrix cannot transpose 32-bit elements), conflict-free at
// D + 4 floats a row, each split once for the MT m-tiles. These sums run
// over every streamed row (8192 keys for the point encoder's dq), and the
// tensor cores add a product into its accumulator with truncation, so a
// sum chained through thousands of mma.sync drifts by ~1e-4 of its value:
// each tile's products sum in a fresh fragment, which joins acc by a
// rounded f32 add.
template <int D, int MT>
__device__ __forceinline__ void mma_weights_tf32x3(float (&acc)[MT][D / 8][4],
                                                   const float (&w)[MT][kStreamNT][4],
                                                   const float* z, int lane) {
  using T = Tile<D, float>;
  const int g = lane >> 2, t = lane & 3;
  uint32_t abig[MT][kStreamNT][4], asmall[MT][kStreamNT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < kStreamNT; ++j) {
      const uint32_t wa[4] = {__float_as_uint(w[mi][j][0]), __float_as_uint(w[mi][j][2]),
                              __float_as_uint(w[mi][j][1]), __float_as_uint(w[mi][j][3])};
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(wa[e], abig[mi][j][e], asmall[mi][j][e]);
    }
  }
  const float* z0 = z + 2 * t * T::kStride + g;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    float part[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) part[mi][0] = part[mi][1] = part[mi][2] = part[mi][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kStreamNT; ++j) {
      const float* zj = z0 + 8 * j * T::kStride + 8 * dn;
      uint32_t b0big, b0small, b1big, b1small;
      split_tf32(__float_as_uint(zj[0]), b0big, b0small);
      split_tf32(__float_as_uint(zj[T::kStride]), b1big, b1small);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_tf32x3(part[mi], abig[mi][j], asmall[mi][j], b0big, b1big, b0small, b1small);
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][dn][e] += part[mi][e];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dq_tf32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dq, const int* __restrict__ q_len,
                             const int* __restrict__ kv_len, int N, int M, int H, int causal,
                             float scale) {
  using T = Tile<D, float>;
  using S = Bwd32Shape<D>;
  constexpr int MT = S::kDqMT;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kDqRows][D + 4]
  float* dos = qs + MT * T::kElems;            // [kDqRows][D + 4]
  float* ks = dos + MT * T::kElems;            // [2 stages][32][D + 4]
  float* vs = ks + 2 * S::kStreamElems;        // [2 stages][32][D + 4]

  // causal: the last query tiles visit the most key tiles, launch them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * S::kDqRows;
  const int wrow = warp * 16 * MT;  // the warp's first row in the block
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t qoff = static_cast<int64_t>(b) * N * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  // no gradient to q from a row without any valid key (its logits do not
  // depend on q), nor in a tile of rows wholly past q_len (dO 0)
  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool live = q_len == nullptr || q0 < q_len[b];
  const int kend = klen == 0 || !live ? 0 : causal ? min(klen, q0 + S::kDqRows) : klen;
  const int ntiles = (kend + kStream - 1) / kStream;

  if (ntiles > 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      cp_tile<D, kMmaThreads>(qs + mt * T::kElems, q + qoff, q0 + mt * kTileRows, N, stride,
                              tid);
      cp_tile<D, kMmaThreads>(dos + mt * T::kElems, dout + qoff, q0 + mt * kTileRows, N,
                              stride, tid);
    }
    cp_tile<D, kMmaThreads, kStream>(ks, kb, 0, M, stride, tid);
    cp_tile<D, kMmaThreads, kStream>(vs, vb, 0, M, stride, tid);
    cp_async_commit();
  }

  // per m-tile mi, rows row[2 mi] = q0 + wrow + 16 mi + g and row[2 mi + 1] = that + 8;
  // lse in base 2, as the kernel takes its exponentials
  const int64_t soff = static_cast<int64_t>(b) * N * H + h;
  int row[2 * MT];
  float lse2[2 * MT], dl[2 * MT];
#pragma unroll
  for (int r = 0; r < 2 * MT; ++r) {
    row[r] = q0 + wrow + 16 * (r >> 1) + g + 8 * (r & 1);
    const bool ok = row[r] < N;
    lse2[r] = ok ? lse[soff + static_cast<int64_t>(row[r]) * H] * kLog2e : 0.f;
    dl[r] = ok ? delta[soff + static_cast<int64_t>(row[r]) * H] : 0.f;
  }

  float acc[MT][D / 8][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kStream, st = it & 1;
    if (it + 1 < ntiles) {
      cp_tile<D, kMmaThreads, kStream>(ks + (st ^ 1) * S::kStreamElems, kb, k0 + kStream, M,
                                       stride, tid);
      cp_tile<D, kMmaThreads, kStream>(vs + (st ^ 1) * S::kStreamElems, vb, k0 + kStream, M,
                                       stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + st * S::kStreamElems;
    const float* vt = vs + st * S::kStreamElems;

    // S = Q K^T and dP = dO V^T: MT x 16 rows x 32 keys per warp
    float s[MT][kStreamNT][4], dp[MT][kStreamNT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] = dp[mi][j][e] = 0.f;
      }
    }
    mma_rows_tf32x3<D, MT>(s, qs, wrow, kt, lane);
    mma_rows_tf32x3<D, MT>(dp, dos, wrow, vt, lane);

    // P = exp(S scale - lse), masked; then dS = P (dP - delta) in its place
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mi][j][e] = ex2(fmaf(s[mi][j][e], scale_log2, -lse2[2 * mi + (e >> 1)]));
        }
      }
    }
    if (k0 + kStream > klen || (causal && k0 + kStream > q0)) {  // one branch per tile
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
        for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= klen || (causal && key > row[2 * mi + (e >> 1)])) s[mi][j][e] = 0.f;
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] *= dp[mi][j][e] - dl[2 * mi + (e >> 1)];
      }
    }

    // dQ += dS K
    mma_weights_tf32x3<D, MT>(acc, s, kt, lane);
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // the warp's own Q rows (read only by this warp) stage dQ
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    store_rows<D>(acc[mi], scale, scale, qs + (wrow + 16 * mi) * T::kStride,
                  q0 + wrow + 16 * mi, N, dq + qoff, stride, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_dkv_tf32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              const int* __restrict__ q_len, const int* __restrict__ kv_len,
                              int N, int M, int H, int causal, float scale) {
  using T = Tile<D, float>;
  using S = Bwd32Shape<D>;
  const float scale_log2 = scale * kLog2e;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + T::kElems;
  float* qs = vs + T::kElems;             // [2 stages][32][D + 4]
  float* dos = qs + 2 * S::kStreamElems;  // [2 stages][32][D + 4]
  float* ls = dos + 2 * S::kStreamElems;  // [2 stages][32]
  float* dls = ls + 2 * kStream;          // [2 stages][32]

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBlock;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t koff = static_cast<int64_t>(b) * M * stride + h * D;
  const float* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const float* db = dout + static_cast<int64_t>(b) * N * stride + h * D;
  const int64_t soff = static_cast<int64_t>(b) * N * H + h;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool dead = klen == 0;  // no valid key: the weights 1/M from query 0
  const int qend = q_len ? min(q_len[b], N) : N;  // dO is zero past q_len
  // under causal masking, rows before this tile see none of its keys
  const int qstart = causal && !dead ? k0 : 0;
  const int qstop = dead || k0 < klen ? qend : qstart;  // keys all past kv_len: nothing
  const int ntiles = qstop > qstart ? (qstop - qstart + kStream - 1) / kStream : 0;

  auto load_rows = [&](int st, int r0) {
    cp_tile<D, kMmaThreads, kStream>(qs + st * S::kStreamElems, qb, r0, qend, stride, tid);
    cp_tile<D, kMmaThreads, kStream>(dos + st * S::kStreamElems, db, r0, qend, stride, tid);
    if (tid < kStream) {
      const bool ok = r0 + tid < qend;
      const int64_t o = soff + static_cast<int64_t>(ok ? r0 + tid : 0) * H;
      cp_async4(smem_addr(ls + st * kStream + tid), lse + o, ok);
      cp_async4(smem_addr(dls + st * kStream + tid), delta + o, ok);
    }
  };
  if (ntiles > 0) {
    cp_tile<D, kMmaThreads>(ks, k + koff, k0, M, stride, tid);
    cp_tile<D, kMmaThreads>(vs, v + koff, k0, M, stride, tid);
    load_rows(0, qstart);
    cp_async_commit();
  }

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const float inv_m = 1.f / static_cast<float>(M);
  float dka[1][D / 8][4], dva[1][D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[0][j][e] = dva[0][j][e] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * kStream, st = it & 1;
    if (it + 1 < ntiles) load_rows(st ^ 1, q0 + kStream);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt = qs + st * S::kStreamElems;
    const float* dt = dos + st * S::kStreamElems;
    const float* lt = ls + st * kStream;
    const float* dlt = dls + st * kStream;

    // P^T: 16 keys x 32 queries per warp, in f32 fragments
    float p[1][kStreamNT][4];
    if (dead) {
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[0][j][e] = q0 + 8 * j + 2 * t + (e & 1) < qend ? inv_m : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) p[0][j][0] = p[0][j][1] = p[0][j][2] = p[0][j][3] = 0.f;
      // S^T = K Q^T
      mma_rows_tf32x3<D, 1>(p, ks, warp * 16, qt, lane);
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[0][j][e] = ex2(fmaf(p[0][j][e], scale_log2, -kLog2e * ((e & 1) ? l2.y : l2.x)));
        }
      }
      if (q0 + kStream > qend || k0 + kBlock > klen || (causal && q0 < k0 + kBlock)) {
#pragma unroll
        for (int j = 0; j < kStreamNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int query = q0 + 8 * j + 2 * t + (e & 1);
            const int key = e < 2 ? key_lo : key_hi;
            if (query >= qend || key >= klen || (causal && key > query)) p[0][j][e] = 0.f;
          }
        }
      }
    }

    // dV += P^T dO
    mma_weights_tf32x3<D, 1>(dva, p, dt, lane);

    if (!dead) {
      // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in its place
      float dp[1][kStreamNT][4];
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
        dp[0][j][0] = dp[0][j][1] = dp[0][j][2] = dp[0][j][3] = 0.f;
      }
      mma_rows_tf32x3<D, 1>(dp, vs, warp * 16, dt, lane);
#pragma unroll
      for (int j = 0; j < kStreamNT; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dlt + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[0][j][e] = p[0][j][e] * (dp[0][j][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dK += dS^T Q
      mma_weights_tf32x3<D, 1>(dka, dp, qt, lane);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  cp_async_wait<0>();
  __syncthreads();  // K/V copies landed before their rows stage the output
  // each warp's own K and V rows (read only by this warp) stage dK and dV
  store_rows<D>(dka[0], scale, scale, ks + warp * 16 * T::kStride, k0 + warp * 16, M,
                dk + koff, stride, lane);
  store_rows<D>(dva[0], 1.f, 1.f, vs + warp * 16 * T::kStride, k0 + warp * 16, M, dv + koff,
                stride, lane);
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dq, void* dk, void* dv,
                const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
                cudaStream_t stream) {
  using S = Bwd32Shape<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         S::kDqSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_mma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::kDkvSmem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dt = static_cast<const float*>(dout);
  flash_bwd_dq_tf32_mma_kernel<D><<<dim3((N + S::kDqRows - 1) / S::kDqRows, H, B),
                                    kMmaThreads, S::kDqSmem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<float*>(dq), q_len, kv_len, N, M, H, causal,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_tf32_mma_kernel<D><<<dim3((M + kBlock - 1) / kBlock, H, B), kMmaThreads,
                                     S::kDkvSmem, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), q_len,
      kv_len, N, M, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q/dout/dq [B,N,H,D], k/v/dk/dv [B,M,H,D] (all contiguous, 16-byte
// aligned, one dtype); lse and delta [B,N,H] f32; q_len/kv_len device int32
// [B] or null; dout must already be zero in rows past q_len. Launches the dq
// kernel, then the dk/dv kernel, on `stream`: the bf16 tensor-core kernels
// for bf16, the 3xTF32 ones for f32. Returns the CUDA error of the launches
// (0 = launched), or cudaErrorInvalidValue for a head dim or dtype the
// kernels have no instance for.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dq, void* dk, void* dv, const int* q_len,
                                   const int* kv_len, int B, int N, int M, int H, int D,
                                   int dtype, int causal, void* stream) {
  using namespace edgerunner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    return launch_mma<64>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  } else if (dtype == kBFloat16 && D == 96) {
    return launch_mma<96>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  } else if (dtype == kFloat32 && D == 64) {
    return launch_tf32<64>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch_tf32<96>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

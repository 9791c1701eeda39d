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
// f32 inputs take the scalar kernels (flash_bwd_*_f32_kernel): a
// tensor-core f32 product would be TF32, another function than the TPU
// kernel's full-precision f32 dots. They run the products as f32 FMAs from
// tiles of 32 rows in shared memory, four threads per row.

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

// ------------------------------------------------------- f32: scalar --

constexpr int kRows = 32;          // rows (queries or keys) owned per block
constexpr int kParts = 4;          // threads per row
constexpr int kThreads = kRows * kParts;
constexpr int kTile = 32;          // rows of the other side per shared tile

// A thread's share of a row of D values: chunks part, part + 4, ... of four
// values each, so the four threads of a row read four neighbouring chunks.
template <int D> struct Lanes {
  static constexpr int kChunks = D / (4 * kParts);
  float v[kChunks * 4];
};

// This thread's lanes of the row at `src` (zeros when !ok).
template <int D>
__device__ __forceinline__ void load_lanes(Lanes<D>& x, const float* src, int part, bool ok) {
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    const float4 y = ok ? *reinterpret_cast<const float4*>(src + 4 * (part + kParts * i))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    x.v[4 * i] = y.x;
    x.v[4 * i + 1] = y.y;
    x.v[4 * i + 2] = y.z;
    x.v[4 * i + 3] = y.w;
  }
}

template <int D>
__device__ __forceinline__ void store_lanes(float* dst, const Lanes<D>& x, int part, float mul) {
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    *reinterpret_cast<float4*>(dst + 4 * (part + kParts * i)) =
        make_float4(x.v[4 * i] * mul, x.v[4 * i + 1] * mul, x.v[4 * i + 2] * mul,
                    x.v[4 * i + 3] * mul);
  }
}

// Rows [r0, r0 + kTile) of one head of x [., L, H, D] into shared memory
// (zero past `rows`).
template <int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const float* base, int r0, int rows,
                                          int64_t stride, int tid) {
  constexpr int kRowVecs = D / 4;
  for (int e = tid; e < kTile * kRowVecs; e += kThreads) {
    const int j = e / kRowVecs, c = (e % kRowVecs) * 4;
    *reinterpret_cast<float4*>(&dst[j][c]) =
        r0 + j < rows
            ? *reinterpret_cast<const float4*>(base + static_cast<int64_t>(r0 + j) * stride + c)
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Partial dots of this thread's lanes of a and b with a shared row, summed
// over the row's four threads.
template <int D>
__device__ __forceinline__ void quad_dots(const Lanes<D>& a, const float* ra, float& sa,
                                          const Lanes<D>& b, const float* rb, float& sb,
                                          int part) {
  sa = 0.f;
  sb = 0.f;
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    const int off = 4 * (part + kParts * i);
    const float4 x = *reinterpret_cast<const float4*>(ra + off);
    const float4 y = *reinterpret_cast<const float4*>(rb + off);
    sa = fmaf(a.v[4 * i], x.x, sa);
    sa = fmaf(a.v[4 * i + 1], x.y, sa);
    sa = fmaf(a.v[4 * i + 2], x.z, sa);
    sa = fmaf(a.v[4 * i + 3], x.w, sa);
    sb = fmaf(b.v[4 * i], y.x, sb);
    sb = fmaf(b.v[4 * i + 1], y.y, sb);
    sb = fmaf(b.v[4 * i + 2], y.z, sb);
    sb = fmaf(b.v[4 * i + 3], y.w, sb);
  }
  sa += __shfl_xor_sync(0xffffffffu, sa, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  sa += __shfl_xor_sync(0xffffffffu, sa, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
}

// acc += w * (this thread's lanes of the shared row r)
template <int D>
__device__ __forceinline__ void axpy_lanes(Lanes<D>& acc, float w, const float* r, int part) {
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(r + 4 * (part + kParts * i));
    acc.v[4 * i] = fmaf(w, x.x, acc.v[4 * i]);
    acc.v[4 * i + 1] = fmaf(w, x.y, acc.v[4 * i + 1]);
    acc.v[4 * i + 2] = fmaf(w, x.z, acc.v[4 * i + 2]);
    acc.v[4 * i + 3] = fmaf(w, x.w, acc.v[4 * i + 3]);
  }
}

// dq: one block per (query tile, head, row) loops over the live key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, const int* __restrict__ q_len,
                        const int* __restrict__ kv_len, int N, int M, int H, int causal,
                        float scale) {
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % kParts;
  const int row = qt * kRows + tid / kParts;
  const bool row_ok = row < N;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t roff = (static_cast<int64_t>(b) * N + (row_ok ? row : 0)) * stride + h * D;
  const int64_t soff = (static_cast<int64_t>(b) * N + (row_ok ? row : 0)) * H + h;

  Lanes<D> qr, dor, acc;
  load_lanes<D>(qr, q + roff, part, row_ok);
  load_lanes<D>(dor, dout + roff, part, row_ok);
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks * 4; ++i) acc.v[i] = 0.f;
  const float lse_r = row_ok ? lse[soff] : 0.f;
  const float delta_r = row_ok ? delta[soff] : 0.f;

  // keys past kv_len (and past M) take no gradient; a row without any valid
  // key gets none at all, and neither does a tile of rows past q_len (dO 0)
  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool live = q_len == nullptr || qt * kRows < q_len[b];
  const int kend = !live ? 0 : causal ? min(klen, (qt + 1) * kRows) : klen;
  const float* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<D>(ks, kb, k0, kend, stride, tid);
    load_tile<D>(vs, vb, k0, kend, stride, tid);
    __syncthreads();
    const int nk = min(kTile, kend - k0);
    for (int j = 0; j < nk; ++j) {
      float s, dp;
      quad_dots<D>(qr, ks[j], s, dor, vs[j], dp, part);
      const bool valid = !causal || k0 + j <= row;
      const float p = valid ? expf(s * scale - lse_r) : 0.f;
      axpy_lanes<D>(acc, p * (dp - delta_r), ks[j], part);
    }
  }
  if (row_ok) store_lanes<D>(dq + roff, acc, part, scale);
}

// dk and dv: one block per (key tile, head, row) loops over the live query
// tiles. dO is zero in rows past q_len, so those rows are skipped.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ q_len, const int* __restrict__ kv_len, int N,
                         int M, int H, int causal, float scale) {
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float ls[kTile];
  __shared__ float ds_[kTile];

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, part = tid % kParts;
  const int k0 = kt * kRows;
  const int key = k0 + tid / kParts;
  const bool key_ok = key < M;
  const int64_t stride = static_cast<int64_t>(H) * D;
  const int64_t koff = (static_cast<int64_t>(b) * M + (key_ok ? key : 0)) * stride + h * D;

  Lanes<D> kr, vr, dka, dva;
  load_lanes<D>(kr, k + koff, part, key_ok);
  load_lanes<D>(vr, v + koff, part, key_ok);
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks * 4; ++i) dka.v[i] = dva.v[i] = 0.f;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool dead = klen == 0;  // no valid key: the weights 1/M from query 0
  const int qend = q_len ? min(q_len[b], N) : N;
  // under causal masking, rows before this tile see none of its keys
  const int qstart = causal && !dead ? k0 : 0;
  const int qstop = (dead || k0 < klen) ? qend : qstart;  // keys all past kv_len: nothing
  const float* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const float* db = dout + static_cast<int64_t>(b) * N * stride + h * D;

  for (int q0 = qstart; q0 < qstop; q0 += kTile) {
    __syncthreads();
    load_tile<D>(qs, qb, q0, qstop, stride, tid);
    load_tile<D>(dos, db, q0, qstop, stride, tid);
    if (tid < kTile) {
      const int r = q0 + tid;
      const int64_t o = (static_cast<int64_t>(b) * N + (r < qstop ? r : 0)) * H + h;
      ls[tid] = r < qstop ? lse[o] : 0.f;
      ds_[tid] = r < qstop ? delta[o] : 0.f;
    }
    __syncthreads();
    const int nq = min(kTile, qstop - q0);
    if (dead) {
      const float w = 1.f / static_cast<float>(M);
      for (int i = 0; i < nq; ++i) axpy_lanes<D>(dva, w, dos[i], part);
      continue;
    }
    for (int i = 0; i < nq; ++i) {
      const int row = q0 + i;
      float s, dp;
      quad_dots<D>(kr, qs[i], s, vr, dos[i], dp, part);
      const bool valid = key < klen && (!causal || key <= row);
      const float p = valid ? expf(s * scale - ls[i]) : 0.f;
      axpy_lanes<D>(dva, p, dos[i], part);
      axpy_lanes<D>(dka, p * (dp - ds_[i]), qs[i], part);
    }
  }
  if (key_ok) {
    store_lanes<D>(dk + koff, dka, part, scale);
    store_lanes<D>(dv + koff, dva, part, 1.f);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk, void* dv,
               const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
               cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dt = static_cast<const float*>(dout);
  flash_bwd_dq_f32_kernel<D><<<dim3((N + kRows - 1) / kRows, H, B), kThreads, 0, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<float*>(dq), q_len, kv_len, N, M, H, causal,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_f32_kernel<D><<<dim3((M + kRows - 1) / kRows, H, B), kThreads, 0, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), q_len,
      kv_len, N, M, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q/dout/dq [B,N,H,D], k/v/dk/dv [B,M,H,D] (all contiguous, 16-byte
// aligned, one dtype); lse and delta [B,N,H] f32; q_len/kv_len device int32
// [B] or null; dout must already be zero in rows past q_len. Launches the dq
// kernel, then the dk/dv kernel, on `stream`: the tensor-core kernels for
// bf16, the scalar ones for f32. Returns the CUDA error of the launches
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
    return launch_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch_f32<96>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M, H,
                          causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

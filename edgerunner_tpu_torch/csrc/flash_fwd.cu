// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels `_fwd`
// (edgerunner_tpu/ops/flash_attention.py:258, kernels `_fwd_kernel` /
// `_fwd_kernel_tri`), its transposed-layout twin `_fwd_t` (:785), both
// reached from `flash_attention` (:1336), and the forward of
// `flash_attention_lse` (:1363). It computes the same function:
// online-softmax attention over q [B,N,H,D] and k/v [B,M,H,D] with per-row
// `kv_len` key masks at -1e30, causal masking (key <= query, only when N ==
// M), rows past `q_len` zeroed, and the f32 row log-sum-exp lse [B,N,H] on
// every row. The TPU devices (two layouts, triangular pair tables, head
// grouping) are dropped: one block per (query tile, head, batch row) loops
// over the key tiles.
//
// What bounds it on the H100: operations. At the main path's shapes (the
// point encoder's 2048 x 8192 cross-attention at D 64, the decoder prefill's
// ~2050^2 causal self-attention at D 96, the training step's 6147^2 and the
// ring's blocks, the DiT's 2048^2 self- and 2048 x 257 cross-attention at D
// 64) the function does hundreds to thousands of operations for every byte
// it must move, past the card's balance point, so the tensor cores set the
// pace: 989 TFLOP/s in bf16 and, for an f32-exact product, 495 / 3 = 165
// TFLOP/s (three TF32 products for each, below). What the design does about
// it, for bf16 (flash_fwd_mma_kernel): both products run as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, as the TPU
// kernel's bf16 dots with preferred_element_type f32. A block of 4 warps
// owns 128 query rows, 32 per warp (two m-tiles, so that every K or V
// fragment read from shared memory feeds two products); the Q tile is copied
// once to shared memory with cp.async, its A fragments held in registers at
// D 64 and read again for each key tile at D 96 (registers). K and V tiles
// of 64 keys stream through a two-stage cp.async ring in padded shared tiles
// (no bank conflicts for ldmatrix), K read by ldmatrix as the column-major B
// of QK^T and V by ldmatrix.trans as the B of PV. The scores stay in the f32
// accumulator fragments, in base 2 (log2(e) folded into the scale, one
// ex2.approx per weight); masks, the online softmax (row max and sum across
// each quad) and the rescale of O happen there, and P is packed to bf16 A
// fragments in registers for PV. Only tiles that reach past kv_len, M or the
// diagonal take the mask, behind one branch per tile. Under causal masking
// the key loop stops at the diagonal, and the heaviest query tiles are
// launched first. What holds it back: each warp runs its products, its
// exponentials (the MUFU unit, 16 a cycle per SM) and its bf16 packing in
// turn, and mma.sync itself tops out well below the card's 989 TFLOP/s. What
// is left for the wgmma/TMA step: wgmma on warpgroup tiles fed by TMA into
// swizzled tiles, a producer warp, and two consumer warpgroups that take
// turns (one's exponentials under the other's products).
//
// f32 inputs (flash_fwd_tf32_mma_kernel) keep the TPU kernel's
// full-precision f32 dots; one TF32 product keeps about three decimal digits
// and would be another function. Both products run as 3xTF32 on
// mma.sync.m16n8k8 (tf32 operands, f32 accumulators): each f32 operand x is
// split into big = x rounded to tf32 (to nearest, ties away, as
// cvt.rna.tf32.f32) and small = x - big rounded the same way, in four
// integer and float instructions (split_tf32), and each product accumulates
// small*big, big*small and then big*big; small*small, under 2^-22 of the
// product, is dropped. The skeleton is the bf16 kernel's (the cp.async ring
// into padded tiles, base-2 softmax, one mask branch per tile, heaviest
// causal tiles first), with these differences. Seen as pairs of b16, f32
// rows load with plain ldmatrix straight into tf32 fragments: Q as A, K
// [key][d] as the column-major B of QK^T. At D 64 a warp owns two m-tiles
// (128 query rows a block), so that each K or V value, split once per warp
// and tile, feeds two products; at D 96 one (64 rows), as two spill. Q is
// read again and split for each key tile. V, the B of PV, would need a
// 32-bit transpose that ldmatrix.trans cannot do, so its B values are scalar
// loads from the padded tile, conflict-free at D + 4 floats a row. P's
// accumulator gives thread (g, t) keys 2t and 2t + 1 of each 8-key chunk
// where the tf32 A fragment wants columns t and t + 4, so the keys inside
// each chunk are permuted: column t stands for key 2t and column t + 4 for
// key 2t + 1, V's B is read from those rows, and P is split in registers
// without a shuffle. What holds it back: each warp runs four to five other
// instructions for each mma.sync (the splits of K, V, P and Q, the scalar V
// loads, the softmax), and the one (D 96) or two (D 64) warps per scheduler
// that shared memory allows hide little of their latency.
//
// Numerics follow the TPU kernel: scores and accumulators in f32; bf16
// rounds p to bf16 only as the PV operand, f32 keeps p unrounded; l is
// summed from the unrounded p, output divided by l where l > 0. Keys masked
// by kv_len or causality get -1e30, a finite value; keys past M (the ragged
// last tile) get no weight at all. A row with no valid key (kv_len 0) visits
// every key tile with every logit at -1e30, so it averages V uniformly over
// the M keys, as the plain version and `attention_reference` do, causal or
// not; its lse is -1e30. Output rows past q_len are zeroed; their lse is
// computed all the same.

#include "mma.cuh"

namespace edgerunner {
namespace {

// ------------------------------------------------- bf16: tensor cores --

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kBlockK = kTileRows;  // keys per tile
// 16-row m-tiles per warp: two, so that each K/V fragment read from shared
// memory feeds two products (7-15% faster than one on the H100)
constexpr int kRowTiles = 2;
constexpr int kBlockQ = 16 * kRowTiles * kMmaWarps;  // query rows per block

template <int D> struct FwdShape {
  // Q fragments held in registers for the whole key loop where they fit;
  // at D 96 they are read again from shared memory for each key tile
  static constexpr bool kHoldQ = kRowTiles * D <= 128;
  static constexpr int kSmem = (kRowTiles + 2 * 2) * Tile<D>::kElems * 2;  // Q; K, V x 2
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ q_len,
                     const int* __restrict__ kv_len, int N, int M, int H, int causal,
                     float scale_log2) {
  using T = Tile<D>;
  constexpr int kSteps = D / 16;  // k-steps of QK^T, pairs of d-tiles of PV
  constexpr int kMT = kRowTiles;
  constexpr bool kHoldQ = FwdShape<D>::kHoldQ;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBlockQ][D + 8]
  __nv_bfloat16* ks = qs + kMT * T::kElems;                     // [2 stages][64][D + 8]
  __nv_bfloat16* vs = ks + 2 * T::kElems;                       // [2 stages][64][D + 8]

  // causal: the last query tiles visit the most key tiles, launch them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBlockQ;
  const int wrow = warp * 16 * kMT;  // the warp's first row in the block
  const int64_t stride = static_cast<int64_t>(H) * D;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  // a row without any valid key averages all M keys; otherwise keys past
  // kv_len (and, causal, past the diagonal) carry no weight
  const int kend = klen == 0 ? M : causal ? min(klen, q0 + kBlockQ) : klen;
  const int ntiles = (kend + kBlockK - 1) / kBlockK;

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    cp_tile<D, kMmaThreads>(qs + mt * T::kElems, qb, q0 + mt * kTileRows, N, stride, tid);
  }
  cp_tile<D, kMmaThreads>(ks, kb, 0, M, stride, tid);
  cp_tile<D, kMmaThreads>(vs, vb, 0, M, stride, tid);
  cp_async_commit();

  // per m-tile mi, rows r[2 mi] = q0 + wrow + 16 mi + g and r[2 mi + 1] = that + 8
  int row[2 * kMT];
  float m[2 * kMT], l[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    row[r] = q0 + wrow + 16 * (r >> 1) + g + 8 * (r & 1);
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  uint32_t qf[kHoldQ ? kMT : 1][kHoldQ ? kSteps : 1][4];
  float acc[kMT][D / 8][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK, st = it & 1;
    if (it + 1 < ntiles) {
      cp_tile<D, kMmaThreads>(ks + (st ^ 1) * T::kElems, kb, k0 + kBlockK, M, stride, tid);
      cp_tile<D, kMmaThreads>(vs + (st ^ 1) * T::kElems, vb, k0 + kBlockK, M, stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kHoldQ) {
      if (it == 0) {
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
          for (int kk = 0; kk < kSteps; ++kk) {
            ldmatrix_x4(qf[mi][kk], frag_a<D>(qs, wrow + 16 * mi, kk * 16, lane));
          }
        }
      }
    }
    const __nv_bfloat16* kt = ks + st * T::kElems;
    const __nv_bfloat16* vt = vs + st * T::kElems;

    // S = Q K^T: 16 kMT rows x 64 keys per warp, 8 n-tiles per m-tile;
    // each K fragment feeds the warp's kMT m-tiles
    float s[kMT][kBlockK / 8][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t af[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        if constexpr (kHoldQ) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[mi][e] = qf[mi][kk][e];
        } else {
          ldmatrix_x4(af[mi], frag_a<D>(qs, wrow + 16 * mi, kk * 16, lane));
        }
      }
#pragma unroll
      for (int np = 0; np < kBlockK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, frag_b<D>(kt, np * 16, kk * 16, lane));
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_bf16(s[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(s[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }

    // scores in base 2 (log2(e) folded into the scale); masks on the
    // fragments: -1e30 past kv_len or the diagonal, -inf past M; then the
    // online softmax, and P as bf16 A fragments (one per 16 keys). A row
    // whose keys are all masked has the max -1e30 and weights 2^0 = 1.
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] *= scale_log2;
      }
    }
    if (k0 + kBlockK > klen || (causal && k0 + kBlockK > q0)) {  // one branch per tile
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= M) {
              s[mi][j][e] = -INFINITY;
            } else if (key >= klen || (causal && key > row[2 * mi + (e >> 1)])) {
              s[mi][j][e] = kNegInf;
            }
          }
        }
      }
    }
    uint32_t pf[kMT][kBlockK / 16][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][j][0], s[mi][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][j][2], s[mi][j][3]));
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = 2 * mi + hi;
        const float mn = fmaxf(m[r], quad_max(mx[hi]));
        const float alpha = ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[mi][j][2 * hi] *= alpha;
          acc[mi][j][2 * hi + 1] *= alpha;
        }
      }
      // l from the unrounded p; p rounded to bf16 only as the PV operand
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        const float p0 = ex2(s[mi][j][0] - m[2 * mi]), p1 = ex2(s[mi][j][1] - m[2 * mi]);
        const float p2 = ex2(s[mi][j][2] - m[2 * mi + 1]);
        const float p3 = ex2(s[mi][j][3] - m[2 * mi + 1]);
        l[2 * mi] += p0 + p1;
        l[2 * mi + 1] += p2 + p3;
        pf[mi][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pf[mi][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
    }

    // O += P V: V's rows are the k index, read transposed; each V fragment
    // feeds the warp's kMT m-tiles
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, frag_bt<D>(vt, kk * 16, dp * 16, lane));
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_bf16(acc[mi][2 * dp], pf[mi][kk], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * dp + 1], pf[mi][kk], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int qlim = q_len ? q_len[b] : N;
  float* lb = lse + static_cast<int64_t>(b) * N * H + h;
  float inv[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    const float lr = quad_sum(l[r]);
    const float safe = lr > 0.f ? lr : 1.f;
    inv[r] = row[r] < qlim ? 1.f / safe : 0.f;
    // lse in base e; a row without keys keeps -1e30 (+ log M rounds away)
    const float lr_e = m[r] == kNegInf ? kNegInf : m[r] * kLn2 + logf(safe);
    if (t == 0 && row[r] < N) lb[static_cast<int64_t>(row[r]) * H] = lr_e;
  }
  // the warp's own Q rows (read only by this warp) stage O
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    store_rows<D>(acc[mi], inv[2 * mi], inv[2 * mi + 1], qs + (wrow + 16 * mi) * T::kStride,
                  q0 + wrow + 16 * mi, N, o + static_cast<int64_t>(b) * N * stride + h * D,
                  stride, lane);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
               cudaStream_t stream) {
  constexpr int kSmem = FwdShape<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_mma_kernel<D><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, q_len, kv_len,
      N, M, H, causal, kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ f32: 3xTF32 on tensor cores --

template <int D> struct Fwd32Shape {
  // 16-row m-tiles per warp: two at D 64, so that each K or V value, split
  // once, feeds two products (at the DiT's [2, 2048^2, 16, 64] 0.558 ms on
  // the H100, against 0.678 with one m-tile and Q held split in registers);
  // one at D 96, where two spill. Q is read again from shared memory and
  // split for each key tile: held split, it would take 2 D registers per
  // m-tile.
  static constexpr int kMT = D == 64 ? 2 : 1;
  static constexpr int kBlockQ = 16 * kMT * kMmaWarps;  // query rows per block
  static constexpr int kSmem = (kMT + 2 * 2) * Tile<D, float>::kElems * 4;  // Q; K, V x 2
};

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_tf32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, const int* __restrict__ q_len,
                          const int* __restrict__ kv_len, int N, int M, int H, int causal,
                          float scale_log2) {
  using T = Tile<D, float>;
  constexpr int kSteps = D / 8;  // k-steps of QK^T, n-tiles of PV
  constexpr int kMT = Fwd32Shape<D>::kMT;
  constexpr int kBlockQ32 = Fwd32Shape<D>::kBlockQ;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [kBlockQ][D + 4]
  float* ks = qs + kMT * T::kElems;            // [2 stages][64][D + 4]
  float* vs = ks + 2 * T::kElems;              // [2 stages][64][D + 4]

  // causal: the last query tiles visit the most key tiles, launch them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kBlockQ32;
  const int wrow = warp * 16 * kMT;  // the warp's first row in the block
  const int64_t stride = static_cast<int64_t>(H) * D;
  const float* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const float* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  // a row without any valid key averages all M keys; otherwise keys past
  // kv_len (and, causal, past the diagonal) carry no weight
  const int kend = klen == 0 ? M : causal ? min(klen, q0 + kBlockQ32) : klen;
  const int ntiles = (kend + kBlockK - 1) / kBlockK;

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    cp_tile<D, kMmaThreads>(qs + mt * T::kElems, qb, q0 + mt * kTileRows, N, stride, tid);
  }
  cp_tile<D, kMmaThreads>(ks, kb, 0, M, stride, tid);
  cp_tile<D, kMmaThreads>(vs, vb, 0, M, stride, tid);
  cp_async_commit();

  // per m-tile mi, rows r[2 mi] = q0 + wrow + 16 mi + g and r[2 mi + 1] = that + 8
  int row[2 * kMT];
  float m[2 * kMT], l[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    row[r] = q0 + wrow + 16 * (r >> 1) + g + 8 * (r & 1);
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[kMT][kSteps][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
  }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBlockK, st = it & 1;
    if (it + 1 < ntiles) {
      cp_tile<D, kMmaThreads>(ks + (st ^ 1) * T::kElems, kb, k0 + kBlockK, M, stride, tid);
      cp_tile<D, kMmaThreads>(vs + (st ^ 1) * T::kElems, vb, k0 + kBlockK, M, stride, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + st * T::kElems;
    const float* vt = vs + st * T::kElems;

    // S = Q K^T: 16 kMT rows x 64 keys per warp, 8 n-tiles per m-tile; Q
    // and K read by ldmatrix as A and the column-major B, each K fragment
    // split once for the warp's kMT m-tiles
    float s[kMT][kBlockK / 8][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t abig[kMT][4], asmall[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        uint32_t raw[4];
        ldmatrix_x4(raw, frag_a<D>(qs, wrow + 16 * mi, kk * 8, lane));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[e], abig[mi][e], asmall[mi][e]);
      }
#pragma unroll
      for (int np = 0; np < kBlockK / 16; ++np) {
        uint32_t raw[4], big[4], small[4];
        ldmatrix_x4(raw, frag_b<D>(kt, np * 16, kk * 8, lane));
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(raw[e], big[e], small[e]);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_tf32x3(s[mi][2 * np], abig[mi], asmall[mi], big[0], big[1], small[0], small[1]);
          mma_tf32x3(s[mi][2 * np + 1], abig[mi], asmall[mi], big[2], big[3], small[2],
                     small[3]);
        }
      }
    }

    // scores in base 2 (log2(e) folded into the scale); masks on the
    // fragments: -1e30 past kv_len or the diagonal, -inf past M; then the
    // online softmax. A row whose keys are all masked has the max -1e30 and
    // weights 2^0 = 1.
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] *= scale_log2;
      }
    }
    if (k0 + kBlockK > klen || (causal && k0 + kBlockK > q0)) {  // one branch per tile
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1);
            if (key >= M) {
              s[mi][j][e] = -INFINITY;
            } else if (key >= klen || (causal && key > row[2 * mi + (e >> 1)])) {
              s[mi][j][e] = kNegInf;
            }
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][j][0], s[mi][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][j][2], s[mi][j][3]));
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int r = 2 * mi + hi;
        const float mn = fmaxf(m[r], quad_max(mx[hi]));
        const float alpha = ex2(m[r] - mn);
        m[r] = mn;
        l[r] *= alpha;
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
          acc[mi][j][2 * hi] *= alpha;
          acc[mi][j][2 * hi + 1] *= alpha;
        }
      }
      // P in place of S, unrounded: it feeds l and, split, the PV product
#pragma unroll
      for (int j = 0; j < kBlockK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] = ex2(s[mi][j][e] - m[2 * mi + (e >> 1)]);
        l[2 * mi] += s[mi][j][0] + s[mi][j][1];
        l[2 * mi + 1] += s[mi][j][2] + s[mi][j][3];
      }
    }

    // O += P V, one k-step per 8 keys. P's accumulator gives thread (g, t)
    // keys 2t and 2t + 1, where the tf32 A fragment wants columns t and
    // t + 4: column t stands for key 2t and column t + 4 for key 2t + 1,
    // and V's B fragment is read from those rows (PV sums over the keys,
    // so the order changes nothing). V's B values are scalar loads from
    // the padded row-major tile (ldmatrix cannot transpose 32-bit
    // elements); with rows D + 4 floats apart the 32 lanes hit 32 banks.
    // Each V value, split once, feeds the warp's kMT m-tiles.
#pragma unroll
    for (int j = 0; j < kBlockK / 8; ++j) {
      uint32_t pbig[kMT][4], psmall[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const uint32_t pa[4] = {__float_as_uint(s[mi][j][0]), __float_as_uint(s[mi][j][2]),
                                __float_as_uint(s[mi][j][1]), __float_as_uint(s[mi][j][3])};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(pa[e], pbig[mi][e], psmall[mi][e]);
      }
      const float* v0 = vt + (8 * j + 2 * t) * T::kStride + g;
#pragma unroll
      for (int dn = 0; dn < kSteps; ++dn) {
        uint32_t b0big, b0small, b1big, b1small;
        split_tf32(__float_as_uint(v0[8 * dn]), b0big, b0small);
        split_tf32(__float_as_uint(v0[T::kStride + 8 * dn]), b1big, b1small);
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_tf32x3(acc[mi][dn], pbig[mi], psmall[mi], b0big, b1big, b0small, b1small);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int qlim = q_len ? q_len[b] : N;
  float* lb = lse + static_cast<int64_t>(b) * N * H + h;
  float inv[2 * kMT];
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    const float lr = quad_sum(l[r]);
    const float safe = lr > 0.f ? lr : 1.f;
    inv[r] = row[r] < qlim ? 1.f / safe : 0.f;
    // lse in base e; a row without keys keeps -1e30 (+ log M rounds away)
    const float lr_e = m[r] == kNegInf ? kNegInf : m[r] * kLn2 + logf(safe);
    if (t == 0 && row[r] < N) lb[static_cast<int64_t>(row[r]) * H] = lr_e;
  }
  // the warp's own Q rows (read only by this warp) stage O
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi) {
    store_rows<D>(acc[mi], inv[2 * mi], inv[2 * mi + 1], qs + (wrow + 16 * mi) * T::kStride,
                  q0 + wrow + 16 * mi, N, o + static_cast<int64_t>(b) * N * stride + h * D,
                  stride, lane);
  }
}

template <int D>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
                cudaStream_t stream) {
  using S = Fwd32Shape<D>;
  constexpr int kSmem = S::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tf32_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + S::kBlockQ - 1) / S::kBlockQ, H, B);
  flash_fwd_tf32_mma_kernel<D><<<grid, kMmaThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, q_len, kv_len, N, M, H, causal,
      kLog2e / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q [B,N,H,D], k/v [B,M,H,D], o like q (all contiguous, 16-byte aligned);
// lse [B,N,H] f32; q_len/kv_len device int32 [B] or null. bf16 launches the
// bf16 tensor-core kernel, f32 the 3xTF32 one. Returns the CUDA error of the
// launch (0 = launched), or cudaErrorInvalidValue for a head dim or dtype
// the kernels have no instance for.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* q_len,
                                   const int* kv_len, int B, int N, int M,
                                   int H, int D, int dtype, int causal,
                                   void* stream) {
  using namespace edgerunner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    return launch_mma<64>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kBFloat16 && D == 96) {
    return launch_mma<96>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 64) {
    return launch_tf32<64>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch_tf32<96>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

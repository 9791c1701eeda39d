// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels `_fwd` (edgerunner_tpu/ops/flash_attention.py:258,
// kernels `_fwd_kernel` / `_fwd_kernel_tri`), its transposed-layout twin
// `_fwd_t` (:785), both reached from `flash_attention` (:1336), and the
// forward of `flash_attention_lse` (:1363). It computes the same function:
// online-softmax attention over q [B,N,H,D] and k/v [B,M,H,D] with per-row
// `kv_len` key masks at -1e30, causal masking (key <= query, only when
// N == M), rows past `q_len` zeroed, and the f32 row log-sum-exp lse
// [B,N,H] on every row. The TPU devices (two layouts, triangular pair
// tables, head grouping) are dropped: one block per (query tile, head,
// batch row) loops over the key tiles.
//
// What bounds it on the H100: operations. At the main path's shapes (the
// point encoder's 2048 x 8192 cross-attention at D 64, the decoder
// prefill's ~2050^2 causal self-attention at D 96, the training step's
// 6147^2 and the ring's blocks) the function does over a thousand
// operations for every byte it must move, far past the card's balance
// point, so the tensor cores set the pace. What the design does about it,
// for bf16 (flash_fwd_mma_kernel): both products run as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulation, as the TPU
// kernel's bf16 dots with preferred_element_type f32. A block of 4 warps
// owns 128 query rows, 32 per warp (two m-tiles, so that every K or V
// fragment read from shared memory feeds two products); the Q tile is
// copied once to shared memory with cp.async, its A fragments held in
// registers at D 64 and read again for each key tile at D 96 (registers).
// K and V tiles of 64 keys stream through a two-stage cp.async ring in
// padded shared tiles (no bank conflicts for ldmatrix), K read by ldmatrix
// as the column-major B of QK^T and V by ldmatrix.trans as the B of PV. The
// scores stay in the f32 accumulator fragments, in base 2 (log2(e) folded
// into the scale, one ex2.approx per weight); masks, the online softmax
// (row max and sum across each quad) and the rescale of O happen there, and
// P is packed to bf16 A fragments in registers for PV. Only tiles that
// reach past kv_len, M or the diagonal take the mask, behind one branch per
// tile. Under causal masking the key loop stops at the diagonal, and the
// heaviest query tiles are launched first. What holds it back: each warp
// runs its products, its exponentials (the MUFU unit, 16 a cycle per SM)
// and its bf16 packing in turn, and mma.sync itself tops out well below
// the card's 989 TFLOP/s. What is left for the wgmma/TMA step: wgmma on
// warpgroup tiles fed by TMA into swizzled tiles, a producer warp, and two
// consumer warpgroups that take turns (one's exponentials under the
// other's products).
//
// f32 inputs take the scalar kernel (flash_fwd_f32_kernel): a tensor-core
// f32 product would be TF32, another function than the TPU kernel's
// full-precision f32 dots. Its products are f32 FMAs from K/V tiles of 32
// keys in shared memory, two threads per query row.
//
// Numerics follow the TPU kernel: scores and accumulators in f32, p rounded
// to bf16 only as the PV operand, l summed from the unrounded p, output
// divided by l where l > 0. Keys masked by kv_len or causality get -1e30, a
// finite value; keys past M (the ragged last tile) get no weight at all. A
// row with no valid key (kv_len 0) visits every key tile with every logit
// at -1e30, so it averages V uniformly over the M keys, as the plain
// version and `attention_reference` do, causal or not; its lse is -1e30.
// Output rows past q_len are zeroed; their lse is computed all the same.

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

// ------------------------------------------------------- f32: scalar --

constexpr int kF32BlockQ = 64;            // query rows per block
constexpr int kF32BlockK = 32;            // keys per shared-memory tile
constexpr int kF32Threads = 2 * kF32BlockQ;  // two threads per query row

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ q_len,
                     const int* __restrict__ kv_len, int N, int M, int H, int causal,
                     float scale) {
  constexpr int kHalf = D / 2;       // each thread's share of the head dim
  constexpr int kRowVecs = D / 4;    // float4 loads per K/V row
  __shared__ __align__(16) float ks[kF32BlockK][D];
  __shared__ __align__(16) float vs[kF32BlockK][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int row = qt * kF32BlockQ + r;
  const bool row_ok = row < N;
  const int64_t stride = static_cast<int64_t>(H) * D;  // between positions

  float qr[kHalf];
  float acc[kHalf];
  {
    const float* qp = q + (static_cast<int64_t>(b) * N + (row_ok ? row : 0)) * stride +
                      h * D + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      qr[d] = row_ok ? qp[d] : 0.f;
      acc[d] = 0.f;
    }
  }

  const int klen = kv_len ? kv_len[b] : M;
  // a row without any valid key averages all M keys, causal or not
  const int kend = causal && klen > 0 ? min(M, (qt + 1) * kF32BlockQ) : M;
  const float* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const float* vb = v + static_cast<int64_t>(b) * M * stride + h * D;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kF32BlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kF32BlockK * kRowVecs; e += kF32Threads) {
      const int j = e / kRowVecs, c = (e % kRowVecs) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (k0 + j < M) {
        kk = *reinterpret_cast<const float4*>(kb + static_cast<int64_t>(k0 + j) * stride + c);
        vv = *reinterpret_cast<const float4*>(vb + static_cast<int64_t>(k0 + j) * stride + c);
      }
      *reinterpret_cast<float4*>(&ks[j][c]) = kk;
      *reinterpret_cast<float4*>(&vs[j][c]) = vv;
    }
    __syncthreads();

    const int nk = min(kF32BlockK, kend - k0);
    float s[kF32BlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      const float* kr = &ks[j][half * kHalf];
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kHalf; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + d);
        dot = fmaf(qr[d], kk.x, dot);
        dot = fmaf(qr[d + 1], kk.y, dot);
        dot = fmaf(qr[d + 2], kk.z, dot);
        dot = fmaf(qr[d + 3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      const int key = k0 + j;
      float sj = dot * scale;
      if (key >= klen || (causal && key > row)) sj = kNegInf;
      s[j] = j < nk ? sj : -INFINITY;  // past M: no weight at all
      m_new = fmaxf(m_new, s[j]);
    }

    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < kF32BlockK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float* vr = &vs[j][half * kHalf];
#pragma unroll
      for (int d = 0; d < kHalf; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float safe_l = l > 0.f ? l : 1.f;
  const bool keep = q_len == nullptr || row < q_len[b];
  float* op = o + (static_cast<int64_t>(b) * N + row) * stride + h * D + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) op[d] = keep ? acc[d] / safe_l : 0.f;
  if (half == 0) lse[(static_cast<int64_t>(b) * N + row) * H + h] = m + logf(safe_l);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
               const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
               cudaStream_t stream) {
  const dim3 grid((N + kF32BlockQ - 1) / kF32BlockQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, q_len, kv_len, N, M, H, causal,
      1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q [B,N,H,D], k/v [B,M,H,D], o like q (all contiguous, 16-byte aligned);
// lse [B,N,H] f32; q_len/kv_len device int32 [B] or null. bf16 launches the
// tensor-core kernel, f32 the scalar one. Returns the CUDA error of the
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
    return launch_f32<64>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch_f32<96>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

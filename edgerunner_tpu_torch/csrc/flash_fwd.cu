// Flash-attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels `_fwd` (edgerunner_tpu/ops/flash_attention.py:258,
// kernels `_fwd_kernel` / `_fwd_kernel_tri`) and its transposed-layout twin
// `_fwd_t` (:785), reached from `flash_attention` (:1336). It computes the
// same function: online-softmax attention over q [B,N,H,D] and k/v [B,M,H,D]
// with per-row `kv_len` key masks at -1e30, causal masking (key <= query,
// only when N == M), rows past `q_len` zeroed, and the f32 row log-sum-exp
// lse [B,N,H]. The TPU devices (two layouts, triangular pair tables, head
// grouping) are dropped: one block per (q tile, head, batch row) loops over
// the key tiles, and causal tiles above the diagonal are skipped by the loop
// bound.
//
// What bounds it on the H100: operations. At the main path's shapes (the
// point encoder's 2048 x 8192 cross-attention at D 64, the decoder
// prefill's ~2050^2 causal self-attention at D 96) the function does over a
// thousand operations for every byte it must move, far past the card's
// balance point. This first version runs the products as scalar f32 FMAs
// from shared memory, so its ceiling is the FMA pipes (67 TFLOP/s), not the
// tensor cores (989 TFLOP/s bf16) that the bound is taken against. What the
// design does about it: each K/V tile is read from device memory once per
// block of 64 query rows and widened to f32 in shared memory, two threads
// share a query row (each keeps half of D in registers), and the score and
// PV loops read shared memory as float4 broadcasts. Tensor-core tiles
// (mma.sync, then wgmma with TMA) are the later step.
//
// Numerics follow the TPU kernel: scores and accumulators in f32, p rounded
// to the input dtype for the PV product (bf16 inputs), l summed from the
// unrounded p, output divided by l where l > 0. Head dims 64 and 96 are
// template instances; 96 is handled by the tiling (two 48-wide halves), not
// by padding the tensors. Keys past M (the ragged last tile) carry no weight,
// so a row with no valid key (kv_len 0) averages V uniformly over the M keys,
// as the plain version does; under causal masking such a row averages over
// the keys of the tiles up to its diagonal tile only, since the tiles above
// are never visited (as in the TPU kernel). Its output is zeroed whenever
// q_len marks the row as padding, as the model's callers do.

#include "common.cuh"

namespace edgerunner {
namespace {

constexpr int kBlockQ = kFwdBlockQ;    // query rows per block
constexpr int kBlockK = 32;            // keys per shared-memory tile
constexpr int kThreads = 2 * kBlockQ;  // two threads per query row

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ q_len,
                 const int* __restrict__ kv_len, int N, int M, int H,
                 int causal, float scale) {
  constexpr int kHalf = D / 2;             // each thread's share of the head dim
  constexpr int kVec = Vec16<T>::N;        // elements per 16-byte load
  constexpr int kRowVecs = D / kVec;       // 16-byte loads per K/V row
  __shared__ __align__(16) float ks[kBlockK][D];
  __shared__ __align__(16) float vs[kBlockK][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int row = qt * kBlockQ + r;
  const bool row_ok = row < N;
  const int64_t stride = static_cast<int64_t>(H) * D;  // between positions

  float qr[kHalf];
  float acc[kHalf];
  {
    const T* qp = q + (static_cast<int64_t>(b) * N + (row_ok ? row : 0)) * stride +
                  h * D + half * kHalf;
#pragma unroll
    for (int d = 0; d < kHalf; ++d) {
      qr[d] = row_ok ? to_float(qp[d]) : 0.f;
      acc[d] = 0.f;
    }
  }

  const int klen = kv_len ? kv_len[b] : M;
  const int kend = causal ? min(M, (qt + 1) * kBlockQ) : M;
  const T* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * M * stride + h * D;
  float m = kNegInf, l = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < kBlockK * kRowVecs; e += kThreads) {
      const int j = e / kRowVecs, c = (e % kRowVecs) * kVec;
      Vec16<T> kk, vv;
      if (k0 + j < M) {
        kk.load(kb + static_cast<int64_t>(k0 + j) * stride + c);
        vv.load(vb + static_cast<int64_t>(k0 + j) * stride + c);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kk.v[i] = vv.v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        ks[j][c + i] = kk.v[i];
        vs[j][c + i] = vv.v[i];
      }
    }
    __syncthreads();

    const int nk = min(kBlockK, kend - k0);
    float s[kBlockK];
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
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
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
      const float pv = round_to<T>(p);
      const float* vr = &vs[j][half * kHalf];
#pragma unroll
      for (int d = 0; d < kHalf; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + d);
        acc[d] = fmaf(pv, vv.x, acc[d]);
        acc[d + 1] = fmaf(pv, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(pv, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(pv, vv.w, acc[d + 3]);
      }
    }
    m = m_new;
  }

  if (!row_ok) return;
  const float safe_l = l > 0.f ? l : 1.f;
  const bool keep = q_len == nullptr || row < q_len[b];
  T* op = o + (static_cast<int64_t>(b) * N + row) * stride + h * D + half * kHalf;
#pragma unroll
  for (int d = 0; d < kHalf; ++d) op[d] = from_float<T>(keep ? acc[d] / safe_l : 0.f);
  if (half == 0) lse[(static_cast<int64_t>(b) * N + row) * H + h] = m + logf(safe_l);
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, float* lse,
            const int* q_len, const int* kv_len, int B, int N, int M, int H,
            int causal, cudaStream_t stream) {
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  flash_fwd_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, q_len, kv_len, N, M,
      H, causal, scale);
}

}  // namespace
}  // namespace edgerunner

// q [B,N,H,D], k/v [B,M,H,D], o like q (all contiguous, 16-byte aligned);
// lse [B,N,H] f32; q_len/kv_len device int32 [B] or null. Returns the CUDA
// error of the launch (0 = launched), or cudaErrorInvalidValue for a head
// dim or dtype the kernel has no instance for.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse, const int* q_len,
                                   const int* kv_len, int B, int N, int M,
                                   int H, int D, int dtype, int causal,
                                   void* stream) {
  using namespace edgerunner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    launch<__nv_bfloat16, 64>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kBFloat16 && D == 96) {
    launch<__nv_bfloat16, 96>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 64) {
    launch<float, 64>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    launch<float, 96>(q, k, v, o, lse, q_len, kv_len, B, N, M, H, causal, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

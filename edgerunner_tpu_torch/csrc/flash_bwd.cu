// Flash-attention backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernels `_bwd` (edgerunner_tpu/ops/flash_attention.py:520,
// kernels `_bwd_dq_kernel[_tri]` :380/:410 and `_bwd_dkv_kernel[_tri]`
// :462/:494) and its transposed-layout twin `_bwd_t` (:1036). It computes the
// same function: from q, k, v [B,N|M,H,D], the forward's f32 row
// log-sum-exp lse [B,N,H], the output gradient dO (already zero in rows past
// q_len) and delta = rowsum(dO * O) [B,N,H] f32 (both prepared by the
// wrapper, as the JAX package prepares delta outside its kernels), it
// recomputes p = exp(s - lse) and forms
//   dv = p^T dO,  ds = p * (dO V^T - delta),  dq = scale * ds K,
//   dk = scale * ds^T Q,
// with the forward's masks: keys past kv_len (or M) and, under causal
// masking (N == M), keys after the query carry no weight and no gradient.
// Two kernels, as on the TPU, so that nothing is accumulated across blocks
// and no atomics are needed: the dq kernel is parallel over (query tile,
// head, row) and loops over the live key tiles; the dk/dv kernel is parallel
// over (key tile, head, row) and loops over the live query tiles.
//
// A row without any valid key (kv_len 0) is the exception. Its logits are
// all the masking constant, so its forward averaged V uniformly over the
// keys it visited (all M; under causal masking the keys of the forward's
// tiles up to its diagonal tile). Its lse is -1e30 whatever that count,
// since -1e30 + log(count) rounds to -1e30 in f32, so exp(s - lse) cannot
// give these weights back; the kernel gives such a row its forward's weights
// 1/count in dv, and no gradient to q or k (the masked logits do not depend
// on them), which is what autograd through the plain version gives.
//
// What bounds it on the H100: operations. The decoder's training shape
// ([2, 6147^2 causal, 16, 96]) needs five products of N*M*D (causal: half)
// and moves a few hundred MB, so it sits far above the card's balance point.
// This first version runs the products as scalar f32 FMAs from shared
// memory, so its ceiling is the FMA pipes (67 TFLOP/s), not the tensor cores
// (989 TFLOP/s bf16) the bound is taken against. What the design does about
// it: each tile of 32 rows is read from device memory once per block of 32
// rows and widened to f32 in shared memory, four threads share a row and
// hold interleaved float4 chunks of it in registers (so a warp's float4
// reads of one shared row hit distinct banks), and the two row dots of a
// pair (s and dp) share one pass. Tensor-core tiles (mma.sync, then wgmma
// with TMA) are the later step.
//
// Numerics follow the TPU kernel: products in f32 from the input values,
// f32 accumulators, and for bf16 inputs p and ds rounded to bf16 before the
// products that take them (`_dq_compute` / `_dkv_compute`); outputs are
// written in the input dtype.

#include "common.cuh"

namespace edgerunner {
namespace {

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

template <typename T> __device__ __forceinline__ void load4(const T* p, float* out);
template <> __device__ __forceinline__ void load4<float>(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
template <> __device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                 float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
}

template <typename T> __device__ __forceinline__ void store4(T* p, const float* in);
template <> __device__ __forceinline__ void store4<float>(float* p, const float* in) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                                  const float* in) {
  uint2 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

// This thread's lanes of the row at `src` (zeros when !ok).
template <typename T, int D>
__device__ __forceinline__ void load_lanes(Lanes<D>& x, const T* src, int part, bool ok) {
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    if (ok) {
      load4<T>(src + 4 * (part + kParts * i), &x.v[4 * i]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x.v[4 * i + e] = 0.f;
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_lanes(T* dst, const Lanes<D>& x, int part, float mul) {
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks; ++i) {
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = x.v[4 * i + e] * mul;
    store4<T>(dst + 4 * (part + kParts * i), y);
  }
}

// Rows [r0, r0 + kTile) of one head of x [., L, H, D] into shared f32 (zero
// past `rows`).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D], const T* base, int r0, int rows,
                                          int64_t stride, int tid) {
  constexpr int kVec = Vec16<T>::N;
  constexpr int kRowVecs = D / kVec;
  for (int e = tid; e < kTile * kRowVecs; e += kThreads) {
    const int j = e / kRowVecs, c = (e % kRowVecs) * kVec;
    Vec16<T> x;
    if (r0 + j < rows) {
      x.load(base + static_cast<int64_t>(r0 + j) * stride + c);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x.v[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) dst[j][c + i] = x.v[i];
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, const int* __restrict__ q_len,
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
  load_lanes<T, D>(qr, q + roff, part, row_ok);
  load_lanes<T, D>(dor, dout + roff, part, row_ok);
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks * 4; ++i) acc.v[i] = 0.f;
  const float lse_r = row_ok ? lse[soff] : 0.f;
  const float delta_r = row_ok ? delta[soff] : 0.f;

  // keys past kv_len (and past M) take no gradient; a row without any valid
  // key gets none at all, and neither does a tile of rows past q_len (dO 0)
  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool live = q_len == nullptr || qt * kRows < q_len[b];
  const int kend = !live ? 0 : causal ? min(klen, (qt + 1) * kRows) : klen;
  const T* kb = k + static_cast<int64_t>(b) * M * stride + h * D;
  const T* vb = v + static_cast<int64_t>(b) * M * stride + h * D;

  for (int k0 = 0; k0 < kend; k0 += kTile) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D>(ks, kb, k0, kend, stride, tid);
    load_tile<T, D>(vs, vb, k0, kend, stride, tid);
    __syncthreads();
    const int nk = min(kTile, kend - k0);
    for (int j = 0; j < nk; ++j) {
      float s, dp;
      quad_dots<D>(qr, ks[j], s, dor, vs[j], dp, part);
      const bool valid = !causal || k0 + j <= row;
      const float p = valid ? expf(s * scale - lse_r) : 0.f;
      axpy_lanes<D>(acc, round_to<T>(p * (dp - delta_r)), ks[j], part);
    }
  }
  if (row_ok) store_lanes<T, D>(dq + roff, acc, part, scale);
}

// dk and dv: one block per (key tile, head, row) loops over the live query
// tiles. dO is zero in rows past q_len, so those rows are skipped.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, const int* __restrict__ q_len,
                     const int* __restrict__ kv_len, int N, int M, int H, int causal,
                     float scale) {
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
  load_lanes<T, D>(kr, k + koff, part, key_ok);
  load_lanes<T, D>(vr, v + koff, part, key_ok);
#pragma unroll
  for (int i = 0; i < Lanes<D>::kChunks * 4; ++i) dka.v[i] = dva.v[i] = 0.f;

  const int klen = kv_len ? min(kv_len[b], M) : M;
  const bool dead = klen == 0;  // no valid key: uniform forward weights
  const int qend = q_len ? min(q_len[b], N) : N;
  // under causal masking, rows before this tile see none of its keys, except
  // the rows of a keyless batch row, which average over whole forward tiles
  const int qstart = causal ? (k0 / kFwdBlockQ) * kFwdBlockQ : 0;
  const int qstop = (dead || k0 < klen) ? qend : qstart;  // keys all past kv_len: nothing
  const T* qb = q + static_cast<int64_t>(b) * N * stride + h * D;
  const T* db = dout + static_cast<int64_t>(b) * N * stride + h * D;

  for (int q0 = qstart; q0 < qstop; q0 += kTile) {
    __syncthreads();
    load_tile<T, D>(qs, qb, q0, qstop, stride, tid);
    load_tile<T, D>(dos, db, q0, qstop, stride, tid);
    if (tid < kTile) {
      const int r = q0 + tid;
      const int64_t o = (static_cast<int64_t>(b) * N + (r < qstop ? r : 0)) * H + h;
      ls[tid] = r < qstop ? lse[o] : 0.f;
      ds_[tid] = r < qstop ? delta[o] : 0.f;
    }
    __syncthreads();
    const int nq = min(kTile, qstop - q0);
    if (dead) {
      for (int i = 0; i < nq; ++i) {
        const int row = q0 + i;
        const int count = causal ? min(M, (row / kFwdBlockQ + 1) * kFwdBlockQ) : M;
        if (key < count) axpy_lanes<D>(dva, round_to<T>(1.f / count), dos[i], part);
      }
      continue;
    }
    for (int i = 0; i < nq; ++i) {
      const int row = q0 + i;
      float s, dp;
      quad_dots<D>(kr, qs[i], s, vr, dos[i], dp, part);
      const bool valid = key < klen && (!causal || key <= row);
      const float p = valid ? expf(s * scale - ls[i]) : 0.f;
      axpy_lanes<D>(dva, round_to<T>(p), dos[i], part);
      axpy_lanes<D>(dka, round_to<T>(p * (dp - ds_[i])), qs[i], part);
    }
  }
  if (key_ok) {
    store_lanes<T, D>(dk + koff, dka, part, scale);
    store_lanes<T, D>(dv + koff, dva, part, 1.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk, void* dv,
           const int* q_len, const int* kv_len, int B, int N, int M, int H, int causal,
           cudaStream_t stream) {
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<dim3((N + kRows - 1) / kRows, H, B), kThreads, 0, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dq), q_len, kv_len, N, M, H, causal,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<T, D><<<dim3((M + kRows - 1) / kRows, H, B), kThreads, 0, stream>>>(
      qt, kt, vt, dt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), q_len, kv_len,
      N, M, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q/dout/dq [B,N,H,D], k/v/dk/dv [B,M,H,D] (all contiguous, 16-byte
// aligned, one dtype); lse and delta [B,N,H] f32; q_len/kv_len device int32
// [B] or null; dout must already be zero in rows past q_len. Launches the dq
// kernel, then the dk/dv kernel, on `stream`. Returns the CUDA error of the
// launches (0 = launched), or cudaErrorInvalidValue for a head dim or dtype
// the kernels have no instance for.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta,
                                   void* dq, void* dk, void* dv, const int* q_len,
                                   const int* kv_len, int B, int N, int M, int H, int D,
                                   int dtype, int causal, void* stream) {
  using namespace edgerunner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    return launch<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len,
                                     B, N, M, H, causal, s);
  } else if (dtype == kBFloat16 && D == 96) {
    return launch<__nv_bfloat16, 96>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len,
                                     B, N, M, H, causal, s);
  } else if (dtype == kFloat32 && D == 64) {
    return launch<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M,
                             H, causal, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch<float, 96>(q, k, v, dout, lse, delta, dq, dk, dv, q_len, kv_len, B, N, M,
                             H, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Single-query decode attention over the packed KV cache, for Hopper
// (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `fused_decode_attention`
// (edgerunner_tpu/ops/decode_attention_pallas.py:139, kernel `_kernel` :51).
// It computes the same function: for each row b and head h, one query
// q[b, h*D:(h+1)*D] attends over the rows [0, index] of the packed caches
// k/v [B, L, H*D], which already hold the new token's row at `index`; the
// scale is 1/sqrt(D); p is rounded to the cache dtype before the PV product,
// which accumulates in f32 (decode_attention_pallas.py:105-116); the output
// is divided by l only where l > 0. Rows past `index` are never read.
//
// What bounds it on the H100: bytes. Every cached K and V element is used
// in one multiply-add per step, so the function does ~1 operation per byte
// (12 rows x ~6k positions x 1536 x 2 caches x 2 bytes is ~0.3 GB per
// layer and step). What the design does about it: the work is split by
// (row, head) and, along the prefix, into chunks of `chunk` positions (split
// KV), so that a decode step launches thousands of blocks and keeps every SM
// streaming; each thread reads the cache in 16-byte loads and neighbouring
// threads read neighbouring bytes of one head's D-wide slice; K and V are
// each read exactly once. Each chunk writes its unnormalised PV sum with its
// max and its sum of p, and a second small kernel merges the chunks through
// their log-sum-exp weights (the TPU kernel's online softmax, across blocks).
// The TPU's block-diagonal "E-matrix" trick for packed heads is not needed:
// a block addresses its head's slice directly.

#include "common.cuh"

namespace edgerunner {
namespace {

constexpr int kThreads = 128;
constexpr int kMaxChunk = 256;

__device__ __forceinline__ float block_reduce(float x, float* scratch, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = is_max ? warp_max(x) : warp_sum(x);
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) r = is_max ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

// grid (splits, H, B): block (s, h, b) reduces positions [s*chunk,
// min((s+1)*chunk, index+1)) of head h in row b.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, float* __restrict__ part_o,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    int B, int L, int H, int index, int chunk, float scale) {
  constexpr int kVec = Vec16<T>::N;     // cache elements per 16-byte load
  constexpr int kG = D / kVec;          // threads that share one cache row
  constexpr int kRows = kThreads / kG;  // cache rows in flight per pass
  __shared__ float part[kMaxChunk][kG + 1];  // +1: conflict-free column reads
  __shared__ float p_s[kMaxChunk];
  __shared__ float acc_s[kRows][D];
  __shared__ float scratch[kThreads / 32];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int c = tid % kG, g = tid / kG;
  const bool active = g < kRows;
  const int k0 = s * chunk;
  const int n = min(k0 + chunk, index + 1) - k0;
  const int64_t hidden = static_cast<int64_t>(H) * D;
  const int64_t col = h * D + c * kVec;
  const T* kb = k + static_cast<int64_t>(b) * L * hidden + col;
  const T* vb = v + static_cast<int64_t>(b) * L * hidden + col;

  Vec16<T> qv;
  qv.load(q + b * hidden + (active ? col : h * D));

  // scores: each thread dots its 16-byte slice of a cache row with q's
  if (active) {
#pragma unroll 4
    for (int j = g; j < n; j += kRows) {
      Vec16<T> kk;
      kk.load(kb + static_cast<int64_t>(k0 + j) * hidden);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) dot = fmaf(qv.v[i], kk.v[i], dot);
      part[j][c] = dot;
    }
  }
  __syncthreads();
  float mx = kNegInf;
  for (int j = tid; j < n; j += kThreads) {
    float sj = 0.f;
#pragma unroll
    for (int cc = 0; cc < kG; ++cc) sj += part[j][cc];
    sj *= scale;
    p_s[j] = sj;
    mx = fmaxf(mx, sj);
  }
  mx = block_reduce(mx, scratch, true);
  float sum = 0.f;
  for (int j = tid; j < n; j += kThreads) {
    const float p = expf(p_s[j] - mx);
    sum += p;
    p_s[j] = round_to<T>(p);
  }
  sum = block_reduce(sum, scratch, false);  // its barriers also publish p_s

  // PV: each thread accumulates its 16-byte column slice over its rows
  float acc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
  if (active) {
#pragma unroll 4
    for (int j = g; j < n; j += kRows) {
      Vec16<T> vv;
      vv.load(vb + static_cast<int64_t>(k0 + j) * hidden);
      const float p = p_s[j];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(p, vv.v[i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc_s[g][c * kVec + i] = acc[i];
  }
  __syncthreads();
  const int64_t slot = (static_cast<int64_t>(s) * B + b) * H + h;
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) o += acc_s[r][d];
    part_o[slot * D + d] = o;
  }
  if (tid == 0) {
    part_m[slot] = mx;
    part_l[slot] = sum;
  }
}

// grid (H, B), one thread per lane of the head: merges the chunks' partial
// sums through their maxima, then divides by the total l where it is > 0.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_o,
                                    const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    T* __restrict__ out, int splits, int B,
                                    int H, int D) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, part_m[(static_cast<int64_t>(s) * B + b) * H + h]);
  float l = 0.f, o = 0.f;
  for (int s = 0; s < splits; ++s) {
    const int64_t slot = (static_cast<int64_t>(s) * B + b) * H + h;
    const float w = expf(part_m[slot] - mx);
    l = fmaf(part_l[slot], w, l);
    o = fmaf(part_o[slot * D + d], w, o);
  }
  out[(static_cast<int64_t>(b) * H + h) * D + d] = from_float<T>(o / (l > 0.f ? l : 1.f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* part_o, float* part_m, float* part_l, int B, int L, int H,
           int index, int chunk, cudaStream_t stream) {
  const int splits = (index + chunk) / chunk;  // ceil((index + 1) / chunk)
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  decode_chunk_kernel<T, D><<<dim3(splits, H, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_o, part_m, part_l, B, L, H, index, chunk,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      part_o, part_m, part_l, static_cast<T*>(out), splits, B, H, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace edgerunner

// q [B, H*D], k/v [B, L, H*D], out like q (contiguous, 16-byte aligned);
// 0 <= index < L; 0 < chunk <= 256. Scratch: part_o f32
// [splits, B, H, D], part_m / part_l f32 [splits, B, H] with splits =
// ceil((index + 1) / chunk). Returns the CUDA error of the launches (0 =
// launched), or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    void* out, float* part_o, float* part_m,
                                    float* part_l, int B, int L, int H, int D,
                                    int index, int chunk, int dtype,
                                    void* stream) {
  using namespace edgerunner;
  if (index < 0 || index >= L || chunk <= 0 || chunk > kMaxChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    return launch<__nv_bfloat16, 64>(q, k, v, out, part_o, part_m, part_l, B, L, H, index, chunk, s);
  } else if (dtype == kBFloat16 && D == 96) {
    return launch<__nv_bfloat16, 96>(q, k, v, out, part_o, part_m, part_l, B, L, H, index, chunk, s);
  } else if (dtype == kFloat32 && D == 64) {
    return launch<float, 64>(q, k, v, out, part_o, part_m, part_l, B, L, H, index, chunk, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch<float, 96>(q, k, v, out, part_o, part_m, part_l, B, L, H, index, chunk, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

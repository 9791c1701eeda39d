// Multi-query decode attention over the bf16 / f32 KV cache at per-row
// positions (kernel D), for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `fused_decode_attention_multi`
// (edgerunner_tpu/ops/decode_attention_pallas.py:585, kernel `_kernel_multi`
// :496). Its int8 and int4 kinds (TPU rows 7, 8, 10, 11) live in
// decode_attention_quant.cu.
// For row b, head h and query t < T, q[b, t, h*D:(h+1)*D] attends over the
// cache rows [0, index[b] + t] of K and V [B, L, H*D], which already hold
// the T new tokens' rows at index[b] .. index[b]+T-1. `index` is an int32
// [B] tensor on the device: the grid is sized from the cache length L and
// each block reads index[b] itself, so a launch needs no host value of a
// position (and no host synchronisation to get one). q * (1/sqrt(D)) is
// rounded to the cache type before QK^T, and p before PV, as the TPU kernel
// rounds its operands (:509-512, :557-559); sums in f32. The output is
// acc / l where l > 0, and acc (zero) where it is not.
//
// What bounds it on the H100: bytes. Each cached K and V element enters T
// multiply-adds (T <= 8), far below the ~300 operations per byte at which
// the card's compute would be the limit. What the design does about it: the
// split-KV scheme of the first decode kernel. Blocks (chunk, head, row) each
// reduce kChunk cache positions, so a step launches thousands of blocks and
// keeps every SM streaming; a block whose chunk starts past index[b]+T-1
// exits at once. Lanes read a cache row's head slice 8 elements at a time
// (16 bytes of bf16), neighbouring lanes on neighbouring bytes, and each K
// and V row is read once for all T queries. A second small kernel merges the
// chunks through their maxima (the TPU kernel's online softmax, across
// blocks); it reads index[b] to know which chunks ran.

#include "common.cuh"

namespace edgerunner {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // cache positions per block
constexpr int kMaxT = 8;

// 8 consecutive elements widened to float: 16 bytes of bf16, 32 of f32.
template <typename E> struct Vec8;

template <> struct Vec8<__nv_bfloat16> {
  float v[8];
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  }
};

template <> struct Vec8<float> {
  float v[8];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
};

// grid (L / kChunk rounded up, H, B): block (s, h, b) reduces the positions
// [s*kChunk, min((s+1)*kChunk, index[b]+T, L)) of head h in row b for all T
// queries. C is the type of the queries, the caches and the output.
template <typename C, int D, int T>
__global__ void __launch_bounds__(kThreads)
multi_chunk_kernel(const C* __restrict__ q, const C* __restrict__ k, const C* __restrict__ v,
                   const int* __restrict__ index, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int B, int L, int H, float scale) {
  constexpr int kG = D / 8;                             // lanes that read one row
  constexpr int kGp = kG <= 8 ? 8 : (kG <= 16 ? 16 : 32);  // a power of two
  constexpr int kRows = kThreads / kGp;                 // rows in flight per pass
  static_assert(kG <= 32 && D % 8 == 0, "head dim");
  __shared__ float p_s[T][kChunk];  // scores, then the probabilities
  __shared__ float acc_s[kWarps][T][D];
  __shared__ float m_s[T], l_s[T];

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int idx = index[b];
  const int k0 = s * kChunk;
  const int n = min(min(k0 + kChunk, idx + T), L) - k0;  // positions read
  if (n <= 0) return;  // the merge pass skips this chunk too

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % kGp, g = tid / kGp;
  const bool on = c < kG;
  const int hidden = H * D;
  const int col = h * D + (on ? c : 0) * 8;
  const int64_t row0 = static_cast<int64_t>(b) * L + k0;

  // the queries' slices, scaled and rounded to the cache type
  float qs[T][8];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    Vec8<C> qv;
    qv.load(q + (static_cast<int64_t>(b) * T + t) * hidden + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) qs[t][i] = round_to<C>(qv.v[i] * scale);
  }

  // scores: the kG lanes of a group dot their slices of one cache row with
  // every query, then sum across the group by shuffles; every lane of a warp
  // runs the same number of passes, so the shuffles are uniform
  for (int j0 = 0; j0 < n; j0 += kRows) {
    const int j = j0 + g;
    float dot[T];
#pragma unroll
    for (int t = 0; t < T; ++t) dot[t] = 0.f;
    if (on && j < n) {
      Vec8<C> kk;
      kk.load(k + (row0 + j) * hidden + col);
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[t] = fmaf(qs[t][i], kk.v[i], dot[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int o = kGp / 2; o > 0; o >>= 1) dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], o);
    }
    if (c == 0 && j < n) {
#pragma unroll
      for (int t = 0; t < T; ++t) p_s[t][j] = dot[t];
    }
  }
  __syncthreads();

  // softmax of each query over its valid positions of the chunk, one warp
  // per query; positions past index[b]+t get p = 0
  for (int t = warp; t < T; t += kWarps) {
    const int nt = min(n, idx + t + 1 - k0);
    float mx = kNegInf;
    for (int j = lane; j < nt; j += 32) mx = fmaxf(mx, p_s[t][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      float p = 0.f;
      if (j < nt) {
        p = expf(p_s[t][j] - mx);
        sum += p;
        p = round_to<C>(p);
      }
      p_s[t][j] = p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[t] = nt > 0 ? mx : kNegInf;
      l_s[t] = sum;
    }
  }
  __syncthreads();

  // PV: each lane accumulates its 8 columns over its rows for every query
  float acc[T][8];
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
  }
  if (on) {
    for (int j = g; j < n; j += kRows) {
      Vec8<C> vv;
      vv.load(v + (row0 + j) * hidden + col);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float p = p_s[t][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[t][i] = fmaf(p, vv.v[i], acc[t][i]);
      }
    }
  }
  // sum the groups of a warp by shuffles, then the warps through shared memory
#pragma unroll
  for (int t = 0; t < T; ++t) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int o = kGp; o < 32; o <<= 1) acc[t][i] += __shfl_xor_sync(0xffffffffu, acc[t][i], o);
    }
  }
  if (lane < kGp && on) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc_s[warp][t][c * 8 + i] = acc[t][i];
    }
  }
  __syncthreads();
  const int64_t slot0 = (static_cast<int64_t>(s) * B + b) * T;  // [splits, B, T, H]
  for (int e = tid; e < T * D; e += kThreads) {
    const int t = e / D, d = e % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += acc_s[w][t][d];
    part_o[((slot0 + t) * H + h) * D + d] = o;
  }
  if (tid < T) {
    part_m[(slot0 + tid) * H + h] = m_s[tid];
    part_l[(slot0 + tid) * H + h] = l_s[tid];
  }
}

// grid (H, B): merges the chunks that ran for row b (those starting before
// min(index[b]+T, L)) through their maxima, then divides by the total l
// where it is > 0. One thread per (query, lane of the head).
template <typename C>
__global__ void multi_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const int* __restrict__ index, C* __restrict__ out,
                                   int B, int L, int H, int D, int T) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int live = max(0, (min(index[b] + T, L) + kChunk - 1) / kChunk);
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) {
    const int t = e / D, d = e % D;
    float mx = kNegInf;
    for (int s = 0; s < live; ++s) {
      mx = fmaxf(mx, part_m[((static_cast<int64_t>(s) * B + b) * T + t) * H + h]);
    }
    float l = 0.f, o = 0.f;
    for (int s = 0; s < live; ++s) {
      const int64_t slot = ((static_cast<int64_t>(s) * B + b) * T + t) * H + h;
      const float w = expf(part_m[slot] - mx);
      l = fmaf(part_l[slot], w, l);
      o = fmaf(part_o[slot * D + d], w, o);
    }
    out[((static_cast<int64_t>(b) * T + t) * H + h) * D + d] =
        from_float<C>(o / (l > 0.f ? l : 1.f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* index;
  void* out;
  float* part_o;
  float* part_m;
  float* part_l;
  int B, L, H;
  float scale;
  cudaStream_t stream;
};

template <typename C, int D, int T>
int launch(const Args& a) {
  const int splits = (a.L + kChunk - 1) / kChunk;
  multi_chunk_kernel<C, D, T><<<dim3(splits, a.H, a.B), kThreads, 0, a.stream>>>(
      static_cast<const C*>(a.q), static_cast<const C*>(a.k), static_cast<const C*>(a.v),
      a.index, a.part_o, a.part_m, a.part_l, a.B, a.L, a.H, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  multi_merge_kernel<C><<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
      a.part_o, a.part_m, a.part_l, a.index, static_cast<C*>(a.out), a.B, a.L, a.H, D, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename C, int D>
int launch_t(const Args& a, int T) {
  switch (T) {
    case 1: return launch<C, D, 1>(a);
    case 2: return launch<C, D, 2>(a);
    case 3: return launch<C, D, 3>(a);
    case 4: return launch<C, D, 4>(a);
    case 5: return launch<C, D, 5>(a);
    case 6: return launch<C, D, 6>(a);
    case 7: return launch<C, D, 7>(a);
    case 8: return launch<C, D, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename C>
int launch_d(const Args& a, int D, int T) {
  if (D == 64) return launch_t<C, 64>(a, T);
  if (D == 96) return launch_t<C, 96>(a, T);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace edgerunner

// q [B, T, H*D] and out like it; k and v [B, L, H*D] caches of q's type
// (dtype kFloat32 or kBFloat16); index int32 [B] on the device. All
// contiguous, 16-byte aligned. Scratch: part_o f32 [splits, B, T, H, D],
// part_m / part_l f32 [splits, B, T, H] with splits = ceil(L / 256). scale is
// 1/sqrt(D) as the caller rounds it to f32. Returns the CUDA error of the
// launches (0 = launched), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int decode_attention_multi_fwd(const void* q, const void* k, const void* v,
                                          const int* index, void* out, float* part_o,
                                          float* part_m, float* part_l, int B, int L, int H,
                                          int D, int T, int dtype, float scale, void* stream) {
  using namespace edgerunner;
  if (B <= 0 || L <= 0 || H <= 0 || T < 1 || T > kMaxT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, index, out, part_o, part_m, part_l, B, L, H, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == kBFloat16) return launch_d<__nv_bfloat16>(a, D, T);
  if (dtype == kFloat32) return launch_d<float>(a, D, T);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Multi-query decode attention over the packed KV cache at per-row
// positions, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces five TPU kernels of edgerunner_tpu/ops/decode_attention_pallas.py:
//   fused_decode_attention_multi    :585 (kernel `_kernel_multi` :496),
//   fused_decode_attention_q8_multi :866 (kernel `_kernel_q8_multi` :626),
//   fused_decode_attention_q8       :445 (kernel `_kernel_q8` :185), which is
//     the second at T = 1 with one position for every row,
//   fused_decode_attention_q4_multi :824 (kernel `_kernel_q4_multi` :716),
//   fused_decode_attention_q4       :401 (kernel `_kernel_q4` :286), which is
//     the fourth at T = 1 with one position for every row.
// For row b, head h and query t < T, q[b, t, h*D:(h+1)*D] attends over the
// cache rows [0, index[b] + t], which already hold the T new tokens' rows at
// index[b] .. index[b]+T-1. `index` is an int32 [B] tensor on the device:
// the grid is sized from the cache length L and each block reads index[b]
// itself, so a launch needs no host value of a position (and no host
// synchronisation to get one).
//
// Three kinds of cache:
//  * bf16 / f32 K and V [B, L, H*D] (TPU row 9): q * (1/sqrt(D)) is rounded
//    to the cache type before QK^T, and p before PV, as the TPU kernel
//    rounds its operands (:509-512, :557-559); sums in f32.
//  * int8 values [B, L, 2*H*D], K in [0, H*D) and V after it, with a bf16
//    scale plane [B, L, 128] whose lane 0 holds the K row's scale and lane
//    `v_lane` (1) the V row's (TPU rows 8 and 11): q * scale and p stay f32;
//    the logits are multiplied by the K scale, l sums p before the V scale,
//    and p is multiplied by the V scale before PV (:638-640, :674-697).
//  * int4 nibbles [B, L, H*D] (TPU rows 7 and 10): K's packed row fills
//    bytes [0, H*D/2), V's the bytes after it, and byte j of a packed row
//    holds lane j of the row in its low nibble and lane j + H*D/2 in its
//    high nibble, sign-extended. A head's lanes thus lie in the low nibbles,
//    the high nibbles, or both (when H*D/2 is not a multiple of D). With
//    per-row scales (`group` 0) the plane and the arithmetic are the int8
//    kind's; with `group` > 0 lanes per scale, each unpacked K lane j is
//    multiplied by plane[j / group] and each V lane by plane[v_lane + j /
//    group] (v_lane 64) before the dots, and the logits and p take no scale
//    (:358-373, :779-803).
// The output is acc / l where l > 0, and acc (zero) where it is not.
//
// What bounds it on the H100: bytes. Each cached K and V element enters T
// multiply-adds (T <= 8), far below the ~300 operations per byte at which
// the card's compute would be the limit. What the design does about it: the
// split-KV scheme of decode_attention.cu. Blocks (chunk, head, row) each
// reduce kChunk cache positions, so a step launches thousands of blocks and
// keeps every SM streaming; a block whose chunk starts past index[b]+T-1
// exits at once. Lanes read a cache row's head slice 8 elements at a time
// (16 bytes of bf16, 8 of int8, 8 of int4 of which they use one nibble
// each), neighbouring lanes on neighbouring bytes, and each K and V row is
// read once for all T queries. The int4 kind reads every byte twice, once
// by the block of head h and once by that of head h +- H/2, which holds the
// other nibble: through L2, which serves the second read, the device
// memory sees each byte about once. A second small kernel merges the chunks
// through their maxima (the TPU kernel's online softmax, across blocks); it
// reads index[b] to know which chunks ran.

#include <type_traits>

#include "common.cuh"

namespace edgerunner {
namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;  // cache positions per block
constexpr int kMaxT = 8;

// 8 consecutive elements widened to float: 16 bytes of bf16, 32 of f32, 8 of int8.
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

template <> struct Vec8<int8_t> {
  float v[8];
  __device__ __forceinline__ void load(const int8_t* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = static_cast<float>(e[i]);
  }
};

// The int4 cache's kind: bytes of two nibbles each.
struct Int4 {};

template <typename C> struct Storage { using T = C; };
template <> struct Storage<Int4> { using T = int8_t; };

// 8 consecutive lanes of a packed int4 row from the 8 bytes at p: their low
// nibbles (shift 0) or their high ones (shift 4), sign-extended.
__device__ __forceinline__ void load_int4(float (&v)[8], const int8_t* p, int shift) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t w = (i < 4 ? raw.x : raw.y) >> (8 * (i & 3) + shift);
    v[i] = static_cast<float>(static_cast<int>((w & 0xFu) ^ 8u) - 8);
  }
}

// 8 lanes of a cache row, widened to float; p points at their first
// element (int4: at the byte that holds them, with their nibble's shift).
template <typename C>
__device__ __forceinline__ void load_row(float (&v)[8], const typename Storage<C>::T* p,
                                         int shift) {
  if constexpr (std::is_same<C, Int4>::value) {
    load_int4(v, p, shift);
  } else {
    Vec8<C> x;
    x.load(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = x.v[i];
  }
}

// Multiplies lanes col .. col+7 by their group scales plane[base + lane / group].
__device__ __forceinline__ void scale_groups(float (&v)[8], const __nv_bfloat16* plane,
                                             int base, int col, int group) {
  const int g0 = col / group;
  if (g0 == (col + 7) / group) {
    const float s = __bfloat162float(plane[base + g0]);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= s;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] *= __bfloat162float(plane[base + (col + i) / group]);
  }
}

// grid (L / kChunk rounded up, H, B): block (s, h, b) reduces the positions
// [s*kChunk, min((s+1)*kChunk, index[b]+T, L)) of head h in row b for all T
// queries. C is the cache's kind (int8_t or Int4 for the quantised caches),
// Q the queries' and the output's type.
template <typename C, typename Q, int D, int T>
__global__ void __launch_bounds__(kThreads)
multi_chunk_kernel(const Q* __restrict__ q, const typename Storage<C>::T* __restrict__ k,
                   const typename Storage<C>::T* __restrict__ v,
                   const __nv_bfloat16* __restrict__ plane,
                   const int* __restrict__ index, float* __restrict__ part_o,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   int B, int L, int H, int row_stride, int group, int v_lane, float scale) {
  constexpr bool kIsInt4 = std::is_same<C, Int4>::value;
  constexpr bool kQuant = kIsInt4 || std::is_same<C, int8_t>::value;
  constexpr int kG = D / 8;                             // lanes that read one row
  constexpr int kGp = kG <= 8 ? 8 : (kG <= 16 ? 16 : 32);  // a power of two
  constexpr int kRows = kThreads / kGp;                 // rows in flight per pass
  static_assert(kG <= 32 && D % 8 == 0, "head dim");
  __shared__ float p_s[T][kChunk];  // scores, then the probabilities
  __shared__ float vs_s[kQuant ? kChunk : 1];
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
  // grouped int4 scales multiply the lanes; the other quantised kinds scale
  // the logits and p by the row's scales
  const bool grouped = kIsInt4 && group > 0;
  // where lanes col .. col+7 lie in a row: int4 keeps them in the low
  // nibbles of bytes col .. col+7 below hidden/2, in the high nibbles of
  // bytes col - hidden/2 .. above it (hidden/2 is a multiple of 8)
  int off = col, shift = 0;
  if constexpr (kIsInt4) {
    if (col >= hidden / 2) {
      off = col - hidden / 2;
      shift = 4;
    }
  }

  // the queries' slices, scaled (and rounded to the cache type for bf16/f32)
  float qs[T][8];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    Vec8<Q> qv;
    qv.load(q + (static_cast<int64_t>(b) * T + t) * hidden + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if constexpr (kQuant) {
        qs[t][i] = qv.v[i] * scale;
      } else {
        qs[t][i] = round_to<C>(qv.v[i] * scale);
      }
    }
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
      float kk[8];
      load_row<C>(kk, k + (row0 + j) * row_stride + off, shift);
      if (grouped) scale_groups(kk, plane + (row0 + j) * 128, 0, col, group);
#pragma unroll
      for (int t = 0; t < T; ++t) {
#pragma unroll
        for (int i = 0; i < 8; ++i) dot[t] = fmaf(qs[t][i], kk[i], dot[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int o = kGp / 2; o > 0; o >>= 1) dot[t] += __shfl_xor_sync(0xffffffffu, dot[t], o);
    }
    if (c == 0 && j < n) {
      float ks = 1.f;
      if constexpr (kQuant) {
        if (!grouped) {
          const __nv_bfloat16* sc = plane + (row0 + j) * 128;
          ks = __bfloat162float(sc[0]);
          vs_s[j] = __bfloat162float(sc[v_lane]);
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) p_s[t][j] = dot[t] * ks;
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
        if constexpr (kQuant) {
          if (!grouped) p *= vs_s[j];
        } else {
          p = round_to<C>(p);
        }
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
      float vv[8];
      load_row<C>(vv, v + (row0 + j) * row_stride + off, shift);
      if (grouped) scale_groups(vv, plane + (row0 + j) * 128, v_lane, col, group);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float p = p_s[t][j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[t][i] = fmaf(p, vv[i], acc[t][i]);
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
template <typename Q>
__global__ void multi_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const int* __restrict__ index, Q* __restrict__ out,
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
        from_float<Q>(o / (l > 0.f ? l : 1.f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* plane;
  const int* index;
  void* out;
  float* part_o;
  float* part_m;
  float* part_l;
  int B, L, H, row_stride, group, v_lane;
  float scale;
  cudaStream_t stream;
};

template <typename C, typename Q, int D, int T>
int launch(const Args& a) {
  using S = typename Storage<C>::T;
  const int splits = (a.L + kChunk - 1) / kChunk;
  multi_chunk_kernel<C, Q, D, T><<<dim3(splits, a.H, a.B), kThreads, 0, a.stream>>>(
      static_cast<const Q*>(a.q), static_cast<const S*>(a.k), static_cast<const S*>(a.v),
      static_cast<const __nv_bfloat16*>(a.plane), a.index, a.part_o, a.part_m, a.part_l,
      a.B, a.L, a.H, a.row_stride, a.group, a.v_lane, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  multi_merge_kernel<Q><<<dim3(a.H, a.B), kThreads, 0, a.stream>>>(
      a.part_o, a.part_m, a.part_l, a.index, static_cast<Q*>(a.out), a.B, a.L, a.H, D, T);
  return static_cast<int>(cudaGetLastError());
}

template <typename C, typename Q, int D>
int launch_t(const Args& a, int T) {
  switch (T) {
    case 1: return launch<C, Q, D, 1>(a);
    case 2: return launch<C, Q, D, 2>(a);
    case 3: return launch<C, Q, D, 3>(a);
    case 4: return launch<C, Q, D, 4>(a);
    case 5: return launch<C, Q, D, 5>(a);
    case 6: return launch<C, Q, D, 6>(a);
    case 7: return launch<C, Q, D, 7>(a);
    case 8: return launch<C, Q, D, 8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// head dims 64 and 96; the int4 kind also 32 (a head that straddles the
// nibble halves at a small width)
template <typename C, typename Q>
int launch_d(const Args& a, int D, int T) {
  if constexpr (std::is_same<C, Int4>::value) {
    if (D == 32) return launch_t<C, Q, 32>(a, T);
  }
  if (D == 64) return launch_t<C, Q, 64>(a, T);
  if (D == 96) return launch_t<C, Q, 96>(a, T);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace edgerunner

// q [B, T, H*D] and out like it; index int32 [B] on the device. cache_dtype
// kFloat32 / kBFloat16: k and v point at [B, L, H*D] caches of q's type
// (row_stride H*D, plane unused); kInt8: k points at the int8 [B, L, 2*H*D]
// values, v at the same tensor plus H*D (row_stride 2*H*D), plane at the bf16
// [B, L, 128] scales; kInt4: k points at the int8 [B, L, H*D] nibbles, v at
// the same tensor plus H*D/2 (row_stride H*D; H*D a multiple of 16), plane
// as for kInt8. With a quantised cache q is f32 or bf16 (q_dtype); `group`
// is 0 for per-row scales (K at plane lane 0, V at lane v_lane = 1) or, int4
// only, the lanes per scale (K's at plane lanes [0, G), V's from v_lane =
// 64). All contiguous, 16-byte aligned. Scratch: part_o f32 [splits, B, T,
// H, D], part_m / part_l f32 [splits, B, T, H] with splits = ceil(L / 256).
// scale is 1/sqrt(D) as the caller rounds it to f32. Returns the CUDA error
// of the launches (0 = launched), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int decode_attention_multi_fwd(const void* q, const void* k, const void* v,
                                          const void* plane, const int* index, void* out,
                                          float* part_o, float* part_m, float* part_l,
                                          int B, int L, int H, int D, int T, int row_stride,
                                          int group, int v_lane, int cache_dtype, int q_dtype,
                                          float scale, void* stream) {
  using namespace edgerunner;
  if (B <= 0 || L <= 0 || H <= 0 || T < 1 || T > kMaxT || group < 0 || v_lane < 0 ||
      v_lane >= 128 || (group > 0 && cache_dtype != kInt4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cache_dtype == kInt4 && ((H * D) % 16 != 0 || (group > 0 && (H * D) % group != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, plane, index, out, part_o, part_m, part_l,
               B, L, H, row_stride, group, v_lane, scale, static_cast<cudaStream_t>(stream)};
  if (cache_dtype == kBFloat16 && q_dtype == kBFloat16) {
    return launch_d<__nv_bfloat16, __nv_bfloat16>(a, D, T);
  } else if (cache_dtype == kFloat32 && q_dtype == kFloat32) {
    return launch_d<float, float>(a, D, T);
  } else if (cache_dtype == kInt8 && q_dtype == kBFloat16) {
    return launch_d<int8_t, __nv_bfloat16>(a, D, T);
  } else if (cache_dtype == kInt8 && q_dtype == kFloat32) {
    return launch_d<int8_t, float>(a, D, T);
  } else if (cache_dtype == kInt4 && q_dtype == kBFloat16) {
    return launch_d<Int4, __nv_bfloat16>(a, D, T);
  } else if (cache_dtype == kInt4 && q_dtype == kFloat32) {
    return launch_d<Int4, float>(a, D, T);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Single-query decode attention over the packed KV cache (kernel B), for
// Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `fused_decode_attention`
// (edgerunner_tpu/ops/decode_attention_pallas.py:139, kernel `_kernel` :51).
// It computes the same function: for each row b and head h, one query
// q[b, h*D:(h+1)*D] attends over the rows [0, index[b]] of the packed caches
// k/v [B, L, H*D], which already hold the new token's row at index[b]; the
// scale is 1/sqrt(D); p is rounded to the cache dtype before the PV product,
// which accumulates in f32 (decode_attention_pallas.py:105-116); the output
// is divided by l only where l > 0. Rows past index[b] are never read. The
// positions are an int32 [B] tensor on the device, read by the kernel (the
// TPU kernel reads them from a scalar-prefetch ref, :55): no host value of a
// position sizes or steers a launch. A position outside [0, L) is clamped
// into it.
//
// What bounds it on the H100: bytes. Every cached K and V element is used
// in one multiply-add per step, so the function does ~1 operation per byte
// (12 rows x ~4k positions x 1536 x 2 caches x 2 bytes is ~0.3 GB per layer
// and step, 0.09 ms at 3.35 TB/s). What the design does about it
// (decode_common.cuh): a persistent grid of as many 4-warp blocks as fit on
// the SMs, whose warps split the live (row, head, 16-row tile) work evenly;
// each warp streams its tiles' K and V rows (a head's 192-byte slice at D
// 96) through a 3-stage ring of 16-byte cp.async copies, so that two tiles'
// bytes are in flight while it scores a third, with one online softmax per
// 8-lane group in base 2 (ex2.approx); the chunks of a (row, head) that
// several warps share merge in the same launch, by the last of them to
// finish. K and V are each read once.

#include "decode_common.cuh"

namespace edgerunner {
namespace {

using decode::Cursor;

// T is the type of the queries, caches and output; D the head dim.
template <typename T, int D>
struct DecodeB {
  struct Params {
    const T* q;
    const T* k;
    const T* v;
    const int* index;
    T* out;
    int B, L, H;
    float scale2;  // 1/sqrt(D) * log2(e): scores in base 2
  };
  static constexpr int kD = D;
  static constexpr int kNS = 1;                   // softmax streams: one head, one query
  static constexpr int kE = D / 8;                // columns per lane
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(T));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies per row
  static constexpr int kGang = 4;       // the warps of a gang take neighbouring heads
  static constexpr int kStages = 3;
  static constexpr int kTileRows = 16;  // cache rows per stage
  static constexpr int kRowsPerGroup = kTileRows / decode::kGroups;
  static constexpr int kMinBlocks = 1;
  static constexpr int kStageBytes = 2 * kTileRows * kRowBytes;  // K rows, then V rows
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kWords = kE * static_cast<int>(sizeof(T)) / 8;  // 8-byte loads per row
  static_assert(kRowBytes % 16 == 0 && (2 * kTileRows * kChunks) % 32 == 0, "row slice");

  const Params& p;  // the kernel's __grid_constant__ parameter: no copy in registers
  const int B, items, real;  // gangs of heads and heads per row
  int sub;             // this warp's head in its gang
  char* extra;         // (no shared memory past the stages)
  float q[kE];
  float m[kNS], l[kNS], acc[kNS][kE];

  __device__ explicit DecodeB(const Params& p_)
      : p(p_), B(p_.B), items((p_.H + kGang - 1) / kGang), real(p_.H) {}

  __device__ __forceinline__ int head(const Cursor& c) const { return c.item * kGang + sub; }
  __device__ __forceinline__ bool has(const Cursor& c) const { return head(c) < p.H; }

  __device__ __forceinline__ int rows(int b) const {
    return min(max(__ldg(p.index + b), 0), p.L - 1) + 1;
  }

  // rows [16 j, 16 j + 16) of head `item` in row b that are < rows, K and V
  __device__ __forceinline__ void issue(char* stage, const Cursor& c) const {
    const int lane = threadIdx.x & 31;
    const int r0 = c.j * kTileRows, nr = min(kTileRows, c.rows - r0);
    const int64_t hidden = static_cast<int64_t>(p.H) * D;
    const int64_t at = (static_cast<int64_t>(c.b) * p.L + r0) * hidden + head(c) * D;
    const char* kb = reinterpret_cast<const char*>(p.k + at);
    const char* vb = reinterpret_cast<const char*>(p.v + at);
    const uint32_t s = smem_addr(stage);
#pragma unroll
    for (int i = 0; i < 2 * kTileRows * kChunks / 32; ++i) {
      const int e = lane + 32 * i;
      const int which = e / (kTileRows * kChunks);
      const int r = (e / kChunks) % kTileRows, ch = e % kChunks;
      if (r < nr) {
        cp_async16(s + which * kTileRows * kRowBytes + r * kRowBytes + ch * 16,
                   (which ? vb : kb) + r * hidden * static_cast<int64_t>(sizeof(T)) + ch * 16,
                   true);
      }
    }
  }

  __device__ __forceinline__ void begin(const Cursor& c) {
    const int col0 = (threadIdx.x & 7) * kE;
    const T* qb = p.q + (static_cast<int64_t>(c.b) * p.H + head(c)) * D + col0;
#pragma unroll
    for (int e = 0; e < kE; ++e) q[e] = to_float(qb[e]) * p.scale2;
    m[0] = kNegInf;
    l[0] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[0][e] = 0.f;
  }

  // this lane's kE elements of a row slice in shared memory, widened
  __device__ __forceinline__ void load(float (&x)[kE], const char* row) const {
    const uint2* src = reinterpret_cast<const uint2*>(row + (threadIdx.x & 7) * kE * sizeof(T));
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint2 u = src[w];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < 8 / static_cast<int>(sizeof(T)); ++i) {
        x[w * (8 / sizeof(T)) + i] = to_float(e[i]);
      }
    }
  }

  __device__ __forceinline__ void consume(const char* stage, const Cursor& c) {
    const int g = (threadIdx.x & 31) >> 3;
    const int live = c.rows - c.j * kTileRows;  // rows of this tile that exist
    float s[kRowsPerGroup];
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      float x[kE];
      load(x, stage + r * kRowBytes);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) dot = fmaf(q[e], x[e], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      s[i] = r < live ? dot : kNegInf;
    }
    float mt = s[0];
#pragma unroll
    for (int i = 1; i < kRowsPerGroup; ++i) mt = fmaxf(mt, s[i]);
    decode::rescale(m[0], l[0], acc[0], mt);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      s[i] = g + decode::kGroups * i < live ? ex2(s[i] - m[0]) : 0.f;
      sum += s[i];
    }
    l[0] += sum;
    const char* vs = stage + kTileRows * kRowBytes;
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      if (r < live) {
        float x[kE];
        load(x, vs + r * kRowBytes);
        const float pr = round_to<T>(s[i]);
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[0][e] = fmaf(pr, x[e], acc[0][e]);
      }
    }
  }

  __device__ __forceinline__ void store(const Cursor& c, int, int col, float x) const {
    p.out[(static_cast<int64_t>(c.b) * p.H + head(c)) * D + col] = from_float<T>(x);
  }
};

template <typename T, int D>
int launch_b(const void* q, const void* k, const void* v, const int* index, void* out,
             float* scratch, int* ticket, int scratch_warps, int B, int L, int H,
             cudaStream_t stream) {
  typename DecodeB<T, D>::Params p{static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), index, static_cast<T*>(out),
                                   B, L, H, decode::kLog2e / sqrtf(static_cast<float>(D))};
  return decode::launch<DecodeB<T, D>>(p, scratch, ticket, scratch_warps, stream);
}

template <typename T, int D>
int warps_b() {
  return decode::grid_blocks<DecodeB<T, D>>() * decode::kWarps;
}

}  // namespace
}  // namespace edgerunner

// Warps of the persistent grid of kernel B for head dim D and dtype: the
// scratch of `decode_attention_fwd` holds 2 slots of D + 4 floats per warp
// (D + 2 rounded up to a multiple of 4).
// Returns < 0 for a head dim or dtype it has no kernel for.
extern "C" int decode_attention_warps(int D, int dtype) {
  using namespace edgerunner;
  if (dtype == kBFloat16 && D == 64) return warps_b<__nv_bfloat16, 64>();
  if (dtype == kBFloat16 && D == 96) return warps_b<__nv_bfloat16, 96>();
  if (dtype == kFloat32 && D == 64) return warps_b<float, 64>();
  if (dtype == kFloat32 && D == 96) return warps_b<float, 96>();
  return -1;
}

// q [B, H*D], k/v [B, L, H*D], out like q (contiguous, 16-byte aligned);
// index int32 [B] on the device. scratch f32 [scratch_warps, 2, D + 4] and
// ticket int32 [B * H], zero before the first launch (each launch leaves it
// zero). Returns the CUDA error of the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* index, void* out, float* scratch, int* ticket,
                                    int scratch_warps, int B, int L, int H, int D, int dtype,
                                    void* stream) {
  using namespace edgerunner;
  if (B <= 0 || L <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBFloat16 && D == 64) {
    return launch_b<__nv_bfloat16, 64>(q, k, v, index, out, scratch, ticket, scratch_warps, B, L, H, s);
  } else if (dtype == kBFloat16 && D == 96) {
    return launch_b<__nv_bfloat16, 96>(q, k, v, index, out, scratch, ticket, scratch_warps, B, L, H, s);
  } else if (dtype == kFloat32 && D == 64) {
    return launch_b<float, 64>(q, k, v, index, out, scratch, ticket, scratch_warps, B, L, H, s);
  } else if (dtype == kFloat32 && D == 96) {
    return launch_b<float, 96>(q, k, v, index, out, scratch, ticket, scratch_warps, B, L, H, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

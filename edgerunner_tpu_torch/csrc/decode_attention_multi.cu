// Multi-query decode attention over the bf16 / f32 KV cache at per-row
// positions (kernel D), for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `fused_decode_attention_multi`
// (edgerunner_tpu/ops/decode_attention_pallas.py:585, kernel `_kernel_multi`
// :496). Its int8 and int4 kinds (TPU rows 7, 8, 10, 11) live in
// decode_attention_quant.cu.
// For row b, head h and query t < T, q[b, t, h*D:(h+1)*D] attends over the
// cache rows [0, index[b] + t] of K and V [B, L, H*D], which already hold
// the T new tokens' rows at index[b] .. index[b]+T-1 (rows at or past L are
// never read). `index` is an int32 [B] tensor on the device, read by the
// kernel: no host value of a position sizes or steers a launch. p is
// rounded to the cache type before PV, as the TPU kernel rounds that
// operand (:557-559); sums in f32. q * (1/sqrt(D)) stays f32, as in kernel
// B (decode_attention.cu): the TPU kernel rounds it too (:509-512), only
// because its MXU takes operands of the cache type; with both roundings
// the outputs sit at the edge of the bf16 tolerance rule against the plain
// version, which keeps q f32, and cross it at the engine's shapes. The
// output is acc / l where l > 0, and acc (zero) where it is not.
//
// What bounds it on the H100: bytes. Each cached K and V element enters T
// multiply-adds (T <= 8), far below the ~300 operations per byte at which
// the card's compute would be the limit (8 slots of ~4.5k positions x 1536
// x 2 caches x 2 bytes is ~0.24 GB per layer and step, 0.072 ms at 3.35
// TB/s). What the design does about it (decode_common.cuh, the skeleton of
// kernel B and the quantised kinds): a persistent grid of as many 4-warp
// blocks as fit on the SMs, whose warps split the live (row, item, tile)
// work evenly from the device positions; an item is a head and a pass over
// the queries (T <= 3 in one pass, more in passes of up to 3, each reading
// the cache once: a lane holds every query of its pass in registers). Each
// warp streams its tiles' K and V head slices (16 cache rows of bf16, 8 of
// f32: 6 KB a stage at D 96 either way) through a 3-stage ring of 16-byte
// cp.async copies, so that two tiles' bytes are in flight while it scores a
// third; each of its four 8-lane groups runs its own base-2 online softmax
// per query over its rows; the partial sums of an item that several warps
// share merge in the same launch, by the last of them to finish (per-item
// tickets). K and V are each read once per pass, and the wrapper's scratch
// and tickets are allocated once per configuration and kept.

#include "decode_common.cuh"

namespace edgerunner {
namespace {

using decode::Cursor;
using decode::queries_per_pass;
using decode::query_passes;

// C is the type of the queries, caches and output; D the head dim; TC the
// queries of a pass.
template <typename C, int D, int TC>
struct DecodeM {
  struct Params {
    const C* q;
    const C* k;
    const C* v;
    const int* index;
    C* out;
    int B, L, H, T, passes;
    float scale;  // 1/sqrt(D) as the caller rounds it to f32
  };
  static constexpr int kD = D;
  static constexpr int kNS = TC;                  // softmax streams: the queries of a pass
  static constexpr int kE = D / 8;                // columns per lane
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C));
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte copies per row
  static constexpr int kGang = 4;       // the warps of a gang take neighbouring heads
  static constexpr int kStages = 3;
  // cache rows per stage: 16 bf16 or 8 f32 rows, the same bytes, so that
  // three blocks fit on an SM in either type
  static constexpr int kTileRows = 32 / static_cast<int>(sizeof(C));
  static constexpr int kRowsPerGroup = kTileRows / decode::kGroups;
  static constexpr int kMinBlocks = 1;
  static constexpr int kStageBytes = 2 * kTileRows * kRowBytes;  // K rows, then V rows
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kWords = kE * static_cast<int>(sizeof(C)) / 8;  // 8-byte loads per row
  static_assert(kRowBytes % 16 == 0 && (2 * kTileRows * kChunks) % 32 == 0, "row slice");

  const Params& p;  // the kernel's __grid_constant__ parameter: no copy in registers
  const int B, items, real;  // gangs of items, and items (passes x heads) per row
  int sub;                   // this warp's item in its gang
  char* extra;               // (no shared memory past the stages)
  // the consumer's item
  int pass, hd, pos;
  float q[TC][kE];
  float m[kNS], l[kNS], acc[kNS][kE];

  __device__ explicit DecodeM(const Params& p_)
      : p(p_), B(p_.B), items((p_.passes * p_.H + kGang - 1) / kGang),
        real(p_.passes * p_.H) {}

  // item c.item * kGang + sub: pass it / H over head it % H
  __device__ __forceinline__ int item(const Cursor& c) const { return c.item * kGang + sub; }
  __device__ __forceinline__ bool has(const Cursor& c) const { return item(c) < real; }

  __device__ __forceinline__ int rows(int b) const {
    return min(max(__ldg(p.index + b), 0) + p.T, p.L);
  }

  // rows [kTileRows j, kTileRows (j + 1)) of the item's head in row b that
  // are < rows, K and V
  __device__ __forceinline__ void issue(char* stage, const Cursor& c) const {
    const int lane = threadIdx.x & 31;
    const int r0 = c.j * kTileRows, nr = min(kTileRows, c.rows - r0);
    const int64_t hidden = static_cast<int64_t>(p.H) * D;
    const int64_t at = (static_cast<int64_t>(c.b) * p.L + r0) * hidden + (item(c) % p.H) * D;
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
                   (which ? vb : kb) + r * hidden * static_cast<int64_t>(sizeof(C)) + ch * 16,
                   true);
      }
    }
  }

  // the pass's queries, scaled by 1/sqrt(D) and taken to base 2, in f32
  __device__ __forceinline__ void begin(const Cursor& c) {
    const int col0 = (threadIdx.x & 7) * kE;
    pass = item(c) / p.H;
    hd = item(c) % p.H;
    pos = max(__ldg(p.index + c.b), 0);
    const float scale2 = p.scale * decode::kLog2e;
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      const int tg = pass * TC + t;
      const C* qb = p.q + ((static_cast<int64_t>(c.b) * p.T + tg) * p.H + hd) * D + col0;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        q[t][e] = tg < p.T ? to_float(qb[e]) * scale2 : 0.f;
      }
      m[t] = kNegInf;
      l[t] = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[t][e] = 0.f;
    }
  }

  // this lane's kE elements of a row slice in shared memory, widened
  __device__ __forceinline__ void load(float (&x)[kE], const char* row) const {
    const uint2* src = reinterpret_cast<const uint2*>(row + (threadIdx.x & 7) * kE * sizeof(C));
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint2 u = src[w];
      const C* e = reinterpret_cast<const C*>(&u);
#pragma unroll
      for (int i = 0; i < 8 / static_cast<int>(sizeof(C)); ++i) {
        x[w * (8 / sizeof(C)) + i] = to_float(e[i]);
      }
    }
  }

  __device__ __forceinline__ void consume(const char* stage, const Cursor& c) {
    const int g = (threadIdx.x & 31) >> 3;
    const int r0 = c.j * kTileRows;
    const int live = c.rows - r0;  // rows of this tile that exist
    // query t of the pass sees the tile's rows r < last[t]
    int last[TC];
#pragma unroll
    for (int t = 0; t < TC; ++t) last[t] = min(live, pos + pass * TC + t + 1 - r0);
    float s[kRowsPerGroup][TC];
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      float x[kE];
      load(x, stage + r * kRowBytes);
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kE; ++e) dot = fmaf(q[t][e], x[e], dot);
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        dot += __shfl_xor_sync(0xffffffffu, dot, 4);
        s[i][t] = r < last[t] ? dot : kNegInf;
      }
    }
    // one online-softmax step per query over the group's rows of the tile
#pragma unroll
    for (int t = 0; t < TC; ++t) {
      float mt = s[0][t];
#pragma unroll
      for (int i = 1; i < kRowsPerGroup; ++i) mt = fmaxf(mt, s[i][t]);
      decode::rescale(m[t], l[t], acc[t], mt);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerGroup; ++i) {
        s[i][t] = g + decode::kGroups * i < last[t] ? ex2(s[i][t] - m[t]) : 0.f;
        sum += s[i][t];
      }
      l[t] += sum;
    }
    // PV, p rounded to the cache type; l summed the unrounded p
    const char* vs = stage + kTileRows * kRowBytes;
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      if (r < live) {
        float x[kE];
        load(x, vs + r * kRowBytes);
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          const float pr = round_to<C>(s[i][t]);
#pragma unroll
          for (int e = 0; e < kE; ++e) acc[t][e] = fmaf(pr, x[e], acc[t][e]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Cursor& c, int st, int col, float x) const {
    const int tg = pass * TC + st;
    if (tg >= p.T) return;
    p.out[((static_cast<int64_t>(c.b) * p.T + tg) * p.H + hd) * D + col] = from_float<C>(x);
  }
};

// calls f.template operator()<C, D, TC>() for the instance that takes
// these arguments; returns cudaErrorInvalidValue where there is none
template <class F>
int dispatch(int dtype, int D, int T, const F& f) {
  const int tc = queries_per_pass(T);
#define ER_M_TC(CC, DD)                                            \
  if (D == DD) {                                                   \
    if (tc == 1) return f.template operator()<CC, DD, 1>();        \
    if (tc == 2) return f.template operator()<CC, DD, 2>();        \
    if (tc == 3) return f.template operator()<CC, DD, 3>();        \
  }
  if (dtype == kBFloat16) {
    ER_M_TC(__nv_bfloat16, 64)
    ER_M_TC(__nv_bfloat16, 96)
  } else if (dtype == kFloat32) {
    ER_M_TC(float, 64)
    ER_M_TC(float, 96)
  }
#undef ER_M_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instance's grid, in warps
struct GridWarps {
  template <typename C, int DD, int TC> int operator()() const {
    return decode::grid_blocks<DecodeM<C, DD, TC>>() * decode::kWarps;
  }
};

struct Launch {
  const void* q;
  const void* k;
  const void* v;
  const int* index;
  void* out;
  float* scratch;
  int* ticket;
  int scratch_warps, B, L, H, T;
  float scale;
  cudaStream_t stream;

  template <typename C, int DD, int TC> int operator()() const {
    using K = DecodeM<C, DD, TC>;
    const typename K::Params p{static_cast<const C*>(q), static_cast<const C*>(k),
                               static_cast<const C*>(v), index, static_cast<C*>(out),
                               B, L, H, T, query_passes(T), scale};
    return decode::launch<K>(p, scratch, ticket, scratch_warps, stream);
  }
};

}  // namespace
}  // namespace edgerunner

// Warps of the persistent grid of kernel D's bf16/f32 instance for (D, T,
// dtype); its scratch holds 2 slots of TC * (D + 2) floats, rounded up to a
// multiple of 4, per warp, TC the queries per pass. Returns < 0 where there
// is no instance.
extern "C" int decode_attention_multi_warps(int D, int T, int dtype) {
  using namespace edgerunner;
  if (T < 1 || T > 8) return -1;
  const int r = dispatch(dtype, D, T, GridWarps{});
  return r == static_cast<int>(cudaErrorInvalidValue) ? -1 : r;
}

// q [B, T, H*D] and out like it; k and v [B, L, H*D] caches of q's type
// (dtype kFloat32 or kBFloat16); index int32 [B] on the device. All
// contiguous, 16-byte aligned. scratch f32 [scratch_warps, 2, slot] (slot as
// above) and ticket int32 [B * passes * H], zero before the first launch
// (each launch leaves it zero). scale is 1/sqrt(D) as the caller rounds it
// to f32. Returns the CUDA error of the launch (0 = launched), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int decode_attention_multi_fwd(const void* q, const void* k, const void* v,
                                          const int* index, void* out, float* scratch,
                                          int* ticket, int scratch_warps, int B, int L, int H,
                                          int D, int T, int dtype, float scale, void* stream) {
  using namespace edgerunner;
  if (B <= 0 || L <= 0 || H <= 0 || T < 1 || T > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Launch run{q, k, v, index, out, scratch, ticket, scratch_warps, B, L, H, T, scale,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, D, T, run);
}

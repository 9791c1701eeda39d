// Multi-query decode attention over the int8 and int4 KV caches at per-row
// positions (kernel D's quantised kinds), for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces four TPU kernels of edgerunner_tpu/ops/decode_attention_pallas.py:
//   fused_decode_attention_q8_multi :866 (kernel `_kernel_q8_multi` :626),
//   fused_decode_attention_q8       :445 (kernel `_kernel_q8` :185), the
//     first at T = 1 with one position for every row,
//   fused_decode_attention_q4_multi :824 (kernel `_kernel_q4_multi` :716),
//   fused_decode_attention_q4       :401 (kernel `_kernel_q4` :286), the
//     third at T = 1 with one position for every row.
// For row b, head h and query t < T, q[b, t, h*D:(h+1)*D] attends over the
// cache rows [0, index[b] + t], which already hold the T new tokens' rows at
// index[b] .. index[b]+T-1 (rows at or past L are never read); `index` is
// an int32 [B] tensor on the device. q * (1/sqrt(D)) and p stay f32.
//  * int8 values [B, L, 2*H*D], K in [0, H*D) and V after it, with a bf16
//    scale plane [B, L, 128] whose lane 0 holds the K row's scale and lane
//    `v_lane` (1) the V row's (TPU rows 8 and 11): the logits are multiplied
//    by the K scale, l sums p before the V scale, and p is multiplied by the
//    V scale before PV (:638-640, :674-697).
//  * int4 nibbles [B, L, H*D] (TPU rows 7 and 10): K's packed row fills
//    bytes [0, H*D/2), V's the bytes after it, and byte j of a packed row
//    holds lane j of the row in its low nibble and lane j + H*D/2 in its
//    high nibble, sign-extended. Per-row scales (`group` 0) as for int8;
//    with `group` > 0 lanes per scale, K lane j is scaled by plane[j / group]
//    and V lane j by plane[v_lane + j / group] (v_lane 64), and the logits
//    and p take no row scale (:358-373, :779-803). Where a group spans whole
//    heads (group a multiple of D), the head's one scale multiplies its dot
//    and its p instead of every lane: the same products, summed in another
//    order.
// The output is acc / l where l > 0.
//
// What bounds it on the H100: bytes, if the arithmetic per byte is kept
// small. Each cached element enters T <= 8 multiply-adds. The kernel before
// this one spent ~110 instructions per cached row and 16-lane group (int to
// float conversions at a quarter of the ALU rate, 4 shuffles per row and
// query, 8-byte loads, one nibble of every int4 byte) and was bound by
// issue. What the design does about it (decode_common.cuh for the grid,
// the cp.async ring and the fused merge):
//  * an int4 item is a pair of heads h and h + H/2, which share their bytes:
//    each byte is read once and both nibbles are used (H odd: one head per
//    item, whose lanes may straddle the nibble halves);
//  * each lane takes 1/8 of a row's slice (12 bytes at D 96: 12 int8 lanes
//    or 2 x 12 int4 lanes) in 4-byte words, and widens them exactly with a
//    byte permute into the mantissa of 2^23 and one subtraction (the values
//    are -128..127 and -8..7; int4 first masks a word's 4 nibbles of a
//    head into its bytes): ~2 operations per element;
//  * 3 shuffles per row, head and query (8-lane groups);
//  * the scales arrive with their tile, as 16-byte copies of the plane
//    chunks that hold them;
//  * the loop is bound by latency more than by issue: short steps of 8
//    rows (2 per lane group) and, at one query per pass, registers capped
//    for 4 blocks (16 warps) per SM, the int4 pairs' queries in shared
//    memory to make room, measured faster than 16-row steps at 2-3 blocks;
//  * queries are taken TC <= 3 at a time (registers): T = 4..8 makes 2 or 3
//    passes over the cache.

#include <type_traits>

#include "decode_common.cuh"

namespace edgerunner {
namespace {

using decode::Cursor;
using decode::queries_per_pass;
using decode::query_passes;

// the item of a quantised launch
constexpr int kQInt8 = 0;      // int8, one head
constexpr int kQInt4Pair = 1;  // int4, heads u and u + H/2, which share their bytes
constexpr int kQInt4 = 2;      // int4, one head (its 8-lane vectors in either nibble)
// where the scales are
constexpr int kScaleRow = 0;   // per row: plane lanes 0 and v_lane
constexpr int kScaleHead = 1;  // one group per head or more: lanes h*D/G, v_lane + h*D/G
constexpr int kScaleLane = 2;  // several groups per head: each lane scaled before the dots

template <int Kind, int D, int TC>
struct DecodeQ {
  struct Params {
    const void* q;
    const int8_t* kv;
    const __nv_bfloat16* plane;
    const int* index;
    void* out;
    int B, L, H, T, row_stride, v_off, group, v_lane, mode, passes, q_bf16;
    float scale2;  // 1/sqrt(D) * log2(e): scores in base 2
  };
  static constexpr int kNH = Kind == kQInt4Pair ? 2 : 1;  // heads of an item
  static constexpr int kNS = kNH * TC;                     // softmax streams
  static constexpr int kD = D;
  static constexpr int kE = D / 8;          // columns of each head per lane (= bytes)
  static constexpr int kWords = D / 32;     // 4-byte words of those bytes
  static constexpr int kSlots = 4;          // plane chunks kept per row (16 bytes each)
  static constexpr int kGang = 4;       // the warps of a gang take neighbouring items
  static constexpr int kStages = 3;
  // 8 cache rows per stage (2 per lane group) and, at one query per pass,
  // registers capped for 4 blocks (16 warps) per SM: fewer rows per step
  // hold fewer registers and run more warps, which this latency-bound loop
  // needs more than longer steps (PERF.md §6)
  static constexpr int kTileRows = 8;
  static constexpr int kRowsPerGroup = kTileRows / decode::kGroups;
  static constexpr int kMinBlocks = TC > 1 ? 1 : 4;
  // a stage: K rows [16][D bytes], V rows [16][D], scale chunks [16][kSlots][16]
  static constexpr int kStageBytes = kTileRows * (2 * D + 16 * kSlots);
  // the int4 pairs keep their scaled queries (2 heads x TC) in shared memory,
  // not in registers: it leaves them room for 4 blocks per SM at one query
  static constexpr bool kQSmem = Kind == kQInt4Pair;
  static constexpr int kWarpBytes = kStages * kStageBytes + (kQSmem ? kNS * D * 4 : 0);
  static_assert(D % 32 == 0 && (Kind == kQInt4 || D % 16 == 0), "head dim");

  const Params& p;  // the kernel's __grid_constant__ parameter: no copy in registers
  const int B, items, units, real;  // gangs of items, units and items per row
  int sub;                          // this warp's item in its gang
  char* extra;                      // kQSmem: the queries [kNS][D] in shared memory
  // the consumer's item
  int pass, unit, pos, ks_off[kNH], vs_off[kNH], shift[kWords];
  float q[kQSmem ? 1 : kNS][kE];
  float m[kNS], l[kNS], acc[kNS][kE];

  __device__ explicit DecodeQ(const Params& p_)
      : p(p_), B(p_.B), items((p_.passes * (p_.H / kNH) + kGang - 1) / kGang),
        units(p_.H / kNH), real(p_.passes * (p_.H / kNH)) {}

  // item c.item * kGang + sub: pass it / units over head (pair) it % units
  __device__ __forceinline__ int item(const Cursor& c) const { return c.item * kGang + sub; }
  __device__ __forceinline__ bool has(const Cursor& c) const { return item(c) < real; }

  __device__ __forceinline__ int rows(int b) const {
    return min(max(__ldg(p.index + b), 0) + p.T, p.L);
  }

  __device__ __forceinline__ int head(int u, int h) const { return u + h * (p.H / 2); }

  // plane lane of the K scale of head hh (kScaleRow: lane 0)
  __device__ __forceinline__ int k_lane(int hh) const {
    return p.mode == kScaleRow ? 0 : hh * D / p.group;
  }

  __device__ __forceinline__ void issue(char* stage, const Cursor& c) const {
    const int lane = threadIdx.x & 31;
    const int u = item(c) % units;
    const int r0 = c.j * kTileRows, nr = min(kTileRows, c.rows - r0);
    const int64_t row0 = static_cast<int64_t>(c.b) * p.L + r0;
    const int8_t* base = p.kv + row0 * p.row_stride;
    const uint32_t s = smem_addr(stage);
    if constexpr (Kind == kQInt4) {
      // one head: its D/8 vectors of 8 lanes, each from the low or the high
      // nibbles, into a row of D bytes
      const int half = p.H * D / 2;
      constexpr int kCopies = 2 * kTileRows * (D / 8);
#pragma unroll
      for (int i = 0; i < (kCopies + 31) / 32; ++i) {
        const int e = lane + 32 * i;
        const int which = e / (kTileRows * D / 8);
        const int r = (e / (D / 8)) % kTileRows, v = e % (D / 8);
        const int l0 = u * D + 8 * v;
        if (e < kCopies && r < nr) {
          decode::cp_async8(s + which * kTileRows * D + r * D + 8 * v,
                    base + static_cast<int64_t>(r) * p.row_stride + which * p.v_off +
                        (l0 < half ? l0 : l0 - half));
        }
      }
    } else {
      // int8 head u, or the int4 pair u: D contiguous bytes of K and of V
      constexpr int kCopies = 2 * kTileRows * (D / 16);
#pragma unroll
      for (int i = 0; i < (kCopies + 31) / 32; ++i) {
        const int e = lane + 32 * i;
        const int which = e / (kTileRows * (D / 16));
        const int r = (e / (D / 16)) % kTileRows, ch = e % (D / 16);
        if (e < kCopies && r < nr) {
          cp_async16(s + which * kTileRows * D + r * D + ch * 16,
                     base + static_cast<int64_t>(r) * p.row_stride + which * p.v_off + u * D +
                         ch * 16,
                     true);
        }
      }
    }
    // the plane chunks that hold this item's scales: per row one (lanes 0
    // and v_lane); per head the K and V chunks of each head
    const int nslots = p.mode == kScaleRow ? 1 : (p.mode == kScaleHead ? 2 * kNH : 0);
    const uint32_t sc = s + 2 * kTileRows * D;
    for (int e = lane; e < kTileRows * nslots; e += 32) {
      const int r = e % kTileRows, slot = e / kTileRows;
      const int kl = k_lane(head(u, slot >> 1));
      const int chunk = ((slot & 1) && p.mode == kScaleHead ? p.v_lane + kl : kl) / 8;
      if (r < nr) cp_async16(sc + (r * kSlots + slot) * 16, p.plane + (row0 + r) * 128 + chunk * 8, true);
    }
  }

  __device__ __forceinline__ void begin(const Cursor& c) {
    const int cl = threadIdx.x & 7;
    pass = item(c) / units;
    unit = item(c) % units;
    const int u = unit;
    pos = max(__ldg(p.index + c.b), 0);
    const int hidden = p.H * D;
#pragma unroll
    for (int h = 0; h < kNH; ++h) {
      const int kl = k_lane(head(u, h));
      // byte offsets of the K and V scales in a row's chunks
      ks_off[h] = p.mode == kScaleRow ? 0 : (2 * h) * 16 + 2 * (kl % 8);
      vs_off[h] = p.mode == kScaleRow ? 2 * p.v_lane : (2 * h + 1) * 16 + 2 * ((p.v_lane + kl) % 8);
#pragma unroll
      for (int t = 0; t < TC; ++t) {
        const int tg = pass * TC + t;
        const int64_t at = (static_cast<int64_t>(c.b) * p.T + tg) * hidden + head(u, h) * D + cl * kE;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          float x = 0.f;
          if (tg < p.T) {
            x = p.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[at + e])
                         : static_cast<const float*>(p.q)[at + e];
          }
          if constexpr (kQSmem) {
            if ((threadIdx.x & 31) < 8) {
              reinterpret_cast<float*>(extra)[(h * TC + t) * D + cl * kE + e] = x * p.scale2;
            }
          } else {
            q[h * TC + t][e] = x * p.scale2;
          }
        }
      }
    }
    if constexpr (Kind == kQInt4) {
      // the nibble of each of this lane's words: low below hidden/2
#pragma unroll
      for (int wd = 0; wd < kWords; ++wd) {
        const int l0 = u * D + ((cl * kE + 4 * wd) / 8) * 8;
        shift[wd] = l0 < hidden / 2 ? 0 : 4;
      }
    }
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      m[s] = kNegInf;
      l[s] = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[s][e] = 0.f;
    }
  }

  // this lane's kE bytes of a row in shared memory, as words
  __device__ __forceinline__ void load(uint32_t (&w)[kWords], const char* row) const {
    const char* src = row + (threadIdx.x & 7) * kE;
    if constexpr (kWords == 2) {  // one 8-byte load: two phases without bank conflicts
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      w[0] = x.x;
      w[1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const uint32_t*>(src)[i];
    }
  }

  // the lanes of word wd for head h, widened exactly: x[0..3] (int8: 4 bytes;
  // int4: the low nibbles (h 0) or the high ones (h 1), or the word's nibble)
  __device__ __forceinline__ void widen(float (&x)[4], uint32_t w, int h, int wd) const {
    if constexpr (Kind == kQInt8) {
      const uint32_t b = w ^ 0x80808080u;  // 2^23 + 128 + value in the mantissa
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + k)) - 8388736.f;
      }
    } else {
      // the 4 nibbles, biased to 0..15, one per byte; then each byte into
      // the mantissa of 2^23 (2^23 + 8 + value)
      const int sh = Kind == kQInt4Pair ? 4 * h : shift[wd];
      const uint32_t b = ((w ^ 0x88888888u) >> sh) & 0x0F0F0F0Fu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7440 + k)) - 8388616.f;
      }
    }
  }

  // grouped scales inside a head: lane j of head hh times plane[base + j / group]
  __device__ __forceinline__ void scale_lanes(float (&x)[4], int64_t row, int hh, int wd,
                                              int base) const {
    const int col = hh * D + (threadIdx.x & 7) * kE + 4 * wd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] *= __bfloat162float(__ldg(p.plane + row * 128 + base + (col + k) / p.group));
    }
  }

  __device__ __forceinline__ float scale_at(const char* chunks, int off) const {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(chunks + off));
  }

  __device__ __forceinline__ void consume(const char* stage, const Cursor& c) {
    const int g = (threadIdx.x & 31) >> 3;
    const int r0 = c.j * kTileRows;
    const int live = c.rows - r0;
    const bool lanes = p.mode == kScaleLane;
    const char* kr = stage;
    const char* vr = stage + kTileRows * D;
    const char* sr = stage + 2 * kTileRows * D;
    const int64_t prow = static_cast<int64_t>(c.b) * p.L + r0;
    float s[kRowsPerGroup][kNS];
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      uint32_t w[kWords];
      load(w, kr + r * D);
      float dot[kNS];
#pragma unroll
      for (int st = 0; st < kNS; ++st) dot[st] = 0.f;
#pragma unroll
      for (int wd = 0; wd < kWords; ++wd) {
#pragma unroll
        for (int h = 0; h < kNH; ++h) {
          float x[4];
          widen(x, w[wd], h, wd);
          if (lanes && r < live) scale_lanes(x, prow + r, head(unit, h), wd, 0);
#pragma unroll
          for (int t = 0; t < TC; ++t) {
            float qv[4];
            if constexpr (kQSmem) {  // 16 bytes: lanes of a group on distinct banks
              const float4 f4 = reinterpret_cast<const float4*>(
                  extra + ((h * TC + t) * D + (threadIdx.x & 7) * kE + 4 * wd) * 4)[0];
              qv[0] = f4.x; qv[1] = f4.y; qv[2] = f4.z; qv[3] = f4.w;
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) qv[k] = q[h * TC + t][4 * wd + k];
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) dot[h * TC + t] = fmaf(qv[k], x[k], dot[h * TC + t]);
          }
        }
      }
#pragma unroll
      for (int st = 0; st < kNS; ++st) {
        dot[st] += __shfl_xor_sync(0xffffffffu, dot[st], 1);
        dot[st] += __shfl_xor_sync(0xffffffffu, dot[st], 2);
        dot[st] += __shfl_xor_sync(0xffffffffu, dot[st], 4);
      }
#pragma unroll
      for (int h = 0; h < kNH; ++h) {
        const float ks = lanes || r >= live ? 1.f : scale_at(sr + r * kSlots * 16, ks_off[h]);
#pragma unroll
        for (int t = 0; t < TC; ++t) {
          const bool ok = r < live && r0 + r <= pos + pass * TC + t;
          s[i][h * TC + t] = ok ? dot[h * TC + t] * ks : kNegInf;
        }
      }
    }
    // one online-softmax step per stream over the group's rows of the tile
#pragma unroll
    for (int st = 0; st < kNS; ++st) {
      const int t = st % TC;
      float mt = s[0][st];
#pragma unroll
      for (int i = 1; i < kRowsPerGroup; ++i) mt = fmaxf(mt, s[i][st]);
      decode::rescale(m[st], l[st], acc[st], mt);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerGroup; ++i) {
        const int r = g + decode::kGroups * i;
        const bool ok = r < live && r0 + r <= pos + pass * TC + t;
        s[i][st] = ok ? ex2(s[i][st] - m[st]) : 0.f;
        sum += s[i][st];
      }
      l[st] += sum;
    }
    // PV: p times the V scale (per row or head), or the lanes scaled
#pragma unroll
    for (int i = 0; i < kRowsPerGroup; ++i) {
      const int r = g + decode::kGroups * i;
      if (r >= live) continue;
      uint32_t w[kWords];
      load(w, vr + r * D);
      float pv[kNS];
#pragma unroll
      for (int h = 0; h < kNH; ++h) {
        const float vs = lanes ? 1.f : scale_at(sr + r * kSlots * 16, vs_off[h]);
#pragma unroll
        for (int t = 0; t < TC; ++t) pv[h * TC + t] = s[i][h * TC + t] * vs;
      }
#pragma unroll
      for (int wd = 0; wd < kWords; ++wd) {
#pragma unroll
        for (int h = 0; h < kNH; ++h) {
          float x[4];
          widen(x, w[wd], h, wd);
          if (lanes) scale_lanes(x, prow + r, head(unit, h), wd, p.v_lane);
#pragma unroll
          for (int t = 0; t < TC; ++t) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[h * TC + t][4 * wd + k] = fmaf(pv[h * TC + t], x[k], acc[h * TC + t][4 * wd + k]);
            }
          }
        }
      }
    }
  }

  __device__ __forceinline__ void store(const Cursor& c, int st, int col, float x) const {
    const int tg = pass * TC + st % TC;
    if (tg >= p.T) return;
    const int64_t at = (static_cast<int64_t>(c.b) * p.T + tg) * p.H * D + head(unit, st / TC) * D + col;
    if (p.q_bf16) {
      static_cast<__nv_bfloat16*>(p.out)[at] = __float2bfloat16(x);
    } else {
      static_cast<float*>(p.out)[at] = x;
    }
  }
};

// the item kind: int4 heads pair when H is even (head dims 64 and 96)
inline int item_kind(int bits, int H, int D) {
  if (bits == 8) return kQInt8;
  return H % 2 == 0 && D != 32 ? kQInt4Pair : kQInt4;
}

// calls f.template operator()<Kind, D, TC>() for the instance that takes
// these arguments; returns cudaErrorInvalidValue where there is none
template <class F>
int dispatch(int bits, int H, int D, int T, const F& f) {
  const int kind = item_kind(bits, H, D), tc = queries_per_pass(T);
#define ER_Q_TC(KIND, DD)                                          \
  if (kind == KIND && D == DD) {                                   \
    if (tc == 1) return f.template operator()<KIND, DD, 1>();      \
    if (tc == 2) return f.template operator()<KIND, DD, 2>();      \
    if (tc == 3) return f.template operator()<KIND, DD, 3>();      \
  }
  ER_Q_TC(kQInt8, 64)
  ER_Q_TC(kQInt8, 96)
  ER_Q_TC(kQInt4Pair, 64)
  ER_Q_TC(kQInt4Pair, 96)
  ER_Q_TC(kQInt4, 32)
  ER_Q_TC(kQInt4, 64)
  ER_Q_TC(kQInt4, 96)
#undef ER_Q_TC
  return static_cast<int>(cudaErrorInvalidValue);
}

// the instance's grid, in warps
struct GridWarps {
  template <int Kind, int DD, int TC> int operator()() const {
    return decode::grid_blocks<DecodeQ<Kind, DD, TC>>() * decode::kWarps;
  }
};

struct Launch {
  const void* q;
  const void* kv;
  const void* plane;
  const int* index;
  void* out;
  float* scratch;
  int* ticket;
  int scratch_warps, B, L, H, T, bits, group, v_lane, mode, q_bf16;
  float scale;
  cudaStream_t stream;

  template <int Kind, int DD, int TC> int operator()() const {
    using K = DecodeQ<Kind, DD, TC>;
    const int hidden = H * DD;
    const typename K::Params p{
        q, static_cast<const int8_t*>(kv), static_cast<const __nv_bfloat16*>(plane), index,
        out, B, L, H, T, bits == 8 ? 2 * hidden : hidden, bits == 8 ? hidden : hidden / 2,
        group, v_lane, mode, query_passes(T), q_bf16, decode::kLog2e * scale};
    return decode::launch<K>(p, scratch, ticket, scratch_warps, stream);
  }
};

}  // namespace
}  // namespace edgerunner

// Warps of the persistent grid of the instance for (bits, H, D, T); its
// scratch holds 2 slots of NH * TC * (D + 2) floats, rounded up to a
// multiple of 4, per warp, NH = 2 heads per
// item for int4 with H even and D 64 or 96 (else 1), TC = queries per pass.
// Returns < 0 where there is no instance.
extern "C" int decode_attention_quant_warps(int bits, int H, int D, int T) {
  using namespace edgerunner;
  if (T < 1 || T > 8 || (bits != 4 && bits != 8) || H <= 0) return -1;
  const int r = dispatch(bits, H, D, T, GridWarps{});
  return r == static_cast<int>(cudaErrorInvalidValue) ? -1 : r;
}

// q [B, T, H*D] (q_dtype f32 or bf16) and out like it; index int32 [B] on the
// device. bits 8: kv the int8 [B, L, 2*H*D] values (K ++ V); bits 4: kv the
// [B, L, H*D] nibbles (H*D a multiple of 16). plane the bf16 [B, L, 128]
// scales: group 0 per row (K at lane 0, V at v_lane < 8), or, int4 only,
// `group` lanes per scale (K's at lanes [0, H*D/group), V's from v_lane).
// scratch f32 [scratch_warps, 2, slot] (slot as above) and ticket int32
// [B * passes * H / NH], zero before the first launch (each launch leaves it
// zero). All contiguous, 16-byte aligned. scale is 1/sqrt(D). Returns the
// CUDA error of the launch (0 = launched), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int decode_attention_quant_fwd(const void* q, const void* kv, const void* plane,
                                          const int* index, void* out, float* scratch,
                                          int* ticket, int scratch_warps, int B, int L, int H,
                                          int D, int T, int bits, int group, int v_lane,
                                          int q_dtype, float scale, void* stream) {
  using namespace edgerunner;
  const int hidden = H * D;
  if (B <= 0 || L <= 0 || H <= 0 || T < 1 || T > 8 || group < 0 || v_lane < 0 ||
      v_lane >= 128 || (q_dtype != kFloat32 && q_dtype != kBFloat16) ||
      (bits == 8 && group != 0) || (bits != 8 && bits != 4) ||
      (bits == 4 && (hidden % 16 != 0 || (group > 0 && hidden % group != 0))) ||
      (group == 0 && v_lane >= 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = group == 0 ? kScaleRow : (group % D == 0 ? kScaleHead : kScaleLane);
  const Launch run{q, kv, plane, index, out, scratch, ticket, scratch_warps, B, L, H, T, bits,
                   group, v_lane, mode, q_dtype == kBFloat16 ? 1 : 0, scale,
                   static_cast<cudaStream_t>(stream)};
  return dispatch(bits, H, D, T, run);
}

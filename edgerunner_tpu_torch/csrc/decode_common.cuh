// The skeleton shared by the decode kernels of decode_attention.cu (kernel
// B) and decode_attention_quant.cu (kernel D's int8 and int4 kinds): a
// persistent grid whose warps split the launch's live work evenly, each
// streaming its cache rows through a cp.async ring of shared-memory stages,
// and a merge of the partial softmax sums fused into the same launch.
//
// Work. A launch attends, for every row b of the batch, its items (a head,
// a pair of heads, times the passes over the queries) over the cache rows
// [0, rows(b)). K::kGang neighbouring items form a gang item, whose
// sub-items the kGang warps of a gang (consecutive warps of a block) take
// side by side, reading neighbouring bytes of the same rows. Each item's
// rows are cut into tiles of K::kTileRows; gang tiles are numbered
// row-major (row b, then gang item, then tile), so the total is known only
// on the device, from the positions. Gang w of the W gangs of the grid owns
// tiles [w*total/W, (w+1)*total/W): every warp gets the same number of tiles
// to within one, whatever the positions, and no block waits in a part-empty
// last wave. A warp's tiles cover one or more items; each item it covers in
// part is a segment.
//
// Streaming. A warp keeps kStages stages of its own in shared memory and
// keeps kStages - 1 tiles in flight (16-byte cp.async, bypassing L1) while it
// computes on the oldest: the K and V rows of a tile arrive together, and the
// next tiles' bytes are in flight while this one's scores are taken. Warps
// never wait for each other: there is no block barrier.
//
// Lanes. A warp is 4 groups of 8 lanes; group g takes rows g, g+4, ... of
// each tile, and lane c of a group the columns [c*D/8, (c+1)*D/8) of each
// head. Each group runs its own online softmax (base 2) over its
// rows, so that a tile needs shuffles only within a group (3 per score),
// and rescales its sums only when its maximum grows by more than 2^8; the
// four groups merge at the end of a segment.
//
// Merge. A segment that covers its whole item writes the output. Otherwise
// the warp writes its partial (the f32 sums of p*v, max and sum of p per
// head and query) to its scratch slot (0 for the warp's first segment, 1 for
// its last), and adds the segment's tile count to the item's int32 ticket;
// the warp whose addition completes the item's tiles merges every segment's
// partial through their maxima, writes the output and resets the ticket to
// 0 for the next launch. One launch, no second kernel.
#pragma once

#include "mma.cuh"

namespace edgerunner {
namespace decode {

constexpr int kWarps = 4;                     // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;                    // row groups of a warp
constexpr float kLog2e = 1.4426950408889634f;

// 8 bytes global -> shared, through L1 (the int4 kind's split vectors).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(src));
}

// A position in a launch's tile order: tile j of item `item` of row b, whose
// item has `tiles` tiles over `rows` cache rows and starts at tile `first`.
struct Cursor {
  int b, item, j, tiles, rows, first;
};

// the first tile of range w of W over `total` tiles (the product in 64 bits)
__device__ __forceinline__ int range_start(int total, int w, int W) {
  return static_cast<int>(static_cast<long long>(total) * w / W);
}

// tiles of K::kTileRows cache rows over `rows` rows
template <class K>
__device__ __forceinline__ int tiles_of(int rows) { return (rows + K::kTileRows - 1) / K::kTileRows; }

// The launch's live tiles, summed by the warp (every lane gets the total).
template <class K>
__device__ __forceinline__ int count_tiles(const K& k) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
  for (int b = lane; b < k.B; b += 32) sum += k.items * tiles_of<K>(k.rows(b));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  return sum;
}

// The cursor at tile t (warp-collective: lanes scan 32 rows at a time).
template <class K>
__device__ __forceinline__ void locate(const K& k, int t, Cursor& c) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int b0 = 0; b0 < k.B; b0 += 32) {
    const int b = b0 + lane;
    const int rows = b < k.B ? k.rows(b) : 0;
    const int n = b < k.B ? k.items * tiles_of<K>(rows) : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += up;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, t < base + incl);
    if (hit) {
      const int f = __ffs(hit) - 1;
      const int before = base + __shfl_sync(0xffffffffu, incl - n, f);
      c.b = b0 + f;
      c.rows = __shfl_sync(0xffffffffu, rows, f);
      c.tiles = tiles_of<K>(c.rows);
      const int r = t - before;
      c.item = r / c.tiles;
      c.j = r % c.tiles;
      c.first = before + c.item * c.tiles;
      return;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// The next tile in the order; the caller never steps past the last one.
template <class K>
__device__ __forceinline__ void advance(const K& k, Cursor& c) {
  if (++c.j < c.tiles) return;
  c.j = 0;
  c.first += c.tiles;
  if (++c.item < k.items) return;
  c.item = 0;
  ++c.b;
  c.rows = k.rows(c.b);
  c.tiles = tiles_of<K>(c.rows);
}

// One online-softmax step of a group for a tile whose largest score is mt
// (base 2): the running maximum m moves, and the sums l and acc are
// rescaled to it, only when mt exceeds it by more than 8, so that most tiles
// skip the rescale and their weights 2^(s - m) stay below 2^8; the final
// division by l and the merges through the maxima are unchanged by where m
// stands.
template <int E>
__device__ __forceinline__ void rescale(float& m, float& l, float (&acc)[E], float mt) {
  if (mt > m + 8.f) {
    const float alpha = ex2(m - mt);
    m = mt;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
  }
}

// The four groups' softmax states become one (each lane then holds the
// merged sums of its columns): maxima by shuffles across groups, each
// group's sums rescaled to the common maximum, then added.
template <class K>
__device__ __forceinline__ void merge_groups(K& k) {
#pragma unroll
  for (int s = 0; s < K::kNS; ++s) {
    float mx = k.m[s];
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float f = ex2(k.m[s] - mx);
    float l = k.l[s] * f;
    l += __shfl_xor_sync(0xffffffffu, l, 8);
    l += __shfl_xor_sync(0xffffffffu, l, 16);
    k.m[s] = mx;
    k.l[s] = l;
#pragma unroll
    for (int e = 0; e < K::kE; ++e) {
      float a = k.acc[s][e] * f;
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      k.acc[s][e] = a;
    }
  }
}

// End of a segment: tiles [seg, end) of the item at cursor c, in the range
// [t0, t1) of range w of W over `total` tiles. Scratch: per warp two slots of
// kNS * (D + 2) floats (sums [kNS][D], maxima [kNS], sums of p [kNS]);
// ticket: one int32 per (row, item), 0 between launches.
template <class K>
__device__ __forceinline__ void finish_segment(K& k, const Cursor& c, int seg, int end, int t0,
                                               int total, int w, int W, float* __restrict__ scratch,
                                               int* __restrict__ ticket) {
  // a slot: sums [kNS][D], maxima [kNS], sums of p [kNS], padded to 16 bytes
  constexpr int D = K::kD, kNS = K::kNS, kSlot = (kNS * (D + 2) + 3) / 4 * 4;
  constexpr int kQuads = kNS * D / 4, kPer = (kQuads + 31) / 32;  // float4s of the sums
  constexpr int G = K::kGang;
  const int lane = threadIdx.x & 31, col0 = (lane & 7) * K::kE;
  merge_groups(k);
  if (seg == c.first && end == c.first + c.tiles) {  // the whole item: write it
    if (lane < 8) {
#pragma unroll
      for (int s = 0; s < kNS; ++s) {
        const float inv = 1.f / (k.l[s] > 0.f ? k.l[s] : 1.f);
#pragma unroll
        for (int e = 0; e < K::kE; ++e) k.store(c, s, col0 + e, k.acc[s][e] * inv);
      }
    }
    return;
  }
  // the slot of this segment: the warp's first (0) or last (1)
  float* mine = scratch + (2ll * (w * G + k.sub) + (seg == t0 ? 0 : 1)) * kSlot;
  if (lane < 8) {
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
#pragma unroll
      for (int e = 0; e < K::kE; ++e) mine[s * D + col0 + e] = k.acc[s][e];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      mine[kNS * D + s] = k.m[s];
      mine[kNS * D + kNS + s] = k.l[s];
    }
  }
  __threadfence();
  __syncwarp();
  const int unit = c.b * k.real + c.item * G + k.sub;  // its (row, item) ticket
  int last = 0;
  if (lane == 0) {
    const int add = end - seg;
    last = atomicAdd(ticket + unit, add) + add == c.tiles;
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();
  // Every segment of the item: ranges warp_of(first) .. warp_of(last tile)
  // that are not empty; a segment is its range's first (slot 0) when the
  // range starts inside the item. Lanes take the segments 32 at a time: the
  // maxima, then each segment's weight, then the weighted sums, every load
  // of a pass independent of the others.
  const int u0 = c.first, u1 = c.first + c.tiles;
  const int wa = static_cast<int>(((u0 + 1ll) * W - 1) / total);
  const int n = static_cast<int>((static_cast<long long>(u1) * W - 1) / total) - wa + 1;
  auto slot = [&](int i) -> int {  // float offset of segment i's slot, or -1
    const int v = wa + i;
    const int a = range_start(total, v, W);
    if (i >= n || a == range_start(total, v + 1, W)) return -1;
    return (2 * (v * G + k.sub) + (a >= u0 ? 0 : 1)) * kSlot;
  };
  float mx[kNS];
#pragma unroll
  for (int s = 0; s < kNS; ++s) mx[s] = kNegInf;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int off = slot(i0 + lane);
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      mx[s] = fmaxf(mx[s], warp_max(off < 0 ? kNegInf : __ldcg(scratch + off + kNS * D + s)));
    }
  }
  // lane owns float4 q = lane + 32 i of the sums (stream q / (D / 4))
  float l[kNS];
  float4 o[kPer];
#pragma unroll
  for (int s = 0; s < kNS; ++s) l[s] = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int off = slot(i0 + lane);
    float f[kNS];
#pragma unroll
    for (int s = 0; s < kNS; ++s) {
      f[s] = off < 0 ? 0.f : ex2(__ldcg(scratch + off + kNS * D + s) - mx[s]);
      l[s] += warp_sum(off < 0 ? 0.f : __ldcg(scratch + off + kNS * D + kNS + s) * f[s]);
    }
    const int m = min(32, n - i0);
#pragma unroll 8
    for (int j = 0; j < m; ++j) {
      const int oj = __shfl_sync(0xffffffffu, off, j);
      float fj[kNS];
#pragma unroll
      for (int s = 0; s < kNS; ++s) fj[s] = __shfl_sync(0xffffffffu, f[s], j);
      if (oj < 0) continue;
      const float4* src = reinterpret_cast<const float4*>(scratch + oj);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int qd = lane + 32 * i;
        if (qd < kQuads) {
          float w = fj[0];
#pragma unroll
          for (int s = 1; s < kNS; ++s) w = qd >= s * (D / 4) ? fj[s] : w;
          const float4 x = __ldcg(src + qd);
          o[i].x = fmaf(x.x, w, o[i].x);
          o[i].y = fmaf(x.y, w, o[i].y);
          o[i].z = fmaf(x.z, w, o[i].z);
          o[i].w = fmaf(x.w, w, o[i].w);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int qd = lane + 32 * i;
    if (qd < kQuads) {
      const int s = qd / (D / 4), d = (qd % (D / 4)) * 4;
      float ls = l[0];
#pragma unroll
      for (int t = 1; t < kNS; ++t) ls = s == t ? l[t] : ls;
      const float inv = 1.f / (ls > 0.f ? ls : 1.f);
      k.store(c, s, d, o[i].x * inv);
      k.store(c, s, d + 1, o[i].y * inv);
      k.store(c, s, d + 2, o[i].z * inv);
      k.store(c, s, d + 3, o[i].w * inv);
    }
  }
  if (lane == 0) atomicExch(ticket + unit, 0);
}

// One warp's share of the launch: the tiles of its range streamed through
// its stages, `ring` (kStages * K::kStageBytes of shared memory), segment by
// segment. The kGang warps of a gang (consecutive warps of a block) share a
// range and take its items' sub-items sub = 0 .. kGang-1 (K::sub), so that
// they read neighbouring bytes of the same cache rows at the same time.
template <class K>
__device__ __forceinline__ void run_warp(K& k, char* ring, float* __restrict__ scratch,
                                         int* __restrict__ ticket) {
  constexpr int S = K::kStages, G = K::kGang;
  const int wp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int W = gridDim.x * (kWarps / G), w = wp / G;
  k.sub = wp % G;
  const int total = count_tiles(k);
  const int t0 = range_start(total, w, W), t1 = range_start(total, w + 1, W);
  if (t0 >= t1) return;
  const int count = static_cast<int>(t1 - t0);
  Cursor pc, cc;
  locate(k, t0, pc);
  cc = pc;
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    if (i < count) {
      if (k.has(pc)) k.issue(ring + i * K::kStageBytes, pc);
      if (i + 1 < count) advance(k, pc);
    }
    cp_async_commit();
  }
  // segment by segment: a tight loop over the segment's tiles, then its end
  for (int i = 0; i < count;) {
    const bool on = k.has(cc);  // the gang's last item may lack this warp's sub-item
    if (on) k.begin(cc);
    const int seg = t0 + i, last = i + min(count - i, cc.tiles - cc.j);
    for (; i < last; ++i) {
      const int ahead = i + S - 1;
      if (ahead < count) {
        if (k.has(pc)) k.issue(ring + (ahead % S) * K::kStageBytes, pc);
        if (ahead + 1 < count) advance(k, pc);
      }
      cp_async_commit();
      cp_async_wait<S - 1>();
      __syncwarp();
      if (on) k.consume(ring + (i % S) * K::kStageBytes, cc);
      __syncwarp();  // the stage is refilled in the next iteration
      ++cc.j;
    }
    if (on) finish_segment(k, cc, seg, t0 + i, t0, total, w, W, scratch, ticket);
    if (i < count) {  // on to the next item
      cc.j = cc.tiles - 1;
      advance(k, cc);
    }
  }
}

template <class K>
__global__ void __launch_bounds__(kThreads, K::kMinBlocks)
decode_kernel(const __grid_constant__ typename K::Params p, float* __restrict__ scratch,
              int* __restrict__ ticket) {
  extern __shared__ __align__(16) char smem[];
  K k(p);
  char* mine = smem + (threadIdx.x >> 5) * K::kWarpBytes;
  k.extra = mine + K::kStages * K::kStageBytes;  // the warp's bytes after its stages
  run_warp(k, mine, scratch, ticket);
}

// Blocks of the persistent grid: as many as fit on every SM at once.
template <class K>
int grid_blocks() {
  static const int blocks = [] {
    const int smem = kWarps * K::kWarpBytes;
    cudaFuncSetAttribute(decode_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<K>, kThreads, smem);
    return sms * per_sm;
  }();
  return blocks;
}

// Launches K over a scratch of `scratch_warps` warps' slots; returns the CUDA
// error (0 = launched).
template <class K>
int launch(const typename K::Params& p, float* scratch, int* ticket, int scratch_warps,
           cudaStream_t stream) {
  const int blocks = grid_blocks<K>();
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks * kWarps > scratch_warps) return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<K><<<blocks, kThreads, kWarps * K::kWarpBytes, stream>>>(
      p, scratch, ticket);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
}  // namespace edgerunner

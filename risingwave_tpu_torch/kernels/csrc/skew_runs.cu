// Hand-written CUDA kernels (sm_90a) for the ★ key-skew telemetry cores
// of risingwave_tpu/device/skew_stats.py:
//
//   vnode_occupancy :69, vnode_traffic :84  -> rw_vnode_hists
//   epoch_topk :102 (after its sort), weighted_topk :129
//                                           -> rw_topk_packed
//
// In the JAX package the histogram is a [16, n] one-hot sum over the
// CRC32 vnode of every key (core/vnode.py crc32_u64_jnp :246), and the
// top-K a pack plus lax.top_k. Both move a few bytes per row and do a
// little integer work, so they are bound by the bytes they read: 8 per
// key, plus 1 per live flag and 8 per weight or count.
//
// rw_vnode_hists: one launch for all of a keyed node's histograms (its
// key tables' occupancy, its input's traffic), so the host pays one call
// per node and epoch. A bucket is four parities of the key under fixed
// masks (bits 4..7 of the CRC, affine in the key's bits: 4 x (AND +
// POPC), no table). Each thread counts into its own column of shared
// counters (cnt[bucket][thread]: no atomics, no bank conflicts; 32-bit
// unless a table is weighted), keys read two at a time with 16-byte
// loads over a grid of at most two blocks per SM, dealt to the tables in
// proportion to their rows, so all of a node's tables are read at once.
// Each block adds its sums into a persistent accumulator (an atomic a
// bucket); the last block to finish, found by a persistent counter,
// takes the rows out and leaves both zero, so nothing is filled before
// the launch. Only thread 0 of a block fences and counts, as a grid
// barrier does: a fence in every thread, and a last block summing every
// block's stored sums, lengthened the launch.
//
// rw_topk_packed: each thread keeps its own top 4 in registers over a
// grid-stride loop; a shuffle butterfly merges the warp's lists (each
// step merges two disjoint groups of lanes, so no value counts twice),
// one thread merges the block's warps, and a one-block second launch of
// the same kernel merges the blocks' lists. In runs mode a thread at the
// start of a run of equal keys finds the run's end by a binary search.
// Simple and correct first: no vectorised loads.
#include "skew_runs.h"

#include "rw_common.cuh"

#include <type_traits>

namespace {

constexpr int BUCKETS = 16;
constexpr int KEY_BITS = 40;
constexpr int64_t KEY_MASK = (int64_t(1) << KEY_BITS) - 1;
constexpr int64_t COUNT_MAX = (int64_t(1) << 22) - 1;
constexpr int64_t MAX_BLOCKS = 1024;

struct HistMasks {
  uint64_t m0, m1, m2, m3;
  int flip;
};

__device__ __forceinline__ int parity_bucket(int64_t key, const HistMasks& h) {
  const uint64_t k = uint64_t(key);
  return ((__popcll(k & h.m0) & 1) | (__popcll(k & h.m1) & 1) << 1 |
          (__popcll(k & h.m2) & 1) << 2 | (__popcll(k & h.m3) & 1) << 3) ^
         h.flip;
}

// Counter column of thread t: C[bucket * BLOCK + t], 32- or 64-bit.
template <bool WIDE>
struct HistCol {
  using T = typename std::conditional<WIDE, unsigned long long,
                                      unsigned>::type;
  T* c;
  __device__ __forceinline__ void add(int64_t key, bool live, int64_t w,
                                      const HistMasks& h) const {
    if (live) c[parity_bucket(key, h) * BLOCK] += T(w);
  }
};

// One table's rows i = gt, gt + gs, ... (pairs of keys when the keys,
// and the weights if any, are 16-byte aligned; four pairs in flight).
template <bool WIDE>
__device__ __forceinline__ void hist_table(const RwHistSeg g,
                                           int64_t empty_key,
                                           const HistMasks& h,
                                           HistCol<WIDE> col, int64_t gt,
                                           int64_t gs) {
  const int64_t n = g.n;
  const bool vec =
      (reinterpret_cast<uintptr_t>(g.keys) & 15) == 0 &&
      (!g.weights || (reinterpret_cast<uintptr_t>(g.weights) & 15) == 0);
  const int64_t np = vec ? n / 2 : 0;
  const longlong2* k2 = reinterpret_cast<const longlong2*>(g.keys);
  const longlong2* w2 = reinterpret_cast<const longlong2*>(g.weights);
  constexpr int U = 4;
  int64_t p = gt;
  for (; p + (U - 1) * gs < np; p += U * gs) {
    longlong2 k[U], w[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      k[u] = k2[p + u * gs];
      w[u] = WIDE && g.weights ? w2[p + u * gs] : make_longlong2(1, 1);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = 2 * (p + u * gs);
      const bool l0 = g.live ? g.live[i] != 0 : k[u].x != empty_key;
      const bool l1 = g.live ? g.live[i + 1] != 0 : k[u].y != empty_key;
      col.add(k[u].x, l0, w[u].x, h);
      col.add(k[u].y, l1, w[u].y, h);
    }
  }
  for (; p < np; p += gs) {
    const longlong2 k = k2[p];
    const longlong2 w = WIDE && g.weights ? w2[p] : make_longlong2(1, 1);
    const bool l0 = g.live ? g.live[2 * p] != 0 : k.x != empty_key;
    const bool l1 = g.live ? g.live[2 * p + 1] != 0 : k.y != empty_key;
    col.add(k.x, l0, w.x, h);
    col.add(k.y, l1, w.y, h);
  }
  for (int64_t i = 2 * np + gt; i < n; i += gs) {
    const int64_t k = g.keys[i];
    col.add(k, g.live ? g.live[i] != 0 : k != empty_key,
            WIDE && g.weights ? g.weights[i] : 1, h);
  }
}

// The blocks are dealt to the non-empty tables, one each and the rest in
// proportion to their rows: table s takes the blocks before end[s]
// (end[s] = end[s - 1] for an empty table; idle blocks after the last).
// Constant indices into the argument block only (a computed one would
// copy it to local memory).
struct HistDeal {
  int64_t end[RW_HIST_SEGS];
};

__device__ __forceinline__ HistDeal hist_deal(const RwHistArgs& a) {
  int64_t n = 0, ne = 0;
#pragma unroll
  for (int s = 0; s < RW_HIST_SEGS; ++s) {
    if (s < a.nseg && a.seg[s].n > 0) {
      n += a.seg[s].n;
      ++ne;
    }
  }
  const int64_t spare = int64_t(gridDim.x) - ne;
  HistDeal d;
  int64_t first = 0;
#pragma unroll
  for (int s = 0; s < RW_HIST_SEGS; ++s) {
    if (s < a.nseg && a.seg[s].n > 0) first += 1 + spare * a.seg[s].n / n;
    d.end[s] = first;
  }
  return d;
}

// Block b's table (its index, or RW_HIST_SEGS: idle).
__device__ __forceinline__ int hist_table_of(const HistDeal& d, int64_t b) {
  int s = 0;
#pragma unroll
  for (int k = 0; k < RW_HIST_SEGS; ++k) s += b >= d.end[k];
  return s;
}

__global__ void __launch_bounds__(BLOCK)
k_vnode_hists(RwHistArgs a, int64_t* out, unsigned* done,
              unsigned long long* acc) {
  __shared__ unsigned long long C[BUCKETS * BLOCK];   // 32 KB
  __shared__ int last_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const HistDeal d = hist_deal(a);
  const int own = hist_table_of(d, blockIdx.x);
  RwHistSeg g{nullptr, nullptr, nullptr, 0, 0};
  int64_t first = 0, count = 0;
#pragma unroll
  for (int s = 0; s < RW_HIST_SEGS; ++s) {
    if (own == s) {
      g = a.seg[s];
      first = s == 0 ? 0 : d.end[s - 1];
      count = d.end[s] - first;
    }
  }
  if (g.n > 0) {
    const HistMasks h{a.mask[0], a.mask[1], a.mask[2], a.mask[3],
                      int(a.flip)};
    const int64_t gt = (int64_t(blockIdx.x) - first) * BLOCK + t;
    const int64_t gs = count * BLOCK;
    const bool wide = g.weights != nullptr;
    unsigned* C32 = reinterpret_cast<unsigned*>(C);
#pragma unroll
    for (int b = 0; b < BUCKETS; ++b) {
      if (wide) C[b * BLOCK + t] = 0; else C32[b * BLOCK + t] = 0;
    }
    if (wide)
      hist_table<true>(g, a.empty_key, h, HistCol<true>{C + t}, gt, gs);
    else
      hist_table<false>(g, a.empty_key, h, HistCol<false>{C32 + t}, gt, gs);
    __syncthreads();
    // warp w sums buckets 2w and 2w + 1 over the block's columns and adds
    // them into its table's row
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      const int b = 2 * warp + bb;
      int64_t v = 0;
#pragma unroll
      for (int k = 0; k < BLOCK / 32; ++k) {
        const int col = b * BLOCK + k * 32 + lane;
        v += wide ? int64_t(C[col]) : int64_t(C32[col]);
      }
      v = warp_sum64(v);
      if (lane == 0 && v != 0)
        atomicAdd(acc + g.row * BUCKETS + b, (unsigned long long)(v));
    }
  }
  // the last block to finish (one fence and one count a block, as a grid
  // barrier does) takes the rows out of the accumulator, leaving it zero
  __syncthreads();
  if (t == 0) {
    __threadfence();
    last_s = atomicAdd(done, 1u) == gridDim.x - 1;
    if (last_s) __threadfence();
  }
  __syncthreads();
  if (!last_s) return;
  if (t < a.rows * BUCKETS) {
    const int64_t v = int64_t(atomicExch(acc + t, 0ULL));
    out[t] = a.add ? out[t] + v : v;
  }
  if (t == 0) *done = 0u;
}

// t[0] >= t[1] >= t[2] >= t[3]: insert x, keeping the 4 largest (with
// multiplicity). Fixed indices only, so t stays in registers.
__device__ __forceinline__ void top4_insert(long long (&t)[4], long long x) {
  if (x <= t[3]) return;
  if (x > t[0]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = t[0]; t[0] = x;
  } else if (x > t[1]) {
    t[3] = t[2]; t[2] = t[1]; t[1] = x;
  } else if (x > t[2]) {
    t[3] = t[2]; t[2] = x;
  } else {
    t[3] = x;
  }
}

__device__ __forceinline__ long long pack(int64_t key, int64_t count) {
  const int64_t c = count < COUNT_MAX ? count : COUNT_MAX;
  return (long long)((c << KEY_BITS) | (key & KEY_MASK));
}

enum TopkMode { WEIGHTED = 0, RUNS = 1, VALUES = 2 };

// Block b writes the top 4 of its rows to out[4b .. 4b + 3].
template <int MODE>
__global__ void k_topk(const int64_t* keys, const int64_t* counts, int64_t n,
                       int64_t empty_key, int64_t* out) {
  long long t[4] = {0, 0, 0, 0};
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t k = keys[i];
    if (MODE == VALUES) {
      top4_insert(t, (long long)k);
    } else if (MODE == WEIGHTED) {
      const int64_t c = counts[i];
      if (c > 0 && k != empty_key) top4_insert(t, pack(k, c));
    } else if (k != empty_key && (i == 0 || keys[i - 1] != k)) {
      const int64_t len = upper_bound(keys + i, n - i, k);
      top4_insert(t, pack(k, len));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __shfl_xor_sync(FULL, t[j], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) top4_insert(t, u[j]);
  }
  __shared__ long long warp_top[WARPS][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) warp_top[warp][j] = t[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) top4_insert(t, warp_top[w][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) out[4 * int64_t(blockIdx.x) + j] = t[j];
  }
}

inline int64_t topk_blocks(int64_t n) {
  const int64_t b = (n + BLOCK - 1) / BLOCK;
  return b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

}  // namespace

extern "C" {

int rw_vnode_hists(RwHistArgs args, int32_t blocks, int64_t* out,
                   int64_t* state, void* stream) {
  k_vnode_hists<<<unsigned(blocks), BLOCK, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      args, out, reinterpret_cast<unsigned*>(state),
      reinterpret_cast<unsigned long long*>(state + 1));
  RW_CHECK(RW_S_VNODE_HIST);
  return 0;
}

int64_t rw_topk_scratch_bytes(int64_t n) {
  return align256(4 * topk_blocks(n) * int64_t(sizeof(int64_t)));
}

int rw_topk_packed(const int64_t* keys, const int64_t* counts, int64_t n,
                   int64_t empty_key, int64_t* out, void* scratch,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nb = topk_blocks(n);
  int64_t* part = nb == 1 ? out : static_cast<int64_t*>(scratch);
  if (counts)
    k_topk<WEIGHTED><<<unsigned(nb), BLOCK, 0, st>>>(keys, counts, n,
                                                     empty_key, part);
  else
    k_topk<RUNS><<<unsigned(nb), BLOCK, 0, st>>>(keys, nullptr, n,
                                                 empty_key, part);
  RW_CHECK(RW_S_TOPK_ROWS);
  if (nb > 1) {
    k_topk<VALUES><<<1, BLOCK, 0, st>>>(part, nullptr, 4 * nb, empty_key,
                                        out);
    RW_CHECK(RW_S_TOPK_MERGE);
  }
  return 0;
}

}  // extern "C"

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
// rw_topk_packed: one launch of at most two blocks an SM; the call
// allocates only its 4-word output. Each thread keeps its own top 4 in
// registers (a value at or below its fourth returns at once); a shuffle
// butterfly merges the warp's lists (each step merges two disjoint groups
// of lanes, so no value counts twice), and one warp merges the block's 8
// warp lists from shared memory the same way. Each block stores its list
// in a persistent per-device buffer and takes a ticket; the last block to
// finish merges the grid's lists into the output and resets the ticket,
// so it is zero between calls (as rw_vnode_hists does). Weighted mode
// reads keys and counts two at a time by 16-byte loads, four pairs in
// flight. Runs mode reads tiles of 2048 sorted keys, 8 a thread by four
// 16-byte loads, and finds each run's length in registers: a head is a
// row whose key differs from its left neighbour's, and a run ends at the
// next head — in the thread's own rows, else a later lane's (ballot and
// __ffs), else a later warp's (shared memory). Only a tile's last run can
// cross its edge; warp 0 gallops from the edge in rounds of 32 probes
// (steps 1, 32, 1024, ... rows, then a warp search in the last step),
// about 2 log32(L) rounds of loads for a run of L rows. No search runs
// over the tail of the input, and a tile whose first key is EMPTY_KEY
// (which sorts last) ends the block's walk.
#include "skew_runs.h"

#include "rw_common.cuh"

#include <type_traits>

namespace {

constexpr int BUCKETS = 16;
constexpr int KEY_BITS = 40;
constexpr int64_t KEY_MASK = (int64_t(1) << KEY_BITS) - 1;
constexpr int64_t COUNT_MAX = (int64_t(1) << 22) - 1;

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

__device__ __forceinline__ void weigh(long long (&t)[4], int64_t key,
                                      int64_t count, int64_t empty_key) {
  if (count > 0 && key != empty_key) top4_insert(t, pack(key, count));
}

// The 4-lists of the 32 lanes merged by the shuffle butterfly: each step
// merges two disjoint groups of lanes, so no value counts twice, and every
// lane ends with the warp's list.
__device__ __forceinline__ void warp_top4(long long (&t)[4]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    long long u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __shfl_xor_sync(FULL, t[j], o);
#pragma unroll
    for (int j = 0; j < 4; ++j) top4_insert(t, u[j]);
  }
}

// The block's list into warp 0's lanes: each warp's by the butterfly, then
// the 8 warp lists (32 values, one a lane) by the butterfly in warp 0.
__device__ __forceinline__ void block_top4(long long (&t)[4],
                                           long long* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_top4(t);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) sh[4 * warp + j] = t[j];
  }
  __syncthreads();
  if (warp == 0) {
    long long v[4] = {sh[lane], 0, 0, 0};
    warp_top4(v);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = v[j];
  }
}

// Weighted rows i = gt, gt + gs, ...: keys and counts two at a time by
// 16-byte loads when both are 16-byte aligned, four pairs in flight.
__device__ __forceinline__ void topk_weighted(const int64_t* keys,
                                              const int64_t* counts,
                                              int64_t n, int64_t empty_key,
                                              long long (&t)[4]) {
  const int64_t gt = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  const int64_t gs = int64_t(gridDim.x) * BLOCK;
  const bool vec = ((reinterpret_cast<uintptr_t>(keys) |
                     reinterpret_cast<uintptr_t>(counts)) & 15) == 0;
  const int64_t np = vec ? n / 2 : 0;
  const longlong2* k2 = reinterpret_cast<const longlong2*>(keys);
  const longlong2* c2 = reinterpret_cast<const longlong2*>(counts);
  constexpr int U = 4;
  int64_t p = gt;
  for (; p + (U - 1) * gs < np; p += U * gs) {
    longlong2 k[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      k[u] = __ldcs(k2 + p + u * gs);
      c[u] = __ldcs(c2 + p + u * gs);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      weigh(t, k[u].x, c[u].x, empty_key);
      weigh(t, k[u].y, c[u].y, empty_key);
    }
  }
  for (; p < np; p += gs) {
    const longlong2 k = __ldcs(k2 + p), c = __ldcs(c2 + p);
    weigh(t, k.x, c.x, empty_key);
    weigh(t, k.y, c.y, empty_key);
  }
  for (int64_t i = 2 * np + gt; i < n; i += gs)
    weigh(t, keys[i], counts[i], empty_key);
}

constexpr int64_t NONE = INT64_MAX;

// The first index at or after `from` whose key is not k (n if none), when
// keys[from - 1] == k, by a whole warp: a galloping search in rounds of 32
// probes, steps 1, 32, 1024, ... until a probe differs, then
// warp_first_true inside the last step, so a run of L rows costs about
// 2 log32(L) rounds of loads. Every lane calls it and gets the result.
__device__ int64_t warp_run_end(const int64_t* keys, int64_t n, int64_t from,
                                int64_t k) {
  const int lane = threadIdx.x & 31;
  int64_t lo = from, step = 1;
  for (;;) {
    const int64_t p = lo + lane * step;
    const unsigned b = __ballot_sync(FULL, p >= n || keys[p] != k);
    if (b) {
      const int f = __ffs(b) - 1;
      const int64_t hi = lo + f * step < n ? lo + f * step : n;
      if (f > 0) lo += (f - 1) * step + 1;
      return warp_first_true(lo, hi,
                             [=](int64_t i) { return keys[i] != k; });
    }
    lo += 31 * step + 1;
    step *= 32;
  }
}

// Runs of equal keys over sorted `keys`, in tiles of TILE rows, a block a
// tile at a time (tile = blockIdx.x, + gridDim.x, ...). Thread t owns the
// tile's rows 8t .. 8t + 7 (four 16-byte loads; rows past n read as
// empty_key). A head is a row whose key differs from the key on its left;
// a run's length is the distance from its head to the next head: inside
// the thread's 8 rows, else the first head of a later lane (a ballot and
// __ffs), else of a later warp (each warp's first head in shared memory).
// Only the tile's last run may cross its right edge; warp 0 finds its end
// by `warp_run_end` for the thread that holds its head. EMPTY_KEY sorts
// last, so a tile whose first key is empty ends the block's walk.
struct RunsShared {
  int64_t wfirst[WARPS];   // each warp's first head (NONE: none)
  int64_t key, end;        // the run crossing the tile's edge
  int need;                // whether one does
};

__device__ __forceinline__ void topk_runs(const int64_t* keys, int64_t n,
                                          int64_t empty_key,
                                          long long (&t)[4],
                                          RunsShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(keys) & 15) == 0;
  const int64_t tiles = tiles_of(n);
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t base = tile * TILE;
    if (keys[base] == empty_key) break;
    if (threadIdx.x == 0) sh.need = 0;
    const int64_t i0 = base + int64_t(threadIdx.x) * ITEMS;
    int64_t k[ITEMS];
    if (vec && i0 + ITEMS <= n) {
      const longlong2* p = reinterpret_cast<const longlong2*>(keys + i0);
#pragma unroll
      for (int j = 0; j < ITEMS / 2; ++j) {
        const longlong2 v = __ldcs(p + j);
        k[2 * j] = v.x;
        k[2 * j + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        k[j] = i0 + j < n ? keys[i0 + j] : empty_key;
    }
    int64_t left = __shfl_up_sync(FULL, k[ITEMS - 1], 1);
    if (lane == 0) left = i0 > 0 && i0 - 1 < n ? keys[i0 - 1] : empty_key;
    unsigned h = i0 == 0 ? 1u : 0u;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if ((j == 0 ? left : k[j - 1]) != k[j]) h |= 1u << j;
    const int64_t fh = h ? i0 + __ffs(h) - 1 : NONE;
    const unsigned has = __ballot_sync(FULL, h != 0);
    const unsigned later = lane == 31 ? 0u : has & (FULL << (lane + 1));
    int64_t next = __shfl_sync(FULL, fh, later ? __ffs(later) - 1 : lane);
    if (!later) next = NONE;
    const int64_t wf = __shfl_sync(FULL, fh, has ? __ffs(has) - 1 : 0);
    if (lane == 0) sh.wfirst[warp] = wf;
    __syncthreads();
    for (int w = warp + 1; next == NONE && w < WARPS; ++w)
      next = sh.wfirst[w];
    if (h && next == NONE) {
      // the tile's last head: its run ends at n, or past the tile's edge
      int64_t kl = k[0];
#pragma unroll
      for (int j = 1; j < ITEMS; ++j)
        if (h >> j & 1) kl = k[j];
      if (kl != empty_key) {
        if (base + TILE >= n) {
          next = n;
        } else {
          sh.key = kl;
          sh.need = 1;
        }
      }
    }
    __syncthreads();
    if (sh.need) {
      if (warp == 0) {
        const int64_t e = warp_run_end(keys, n, base + TILE, sh.key);
        if (lane == 0) sh.end = e;
      }
      __syncthreads();
      if (h && next == NONE) next = sh.end;
    }
    // heads right to left: each run ends where the one on its right starts
#pragma unroll
    for (int j = ITEMS - 1; j >= 0; --j) {
      if (h >> j & 1) {
        if (k[j] != empty_key) top4_insert(t, pack(k[j], next - (i0 + j)));
        next = i0 + j;
      }
    }
    __syncthreads();
  }
}

// One launch: each block its rows' top 4 into part[4b ..], then a ticket;
// the last block to take one merges the grid's lists into `out` and
// resets the ticket, so it is zero between calls.
template <bool RUNS>
__global__ void __launch_bounds__(BLOCK)
k_topk(const int64_t* keys, const int64_t* counts, int64_t n,
       int64_t empty_key, int64_t* out, unsigned* done, long long* part) {
  __shared__ long long sh[4 * WARPS];
  __shared__ RunsShared runs;
  __shared__ int last_s;
  long long t[4] = {0, 0, 0, 0};
  if (RUNS)
    topk_runs(keys, n, empty_key, t, runs);
  else
    topk_weighted(keys, counts, n, empty_key, t);
  block_top4(t, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) part[4 * int64_t(blockIdx.x) + j] = t[j];
    __threadfence();
    last_s = atomicAdd(done, 1u) == gridDim.x - 1;
    if (last_s) __threadfence();
  }
  __syncthreads();
  if (!last_s) return;
  long long m[4] = {0, 0, 0, 0};
  for (int i = threadIdx.x; i < 4 * int(gridDim.x); i += BLOCK)
    top4_insert(m, __ldcg(part + i));
  block_top4(m, sh);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = m[j];
    *done = 0u;
  }
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

int rw_topk_packed(const int64_t* keys, const int64_t* counts, int64_t n,
                   int64_t empty_key, int32_t max_blocks, int64_t* out,
                   int64_t* state, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t nb = tiles_of(n);
  const int64_t most = max_blocks < RW_TOPK_MAX_BLOCKS ? max_blocks
                                                       : RW_TOPK_MAX_BLOCKS;
  nb = nb < 1 ? 1 : (nb > most ? most : nb);
  unsigned* done = reinterpret_cast<unsigned*>(state);
  long long* part = reinterpret_cast<long long*>(state + 1);
  if (counts)
    k_topk<false><<<unsigned(nb), BLOCK, 0, st>>>(keys, counts, n, empty_key,
                                                  out, done, part);
  else
    k_topk<true><<<unsigned(nb), BLOCK, 0, st>>>(keys, nullptr, n, empty_key,
                                                 out, done, part);
  RW_CHECK(RW_S_TOPK);
  return 0;
}

}  // extern "C"

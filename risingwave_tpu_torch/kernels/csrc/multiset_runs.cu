// Hand-written CUDA kernels (sm_90a) for the three ★ cores of the
// retractable min/max multiset, risingwave_tpu/device/minput.py:
//
//   ms_batch_reduce :79   -> rw_ms_reduce   the tiled segmented reduce over
//                                           (k1, k2), one int64 SUM
//   ms_merge        :98   -> rw_ms_merge    one merge-path pass that
//                                           combines and compacts
//   ms_find         :136  -> rw_ms_find     composite lower bound per query
//
// In the JAX package these are XLA programs built from a two-key
// lax.sort, segment_sum, a concat + re-sort of the whole multiset, and an
// unrolled binary search. Each moves three words per row and does no
// arithmetic to speak of, so each is bound by device-memory bytes;
// ms_find gets there by skipping its EMPTY queries and searching a sample
// of the multiset in shared memory before the few steps left in device
// memory.
// ms_batch_reduce sorts with the two-key radix sort of sorted_runs.cu
// (launched by the wrapper), then reduces with the two-key form of
// reduce_tiles.cuh: the count delta is column 0, an int64 SUM gathered
// through the permutation with the second key, no REPLACE column, so
// every slot past the live pairs takes EMPTY_KEY keys and a 0 sum. No
// thread walks more than its 8 rows (one thread per segment walked q5's
// ~400-row segments before). ms_merge is merge's pass (sorted_runs.cu
// k_merge_tiles) on two keys and one count; see below.
#include "multiset_runs.h"

#include "reduce_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// ms_merge: one merge-path pass that combines and compacts, straight into
// the new multiset.
//
// Bound: each run's live pairs read once (k1, k2, count) and C rows
// written — bytes, at 3.35 TB/s. No row of C + B is written in between.
// The design, merge's:
//   1. k_ms_cuts: a two-key co-rank search per tile edge on the merge
//      path of (state pairs, delta pairs), a state row first on ties (its
//      delta twin is the next merged row: both runs are unique).
//   2. k_ms_merge_tiles: a tile of 2048 merged rows takes its index from a
//      ticket. EMPTY_KEY sorts last, so a tile whose first merged k1 is
//      EMPTY holds only dead rows and every tile after it too: it
//      publishes 0 and returns, and no live tile waits on it (the delta's
//      EMPTY tail). A live tile stages its slices of both runs' keys in
//      shared memory, each thread merges its 8 rows (a co-rank search in
//      shared memory, then a two-cursor merge) and writes them back in
//      merged order; the merged rows just before and just after the tile
//      come from global memory, so a pair and its twin may straddle a
//      tile edge. Read again striped (row r x 256 + thread), a row is a
//      candidate when it is not its predecessor's twin and its k1 is not
//      EMPTY; its count is its own plus its twin's (wrapping int64), and
//      it is alive when that is not 0 — a count below 0 stays, as in the
//      reference. A ballot per warp and a scan of the 64 (stripe, warp)
//      counts rank the pairs alive; the tile's offset comes by decoupled
//      look-back; the last tile with live rows writes `needed` (every
//      pair alive, those past C too) and the clipped count. Pairs below
//      C go out through shared memory, k1, then k2, then the count, each
//      staged at its rank and written as one run.
//   3. k_ms_fill: slots [min(needed, C), C) get (EMPTY_KEY, EMPTY_KEY, 0).
// Out of place: the input multiset stays intact (growth replay re-runs
// the epoch from it). Sources are int32 (state row, or c + delta row), so
// c + b < 2^31 (the binding refuses more).
// ---------------------------------------------------------------------------

// cuts[t] = the state rows before merged row t x TILE, t in [0, nt].
__global__ void k_ms_cuts(const int64_t* s1, const int64_t* s2, int64_t c,
                          const int64_t* d1, const int64_t* d2, int64_t b,
                          int64_t nt, int64_t* cuts) {
  const int64_t t = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (t > nt) return;
  const int64_t n = c + b;
  const int64_t p = t * TILE < n ? t * TILE : n;
  cuts[t] = co_rank(s1, s2, c, d1, d2, b, p);
}

__device__ __forceinline__ bool same2(int64_t a1, int64_t a2, int64_t b1,
                                      int64_t b2) {
  return a1 == b1 && a2 == b2;
}

// A tile's survivors of one column, staged at their ranks, written out as
// one run (consecutive lanes to consecutive slots).
__device__ __forceinline__ void put_run(int64_t* stage, unsigned live,
                                        const int* rank, const int64_t* v,
                                        int64_t* out, int keep) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if ((live >> r) & 1u) stage[rank[r]] = v[r];
  __syncthreads();
  for (int k = threadIdx.x; k < keep; k += BLOCK) out[k] = stage[k];
  __syncthreads();
}

// three blocks an SM (41 KB of shared memory, at most 80 registers)
__global__ void __launch_bounds__(BLOCK, 3)
k_ms_merge_tiles(const int64_t* s1, const int64_t* s2, const int64_t* s_cnt,
                 int64_t c, const int64_t* d1, const int64_t* d2,
                 const int64_t* d_cnt, int64_t b, const int64_t* cuts,
                 int64_t* o1, int64_t* o2, int64_t* o_cnt, int32_t* needed,
                 unsigned* ticket, unsigned long long* status) {
  // the tile's input pairs at [0, len), then its merged rows at [1, len]
  // with the row before the tile at 0 and the row after it at len + 1;
  // K1 is the output stage once every thread holds its rows
  __shared__ int64_t K1[TILE + 2];
  __shared__ int64_t K2[TILE + 2];
  __shared__ int32_t SRC[TILE + 2];
  __shared__ int cnt[ITEMS * WARPS];
  __shared__ int slot, count_s;
  __shared__ unsigned base_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t n = c + b;
  const int64_t tile = take_ticket(ticket, &slot);
  const int64_t p0 = tile * TILE;
  const int len = n - p0 < TILE ? int(n - p0) : TILE;
  const int64_t i0 = cuts[tile], i1 = cuts[tile + 1];
  const int64_t j0 = p0 - i0, j1 = p0 + len - i1;
  {
    const int64_t fs = i0 < c ? s1[i0] : EMPTY_KEY;
    const int64_t fd = j0 < b ? d1[j0] : EMPTY_KEY;
    if ((fs < fd ? fs : fd) == EMPTY_KEY) {   // only dead rows from here
      if (t == 0) {
        lookback_publish(status, tile, 1, 1u, 0u);
        if (tile == 0) needed[0] = needed[1] = 0;
      }
      return;
    }
  }
  const int ns = int(i1 - i0), nd = int(j1 - j0);
  for (int q = t; q < ns; q += BLOCK) {
    K1[q] = s1[i0 + q];
    K2[q] = s2[i0 + q];
  }
  for (int q = t; q < nd; q += BLOCK) {
    K1[ns + q] = d1[j0 + q];
    K2[ns + q] = d2[j0 + q];
  }
  __syncthreads();
  int64_t m1[ITEMS], m2[ITEMS];
  int32_t ms[ITEMS];
  const int d0 = t * ITEMS;
  if (d0 < len) {
    int a = int(co_rank(K1, K2, ns, K1 + ns, K2 + ns, nd, d0));
    int e = d0 - a;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (d0 + r < len) {
        const bool st = a < ns && (e >= nd || !lt2(K1[ns + e], K2[ns + e],
                                                   K1[a], K2[a]));
        const int q = st ? a++ : ns + e++;
        m1[r] = K1[q];
        m2[r] = K2[q];
        ms[r] = st ? int32_t(i0 + q) : int32_t(c + j0 + (q - ns));
      }
    }
  }
  __syncthreads();
  if (d0 < len) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (d0 + r < len) {
        K1[1 + d0 + r] = m1[r];
        K2[1 + d0 + r] = m2[r];
        SRC[1 + d0 + r] = ms[r];
      }
    }
  }
  if (t == 0 && p0 > 0) {
    // merged row p0 - 1: the later of state[i0 - 1] and delta[j0 - 1]
    const bool dl = j0 > 0 && (i0 == 0 || !lt2(d1[j0 - 1], d2[j0 - 1],
                                               s1[i0 - 1], s2[i0 - 1]));
    K1[0] = dl ? d1[j0 - 1] : s1[i0 - 1];
    K2[0] = dl ? d2[j0 - 1] : s2[i0 - 1];
  }
  if (t == 32 && p0 + len < n) {
    // merged row p0 + len: the earlier of state[i1] and delta[j1]
    const bool sd = i1 < c && (j1 >= b || !lt2(d1[j1], d2[j1], s1[i1],
                                               s2[i1]));
    K1[len + 1] = sd ? s1[i1] : d1[j1];
    K2[len + 1] = sd ? s2[i1] : d2[j1];
    SRC[len + 1] = sd ? int32_t(i1) : int32_t(c + j1);
  }
  __syncthreads();
  // bit r: row r is its pair's first merged row, its k1 is not EMPTY and
  // its count with its twin's is not 0
  unsigned live = 0;
  int64_t v1[ITEMS], v2[ITEMS], vc[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + t;
    const int64_t p = p0 + q;
    v1[r] = v2[r] = vc[r] = 0;
    if (q < len) {
      const int64_t a1 = K1[q + 1], a2 = K2[q + 1];
      if (!(p > 0 && same2(K1[q], K2[q], a1, a2)) && a1 != EMPTY_KEY) {
        const int32_t sr = SRC[q + 1];
        uint64_t v = uint64_t(sr < c ? s_cnt[sr] : d_cnt[sr - c]);
        if (p + 1 < n && same2(K1[q + 2], K2[q + 2], a1, a2)) {
          const int32_t tw = SRC[q + 2];
          v += uint64_t(tw < c ? s_cnt[tw] : d_cnt[tw - c]);
        }
        if (v != 0) {
          live |= 1u << r;
          v1[r] = a1;
          v2[r] = a2;
          vc[r] = int64_t(v);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const unsigned ball = __ballot_sync(FULL, (live >> r) & 1u);
    if (lane == 0) cnt[r * WARPS + warp] = __popc(ball);
  }
  // the last tile with live rows: the row after it has an EMPTY k1, or
  // there is none
  const bool last_live = p0 + len == n || K1[len + 1] == EMPTY_KEY;
  __syncthreads();
  if (warp == 0) {
    int total;
    const unsigned base = tile_offsets(cnt, tile, status, total);
    if (lane == 0) {
      base_s = base;
      count_s = total;
      if (last_live) {
        const int64_t all = int64_t(base) + total;
        needed[0] = int32_t(all);
        needed[1] = int32_t(all < c ? all : c);
      }
    }
  }
  __syncthreads();
  const int64_t base = base_s;
  if (base >= c) return;                   // truncated: the first c survive
  const int keep = int(c - base < count_s ? c - base : count_s);
  const unsigned below = (1u << lane) - 1u;
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)       // the same ballots again
    rank[r] = cnt[r * WARPS + warp] +
              __popc(__ballot_sync(FULL, (live >> r) & 1u) & below);
  put_run(K1, live, rank, v1, o1 + base, keep);
  put_run(K1, live, rank, v2, o2 + base, keep);
  put_run(K1, live, rank, vc, o_cnt + base, keep);
}

__global__ void k_ms_fill(int64_t* o1, int64_t* o2, int64_t* o_cnt,
                          int64_t c, const int32_t* needed) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= c || i < needed[1]) return;
  o1[i] = EMPTY_KEY;
  o2[i] = EMPTY_KEY;
  o_cnt[i] = 0;
}

// ---------------------------------------------------------------------------
// ms_find: composite lower bound per query, a thread four queries.
//
// The reference unrolls bit_length(C - 1) + 1 halving steps of (lo, hi)
// over all C slots; each step leaves hi - lo <= floor((hi - lo) / 2), so
// after bit_length(C) steps — never more than it unrolls — lo is the
// composite lower bound (or past C - 1 when every pair is smaller, which
// the clip to C - 1 maps to the same slot). So a plain lower bound,
// clipped, is the same slot for every C >= 1, whatever the queries'
// order.
//
// Bound: q1 read and found / count written for every query, q2 read for
// the live ones, the multiset once — bytes. What held the one-thread-a-
// query kernel at 3x that was a full search of ~17 dependent L2 loads for
// every query, the EMPTY ones too (q5's queries are its reduced delta:
// ~2,700 live pairs, then ~10.5M EMPTY rows). Here:
//   * an EMPTY query (q1 == EMPTY_KEY) writes (false, 0) unsearched and
//     its q2 is not read: the reference's `q1 != EMPTY_KEY` term makes
//     that exact in any order; a tile with no live query searches
//     nothing, and a block stages its sample only at its first tile with
//     a live query;
//   * a thread takes MSF_Q = 4 consecutive queries: q1 / q2 in 16-byte
//     loads and count in 16-byte stores, found in one 4-byte store,
//     where the addresses allow (scalar otherwise, and at the tail); the
//     next tile's q1 is loaded before this one is searched;
//   * a block stages every st-th pair (st = ceil(C / 2047)) in shared
//     memory, 32 KB, in heap (Eytzinger) order: node 1 the middle
//     sample, nodes 2k and 2k + 1 the halves below and above node k,
//     sentinels (EMPTY_KEY, EMPTY_KEY) past the last sample. The
//     search's first 11 steps descend that tree (a level's nodes are
//     contiguous, so a warp's probes spread over the banks; the sorted
//     layout put every probe of a level in one bank) and only the last
//     bit_length(st - 1) read device memory (6 at q5's C = 2^16, was
//     17), the four queries in lockstep so their loads are in flight
//     together; a multiset of at most 2047 pairs is searched in shared
//     memory whole. The key at the answer is tracked through the global
//     steps, so only a found pair's count is read;
//   * a grid of three blocks an SM, tiles dealt statically (tile b, b +
//     grid, ...): no ticket, no state kept between calls.
// ---------------------------------------------------------------------------

constexpr int MSF_H = 11;                      // the sample tree's height
constexpr int MSF_NODES = (1 << MSF_H) - 1;    // 2047 pairs staged a block
constexpr int MSF_Q = 4;                       // queries a thread
constexpr int MSF_TILE = BLOCK * MSF_Q;        // queries a tile
constexpr int MSF_BLOCKS = 3 * 132;            // three an SM of an H100

// in-order rank of heap node x (1 .. MSF_NODES) of the perfect sample
// tree: the samples' sorted index it holds
__device__ __forceinline__ int node_rank(int x) {
  const int d = 31 - __clz(x);
  return ((2 * (x - (1 << d)) + 1) << (MSF_H - 1 - d)) - 1;
}

__device__ __forceinline__ bool al16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the MSF_Q queries from i0 of a column (EMPTY_KEY past q)
__device__ __forceinline__ void msf_load(const int64_t* a, int64_t i0,
                                         int64_t q, bool vec,
                                         int64_t (&v)[MSF_Q]) {
  if (vec && i0 + MSF_Q <= q) {
    const longlong2 x = *reinterpret_cast<const longlong2*>(a + i0);
    const longlong2 y = *reinterpret_cast<const longlong2*>(a + i0 + 2);
    v[0] = x.x; v[1] = x.y; v[2] = y.x; v[3] = y.y;
  } else {
#pragma unroll
    for (int r = 0; r < MSF_Q; ++r)
      v[r] = i0 + r < q ? a[i0 + r] : EMPTY_KEY;
  }
}

// three blocks an SM (32 KB of shared memory, at most 85 registers)
__global__ void __launch_bounds__(BLOCK, 3)
k_ms_find(const int64_t* k1, const int64_t* k2, const int64_t* cnt,
          int64_t c, int64_t st, int ns, int g_glob,
          const int64_t* q1, const int64_t* q2, int64_t q, uint8_t* found,
          int64_t* out) {
  __shared__ longlong2 E[MSF_NODES + 1];      // heap order, E[1] the root
  const int t = threadIdx.x;
  const bool v1 = al16(q1), v2 = al16(q2), vo = al16(out);
  const bool vf = (reinterpret_cast<uintptr_t>(found) & 3) == 0;
  const int64_t ntiles = (q + MSF_TILE - 1) / MSF_TILE;
  bool staged = false;
  int64_t tile = blockIdx.x;
  int64_t nxt[MSF_Q];
  if (tile < ntiles) msf_load(q1, tile * MSF_TILE + t * MSF_Q, q, v1, nxt);
  for (; tile < ntiles; tile += gridDim.x) {
    const int64_t i0 = tile * MSF_TILE + t * MSF_Q;
    int64_t a[MSF_Q];
    unsigned live = 0;
#pragma unroll
    for (int r = 0; r < MSF_Q; ++r) {
      a[r] = nxt[r];
      if (a[r] != EMPTY_KEY) live |= 1u << r;
    }
    if (tile + gridDim.x < ntiles)       // the next tile's q1, in flight
      msf_load(q1, (tile + gridDim.x) * MSF_TILE + t * MSF_Q, q, v1, nxt);
    int64_t res[MSF_Q] = {0, 0, 0, 0};
    unsigned hit = 0;
    if (__syncthreads_or(live != 0)) {
      if (!staged) {
#pragma unroll 8
        for (int x = t + 1; x <= MSF_NODES; x += BLOCK) {
          const int j = node_rank(x);
          E[x] = j < ns ? make_longlong2(k1[j * st], k2[j * st])
                        : make_longlong2(EMPTY_KEY, EMPTY_KEY);
        }
        __syncthreads();
        staged = true;
      }
      if (live) {
        int64_t b[MSF_Q];
        if (v2 && live == 0xfu) {
          msf_load(q2, i0, q, true, b);
        } else {
#pragma unroll
          for (int r = 0; r < MSF_Q; ++r)
            b[r] = (live >> r) & 1u ? q2[i0 + r] : 0;
        }
        // descend the sample tree: bit d of the path set where node < q
        int x[MSF_Q];
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r) x[r] = 1;
#pragma unroll
        for (int d = 0; d < MSF_H; ++d) {
#pragma unroll
          for (int r = 0; r < MSF_Q; ++r) {
            const longlong2 e = E[x[r]];
            x[r] = 2 * x[r] + int(lt2(e.x, e.y, a[r], b[r]));
          }
        }
        // the first sample not below q: the node the path last left by
        // its lower child (0 when it never did: every node is below q)
        int lo[MSF_Q], hi[MSF_Q];       // slots < c < 2^31
        int64_t h1[MSF_Q], h2[MSF_Q];
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r) {
          const int y = x[r] >> __ffs(~x[r]);
          lo[r] = y == 0 ? ns : node_rank(y);
          const longlong2 e = E[y == 0 ? 1 : y];
          h1[r] = e.x;
          h2[r] = e.y;
        }
        // between two samples: (j - 1) x st + 1 .. j x st in device
        // memory, the pair at j x st known (or none past the last)
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r) {
          const int64_t j = lo[r] < ns ? lo[r] : ns;
          lo[r] = int(j == 0 ? 0 : (j - 1) * st + 1);
          hi[r] = int((live >> r) & 1u ? (j < ns ? j * st : c) : 0);
        }
        for (int s = 0; s < g_glob; ++s) {
          int m[MSF_Q];
          int64_t x1[MSF_Q], x2[MSF_Q];
#pragma unroll
          for (int r = 0; r < MSF_Q; ++r) {
            m[r] = (lo[r] + hi[r]) >> 1;
            if (lo[r] < hi[r]) {
              x1[r] = __ldg(k1 + m[r]);
              x2[r] = __ldg(k2 + m[r]);
            }
          }
#pragma unroll
          for (int r = 0; r < MSF_Q; ++r) {
            if (lo[r] < hi[r]) {
              if (lt2(x1[r], x2[r], a[r], b[r])) {
                lo[r] = m[r] + 1;
              } else {
                hi[r] = m[r];
                h1[r] = x1[r];
                h2[r] = x2[r];
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r)
          if ((live >> r) & 1u && hi[r] < c && h1[r] == a[r] &&
              h2[r] == b[r])
            hit |= 1u << r;
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r)
          if ((hit >> r) & 1u) res[r] = __ldg(cnt + hi[r]);
      }
    }
    if (i0 + MSF_Q <= q) {
      if (vf) {
        *reinterpret_cast<uint32_t*>(found + i0) =
            (hit & 1u) | (hit >> 1 & 1u) << 8 | (hit >> 2 & 1u) << 16 |
            (hit >> 3 & 1u) << 24;
      } else {
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r) found[i0 + r] = (hit >> r) & 1u;
      }
      if (vo) {
        *reinterpret_cast<longlong2*>(out + i0) = make_longlong2(res[0],
                                                                 res[1]);
        *reinterpret_cast<longlong2*>(out + i0 + 2) =
            make_longlong2(res[2], res[3]);
      } else {
#pragma unroll
        for (int r = 0; r < MSF_Q; ++r) out[i0 + r] = res[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < MSF_Q; ++r) {
        if (i0 + r < q) {
          found[i0 + r] = (hit >> r) & 1u;
          out[i0 + r] = res[r];
        }
      }
    }
  }
}

// bits needed for v >= 0 (bit_length)
inline int bit_length(int64_t v) {
  int b = 0;
  while (v > 0) {
    ++b;
    v >>= 1;
  }
  return b;
}

}  // namespace

extern "C" {

int64_t rw_ms_scratch_bytes(int64_t n) {
  return reduce_layout(nullptr, n, false).bytes;
}

int rw_ms_reduce(const int64_t* sk1, const int64_t* k2, const int64_t* perm,
                 const int64_t* delta, int64_t n, int64_t* u1, int64_t* u2,
                 int64_t* ud, void* scratch, void* stream) {
  if (n <= 0) return 0;
  RwCols cols{};
  cols.n = 1;
  cols.dtype[0] = RW_I64;
  cols.kind[0] = RW_SUM;
  cols.fill[0] = 0;                        // the padding's sum
  cols.a[0] = delta;
  cols.out[0] = ud;
  const int sites[3] = {RW_S_MS_TILES, RW_S_MS_CARRY, RW_S_MS_CARRY};
  return reduce_tiles_launch<true, int64_t>(
      sk1, k2, perm, n, cols, u1, u2, nullptr, scratch,
      static_cast<cudaStream_t>(stream), sites);
}

int rw_ms_merge(const int64_t* s1, const int64_t* s2, const int64_t* s_cnt,
                int64_t c, const int64_t* d1, const int64_t* d2,
                const int64_t* d_cnt, int64_t b, int64_t* o1, int64_t* o2,
                int64_t* o_cnt, int32_t* needed, void* scratch,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  const SweepScratch sc = sweep_layout(scratch, n);
  const int64_t nt = tiles_of(n);
  if (const cudaError_t e = cudaMemsetAsync(sc.ticket, 0,
                                            size_t(sc.zero_bytes), st))
    return RW_S_MS_MERGE * RW_SITE_STRIDE + int(e);
  k_ms_cuts<<<blocks_of(nt + 1), BLOCK, 0, st>>>(s1, s2, c, d1, d2, b, nt,
                                                 sc.cuts);
  RW_CHECK(RW_S_MS_CUTS);
  k_ms_merge_tiles<<<unsigned(nt), BLOCK, 0, st>>>(
      s1, s2, s_cnt, c, d1, d2, d_cnt, b, sc.cuts, o1, o2, o_cnt, needed,
      sc.ticket, sc.status);
  RW_CHECK(RW_S_MS_MERGE);
  if (c > 0) {
    k_ms_fill<<<blocks_of(c), BLOCK, 0, st>>>(o1, o2, o_cnt, c, needed);
    RW_CHECK(RW_S_MS_FILL);
  }
  return 0;
}

int rw_ms_find(const int64_t* k1, const int64_t* k2, const int64_t* cnt,
               int64_t c, const int64_t* q1, const int64_t* q2, int64_t q,
               uint8_t* found, int64_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q <= 0) return 0;
  const int64_t stride = (c + MSF_NODES - 1) / MSF_NODES;
  const int64_t ns = (c + stride - 1) / stride;
  const int64_t nt = (q + MSF_TILE - 1) / MSF_TILE;
  const unsigned grid = unsigned(nt < MSF_BLOCKS ? nt : MSF_BLOCKS);
  k_ms_find<<<grid, BLOCK, 0, st>>>(k1, k2, cnt, c, stride, int(ns),
                                    bit_length(stride - 1), q1, q2, q,
                                    found, out);
  RW_CHECK(RW_S_MS_FIND);
  return 0;
}

}  // extern "C"

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
// arithmetic to speak of, so each is bound by device-memory bytes — but
// for ms_find, whose floor is the ~log2(C) dependent reads of one binary
// search per query (the multiset of q5 is small enough to sit in L2).
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
// ms_find: one thread per query. The reference unrolls
// bit_length(C - 1) + 1 halving steps of (lo, hi) over all C slots; each
// step leaves hi - lo <= floor((hi - lo) / 2), so after bit_length(C)
// steps — never more than it unrolls — lo is the composite lower bound
// (or past C - 1 when every pair is smaller, which the clip to C - 1
// maps to the same slot). So a plain lower bound, clipped, is the same
// slot for every C >= 1.
// ---------------------------------------------------------------------------

__global__ void k_ms_find(const int64_t* k1, const int64_t* k2,
                          const int64_t* cnt, int64_t c, const int64_t* q1,
                          const int64_t* q2, int64_t q, uint8_t* found,
                          int64_t* out) {
  const int64_t t = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (t >= q) return;
  const int64_t a = q1[t], b = q2[t];
  int64_t lo = lower_bound2(k1, k2, c, a, b);
  lo = lo < c ? lo : c - 1;
  const bool f = k1[lo] == a && k2[lo] == b && a != EMPTY_KEY;
  found[t] = f;
  out[t] = f ? cnt[lo] : 0;
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
  k_ms_find<<<blocks_of(q), BLOCK, 0, st>>>(k1, k2, cnt, c, q1, q2, q, found,
                                            out);
  RW_CHECK(RW_S_MS_FIND);
  return 0;
}

}  // extern "C"

// Hand-written CUDA kernels (sm_90a) for the three join-side cores of
// risingwave_tpu/device/join_step.py:
//
//   batch_reduce_rows :57   -> rw_reduce_rows   tiled segmented reduce
//                                               over (jk, pk)
//   merge_side        :83   -> rw_side_merge    one merge-path pass that
//                                               combines and compacts
//   probe             :118  -> rw_probe         one counting pass over
//                                               query tiles, then a
//                                               merge-path expansion
//
// In the JAX package these are XLA programs built from a two-key
// lax.sort, segment ops, searchsorted and cumsum. Like the sorted-run
// cores they move a few words per row and do almost no arithmetic, so
// each is bound by device-memory bytes; probe's searches are kept in
// shared memory so that their dependent loads do not set its time.
// batch_reduce_rows sorts with the two-key radix sort of
// sorted_runs.cu (launched by the wrapper) and reduces with the tiled
// segmented reduce of reduce_tiles.cuh in its two-key form; merge_side
// never re-sorts what is already sorted.
#include "join_runs.h"

#include "reduce_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// merge_side: one pass over the merged order that merges, combines and
// compacts, straight into the new side.
//
// Replaces a placement kernel (one binary search per merged row, writing
// merged keys and sources), a combine kernel (every payload column
// gathered and written in merged order, plus alive flags) and compact_rows
// (a three-launch scan and a fill that read the merged copy a third time):
// three full passes over C + B rows and ~(C + B) x (21 + 8k) bytes of
// temporaries, each copy of a column waiting for the one before (a store
// may alias the next column's load). Bound: the keys of both runs read once, each surviving
// row's payload read once from its source, and C rows written — bytes, at
// 3.35 TB/s. The design:
//   1. k_side_cuts: one co-rank binary search per tile edge on the merge
//      path of (side, delta) — the side rows among the first p merged rows,
//      a side row first on ties (its twin in the delta comes right after).
//   2. k_side_merge: a tile of 2048 merged rows takes its index from a
//      ticket, loads its side and delta keys into shared memory, and each
//      thread merges its 8 rows (a co-rank search in shared memory, then a
//      two-cursor merge), keeping each row's key and source. The merged
//      row before the tile and the one after it come from global memory,
//      so a side row and its delta twin may straddle a tile edge. Read
//      again striped (row r x 256 + thread), each row is combined as the
//      reference does: presence = (jk != EMPTY) for a side row, the sign
//      for a delta row; on a pair clip(sum, 0, 1), the delta's payload when
//      its sign is > 0; alive = !same_prev && jk != EMPTY && presence > 0.
//      A ballot per warp and a scan of the 64 (stripe, warp) counts rank
//      the survivors in merged order; the tile's offset comes by decoupled
//      look-back; survivors below C write their keys and every payload
//      column from their source row, consecutive lanes to consecutive
//      slots, each column loaded for all the thread's rows before any is
//      stored. The last tile writes `needed`. Three blocks fit an SM (41
//      KB of shared memory, at most 80 registers): every phase waits on
//      memory, so tiles in flight are what hides it.
//   3. k_side_fill: slots [needed, C) get EMPTY_KEY, EMPTY_KEY, 0 ...
// Out of place: the input side stays intact (growth replay re-runs the
// epoch from it). Sources are int32 (side row, or c + delta row), so
// c + b < 2^31 (the binding refuses more).
// ---------------------------------------------------------------------------

// cuts[t] = the side rows before merged row t x TILE, t in [0, nt].
__global__ void k_side_cuts(const int64_t* s_jk, const int64_t* s_pk,
                            int64_t c, const int64_t* d_jk,
                            const int64_t* d_pk, int64_t b, int64_t nt,
                            int64_t* cuts) {
  const int64_t t = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (t > nt) return;
  const int64_t n = c + b;
  const int64_t p = t * TILE < n ? t * TILE : n;
  cuts[t] = co_rank(s_jk, s_pk, c, d_jk, d_pk, b, p);
}

// A merged row's presence: 1 for a side row (the caller has seen its jk
// is not EMPTY), its sign for a delta row.
__device__ __forceinline__ int32_t presence(int32_t src, int64_t c,
                                            const int32_t* d_sign) {
  return src < c ? 1 : d_sign[src - c];
}

// One payload column of a thread's surviving rows: out[dst[r]] from side
// row src[r] (< c) or delta row src[r] - c, where dst[r] >= 0.
template <typename T>
__device__ __forceinline__ void copy_rows(const void* a, const void* b,
                                          void* out, int64_t c,
                                          const int64_t* dst,
                                          const int32_t* src) {
  T v[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if (dst[r] >= 0)
      v[r] = src[r] < c ? static_cast<const T*>(a)[src[r]]
                        : static_cast<const T*>(b)[src[r] - c];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if (dst[r] >= 0) static_cast<T*>(out)[dst[r]] = v[r];
}

__global__ void __launch_bounds__(BLOCK, 3)
k_side_merge(const int64_t* s_jk, const int64_t* s_pk, int64_t c,
             const int64_t* d_jk, const int64_t* d_pk, const int32_t* d_sign,
             int64_t b, const int64_t* cuts, RwCols cols, int64_t* o_jk,
             int64_t* o_pk, int32_t* needed, unsigned* ticket,
             unsigned long long* status) {
  // the tile's input keys at [0, len), then its merged rows at [1, len]
  // with the row before the tile at 0 and the row after it at len + 1
  __shared__ int64_t K1[TILE + 2], K2[TILE + 2];
  __shared__ int32_t SRC[TILE + 2];
  __shared__ int cnt[ITEMS * WARPS];
  __shared__ int slot;
  __shared__ unsigned base_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t n = c + b;
  const int64_t tile = take_ticket(ticket, &slot);
  const int64_t p0 = tile * TILE;
  const int len = n - p0 < TILE ? int(n - p0) : TILE;
  const int64_t i0 = cuts[tile], i1 = cuts[tile + 1];
  const int64_t j0 = p0 - i0, j1 = p0 + len - i1;
  const int ns = int(i1 - i0), nd = int(j1 - j0);
  for (int q = t; q < ns; q += BLOCK) {
    K1[q] = s_jk[i0 + q];
    K2[q] = s_pk[i0 + q];
  }
  for (int q = t; q < nd; q += BLOCK) {
    K1[ns + q] = d_jk[j0 + q];
    K2[ns + q] = d_pk[j0 + q];
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
        const bool side = a < ns && (e >= nd || !lt2(K1[ns + e], K2[ns + e],
                                                      K1[a], K2[a]));
        const int q = side ? a++ : ns + e++;
        m1[r] = K1[q];
        m2[r] = K2[q];
        ms[r] = side ? int32_t(i0 + q) : int32_t(c + j0 + (q - ns));
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
    // merged row p0 - 1: the later of side[i0 - 1] and delta[j0 - 1]
    const bool dl = j0 > 0 && (i0 == 0 || !lt2(d_jk[j0 - 1], d_pk[j0 - 1],
                                               s_jk[i0 - 1], s_pk[i0 - 1]));
    K1[0] = dl ? d_jk[j0 - 1] : s_jk[i0 - 1];
    K2[0] = dl ? d_pk[j0 - 1] : s_pk[i0 - 1];
  }
  if (t == 32 && p0 + len < n) {
    // merged row p0 + len: the earlier of side[i1] and delta[j1]
    const bool sd = i1 < c && (j1 >= b || !lt2(d_jk[j1], d_pk[j1], s_jk[i1],
                                               s_pk[i1]));
    K1[len + 1] = sd ? s_jk[i1] : d_jk[j1];
    K2[len + 1] = sd ? s_pk[i1] : d_pk[j1];
    SRC[len + 1] = sd ? int32_t(i1) : int32_t(c + j1);
  }
  __syncthreads();
  unsigned ball[ITEMS];
  int32_t psrc[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + t;
    const int64_t p = p0 + q;
    bool alive = false;
    int32_t src = 0;
    if (q < len) {
      const int64_t k1 = K1[q + 1], k2 = K2[q + 1];
      const bool same_prev = p > 0 && K1[q] == k1 && K2[q] == k2;
      if (!same_prev && k1 != EMPTY_KEY) {
        src = SRC[q + 1];
        int32_t pres = presence(src, c, d_sign);
        if (p + 1 < n && K1[q + 2] == k1 && K2[q + 2] == k2) {
          const int32_t rn = SRC[q + 2];
          const int32_t pn = presence(rn, c, d_sign);
          const int32_t sum = pres + pn;
          pres = sum < 0 ? 0 : (sum > 1 ? 1 : sum);
          if (pn > 0) src = rn;          // an upsert takes the delta payload
        }
        alive = pres > 0;
      }
    }
    ball[r] = __ballot_sync(FULL, alive);
    psrc[r] = src;
    if (lane == 0) cnt[r * WARPS + warp] = __popc(ball[r]);
  }
  __syncthreads();
  if (warp == 0) {
    int total;
    const unsigned base = tile_offsets(cnt, tile, status, total);
    if (lane == 0) {
      base_s = base;
      if (tile == int64_t(gridDim.x) - 1) *needed = int32_t(base + total);
    }
  }
  __syncthreads();
  // survivors below C: keys from shared memory, then each payload column
  // gathered for all the thread's rows before any is stored (a store may
  // alias another column, so interleaved each load would wait its turn)
  const int64_t base = base_s;
  const unsigned below = (1u << lane) - 1u;
  int64_t dst[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    dst[r] = -1;
    if ((ball[r] >> lane) & 1u) {
      const int64_t o = base + cnt[r * WARPS + warp] +
                        __popc(ball[r] & below);
      if (o < c) {                         // truncated: the first c survive
        const int q = r * BLOCK + t;
        dst[r] = o;
        o_jk[o] = K1[q + 1];
        o_pk[o] = K2[q + 1];
      }
    }
  }
  for (int j = 0; j < cols.n; ++j) {
    switch (cols.dtype[j]) {
      case RW_I64:
      case RW_F64:
        copy_rows<int64_t>(cols.a[j], cols.b[j], cols.out[j], c, dst, psrc);
        break;
      case RW_I32:
        copy_rows<int32_t>(cols.a[j], cols.b[j], cols.out[j], c, dst, psrc);
        break;
      default:
        copy_rows<uint8_t>(cols.a[j], cols.b[j], cols.out[j], c, dst, psrc);
    }
  }
}

__global__ void k_side_fill(int64_t* o_jk, int64_t* o_pk, RwCols cols,
                            int64_t c, const int32_t* needed) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= c || i < *needed) return;
  o_jk[i] = EMPTY_KEY;
  o_pk[i] = EMPTY_KEY;
  for (int j = 0; j < cols.n; ++j) put_bits(cols.dtype[j], cols.out[j], i, 0);
}

// ---------------------------------------------------------------------------
// probe: all matches of each query key in the side's sorted jk, expanded
// into m slots, in one counting pass and one load-balanced expansion.
//
// Replaces five launches: a bounds kernel making two binary
// searches of the side per query (~40 dependent loads at C = 2^20), the
// three-launch scan of the counts, and an expansion whose every slot
// binary-searched the q offsets in device memory (~20 dependent loads)
// before a random gather of `lo`. Bound: the queries and their mask read
// once, the side's jk read once, m slots of (row, sidx, mask) written —
// bytes. What costs beyond that is chains of dependent loads and
// scattered sectors, so the design keeps the searches in shared memory
// and every copy's loads in flight together:
//   1. k_probe_tiles: a tile of 2048 queries (from a ticket), loaded
//      striped and staged in shared memory, a thread then taking 8
//      consecutive ones. A coarse sample of the side (every
//      ceil(C / 1024)th key; its loads go out with the ticket's) puts
//      each end of the window [L, R) of side rows that can hold the
//      tile's live keys within one stride, where a warp finds it (two
//      rounds of 32 loads). The window, or a sample of it (every
//      stride-th key, stride = ceil((R - L) / 4096)), is loaded into
//      shared memory. The main path's queries arrive sorted by jk
//      (batch_reduce_rows' order, sign-0 rows masked in place), so the
//      window fits (stride 1) and each key's lower bound comes from one
//      merge path of (the tile's keys, the window), cheaper than a
//      binary search per key, whose shared loads conflict, and its upper
//      bound from a gallop there. Unsorted keys search the
//      window in lockstep, 8 a thread; a sampled window narrows each
//      bound to one stride, finished in device memory the same way. Any
//      query order stays right. The tile's counts are summed per thread
//      and scanned in the block (64-bit), its offset comes by a 64-bit
//      decoupled look-back (pairs may pass 2^32: total must be exact;
//      128 tiles a round trip). Per query it writes the inclusive end
//      `off` and `d = lo - (start of its slots)` (staged, then striped),
//      and the cuts of the expansion below that fall to it; the last
//      tile writes `total`.
//   2. k_probe_expand: a merge path over (the q query ends, the m slots):
//      slot t follows every end <= t, so end i sits at merged position
//      i + min(off[i], m), and a slot's query is the number of ends before
//      it. Query i writes the cut of each 2048-item span of the merged
//      order that starts after end i - 1 and at or before end i (a cut
//      is the ends before the span's start), so no block searches for
//      its span. A block loads its span's ends into shared memory, each
//      thread walks 8 merged items and stages each slot's query, and the
//      slots are written striped: row, sidx = clip(d[row] + t, 0, C - 1),
//      mask = t < total. A span with no query end (a hot key's slots, or
//      the slots past `total`, which take the clipped last query) is a
//      plain fill.
// The scratch holds the ticket and the look-back words (one memset),
// `off`, `d` and the cuts.
// ---------------------------------------------------------------------------

constexpr int PROBE_COARSE = 1024;       // coarse sample of the side
constexpr int PROBE_WINDOW = 2 * TILE;   // window (or its sample) keys
constexpr int PROBE_LB = 4;              // look-back words a lane
// A thread's ITEMS consecutive queries sit in shared memory at padded
// slots, a word skipped every 16, so that the 16 lanes of a half-warp
// reading their r-th query hit 16 different bank pairs
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }
constexpr int TILE_PAD = TILE + TILE / 16;
// dynamic shared memory of k_probe_tiles: the window (then the tile's
// staged ends), the tile's keys (then its staged d), their ranks in the
// window (16-bit: four blocks fit an SM)
constexpr int PROBE_SMEM = PROBE_WINDOW * 8 + TILE_PAD * 8 + TILE * 2;
static_assert(PROBE_WINDOW < 65536 && PROBE_WINDOW >= TILE_PAD,
              "window ranks are 16-bit; the window stages the ends");

// first i in [lo, hi) with a[i] > key, else hi: a gallop from lo (a key
// with few matches ends within a load or two), then a binary search
__device__ __forceinline__ int64_t gallop_upper(const int64_t* a, int64_t lo,
                                                int64_t hi, int64_t key) {
  for (int64_t step = 1; lo < hi; step <<= 1) {
    const int64_t p = lo + step - 1;
    if (p >= hi) break;
    if (a[p] > key) {
      hi = p;
      break;
    }
    lo = p + 1;
  }
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// in S[0, n): the entries < key (strict) or <= key
template <bool STRICT>
__device__ __forceinline__ int64_t rank_in(const int64_t* S, int64_t n,
                                           int64_t key) {
  int64_t lo = 0;
  while (lo < n) {
    const int64_t mid = (lo + n) >> 1;
    if (STRICT ? S[mid] < key : S[mid] <= key) lo = mid + 1; else n = mid;
  }
  return lo;
}

// A thread's ITEMS binary searches in lockstep, so that their loads are in
// flight together: item r's range [base, base + len) of the sorted a ->
// base = the first index there whose value is not < key (STRICT) or not
// <= key. A range of length 0 is done.
template <bool STRICT>
__device__ __forceinline__ void lockstep_rank(const int64_t* a,
                                              int32_t (&base)[ITEMS],
                                              int32_t (&len)[ITEMS],
                                              const int64_t (&key)[ITEMS]) {
  for (;;) {
    int64_t v[ITEMS];
    bool more = false;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (len[r] > 0) {
        v[r] = a[base[r] + (len[r] >> 1)];
        more = true;
      }
    }
    if (!more) return;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (len[r] > 0) {
        const int32_t h = len[r] >> 1;
        if (STRICT ? v[r] < key[r] : v[r] <= key[r]) {
          base[r] += h + 1;
          len[r] -= h + 1;
        } else {
          len[r] = h;
        }
      }
    }
  }
}

// dst[k] = src[first + k * step] for k < n, by the whole block: ITEMS
// loads in flight a thread before any store
__device__ __forceinline__ void gather_keys(int64_t* dst, const int64_t* src,
                                            int64_t first, int64_t step,
                                            int n) {
  for (int k0 = 0; k0 < n; k0 += ITEMS * BLOCK) {
    int64_t v[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int k = k0 + j * BLOCK + int(threadIdx.x);
      if (k < n) v[j] = src[first + k * step];
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int k = k0 + j * BLOCK + int(threadIdx.x);
      if (k < n) dst[k] = v[j];
    }
  }
}

__global__ void __launch_bounds__(BLOCK, 4)
k_probe_tiles(const int64_t* side, int64_t c, const int64_t* qjk,
              const uint8_t* qmask, int64_t q, int64_t m, int64_t* off,
              int64_t* dd, int64_t* cuts, int64_t* total, unsigned* ticket,
              unsigned long long* status) {
  extern __shared__ int64_t smem[];
  int64_t* W = smem;                       // the window (or its sample)
  int64_t* A = W + PROBE_WINDOW;           // the tile's keys, padded
  uint16_t* LO = reinterpret_cast<uint16_t*>(A + TILE_PAD);  // ranks in W
  uint8_t* LV = reinterpret_cast<uint8_t*>(LO);   // first: the live flags
  __shared__ int64_t red[2][WARPS], wsum[WARPS], win[2];
  __shared__ int64_t lo_last, base_s;
  __shared__ int slot;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // the coarse sample: it does not depend on the tile
  const int64_t s0 = c > PROBE_COARSE
      ? (c + PROBE_COARSE - 1) / PROBE_COARSE : 1;
  const int n0 = int((c + s0 - 1) / s0);
  gather_keys(W, side, 0, s0, n0);
  const int64_t tile = take_ticket(ticket, &slot);
  const int64_t base = tile * TILE;
  const bool last_tile = tile == int64_t(gridDim.x) - 1;
  {
    // the tile's keys and live flags, loaded striped (coalesced)
    int64_t k[ITEMS];
    uint8_t f[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = base + j * BLOCK + t;
      k[j] = i < q ? qjk[i] : EMPTY_KEY;
      f[j] = i < q ? qmask[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      A[pad16(j * BLOCK + t)] = k[j];
      LV[j * BLOCK + t] = f[j] != 0 && k[j] != EMPTY_KEY;
    }
  }
  __syncthreads();
  // the thread's ITEMS consecutive queries (past q: EMPTY_KEY, dead)
  const int64_t i0 = base + t * ITEMS;
  int64_t key[ITEMS];
  unsigned live = 0;
  int64_t kmin = EMPTY_KEY, kmax = INT64_MIN;
  bool sorted = t == BLOCK - 1 ||
                A[pad16(t * ITEMS + ITEMS - 1)] <= A[pad16((t + 1) * ITEMS)];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    key[r] = A[pad16(t * ITEMS + r)];
    if (LV[t * ITEMS + r]) {
      live |= 1u << r;
      kmin = key[r] < kmin ? key[r] : kmin;
      kmax = key[r] > kmax ? key[r] : kmax;
    }
    if (r > 0) sorted = sorted && key[r - 1] <= key[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int64_t a = __shfl_xor_sync(FULL, kmin, o);
    const int64_t b = __shfl_xor_sync(FULL, kmax, o);
    kmin = a < kmin ? a : kmin;
    kmax = b > kmax ? b : kmax;
  }
  if (lane == 0) {
    red[0][warp] = kmin;
    red[1][warp] = kmax;
  }
  // the main path's queries are sorted: then ranks come by a merge
  sorted = __syncthreads_and(sorted);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    kmin = red[0][w] < kmin ? red[0][w] : kmin;
    kmax = red[1][w] > kmax ? red[1][w] : kmax;
  }
  // the window [L, R): side rows before L are < kmin, from R on > kmax;
  // each end lies within one coarse stride, searched there by a warp
  if (warp < 2) {
    int64_t v = 0;
    if (kmin <= kmax) {
      const int64_t k = warp ? kmax : kmin;
      const int64_t i = warp ? rank_in<false>(W, n0, k)
                             : rank_in<true>(W, n0, k);
      const int64_t a = i == 0 ? 0 : (i - 1) * s0 + 1;
      const int64_t b = i * s0 < c ? i * s0 : c;
      v = warp ? warp_first_true(a, b, [=](int64_t x) { return side[x] > k; })
               : warp_first_true(a, b,
                                 [=](int64_t x) { return side[x] >= k; });
    }
    if (lane == 0) win[warp] = v;
  } else if (warp == 2 && last_tile) {
    // the last query's lo: the slots past the total take it
    const int64_t k = qmask[q - 1] ? qjk[q - 1] : EMPTY_KEY;
    const int64_t i = rank_in<true>(W, n0, k);
    const int64_t a = i == 0 ? 0 : (i - 1) * s0 + 1;
    const int64_t b = i * s0 < c ? i * s0 : c;
    const int64_t v = warp_first_true(
        a, b, [=](int64_t x) { return side[x] >= k; });
    if (lane == 0) lo_last = v;
  }
  __syncthreads();
  const int64_t L = win[0], nw = win[1] - win[0];
  const int64_t stride = nw > PROBE_WINDOW
      ? (nw + PROBE_WINDOW - 1) / PROBE_WINDOW : 1;
  const int ns = int((nw + stride - 1) / stride);
  gather_keys(W, side, L, stride, ns);
  __syncthreads();
  // each key's rank in the window (sample): the samples < key
  int32_t lo[ITEMS], n[ITEMS], len[ITEMS];
  if (sorted && stride == 1) {
    // a merge path of (the tile's keys, the window), a key first on a
    // tie: each thread walks an equal share of the merged order
    const int nm = TILE + ns, share = (nm + BLOCK - 1) / BLOCK;
    const int d0 = t * share < nm ? t * share : nm;
    const int d1 = d0 + share < nm ? d0 + share : nm;
    int a = int(co_rank_by(TILE, ns, d0, [=](int64_t k, int64_t i) {
      return W[k] < A[pad16(int(i))];
    }));
    int b = d0 - a;
    for (int d = d0; d < d1; ++d) {
      if (a < TILE && (b >= ns || A[pad16(a)] <= W[b])) LO[a++] = uint16_t(b);
      else ++b;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) lo[r] = LO[t * ITEMS + r];
  } else {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      lo[r] = 0;
      len[r] = (live >> r) & 1u ? ns : 0;
    }
    lockstep_rank<true>(W, lo, len, key);
  }
  // ... and the samples <= key: a gallop from there (most keys match 0
  // or 1 side row)
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    n[r] = (live >> r) & 1u ? int32_t(gallop_upper(W, lo[r], ns, key[r]))
                            : lo[r];
  if (stride == 1) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      n[r] -= lo[r];
      lo[r] += int32_t(L);
    }
  } else {
    // finish in device memory: lo in (sample s - 1, sample s], hi in
    // (sample u - 1, sample u], s and u the two ranks
    const int64_t R = L + nw;
    int32_t u[ITEMS];
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      u[r] = n[r];
      const int64_t a = lo[r] == 0 ? L : L + (lo[r] - 1) * stride + 1;
      const int64_t b = L + lo[r] * stride < R ? L + lo[r] * stride : R;
      lo[r] = int32_t(a);
      len[r] = (live >> r) & 1u ? int32_t(b - a) : 0;
    }
    lockstep_rank<true>(side, lo, len, key);
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      const int64_t h0 = u[r] == 0 ? L : L + (u[r] - 1) * stride + 1;
      const int64_t h1 = L + u[r] * stride < R ? L + u[r] * stride : R;
      n[r] = int32_t(h0 > lo[r] ? h0 : lo[r]);
      len[r] = (live >> r) & 1u ? int32_t(h1 - n[r]) : 0;
    }
    lockstep_rank<false>(side, n, len, key);
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) n[r] -= lo[r];
  }
  // the block's counts in query order: the thread's sum, a warp scan,
  // warp 0 scans the warps' sums and takes the tile's offset by look-back
  int64_t tsum = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (!((live >> r) & 1u)) n[r] = 0;    // dead items: no matches
    tsum += n[r];
  }
  int64_t x = tsum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int64_t v = lane < WARPS ? wsum[lane] : 0;
    int64_t y = v;
#pragma unroll
    for (int o = 1; o < WARPS; o <<= 1) {
      const int64_t z = __shfl_up_sync(FULL, y, o);
      if (lane >= o) y += z;
    }
    if (lane < WARPS) wsum[lane] = y - v;
    const int64_t sum = __shfl_sync(FULL, y, WARPS - 1);
    if (lane == 0)
      st_relaxed_u64(status + tile,
                     lb64_word(tile == 0 ? LB_INCL : LB_AGG, sum));
    const int64_t excl = lookback_warp64<PROBE_LB>(status, tile, sum);
    if (lane == 0) {
      base_s = excl;
      if (last_tile) *total = excl + sum;
    }
  }
  __syncthreads();
  // each query's end and d, staged (the window's and the keys' places
  // are free now) and written striped; the expansion's cuts that fall to
  // it written at once (about one a 2048 merged items)
  int64_t e = base_s + wsum[warp] + x - tsum;   // the first query's start
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = i0 + r;
    const int64_t o = e + n[r];
    W[pad16(t * ITEMS + r)] = o;
    A[pad16(t * ITEMS + r)] = (i == q - 1 ? lo_last : lo[r]) - e;
    if (i < q) {
      // end i sits at merged position pe, end i - 1 at ps: the spans
      // starting in (ps, pe] have i ends before them
      const int64_t pe = i + (o < m ? o : m);
      const int64_t ps = i - 1 + (e < m ? e : m);
      for (int64_t b = ps < 0 ? 0 : ps / TILE + 1; b <= pe / TILE; ++b)
        cuts[b] = i;
      if (i == q - 1) {                          // and those after end q - 1
        const int64_t nb = tiles_of(q + m);
        for (int64_t b = pe / TILE + 1; b <= nb; ++b) cuts[b] = q;
      }
    }
    e = o;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = base + j * BLOCK + t;
    if (i < q) {
      off[i] = W[pad16(j * BLOCK + t)];
      dd[i] = A[pad16(j * BLOCK + t)];
    }
  }
}

__global__ void __launch_bounds__(BLOCK, 4)
k_probe_expand(const int64_t* off, const int64_t* dd, const int64_t* cuts,
               int64_t q, int64_t c, int64_t m, int32_t* row, int64_t* sidx,
               uint8_t* mask) {
  __shared__ int64_t O[TILE];          // the span's query ends
  __shared__ int32_t RW[TILE];         // each slot's ends before it
  const int t = threadIdx.x;
  const int64_t n = q + m;
  const int64_t p0 = int64_t(blockIdx.x) * TILE;
  const int64_t p1 = n - p0 < TILE ? n : p0 + TILE;
  const int64_t i0 = cuts[blockIdx.x], i1 = cuts[blockIdx.x + 1];
  const int64_t j0 = p0 - i0;
  const int nb = int(p1 - i1 - j0), na = int(i1 - i0);
  const int64_t last = q - 1;
  if (nb == 0) return;                  // only query ends
  if (na == 0) {
    // every slot of the span belongs to query i0 (i0 == q: past the total)
    const int64_t r = i0 < q ? i0 : last;
    const int64_t dv = dd[r];
    const uint8_t mk = i0 < q;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int k = j * BLOCK + t;
      if (k < nb) {
        int64_t s = dv + j0 + k;
        s = s < 0 ? 0 : (s > c - 1 ? c - 1 : s);
        row[j0 + k] = int32_t(r);
        sidx[j0 + k] = s;
        mask[j0 + k] = mk;
      }
    }
    return;
  }
  gather_keys(O, off, i0, 1, na);
  __syncthreads();
  const int len = int(p1 - p0);
  const int d0 = t * ITEMS;
  if (d0 < len) {
    int a = int(co_rank_by(na, nb, d0, [=](int64_t k, int64_t i) {
      return j0 + k < O[i];
    }));
    int b = d0 - a;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (d0 + r < len) {
        if (a < na && (b >= nb || O[a] <= j0 + b)) {
          ++a;
        } else {
          RW[b] = a;
          ++b;
        }
      }
    }
  }
  __syncthreads();
  // the slots striped: every d of the thread's slots loaded before any
  // store
  int64_t rc[ITEMS], dv[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * BLOCK + t;
    if (k < nb) {
      rc[j] = i0 + RW[k];
      dv[j] = dd[rc[j] < q ? rc[j] : last];
    }
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int k = j * BLOCK + t;
    if (k < nb) {
      int64_t s = dv[j] + j0 + k;
      s = s < 0 ? 0 : (s > c - 1 ? c - 1 : s);
      row[j0 + k] = int32_t(rc[j] < q ? rc[j] : last);
      sidx[j0 + k] = s;
      mask[j0 + k] = rc[j] < q;
    }
  }
}

}  // namespace

extern "C" {

int64_t rw_rows_scratch_bytes(int64_t n) {
  return reduce_layout(nullptr, n, true).bytes;
}

int64_t rw_probe_scratch_bytes(int64_t q, int64_t m) {
  return 256 + align256(tiles_of(q) * 8) + 2 * align256(q * 8) +
         align256((tiles_of(q + m) + 1) * 8);
}

int rw_reduce_rows(const int64_t* sk, const int64_t* pk, const int64_t* perm,
                   int64_t n, RwCols cols, int64_t* ujk, int64_t* upk,
                   void* scratch, void* stream) {
  if (n <= 0) return 0;
  const int sites[3] = {RW_S_ROWS_TILES, RW_S_ROWS_CARRY, RW_S_ROWS_GATHER};
  return reduce_tiles_launch<true>(sk, pk, perm, n, cols, ujk, upk, nullptr,
                                   scratch, static_cast<cudaStream_t>(stream),
                                   sites);
}

int rw_side_merge(const int64_t* s_jk, const int64_t* s_pk, int64_t c,
                  const int64_t* d_jk, const int64_t* d_pk,
                  const int32_t* d_sign, int64_t b, RwCols cols,
                  int64_t* o_jk, int64_t* o_pk, int32_t* needed,
                  void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  const SweepScratch s = sweep_layout(scratch, n);
  const int64_t nt = tiles_of(n);
  if (const cudaError_t e = cudaMemsetAsync(s.ticket, 0,
                                            size_t(s.zero_bytes), st))
    return RW_S_SIDE_MERGE * RW_SITE_STRIDE + int(e);
  k_side_cuts<<<blocks_of(nt + 1), BLOCK, 0, st>>>(s_jk, s_pk, c, d_jk, d_pk,
                                                   b, nt, s.cuts);
  RW_CHECK(RW_S_SIDE_CUTS);
  k_side_merge<<<unsigned(nt), BLOCK, 0, st>>>(
      s_jk, s_pk, c, d_jk, d_pk, d_sign, b, s.cuts, cols, o_jk, o_pk, needed,
      s.ticket, s.status);
  RW_CHECK(RW_S_SIDE_MERGE);
  if (c > 0) {
    k_side_fill<<<blocks_of(c), BLOCK, 0, st>>>(o_jk, o_pk, cols, c, needed);
    RW_CHECK(RW_S_SIDE_FILL);
  }
  return 0;
}

int rw_probe(const int64_t* side_jk, int64_t c, const int64_t* qjk,
             const uint8_t* qmask, int64_t q, int64_t m, int32_t* row,
             int64_t* sidx, uint8_t* mask, int64_t* total, void* scratch,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q <= 0) return 0;
  const int64_t nt = tiles_of(q);
  char* p = static_cast<char*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(p);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(p + 256);
  const int64_t zero = 256 + align256(nt * 8);
  int64_t* off = reinterpret_cast<int64_t*>(p + zero);
  int64_t* dd = off + align256(q * 8) / 8;
  int64_t* cuts = dd + align256(q * 8) / 8;
  static bool smem_set = false;     // above 48 KB: opt in, once
  if (!smem_set) {
    if (const cudaError_t e = cudaFuncSetAttribute(
            k_probe_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize,
            PROBE_SMEM))
      return RW_S_PROBE_TILES * RW_SITE_STRIDE + int(e);
    smem_set = true;
  }
  if (const cudaError_t e = cudaMemsetAsync(p, 0, size_t(zero), st))
    return RW_S_PROBE_TILES * RW_SITE_STRIDE + int(e);
  k_probe_tiles<<<unsigned(nt), BLOCK, PROBE_SMEM, st>>>(side_jk, c, qjk, qmask, q, m,
                                                off, dd, cuts, total, ticket,
                                                status);
  RW_CHECK(RW_S_PROBE_TILES);
  if (m > 0) {
    k_probe_expand<<<unsigned(tiles_of(q + m)), BLOCK, 0, st>>>(
        off, dd, cuts, q, c, m, row, sidx, mask);
    RW_CHECK(RW_S_PROBE_EXPAND);
  }
  return 0;
}

}  // extern "C"

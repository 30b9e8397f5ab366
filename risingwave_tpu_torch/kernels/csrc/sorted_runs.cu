// Hand-written CUDA kernels (sm_90a) for the four sorted-run cores of
// risingwave_tpu/device/sorted_state.py:
//
//   sort_cols     :189  -> rw_sort_perm       one-sweep LSD radix sort
//   batch_reduce  :108  -> rw_batch_reduce    tiled segmented reduce
//   merge         :227  -> rw_merge           one merge-path pass that
//                                             combines and compacts
//   compact_rows  :206  -> rw_compact_rows    one pass with look-back
//
// In the JAX package these are XLA programs built from lax.sort and
// segment ops. Every one of them moves a few words per row and does
// almost no arithmetic, so each is bound by device-memory bytes (3.35
// TB/s on an H100 SXM). The design keeps every pass a streaming pass over
// tiles of 256 threads and does the data-dependent work (digit ranks,
// segment scans, merge-path searches) in registers and shared memory.
// Every one of them scans across tiles in the same launch by decoupled
// look-back (rw_common.cuh: tiles ordered by an atomic ticket, status
// words zeroed once per call and tagged per pass). The reduce and the
// typed combine live in reduce_tiles.cuh, shared with batch_reduce_rows
// and ms_batch_reduce; merge's tile pass is merge_side's (join_runs.cu)
// with one key and that typed combine. No TMA, no persistent blocks.
#include "reduce_tiles.cuh"

namespace {

constexpr uint64_t SIGN = 0x8000000000000000ULL;

// ---------------------------------------------------------------------------
// sort: a stable one-sweep LSD radix sort of 1–2 int64 keys, 8-bit digits,
// the sign bit flipped so negative keys order first.
//
// Replaces an LSD sort that ran all 8 passes of every key, each pass five
// launches, one of them a single block walking every (digit, tile) count.
// Bound: a live pass reads a key and a perm and writes both (24 B a row;
// 2^20 rows: 7.5 us at 3.35 TB/s), so the work is the number of live
// passes. The design:
//   1. k_sort_upsweep reads each key column once and builds all 8 digit
//      histograms of every key together; EMPTY_KEY rows are counted apart.
//   2. k_sort_plan (one block) scans the bins into bucket starts and lists
//      the live passes on the device: a digit is dead when one bin holds
//      every non-EMPTY row. k2's live digits come first, then k1's. The
//      epoch never waits on the host for this: the host launches 8 passes
//      per key and launch p runs list entry p or exits at once, so launch
//      p reads ping-pong buffer p & 1 and the last live pass writes the
//      outputs.
//   3. k_sort_pass: one launch per pass. A tile of 256 x 16 rows (58 KB
//      of dynamic shared memory) takes its index from a ticket, ranks its
//      rows stably in shared memory (each warp ranks its rows in row order
//      with __match_any_sync, then warp offsets per bucket), publishes its
//      bucket counts and reads its predecessors' by decoupled look-back
//      (one lane per bucket, 8 words a read), and writes keys and perm out
//      of shared memory bucket run by bucket run, so stores coalesce.
//      What still holds a pass back at large n is the look-back: every
//      resident tile waits for the inclusive prefix to reach it, and the
//      prefix crosses a window of tiles per L2 round trip.
//   4. EMPTY_KEY rows form bucket 256, after every digit: each live pass
//      moves them to the tail in their current order, which is where a
//      stable sort puts the largest value. The dead-digit test sees live
//      keys only (flipped, EMPTY has 0xFF in every byte and would make
//      every digit live).
//   5. Two keys: k2's passes, then k1's. The first pass of a key reads its
//      column through the perm (a gather); later passes read the key the
//      pass before carried; a key's last pass carries no key on.
// Traps: every live key equal with EMPTY rows present still takes one
// pass (the top digit's) to move EMPTY to the tail — a key equal to
// EMPTY_KEY is already the largest value; with no pass at all, launch 0
// writes the identity. The look-back words come from torch.empty: they
// are zeroed on the stream once per call and tagged with the pass. The
// perm stays int32 inside the sort (the binding refuses n >= 2^31).
// ---------------------------------------------------------------------------

constexpr int SORT_ITEMS = 16;                    // rows per thread per pass
constexpr int SORT_TILE = BLOCK * SORT_ITEMS;     // 4096 rows
constexpr int EMPTY_BUCKET = 256;                 // after the 256 digits
constexpr int NBUCKET = 257;
constexpr int MAX_PASSES = 16;                    // 8 digits x 2 keys
constexpr int UPSWEEP_ROWS = 4;                   // rows per thread per round
constexpr int UPSWEEP_BLOCKS = 1056;              // eight per SM of an H100
constexpr uint64_t ALL_ONES = ~0ULL;              // EMPTY_KEY, sign flipped

inline int64_t sort_tiles(int64_t n) {
  return (n + SORT_TILE - 1) / SORT_TILE;
}

// The live passes in order, as k_sort_plan found them.
struct SortPlan {
  int npass;
  int key[MAX_PASSES];            // 0: k1, 1: k2
  int shift[MAX_PASSES];
  int first[MAX_PASSES];          // first pass of its key: read it by perm
  int last[MAX_PASSES];           // last pass of its key: carry no key on
  int base[MAX_PASSES][NBUCKET];  // global start of each bucket
};

__device__ __forceinline__ int bucket_of(uint64_t u, int shift) {
  return u == ALL_ONES ? EMPTY_BUCKET : int((u >> shift) & 255u);
}

// Every digit histogram of k1 (and k2) in one read: hist[key][digit][bin]
// over non-EMPTY rows, nempty[key] the EMPTY rows. A warp whose live lanes
// share a bin adds once; otherwise each lane adds (shared atomics).
__global__ void __launch_bounds__(BLOCK)
k_sort_upsweep(const int64_t* k1, const int64_t* k2, int64_t n, int* hist,
               int* nempty) {
  __shared__ int h[2 * 8 * 256];
  __shared__ int se[2];
  const int t = threadIdx.x, lane = t & 31;
  for (int i = t; i < 2 * 8 * 256; i += BLOCK) h[i] = 0;
  if (t < 2) se[t] = 0;
  __syncthreads();
  int ne[2] = {0, 0};
  const int64_t step = int64_t(gridDim.x) * BLOCK * UPSWEEP_ROWS;
  for (int64_t b0 = int64_t(blockIdx.x) * BLOCK * UPSWEEP_ROWS; b0 < n;
       b0 += step) {
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const int64_t* k = kc ? k2 : k1;
      if (k == nullptr) continue;
      int64_t v[UPSWEEP_ROWS];
#pragma unroll
      for (int r = 0; r < UPSWEEP_ROWS; ++r) {
        const int64_t i = b0 + r * BLOCK + t;
        v[r] = i < n ? k[i] : EMPTY_KEY;
      }
#pragma unroll
      for (int r = 0; r < UPSWEEP_ROWS; ++r) {
        const bool in = b0 + r * BLOCK + t < n;
        const bool live = in && v[r] != EMPTY_KEY;
        ne[kc] += (in && !live) ? 1 : 0;
        const unsigned act = __ballot_sync(FULL, live);
        if (live) {
          const uint64_t u = uint64_t(v[r]) ^ SIGN;
          const int leader = __ffs(act) - 1;
          int* hk = h + kc * 2048;
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const unsigned d = unsigned(u >> (8 * b)) & 255u;
            if (__reduce_min_sync(act, d) == __reduce_max_sync(act, d)) {
              if (lane == leader) atomicAdd(&hk[b * 256 + d], __popc(act));
            } else {
              atomicAdd(&hk[b * 256 + d], 1);
            }
          }
        }
      }
    }
  }
  const unsigned e0 = __reduce_add_sync(FULL, unsigned(ne[0]));
  const unsigned e1 = __reduce_add_sync(FULL, unsigned(ne[1]));
  if (lane == 0) {
    if (e0) atomicAdd(&se[0], int(e0));
    if (e1) atomicAdd(&se[1], int(e1));
  }
  __syncthreads();
  const int nk = k2 ? 2 : 1;
  for (int i = t; i < nk * 2048; i += BLOCK)
    if (h[i]) atomicAdd(&hist[i], h[i]);
  if (t < nk && se[t]) atomicAdd(&nempty[t], se[t]);
}

// One block: the live passes and each one's bucket starts (the bins'
// exclusive scan; the EMPTY bucket starts after the live rows).
__global__ void __launch_bounds__(BLOCK)
k_sort_plan(const int* hist, const int* nempty, int nk, int64_t n,
            SortPlan* plan) {
  __shared__ int wt[WARPS];
  const int t = threadIdx.x;
  int np = 0;
  for (int o = 0; o < nk; ++o) {
    const int kc = nk - 1 - o;                // the less significant key first
    const int ne = nempty[kc];
    const int nl = int(n) - ne;
    const int p0 = np;
    for (int b = 0; b < 8; ++b) {
      const int c = hist[(kc * 8 + b) * 256 + t];
      const bool dead = __syncthreads_or(c == nl) != 0;
      // no live digit, but EMPTY rows among live ones: the top digit's
      // pass still moves the EMPTY rows to the tail
      const bool partition = b == 7 && np == p0 && ne > 0 && nl > 0;
      if (dead && !partition) continue;
      int total;
      const int e = block_excl_scan<int>(c, wt, total);
      plan->base[np][t] = e;
      if (t == 0) {
        plan->base[np][EMPTY_BUCKET] = nl;
        plan->key[np] = kc;
        plan->shift[np] = 8 * b;
        plan->first[np] = np == p0;
        plan->last[np] = 0;
      }
      ++np;
    }
    if (t == 0 && np > p0) plan->last[np - 1] = 1;
  }
  if (t == 0) plan->npass = np;
}

// A pass tile's shared memory (dynamic: above 48 KB).
struct PassSmem {
  uint64_t skey[SORT_TILE];       // the tile staged in bucket order
  int32_t sperm[SORT_TILE];
  int whist[WARPS][NBUCKET];      // per warp: bucket counts, then offsets
  int tstart[NBUCKET];            // the tile's start of each bucket
  int delta[NBUCKET];             // global minus tile start of each bucket
  int wt[WARPS];
  int slot;
};

// Launch p of the passes: list entry p, or nothing (launch 0 writes the
// identity when the list is empty). Reads kin/pin (the pass before's
// order), writes kout/pout, or perm and sorted_k1 when it is the last.
__global__ void __launch_bounds__(BLOCK)
k_sort_pass(int p, const SortPlan* plan, const int64_t* k1,
            const int64_t* k2, int64_t n, const uint64_t* kin,
            const int32_t* pin, uint64_t* kout, int32_t* pout, int64_t* perm,
            int64_t* sorted_k1, unsigned* tickets,
            unsigned long long* status) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);
  uint64_t* skey = sm.skey;
  int32_t* sperm = sm.sperm;
  int (*whist)[NBUCKET] = sm.whist;
  int* tstart = sm.tstart;
  int* delta = sm.delta;
  int* wt = sm.wt;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int np = plan->npass;
  if (p >= np) {
    if (p == 0) {               // no live pass: the input order is sorted
      const int64_t b0 = int64_t(blockIdx.x) * SORT_TILE;
      for (int r = t; r < SORT_TILE; r += BLOCK) {
        const int64_t i = b0 + r;
        if (i < n) {
          perm[i] = i;
          if (sorted_k1) sorted_k1[i] = k1[i];
        }
      }
    }
    return;
  }
  for (int i = t; i < WARPS * NBUCKET; i += BLOCK) (&whist[0][0])[i] = 0;
  const int64_t tile = take_ticket(&tickets[p], &sm.slot);
  const int kc = plan->key[p], shift = plan->shift[p];
  const bool first = plan->first[p] != 0;
  const bool carry = plan->last[p] == 0;
  const bool final_pass = p == np - 1;
  const int64_t* src = kc ? k2 : k1;
  // warp-striped: warp w holds rows w * 384 .. of the tile, item j of lane
  // l is row j * 32 + l of them, so items in order are rows in order
  const int64_t w0 = tile * SORT_TILE + int64_t(warp) * (32 * SORT_ITEMS) +
                     lane;
  int32_t pv[SORT_ITEMS];
  uint64_t key[SORT_ITEMS];
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int64_t i = w0 + j * 32;
    pv[j] = i < n ? (p == 0 ? int32_t(i) : pin[i]) : 0;
  }
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int64_t i = w0 + j * 32;
    key[j] = i >= n ? ALL_ONES
             : first ? uint64_t(src[pv[j]]) ^ SIGN
                     : kin[i];
  }
  const unsigned lt = (1u << lane) - 1u;
  int rank[SORT_ITEMS];
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const bool valid = w0 + j * 32 < n;
    const unsigned act = __ballot_sync(FULL, valid);
    rank[j] = 0;
    if (valid) {
      const int d = bucket_of(key[j], shift);
      const unsigned peers = __match_any_sync(act, d);
      const int leader = __ffs(peers) - 1;
      int prior = 0;
      if (lane == leader) prior = atomicAdd(&whist[warp][d], __popc(peers));
      rank[j] = __shfl_sync(act, prior, leader) + __popc(peers & lt);
    }
  }
  __syncthreads();
  // per bucket: each warp's offset, and the tile's count
  for (int d = t; d < NBUCKET; d += BLOCK) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int c = whist[w][d];
      whist[w][d] = acc;
      acc += c;
    }
    tstart[d] = acc;
  }
  __syncthreads();
  const int cnt = tstart[t];
  const int cnt_empty = tstart[EMPTY_BUCKET];
  int live;
  const int ex = block_excl_scan<int>(cnt, wt, live);
  tstart[t] = ex;
  if (t == 0) tstart[EMPTY_BUCKET] = live;
  // global start of this tile's run of each bucket: a look-back lane
  // each, every count published before any lane waits
  const unsigned tag = unsigned(p) + 1u;
  for (int d = t; d < NBUCKET; d += BLOCK)
    lookback_publish(status + d, tile, NBUCKET, tag,
                     unsigned(d == EMPTY_BUCKET ? cnt_empty : cnt));
  for (int d = t; d < NBUCKET; d += BLOCK) {
    const bool em = d == EMPTY_BUCKET;
    const unsigned before = lookback_wait<8>(
        status + d, tile, NBUCKET, tag, unsigned(em ? cnt_empty : cnt));
    delta[d] = plan->base[p][d] + int(before) - (em ? live : ex);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    if (w0 + j * 32 < n) {
      const int d = bucket_of(key[j], shift);
      const int s = tstart[d] + whist[warp][d] + rank[j];
      skey[s] = key[j];
      sperm[s] = pv[j];
    }
  }
  __syncthreads();
  const int64_t t0 = tile * SORT_TILE;
  const int rows = n - t0 < SORT_TILE ? int(n - t0) : SORT_TILE;
  for (int s = t; s < rows; s += BLOCK) {
    const uint64_t u = skey[s];
    const int32_t q = sperm[s];
    const int64_t g = int64_t(delta[bucket_of(u, shift)]) + s;
    if (final_pass) {
      perm[g] = q;
      if (sorted_k1) sorted_k1[g] = kc == 0 ? int64_t(u ^ SIGN) : k1[q];
    } else {
      pout[g] = q;
      if (carry) kout[g] = u;
    }
  }
}

struct SortScratch {
  uint64_t* k[2];                 // ping-pong keys (flipped)
  int32_t* p[2];                  // ping-pong perm
  SortPlan* plan;
  char* zero;                     // hist .. status, zeroed once per call
  int64_t zero_bytes;
  int* hist;                      // [2][8][256]
  int* nempty;                    // [2]
  unsigned* tickets;              // [MAX_PASSES]
  unsigned long long* status;     // [tiles][NBUCKET]
  int64_t bytes;
};

SortScratch sort_layout(void* scratch, int64_t n) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(scratch);
  int64_t off = 0;
  auto take = [&](int64_t bytes) {
    const int64_t o = off;
    off += align256(bytes);
    return reinterpret_cast<char*>(base + uintptr_t(o));
  };
  SortScratch s;
  for (int i = 0; i < 2; ++i) s.k[i] = reinterpret_cast<uint64_t*>(take(n * 8));
  for (int i = 0; i < 2; ++i) s.p[i] = reinterpret_cast<int32_t*>(take(n * 4));
  s.plan = reinterpret_cast<SortPlan*>(take(int64_t(sizeof(SortPlan))));
  const int64_t z0 = off;
  s.zero = take(0);
  s.hist = reinterpret_cast<int*>(take(2 * 8 * 256 * 4));
  s.nempty = reinterpret_cast<int*>(take(2 * 4));
  s.tickets = reinterpret_cast<unsigned*>(take(MAX_PASSES * 4));
  s.status = reinterpret_cast<unsigned long long*>(
      take(sort_tiles(n) * NBUCKET * 8));
  s.zero_bytes = off - z0;
  s.bytes = off;
  return s;
}


// ---------------------------------------------------------------------------
// merge: one pass over the merged order of (state, delta) that places,
// combines and compacts, straight into the new state.
//
// Replaces a placement kernel (one global binary search per merged row,
// writing merged keys and an int32 source), a combine kernel (every
// column gathered through the source and written in merged order, plus
// an alive byte) and compact_rows over all of that: three full passes over
// C + B rows and ~(C + B) x (13 + 8k) bytes of temporaries. Bound: each
// run's live rows read once (keys and every column) and C rows written —
// bytes, at 3.35 TB/s. The design, merge_side's (join_runs.cu) with one
// key and a typed combine:
//   1. k_merge_cuts: one co-rank search per tile edge on the merge path of
//      (state keys, delta keys), a state row first on ties (its delta twin
//      is the next merged row).
//   2. k_merge_tiles: a tile of 2048 merged rows takes its index from a
//      ticket. EMPTY_KEY sorts last, so a tile whose first merged key is
//      EMPTY holds only EMPTY rows and every tile after it too: it
//      publishes 0 and returns, and no live tile waits on it. A live tile
//      loads its state and delta keys into shared memory and each thread
//      merges its 8 rows (a co-rank search in shared memory, then a
//      two-cursor merge). The merged rows just before and just after the
//      tile come from global memory, so a state row and its delta twin may
//      straddle a tile edge. Read again striped (row r x 256 + thread),
//      each row is what the reference makes of it
//      (risingwave_tpu/device/sorted_state.py:248-256): a candidate when
//      !same_prev and key != EMPTY_KEY; on a pair each column is
//      comb(kind, state, delta) (reduce_tiles.cuh), else the row's own;
//      with drop_dead the candidate dies when its combined dead column is
//      0. A ballot per warp and a scan of the 64 (stripe, warp) counts
//      rank the survivors; the tile's offset comes by decoupled look-back
//      (a window of 32 words read a word a lane, so the rows' state stays
//      in registers through the wait). Survivors below C go out through
//      shared memory — keys, then column by column, each staged at its
//      rank and written as one run, consecutive lanes to consecutive
//      slots; every load of a column is issued before any of its stores,
//      the next column's before the run goes out and the first column's
//      before the look-back, so a tile waits on memory about once a
//      column. The last tile with live rows writes `needed`, every
//      survivor counted (those past C too).
//   3. k_merge_fill: slots [min(needed, C), C) get EMPTY_KEY and each
//      column's fill (its neutral value).
// Out of place: the input state stays intact (growth replay re-runs the
// epoch from it). Sources are int32 (state row, or c + delta row), so
// c + b < 2^31 (the binding refuses more). A pair's float SUM is one add,
// as in the reference.
// ---------------------------------------------------------------------------

// cuts[t] = the state rows before merged row t x TILE, t in [0, nt].
__global__ void k_merge_cuts(const int64_t* s, int64_t c, const int64_t* d,
                             int64_t b, int64_t nt, int64_t* cuts) {
  const int64_t t = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (t > nt) return;
  const int64_t n = c + b;
  const int64_t p = t * TILE < n ? t * TILE : n;
  cuts[t] = co_rank(s, c, d, b, p);
}

template <typename T>
__device__ __forceinline__ T side_val(const void* a, const void* b, int64_t c,
                                      int32_t r) {
  return r < c ? static_cast<const T*>(a)[r]
               : static_cast<const T*>(b)[r - c];
}

// A tile's column as raw bits (merge and compact_rows): int64 and f64 as 8
// bytes, int32 as 4, bool as 1. load_col loads the value of each of a
// thread's rows whose bit r is set in `on` (row r x BLOCK + t of the
// tile); stage_rows puts each at its rank among the tile's survivors;
// store_run writes the first `keep` staged values to out[base ..],
// consecutive lanes to consecutive slots.
template <typename T>
__device__ __forceinline__ void load_rows(const void* in, int64_t p0,
                                          unsigned on, uint64_t* v) {
  const T* a = static_cast<const T*>(in) + p0 + threadIdx.x;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if ((on >> r) & 1u) v[r] = a[r * BLOCK];
}

__device__ __forceinline__ void load_col(int dt, const void* in, int64_t p0,
                                         unsigned on, uint64_t* v) {
  switch (dt) {
    case RW_I64:
    case RW_F64: load_rows<uint64_t>(in, p0, on, v); break;
    case RW_I32: load_rows<uint32_t>(in, p0, on, v); break;
    default: load_rows<uint8_t>(in, p0, on, v);
  }
}

template <typename T>
__device__ __forceinline__ void stage_rows(int64_t* stage, unsigned on,
                                           const int* rank,
                                           const uint64_t* v) {
  T* st = reinterpret_cast<T*>(stage);
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if ((on >> r) & 1u) st[rank[r]] = T(v[r]);
}

template <typename T>
__device__ __forceinline__ void store_run(void* out, int64_t base, int keep,
                                          const int64_t* stage) {
  const T* st = reinterpret_cast<const T*>(stage);
  T* o = static_cast<T*>(out) + base;
  for (int k = threadIdx.x; k < keep; k += BLOCK) o[k] = st[k];
}

// A thread's rows in a merge tile: row r is merged row r x BLOCK + t of
// the tile, its source at SRC[q + 1] and, where bit r of `pair` is set,
// its delta twin's at SRC[q + 2] (the merged rows sit one slot up in
// SRC; a pair's first row is the state row). load_pairs loads both
// values of each row whose bit is set in `on`, as raw bits.
template <typename T>
__device__ __forceinline__ void load_pair_rows(const void* a, const void* b,
                                               int64_t c, const int32_t* SRC,
                                               unsigned on, unsigned pair,
                                               uint64_t* v0, uint64_t* v1) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + threadIdx.x;
    if ((on >> r) & 1u) {
      v0[r] = side_val<T>(a, b, c, SRC[q + 1]);
      if ((pair >> r) & 1u) v1[r] = static_cast<const T*>(b)[SRC[q + 2] - c];
    }
  }
}

__device__ __forceinline__ void load_pairs(int dt, const void* a,
                                           const void* b, int64_t c,
                                           const int32_t* SRC, unsigned on,
                                           unsigned pair, uint64_t* v0,
                                           uint64_t* v1) {
  switch (dt) {
    case RW_I64:
    case RW_F64: load_pair_rows<uint64_t>(a, b, c, SRC, on, pair, v0, v1);
      break;
    case RW_I32: load_pair_rows<uint32_t>(a, b, c, SRC, on, pair, v0, v1);
      break;
    default: load_pair_rows<uint8_t>(a, b, c, SRC, on, pair, v0, v1);
  }
}

// comb (reduce_tiles.cuh) of a state value and its delta twin's, as bits
__device__ __forceinline__ uint64_t comb_bits(int dt, int kind, uint64_t a,
                                              uint64_t b) {
  switch (dt) {
    case RW_I64:
      return uint64_t(comb<int64_t>(kind, int64_t(a), int64_t(b)));
    case RW_F64:
      return uint64_t(__double_as_longlong(comb<double>(
          kind, __longlong_as_double(int64_t(a)),
          __longlong_as_double(int64_t(b)))));
    case RW_I32:
      return uint32_t(comb<int32_t>(kind, int32_t(uint32_t(a)),
                                    int32_t(uint32_t(b))));
    default:
      return comb<uint8_t>(kind, uint8_t(a), uint8_t(b));
  }
}

// v0[r] becomes row r's value: combined with its twin's on a pair
__device__ __forceinline__ void combine_rows(int dt, int kind, unsigned on,
                                             unsigned pair, uint64_t* v0,
                                             const uint64_t* v1) {
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    if ((on >> r) & (pair >> r) & 1u) v0[r] = comb_bits(dt, kind, v0[r],
                                                        v1[r]);
}

// three blocks an SM (41 KB of shared memory, at most 80 registers)
__global__ void __launch_bounds__(BLOCK, 3)
k_merge_tiles(const int64_t* s, int64_t c, const int64_t* d, int64_t b,
              const int64_t* cuts, RwCols cols, int drop_dead, int dead_col,
              int64_t* o_keys, int32_t* needed, unsigned* ticket,
              unsigned long long* status) {
  // the tile's input keys at [0, len), then its merged rows at [1, len]
  // with the row before the tile at 0 and the row after it at len + 1
  __shared__ int64_t K[TILE + 2];
  __shared__ int32_t SRC[TILE + 2];
  __shared__ int64_t stage[TILE];          // the survivors of one column
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
    const int64_t fs = i0 < c ? s[i0] : EMPTY_KEY;
    const int64_t fd = j0 < b ? d[j0] : EMPTY_KEY;
    if ((fs < fd ? fs : fd) == EMPTY_KEY) {   // only EMPTY rows from here
      if (t == 0) {
        lookback_publish(status, tile, 1, 1u, 0u);
        if (tile == 0) *needed = 0;
      }
      return;
    }
  }
  const int ns = int(i1 - i0), nd = int(j1 - j0);
  for (int q = t; q < ns; q += BLOCK) K[q] = s[i0 + q];
  for (int q = t; q < nd; q += BLOCK) K[ns + q] = d[j0 + q];
  __syncthreads();
  int64_t mk[ITEMS];
  int32_t ms[ITEMS];
  const int d0 = t * ITEMS;
  if (d0 < len) {
    int a = int(co_rank(K, ns, K + ns, nd, d0));
    int e = d0 - a;
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (d0 + r < len) {
        const bool st = a < ns && (e >= nd || !(K[ns + e] < K[a]));
        const int q = st ? a++ : ns + e++;
        mk[r] = K[q];
        ms[r] = st ? int32_t(i0 + q) : int32_t(c + j0 + (q - ns));
      }
    }
  }
  __syncthreads();
  if (d0 < len) {
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (d0 + r < len) {
        K[1 + d0 + r] = mk[r];
        SRC[1 + d0 + r] = ms[r];
      }
    }
  }
  if (t == 0 && p0 > 0) {
    // merged row p0 - 1: the later of state[i0 - 1] and delta[j0 - 1]
    const bool dl = j0 > 0 && (i0 == 0 || !(d[j0 - 1] < s[i0 - 1]));
    K[0] = dl ? d[j0 - 1] : s[i0 - 1];
  }
  if (t == 32 && p0 + len < n) {
    // merged row p0 + len: the earlier of state[i1] and delta[j1]
    const bool sd = i1 < c && (j1 >= b || !(d[j1] < s[i1]));
    K[len + 1] = sd ? s[i1] : d[j1];
    SRC[len + 1] = sd ? int32_t(i1) : int32_t(c + j1);
  }
  __syncthreads();
  // bit r: row r is its key's first merged row and not EMPTY (live), and
  // its delta twin is the next merged row (pair)
  unsigned live = 0, pair = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + t;
    const int64_t p = p0 + q;
    if (q < len) {
      const int64_t k = K[q + 1];
      if (!(p > 0 && K[q] == k) && k != EMPTY_KEY) {
        live |= 1u << r;
        if (p + 1 < n && K[q + 2] == k) pair |= 1u << r;
      }
    }
  }
  uint64_t v0[ITEMS], v1[ITEMS];
  if (drop_dead) {
    // the combined dead column: 0 kills the row (its group dies)
    const int dt = cols.dtype[dead_col];
    load_pairs(dt, cols.a[dead_col], cols.b[dead_col], c, SRC, live, pair,
               v0, v1);
    combine_rows(dt, cols.kind[dead_col], live, pair, v0, v1);
#pragma unroll
    for (int r = 0; r < ITEMS; ++r) {
      if (!((live >> r) & 1u)) continue;
      const bool zero = dt == RW_F64
          ? __longlong_as_double(int64_t(v0[r])) == 0.0 : v0[r] == 0;
      if (zero) live &= ~(1u << r);
    }
  }
  unsigned ball[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    ball[r] = __ballot_sync(FULL, (live >> r) & 1u);
    if (lane == 0) cnt[r * WARPS + warp] = __popc(ball[r]);
  }
  // the last tile with live rows: the row after it is EMPTY, or none
  const bool last_live = p0 + len == n || K[len + 1] == EMPTY_KEY;
  // the first column's loads wait out the look-back
  if (cols.n > 0)
    load_pairs(cols.dtype[0], cols.a[0], cols.b[0], c, SRC, live, pair, v0,
               v1);
  __syncthreads();
  if (warp == 0) {
    int total;
    const unsigned base = tile_offsets(cnt, tile, status, total);
    if (lane == 0) {
      base_s = base;
      count_s = total;
      if (last_live) *needed = int32_t(base + total);
    }
  }
  __syncthreads();
  // survivors below C: staged in shared memory by rank and written out in
  // order, keys first, then column by column — column j + 1 loaded before
  // column j is written out (every load of a column before any store)
  const int64_t base = base_s;
  if (base >= c) return;                   // truncated: the first c survive
  const int keep = int(c - base < count_s ? c - base : count_s);
  const unsigned below = (1u << lane) - 1u;
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    rank[r] = cnt[r * WARPS + warp] + __popc(ball[r] & below);
    if ((live >> r) & 1u) stage[rank[r]] = K[r * BLOCK + t + 1];
  }
  __syncthreads();
  store_run<int64_t>(o_keys, base, keep, stage);
  __syncthreads();
  for (int j = 0; j < cols.n; ++j) {
    const int dt = cols.dtype[j];
    combine_rows(dt, cols.kind[j], live, pair, v0, v1);
    switch (dt) {
      case RW_I64:
      case RW_F64: stage_rows<uint64_t>(stage, live, rank, v0); break;
      case RW_I32: stage_rows<uint32_t>(stage, live, rank, v0); break;
      default: stage_rows<uint8_t>(stage, live, rank, v0);
    }
    __syncthreads();
    if (j + 1 < cols.n)
      load_pairs(cols.dtype[j + 1], cols.a[j + 1], cols.b[j + 1], c, SRC,
                 live, pair, v0, v1);
    switch (dt) {
      case RW_I64:
      case RW_F64: store_run<uint64_t>(cols.out[j], base, keep, stage); break;
      case RW_I32: store_run<uint32_t>(cols.out[j], base, keep, stage); break;
      default: store_run<uint8_t>(cols.out[j], base, keep, stage);
    }
    __syncthreads();                       // the run is out of `stage`
  }
}

__global__ void k_merge_fill(int64_t* o_keys, RwCols cols, int64_t c,
                             const int32_t* needed) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= c || i < *needed) return;
  o_keys[i] = EMPTY_KEY;
  for (int j = 0; j < cols.n; ++j)
    put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
}

// ---------------------------------------------------------------------------
// compact_rows: one pass with decoupled look-back.
//
// Replaces the three-launch scan (tile sums, a scan of the sums, a rescan
// that scattered each alive row column by column, every launch reading
// `alive` again, each copy waiting for the store before it). Bound: the
// flags read once, the kept rows read once and out_len rows written —
// bytes. k_compact_tiles: a tile of 2048 rows takes its index from a
// ticket, loads its flags (8 rows a thread, striped), ranks the alive
// rows by a ballot per warp and a scan of the 64 (stripe, warp) counts,
// and gets its offset by decoupled look-back; the last tile writes
// `total`, every alive row counted. A tile whose rows all rank past
// out_len stops there. Otherwise, column by column, each thread's alive
// rows are loaded (all of them before any is stored), staged in shared
// memory at their ranks, and the block writes the staged run out in
// order, so consecutive lanes write consecutive slots. The loads of the
// next column are issued before the run is written, and those of the
// first before the look-back, so a tile waits for memory once rather
// than once per phase. k_compact_fill gives slots
// [total, out_len) the fills.
// ---------------------------------------------------------------------------

// four blocks an SM (at most 64 registers): tiles in flight hide memory
__global__ void __launch_bounds__(BLOCK, 4)
k_compact_tiles(const uint8_t* alive, int64_t n, RwCols cols, int64_t len,
                int32_t* total, unsigned* ticket,
                unsigned long long* status) {
  __shared__ int64_t stage[TILE];
  __shared__ int cnt[ITEMS * WARPS];
  __shared__ int slot;
  __shared__ unsigned base_s;
  __shared__ int count_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t tile = take_ticket(ticket, &slot);
  const int64_t p0 = tile * TILE;
  unsigned on = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int64_t i = p0 + r * BLOCK + t;
    if (i < n && alive[i] != 0) on |= 1u << r;
  }
  unsigned ball[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    ball[r] = __ballot_sync(FULL, (on >> r) & 1u);
    if (lane == 0) cnt[r * WARPS + warp] = __popc(ball[r]);
  }
  // the first column's loads wait out the look-back
  uint64_t v[ITEMS];
  if (cols.n > 0) load_col(cols.dtype[0], cols.a[0], p0, on, v);
  __syncthreads();
  if (warp == 0) {
    int tot;
    const unsigned base = tile_offsets(cnt, tile, status, tot);
    if (lane == 0) {
      base_s = base;
      count_s = tot;
      if (tile == int64_t(gridDim.x) - 1) *total = int32_t(base + tot);
    }
  }
  __syncthreads();
  const int64_t base = base_s;
  if (base >= len) return;                 // every row here ranks past len
  const int keep = int(len - base < count_s ? len - base : count_s);
  const unsigned below = (1u << lane) - 1u;
  int rank[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r)
    rank[r] = cnt[r * WARPS + warp] + __popc(ball[r] & below);
  // column j is staged, then column j + 1 loaded before j is written out
  for (int j = 0; j < cols.n; ++j) {
    const int dt = cols.dtype[j];
    switch (dt) {
      case RW_I64:
      case RW_F64: stage_rows<uint64_t>(stage, on, rank, v); break;
      case RW_I32: stage_rows<uint32_t>(stage, on, rank, v); break;
      default: stage_rows<uint8_t>(stage, on, rank, v);
    }
    __syncthreads();
    if (j + 1 < cols.n) load_col(cols.dtype[j + 1], cols.a[j + 1], p0, on, v);
    switch (dt) {
      case RW_I64:
      case RW_F64: store_run<uint64_t>(cols.out[j], base, keep, stage); break;
      case RW_I32: store_run<uint32_t>(cols.out[j], base, keep, stage); break;
      default: store_run<uint8_t>(cols.out[j], base, keep, stage);
    }
    __syncthreads();                       // the run is out of `stage`
  }
}

__global__ void k_compact_fill(RwCols cols, int64_t len, const int* total) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= len || i < *total) return;
  for (int j = 0; j < cols.n; ++j)
    put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
}

}  // namespace

extern "C" {

int64_t rw_sweep_scratch_bytes(int64_t n) {
  return sweep_layout(nullptr, n).bytes;
}

int64_t rw_sort_scratch_bytes(int64_t n) {
  return sort_layout(nullptr, n).bytes;
}

int64_t rw_reduce_scratch_bytes(int64_t n) {
  return reduce_layout(nullptr, n, false).bytes;
}

int rw_sort_perm(const int64_t* k1, const int64_t* k2, int64_t n,
                 int64_t* perm, int64_t* sorted_k1, void* scratch,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const SortScratch s = sort_layout(scratch, n);
  if (const cudaError_t e = cudaMemsetAsync(s.zero, 0, size_t(s.zero_bytes),
                                            st))
    return RW_S_SORT_UPSWEEP * RW_SITE_STRIDE + int(e);
  const int nk = k2 ? 2 : 1;
  const int64_t ub = (n + BLOCK * UPSWEEP_ROWS - 1) / (BLOCK * UPSWEEP_ROWS);
  k_sort_upsweep<<<unsigned(ub < UPSWEEP_BLOCKS ? ub : UPSWEEP_BLOCKS), BLOCK,
                   0, st>>>(k1, k2, n, s.hist, s.nempty);
  RW_CHECK(RW_S_SORT_UPSWEEP);
  k_sort_plan<<<1, BLOCK, 0, st>>>(s.hist, s.nempty, nk, n, s.plan);
  RW_CHECK(RW_S_SORT_PLAN);
  const unsigned nt = unsigned(sort_tiles(n));
  const int smem = int(sizeof(PassSmem));
  if (const cudaError_t e = cudaFuncSetAttribute(
          k_sort_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return RW_S_SORT_PASS * RW_SITE_STRIDE + int(e);
  for (int p = 0; p < 8 * nk; ++p) {
    k_sort_pass<<<nt, BLOCK, smem, st>>>(
        p, s.plan, k1, k2, n, s.k[p & 1], s.p[p & 1], s.k[(p + 1) & 1],
        s.p[(p + 1) & 1], perm, sorted_k1, s.tickets, s.status);
    RW_CHECK(RW_S_SORT_PASS);
  }
  return 0;
}

int rw_batch_reduce(const int64_t* sk, const int64_t* perm, int64_t n,
                    RwCols cols, int64_t* ukeys, int32_t* ucount,
                    void* scratch, void* stream) {
  if (n <= 0) return 0;
  const int sites[3] = {RW_S_REDUCE_TILES, RW_S_REDUCE_CARRY, 0};
  return reduce_tiles_launch<false>(sk, nullptr, perm, n, cols, ukeys, nullptr,
                                    ucount, scratch,
                                    static_cast<cudaStream_t>(stream), sites);
}

int rw_merge(const int64_t* s, int64_t c, const int64_t* d, int64_t b,
             RwCols cols, int drop_dead, int dead_col, int64_t* o_keys,
             int32_t* needed, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  const SweepScratch sc = sweep_layout(scratch, n);
  const int64_t nt = tiles_of(n);
  if (const cudaError_t e = cudaMemsetAsync(sc.ticket, 0,
                                            size_t(sc.zero_bytes), st))
    return RW_S_MERGE_TILES * RW_SITE_STRIDE + int(e);
  k_merge_cuts<<<blocks_of(nt + 1), BLOCK, 0, st>>>(s, c, d, b, nt, sc.cuts);
  RW_CHECK(RW_S_MERGE_CUTS);
  k_merge_tiles<<<unsigned(nt), BLOCK, 0, st>>>(
      s, c, d, b, sc.cuts, cols, drop_dead, dead_col, o_keys, needed,
      sc.ticket, sc.status);
  RW_CHECK(RW_S_MERGE_TILES);
  if (c > 0) {
    k_merge_fill<<<blocks_of(c), BLOCK, 0, st>>>(o_keys, cols, c, needed);
    RW_CHECK(RW_S_MERGE_FILL);
  }
  return 0;
}

int rw_compact_rows(const uint8_t* alive, int64_t n, RwCols cols,
                    int64_t out_len, int32_t* total, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t len = out_len < n ? out_len : n;
  const SweepScratch sc = sweep_layout(scratch, n);
  if (const cudaError_t e = cudaMemsetAsync(sc.ticket, 0,
                                            size_t(sc.zero_bytes), st))
    return RW_S_COMPACT_TILES * RW_SITE_STRIDE + int(e);
  k_compact_tiles<<<unsigned(tiles_of(n)), BLOCK, 0, st>>>(
      alive, n, cols, len, total, sc.ticket, sc.status);
  RW_CHECK(RW_S_COMPACT_TILES);
  if (len > 0) {
    k_compact_fill<<<blocks_of(len), BLOCK, 0, st>>>(cols, len, total);
    RW_CHECK(RW_S_COMPACT_FILL);
  }
  return 0;
}

}  // extern "C"

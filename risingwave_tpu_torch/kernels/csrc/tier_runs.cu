// Hand-written CUDA kernels (sm_90a) for the ★ state-tiering cores of
// risingwave_tpu/device/fused.py:
//
//   AggNode._tier_tail :1186, the join's touch tail :1584-1605 and the
//   promote cores' touch carry :1852-1860, :1891-1898
//                                            -> rw_touch_stamp
//   _agg_evict_core :1758, _mv_evict_core :1788, _join_evict_core :1809
//   (the membership searchsorted and the compact_rows passes)
//                                            -> rw_tier_partition
//
// rw_touch_stamp: in the JAX package two searchsorteds, two gathers and
// two masked sums over the key table. All three key runs are sorted — the
// new table A, the old table B, the touched / promoted keys S — so one
// merge-path pass gives every row of A its lower bound in B (the first old
// row of its key, whose stamp it carries) and in S, streaming each run
// once; it replaces one thread per row doing both binary searches (~44
// dependent reads a row at C = 2^23, T = 2^21, the lower levels missing
// L2). Bound: A, B and S read once, B's stamps read at the rows found, the
// stamps written once — bytes, at 3.35 TB/s. The design:
//   1. The merged order of the three runs is by key, A before B before S
//      on ties, so a row of A follows exactly the B and S rows below its
//      key: its lower bound in B (S) is the B (S) rows merged before it.
//   2. k_ts_cuts, 8 lanes per cut (8-ary searches: 8 dependent reads
//      for 2^23 rows, not 23), cuts that order twice: every 2048 rows of
//      the merge of A and B (a co-rank search, then the S rows below both
//      next keys: one lower bound), and every 2048 rows of the merge of A
//      and S (the B rows below both next keys). Every cut is a
//      prefix of the merged order, so each finds its place in the merged
//      list of both by counting, with no search, and the pieces between
//      consecutive cuts hold at most 2048 rows of A and B and at most 2048
//      of A and S, however the keys fall: many deleted old keys, or many
//      touched keys, between two new ones only make more pieces.
//   3. k_touch_stamp, a block per piece (none of A: it returns at once):
//      stages the piece's A, B and S keys, and the B and S rows after
//      them, in shared memory (a spare slot every 16 keys against bank
//      conflicts). Each thread merges 8 positions of A with B and 8 of A
//      with S (a co-rank search in shared memory, then two cursors),
//      noting per A row its first old row and its touched row where the
//      keys are equal: the same steps in every lane (a binary search per
//      row, or galloping per thread, measured slower). Then every thread
//      loads the stamps of its rows striped (coalesced) — all loads
//      before any store — writes them, and the block adds its (live,
//      cold) counts with one 64-bit atomic pair.
// A run of equal keys may straddle any cut: a piece reads the B (S) row
// after its range too, so an A row whose first old row lies in the next
// piece still finds it.
//
// rw_tier_partition: in the JAX package a searchsorted of the table into
// the demoted keys, then one compact_rows pass (agg / MV) or two (join:
// the kept rows and the demoted rows). Here one three-phase scan
// (rw_common.cuh) over a packed int64 flag — 1 for a kept row, 2^32 for a
// hit — gives each row both its kept rank (low 32 bits of the exclusive
// prefix) and its hit rank (high 32 bits), so one pass moves each row to
// its prefix; a fill kernel writes the reference's fills past each
// prefix. Each row pays one binary search into the (small) demoted-key
// list per scan phase that reads its flag. Bound by the bytes of the
// table it reads once and of the one or two tables it writes.
#include "tier_runs.h"

#include "rw_common.cuh"

namespace {

// A prefix of the merged order: its rows of A, B and S.
struct Cut {
  int64_t a, b, s;
};

// The least m in [lo, hi) with pred(m) true — pred false then true over
// the range — or hi. A group of 8 lanes searches together, probing 8
// points of the range a step, so a search of 2^23 rows takes 8 dependent
// reads instead of 23 (32 lanes a search would take 5, but fetch 4x the
// sectors: measured slower). The 4 groups of a warp search at once, each
// its own range; every lane of the warp calls it.
constexpr int GROUP = 8;
template <class P>
__device__ __forceinline__ int64_t group_search(int64_t lo, int64_t hi,
                                                P pred) {
  const int g = threadIdx.x & (GROUP - 1);
  const int shift = threadIdx.x & 31 & ~(GROUP - 1);
  for (;;) {
    const bool on = lo < hi;
    if (!__any_sync(FULL, on)) break;
    const int64_t len = hi - lo;
    const int64_t m = len <= GROUP ? lo + g : lo + len * g / GROUP;
    const unsigned hit =
        (__ballot_sync(FULL, on && m < hi && pred(m)) >> shift) & 0xFFu;
    if (!on) continue;
    if (len <= GROUP) {
      lo = hi = hit ? lo + __ffs(hit) - 1 : hi;
      continue;
    }
    const int k = hit ? __ffs(hit) - 1 : GROUP;
    // the probes of lanes k - 1 and k bracket the answer
    const int64_t below = k == 0 ? lo - 1 : lo + len * (k - 1) / GROUP;
    if (k < GROUP) hi = lo + len * k / GROUP;
    lo = below + 1;
  }
  return lo;
}

__device__ __forceinline__ int64_t ceil_tiles(int64_t rows) {
  return (rows + TILE - 1) / TILE;
}

// Group t <= tab: the cut after min(t x TILE, na + nb) rows of the merge
// of A and B, with every S row below the next A row and the next B row;
// group tab + 1 + u, u <= tas: the cut after min(u x TILE, na + ns) rows
// of the merge of A and S, with every B row below the next A row and up to
// the next S row. Each is a prefix of the merged order, so the two lists
// merge into one by counting (the A-B cut first on equal prefixes): cut t
// follows the ceil((a + s) / TILE) A-S cuts of a smaller A-S prefix; cut u
// follows the ceil((a + b) / TILE) A-B cuts of a smaller A-B prefix and,
// when one has its A-B prefix and it took every S row it could, that one.
// cuts[] gets them in that order, tab + tas + 2 in all.
__global__ void k_ts_cuts(const int64_t* A, int64_t na, const int64_t* B,
                          int64_t nb, const int64_t* S, int64_t ns,
                          int64_t tab, int64_t tas, Cut* cuts) {
  const int64_t t = (int64_t(blockIdx.x) * BLOCK + threadIdx.x) / GROUP;
  const bool on = t <= tab + 1 + tas, ab = t <= tab;
  const int64_t u = t - tab - 1;
  // the co-rank of A in its merge with X (B or S): the A rows among the
  // first p, a row of A first on ties
  const int64_t* X = ab ? B : S;
  const int64_t nx = ab ? nb : ns;
  const int64_t pt = ab ? t * TILE : u * TILE;
  const int64_t p = pt < na + nx ? pt : na + nx;
  const int64_t a = group_search(
      on && p > nx ? p - nx : 0, on ? (p < na ? p : na) : 0,
      [&](int64_t m) { return X[p - 1 - m] < A[m]; });
  const int64_t x = p - a;
  // the other run's rows below the next keys: for an A-B cut the S rows
  // below the next A and B rows, for an A-S cut the B rows below the next
  // A row and up to the next S row
  const int64_t* Y = ab ? S : B;
  const int64_t ny = ab ? ns : nb;
  int64_t v = 0;
  bool strict = false, search = on;
  if (ab) {
    search = on && (a < na || x < nb);
    v = a >= na ? (x < nb ? B[x] : 0) : x >= nb ? A[a]
        : (A[a] < B[x] ? A[a] : B[x]);
  } else if (a < na && (x >= ns || A[a] <= S[x])) {
    v = A[a];
  } else {
    search = on && x < ns;
    v = x < ns ? S[x] : 0;
    strict = true;
  }
  const int64_t y = group_search(search ? 0 : ny, ny, [&](int64_t i) {
    return strict ? Y[i] > v : Y[i] >= v;
  });
  if (!on || (threadIdx.x & (GROUP - 1))) return;
  if (ab) {
    cuts[t + ceil_tiles(a + y)] = Cut{a, x, y};
  } else {
    const int64_t b = y, s = x;
    // the A-B cut with this A-B prefix, if any, equals this cut when no
    // further S row precedes both the next A row and the next B row
    bool same = false;
    if ((a + b) % TILE == 0 || a + b == na + nb)
      same = s >= ns || (a < na && S[s] >= A[a]) || (b < nb && S[s] >= B[b]);
    cuts[u + ceil_tiles(a + b) + same] = Cut{a, b, s};
  }
}

// A piece's keys sit in shared memory with one spare slot after every 16:
// the threads of a merge start 8 positions apart, and unpadded a warp's
// 8-byte loads 64 bytes apart would meet on four pairs of banks.
constexpr int PADDED = TILE + 1 + (TILE + 1) / 16 + 1;
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// A piece's rows of A, at a[pad(0 .. na)), and the rows that hold their
// lower bounds, at x[pad(xo .. xo + nx)) (and the row after them at xo +
// nx, valid when `more`): out[i] = the lower bound of a[i] among those
// rows when that row holds a[i]'s key, else -1. Each thread merges 8
// consecutive positions of their merged order (a first on ties) after a
// co-rank search: na + nx <= TILE.
__device__ __forceinline__ void piece_hits(const int64_t* a, int na,
                                           const int64_t* x, int xo, int nx,
                                           bool more, int16_t* out) {
  const int d0 = threadIdx.x * ITEMS;
  if (d0 >= na + nx) return;
  int lo = d0 > nx ? d0 - nx : 0, hi = d0 < na ? d0 : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[pad(xo + d0 - 1 - mid)] < a[pad(mid)]) hi = mid; else lo = mid + 1;
  }
  int i = lo, j = d0 - lo;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    if (d0 + r < na + nx) {
      const int64_t ka = i < na ? a[pad(i)] : 0;
      const int64_t kx = j < nx || more ? x[pad(xo + j)] : 0;
      if (i < na && (j >= nx || ka <= kx)) {
        out[i] = (j < nx || more) && kx == ka ? int16_t(j) : int16_t(-1);
        ++i;
      } else {
        ++j;
      }
    }
  }
}

// One block per piece between consecutive cuts: at most TILE rows of A and
// B, and of A and S, together.
__global__ void __launch_bounds__(BLOCK)
k_touch_stamp(const int64_t* A, const int64_t* B, const int64_t* btouch,
              int64_t nb, const int64_t* S, const int64_t* svals, int64_t ns,
              const Cut* cuts, const int64_t* tick_p, int64_t ttl,
              int64_t empty_key, int64_t* out, unsigned long long* counts) {
  __shared__ int64_t KAB[PADDED];       // the piece's A rows, then its B
                                        // rows and the B row after them
  __shared__ int64_t KS[PADDED];        // its S rows and the one after
  __shared__ int16_t LB[TILE];          // per A row: its old row, or -1
  __shared__ int16_t LS[TILE];          // its S row, or -1
  __shared__ unsigned long long red[2][WARPS];
  const int t = threadIdx.x;
  const Cut c0 = cuts[blockIdx.x], c1 = cuts[blockIdx.x + 1];
  const int la = int(c1.a - c0.a);
  if (la == 0) return;                  // only B or S rows: nothing to stamp
  const int lb = int(c1.b - c0.b), ls = int(c1.s - c0.s);
  const bool bmore = c1.b < nb, smore = c1.s < ns;
  for (int q = t; q < la; q += BLOCK) KAB[pad(q)] = A[c0.a + q];
  for (int q = t; q < lb + bmore; q += BLOCK) KAB[pad(la + q)] = B[c0.b + q];
  for (int q = t; q < ls + smore; q += BLOCK) KS[pad(q)] = S[c0.s + q];
  __syncthreads();
  piece_hits(KAB, la, KAB, la, lb, bmore, LB);
  piece_hits(KAB, la, KS, 0, ls, smore, LS);
  __syncthreads();
  // each thread's rows striped: every stamp loaded before any is stored
  const int64_t tick = *tick_p;
  int64_t v[ITEMS];
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + t;
    v[r] = 0;
    if (q < la && KAB[pad(q)] != empty_key) {
      const int ob = LB[q], os = LS[q];
      if (svals)                        // promotion: the old table wins
        v[r] = ob >= 0 ? btouch[c0.b + ob]
                       : (os >= 0 ? svals[c0.s + os] : 0);
      else                              // epoch stamp: a touch wins
        v[r] = os >= 0 ? tick : (ob >= 0 ? btouch[c0.b + ob] : 0);
    }
  }
  unsigned long long live = 0, cold = 0;
#pragma unroll
  for (int r = 0; r < ITEMS; ++r) {
    const int q = r * BLOCK + t;
    if (q < la) {
      out[c0.a + q] = v[r];
      if (KAB[pad(q)] != empty_key) {
        ++live;
        cold += tick - v[r] >= ttl;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    live += __shfl_down_sync(FULL, live, o);
    cold += __shfl_down_sync(FULL, cold, o);
  }
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) {
    red[0][warp] = live;
    red[1][warp] = cold;
  }
  __syncthreads();
  if (t == 0) {
    unsigned long long x = 0, y = 0;
    for (int w = 0; w < WARPS; ++w) {
      x += red[0][w];
      y += red[1][w];
    }
    if (x) atomicAdd(&counts[0], x);
    if (y) atomicAdd(&counts[1], y);
  }
}

struct TouchScratch {
  int64_t tab, tas;               // tiles of the A-B and A-S merges
  Cut* cuts;                      // [tab + tas + 2]
  int64_t bytes;
};

TouchScratch touch_layout(void* scratch, int64_t n, int64_t n_old,
                          int64_t n_src) {
  TouchScratch s;
  s.tab = tiles_of(n + n_old);
  s.tas = tiles_of(n + n_src);
  s.cuts = static_cast<Cut*>(scratch);
  s.bytes = align256((s.tab + s.tas + 2) * int64_t(sizeof(Cut)));
  return s;
}

// 1 for a kept row, 2^32 for a hit, 0 for an empty slot.
struct PartFlag {
  const int64_t* keys;
  const int64_t* dkeys;
  int64_t L;
  int64_t empty;
  __device__ long long operator()(int64_t i) const {
    const int64_t k = keys[i];
    if (k == empty) return 0;
    const int64_t j = lower_bound(dkeys, L, k);
    return (j < L && dkeys[j] == k) ? (1LL << 32) : 1LL;
  }
};

struct PartScatter {
  RwCols cols;
  int want_hits;
  __device__ void operator()(int64_t i, long long rank, long long v) const {
    if (v == 1) {
      const int64_t r = rank & 0xFFFFFFFFLL;
      for (int j = 0; j < cols.n; ++j)
        copy_elem(cols.dtype[j], cols.a[j], i, cols.out[j], r);
    } else if (v != 0 && want_hits) {
      const int64_t r = rank >> 32;
      for (int j = 0; j < cols.n; ++j)
        copy_elem(cols.dtype[j], cols.a[j], i,
                  const_cast<void*>(cols.b[j]), r);
    }
  }
};

__global__ void k_partition_fill(RwCols cols, int64_t n, int want_hits,
                                 const long long* total, int32_t* counts) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  const long long t = *total;
  const int64_t kept = t & 0xFFFFFFFFLL, hits = t >> 32;
  if (i == 0) {
    counts[0] = int32_t(kept);
    counts[1] = int32_t(hits);
  }
  if (i >= n) return;
  if (i >= kept)
    for (int j = 0; j < cols.n; ++j)
      put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
  if (want_hits && i >= hits)
    for (int j = 0; j < cols.n; ++j)
      put_bits(cols.dtype[j], const_cast<void*>(cols.b[j]), i,
               cols.fill[j]);
}

}  // namespace

extern "C" {

int64_t rw_touch_scratch_bytes(int64_t n, int64_t n_old, int64_t n_src) {
  return touch_layout(nullptr, n, n_old, n_src).bytes;
}

int rw_touch_stamp(const int64_t* keys, int64_t n, const int64_t* old_keys,
                   const int64_t* old_touch, int64_t n_old,
                   const int64_t* src_keys, const int64_t* src_vals,
                   int64_t n_src, const int64_t* tick, int64_t ttl,
                   int64_t empty_key, int64_t* ntouch, int64_t* counts,
                   void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const TouchScratch s = touch_layout(scratch, n, n_old, n_src);
  k_ts_cuts<<<blocks_of(GROUP * (s.tab + s.tas + 2)), BLOCK, 0, st>>>(
      keys, n, old_keys, n_old, src_keys, n_src, s.tab, s.tas, s.cuts);
  RW_CHECK(RW_T_TOUCH_CUTS);
  k_touch_stamp<<<unsigned(s.tab + s.tas + 1), BLOCK, 0, st>>>(
      keys, old_keys, old_touch, n_old, src_keys, src_vals, n_src, s.cuts,
      tick, ttl, empty_key, ntouch,
      reinterpret_cast<unsigned long long*>(counts));
  RW_CHECK(RW_T_TOUCH_STAMP);
  return 0;
}

int64_t rw_tier_scratch_bytes(int64_t n) { return scan_bytes<long long>(n); }

int rw_tier_partition(const int64_t* keys, int64_t n, const int64_t* dkeys,
                      int64_t L, RwCols cols, int want_hits,
                      int64_t empty_key, int32_t* counts, void* scratch,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  long long* sums = static_cast<long long*>(scratch);
  if (int rc = scan_apply(PartFlag{keys, dkeys, L, empty_key},
                          PartScatter{cols, want_hits}, n, sums, nullptr,
                          st))
    return rc;
  k_partition_fill<<<blocks_of(n), BLOCK, 0, st>>>(
      cols, n, want_hits, sums + tiles_of(n), counts);
  RW_CHECK(RW_T_PARTITION_FILL);
  return 0;
}

}  // extern "C"

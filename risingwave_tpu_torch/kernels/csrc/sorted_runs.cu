// Hand-written CUDA kernels (sm_90a) for the four sorted-run cores of
// risingwave_tpu/device/sorted_state.py:
//
//   sort_cols     :189  -> rw_sort_perm       one-sweep LSD radix sort
//   batch_reduce  :108  -> rw_batch_reduce    tiled segmented reduce
//   merge         :227  -> rw_merge_combine   merge-path placement + combine
//   compact_rows  :206  -> rw_compact_rows    three-phase scan + scatter
//
// In the JAX package these are XLA programs built from lax.sort and
// segment ops. Every one of them moves a few words per row and does
// almost no arithmetic, so each is bound by device-memory bytes (3.35
// TB/s on an H100 SXM). The design keeps every pass a streaming pass over
// tiles of 256 threads and does the data-dependent work (digit ranks,
// segment scans, binary searches) in registers and shared memory. The sort
// and the reduce scan across tiles in the same launch by decoupled
// look-back (rw_common.cuh: tiles ordered by an atomic ticket, status words
// zeroed once per call and tagged per pass); merge and compact_rows keep
// the three-launch scan. The reduce and the typed combine live in
// reduce_tiles.cuh, shared with batch_reduce_rows. No TMA, no persistent
// blocks.
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
// merge: both sides sorted, so no sort — state row i lands at
// i + #(delta < key), delta row j at j + #(state <= key): a stable merge
// with the state row first on ties. Runs of <= 2 then combine positionally.
// ---------------------------------------------------------------------------

__global__ void k_merge_place(const int64_t* s, int64_t c, const int64_t* d,
                              int64_t b, int64_t* mk, int32_t* src) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= c + b) return;
  int64_t key, pos;
  if (p < c) {
    key = s[p];
    pos = p + lower_bound(d, b, key);
  } else {
    key = d[p - c];
    pos = (p - c) + upper_bound(s, c, key);
  }
  mk[pos] = key;
  src[pos] = int32_t(p);
}

template <typename T>
__device__ __forceinline__ T side_val(const void* a, const void* b, int64_t c,
                                      int32_t r) {
  return r < c ? static_cast<const T*>(a)[r]
               : static_cast<const T*>(b)[r - c];
}

template <typename T>
__device__ __forceinline__ bool merge_col(int kind, const void* a,
                                          const void* b, int64_t c, int32_t r0,
                                          int32_t r1, void* out, int64_t p) {
  T v = side_val<T>(a, b, c, r0);
  if (r1 >= 0) v = comb<T>(kind, v, side_val<T>(a, b, c, r1));
  static_cast<T*>(out)[p] = v;
  return v != T(0);
}

__global__ void k_merge_combine(const int64_t* mk, const int32_t* src,
                                int64_t c, int64_t n, RwCols cols,
                                int drop_dead, int dead_col, uint8_t* alive) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= n) return;
  const int64_t key = mk[p];
  const bool same_next = p + 1 < n && mk[p + 1] == key;
  const bool same_prev = p > 0 && mk[p - 1] == key;
  const int32_t r0 = src[p];
  const int32_t r1 = same_next ? src[p + 1] : -1;
  bool dead_nz = true;
  for (int j = 0; j < cols.n; ++j) {
    bool nz;
    switch (cols.dtype[j]) {
      case RW_I64:
        nz = merge_col<int64_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
        break;
      case RW_I32:
        nz = merge_col<int32_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
        break;
      case RW_F64:
        nz = merge_col<double>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                               cols.out[j], p);
        break;
      default:
        nz = merge_col<uint8_t>(cols.kind[j], cols.a[j], cols.b[j], c, r0, r1,
                                cols.out[j], p);
    }
    if (j == dead_col) dead_nz = nz;
  }
  alive[p] = !same_prev && key != EMPTY_KEY && (!drop_dead || dead_nz);
}

// ---------------------------------------------------------------------------
// compact_rows: exclusive scan of the alive flags gives each alive row
// its output slot; rows past out_len are dropped; slots past the alive
// total get the fills.
// ---------------------------------------------------------------------------

struct AliveAt {
  const uint8_t* a;
  __device__ int operator()(int64_t i) const { return a[i] != 0; }
};
struct ScatterAlive {
  RwCols cols;
  int64_t out_len;
  __device__ void operator()(int64_t i, int rank, int v) const {
    if (!v || rank >= out_len) return;
    for (int j = 0; j < cols.n; ++j)
      copy_elem(cols.dtype[j], cols.a[j], i, cols.out[j], rank);
  }
};

__global__ void k_compact_fill(RwCols cols, int64_t len, const int* total) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= len || i < *total) return;
  for (int j = 0; j < cols.n; ++j)
    put_bits(cols.dtype[j], cols.out[j], i, cols.fill[j]);
}

}  // namespace

extern "C" {

int64_t rw_scan_scratch_bytes(int64_t n) { return scan_bytes<int>(n); }

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

int rw_merge_combine(const int64_t* s, int64_t c, const int64_t* d,
                     int64_t b, RwCols cols, int drop_dead, int dead_col,
                     int64_t* mk, uint8_t* alive, int32_t* src,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  k_merge_place<<<blocks_of(n), BLOCK, 0, st>>>(s, c, d, b, mk, src);
  RW_CHECK(RW_S_MERGE_PLACE);
  k_merge_combine<<<blocks_of(n), BLOCK, 0, st>>>(mk, src, c, n, cols,
                                                  drop_dead, dead_col, alive);
  RW_CHECK(RW_S_MERGE_COMBINE);
  return 0;
}

int rw_compact_rows(const uint8_t* alive, int64_t n, RwCols cols,
                    int64_t out_len, int32_t* total, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  const int64_t len = out_len < n ? out_len : n;
  int* sums = static_cast<int*>(scratch);
  if (int rc = scan_apply(AliveAt{alive}, ScatterAlive{cols, len}, n, sums,
                          total, st))
    return rc;
  if (len > 0) {
    k_compact_fill<<<blocks_of(len), BLOCK, 0, st>>>(cols, len,
                                                     sums + tiles_of(n));
    RW_CHECK(RW_S_COMPACT_FILL);
  }
  return 0;
}

}  // extern "C"

// Hand-written CUDA kernels (sm_90a) for the three join-side cores of
// risingwave_tpu/device/join_step.py:
//
//   batch_reduce_rows :57   -> rw_reduce_rows   tiled segmented reduce
//                                               over (jk, pk)
//   merge_side        :83   -> rw_side_merge    one merge-path pass that
//                                               combines and compacts
//   probe             :118  -> rw_probe         binary-search ranges, count
//                                               scan, per-slot expansion
//
// In the JAX package these are XLA programs built from a two-key
// lax.sort, segment ops, searchsorted and cumsum. Like the sorted-run
// cores they move a few words per row and do almost no arithmetic, so
// each is bound by device-memory bytes — except probe's expansion, whose
// floor is the ~log2(q) dependent reads of one binary search per output
// slot. batch_reduce_rows sorts with the two-key radix sort of
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
// probe: per query, [lo, hi) of its key in the side's sorted jk; an
// inclusive 64-bit scan of the counts gives each query its slot range;
// each of the m slots finds its query by a binary search of the scan.
// ---------------------------------------------------------------------------

__global__ void k_probe_bounds(const int64_t* side_jk, int64_t c,
                               const int64_t* qjk, const uint8_t* qmask,
                               int64_t q, int64_t* lo, int64_t* cnt) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= q) return;
  const bool on = qmask[i] != 0;
  const int64_t key = on ? qjk[i] : EMPTY_KEY;
  const int64_t l = lower_bound(side_jk, c, key);
  lo[i] = l;
  cnt[i] = (on && key != EMPTY_KEY) ? upper_bound(side_jk, c, key) - l : 0;
}

struct Count64 {
  const int64_t* c;
  __device__ int64_t operator()(int64_t i) const { return c[i]; }
};
struct StoreIncl {
  int64_t* off;
  __device__ void operator()(int64_t i, int64_t excl, int64_t v) const {
    off[i] = excl + v;
  }
};

__global__ void k_probe_expand(const int64_t* off, const int64_t* lo,
                               int64_t q, int64_t c, int64_t m,
                               const int64_t* total, int32_t* row,
                               int64_t* sidx, uint8_t* mask) {
  const int64_t t = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (t >= m) return;
  const int64_t r = upper_bound(off, q, t);  // first query whose end > t
  const int64_t rc = r < q ? r : q - 1;
  const int64_t prev = rc > 0 ? off[rc - 1] : 0;
  int64_t s = lo[rc] + (t - prev);
  s = s < 0 ? 0 : (s > c - 1 ? c - 1 : s);
  row[t] = int32_t(rc);
  sidx[t] = s;
  mask[t] = t < *total;
}

}  // namespace

extern "C" {

int64_t rw_rows_scratch_bytes(int64_t n) {
  return reduce_layout(nullptr, n, true).bytes;
}

int64_t rw_probe_scratch_bytes(int64_t q) {
  return 3 * align256(q * 8) + scan_bytes<int64_t>(q);
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
  char* p = static_cast<char*>(scratch);
  int64_t* lo = reinterpret_cast<int64_t*>(p);
  p += align256(q * 8);
  int64_t* cnt = reinterpret_cast<int64_t*>(p);
  p += align256(q * 8);
  int64_t* off = reinterpret_cast<int64_t*>(p);
  p += align256(q * 8);
  int64_t* sums = reinterpret_cast<int64_t*>(p);
  k_probe_bounds<<<blocks_of(q), BLOCK, 0, st>>>(side_jk, c, qjk, qmask, q, lo,
                                                 cnt);
  RW_CHECK(RW_S_PROBE_BOUNDS);
  if (int rc = scan_apply(Count64{cnt}, StoreIncl{off}, q, sums, total, st))
    return rc;
  if (m > 0) {
    k_probe_expand<<<blocks_of(m), BLOCK, 0, st>>>(off, lo, q, c, m, total,
                                                   row, sidx, mask);
    RW_CHECK(RW_S_PROBE_EXPAND);
  }
  return 0;
}

}  // extern "C"

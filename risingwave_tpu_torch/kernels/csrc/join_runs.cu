// Hand-written CUDA kernels (sm_90a) for the three join-side cores of
// risingwave_tpu/device/join_step.py:
//
//   batch_reduce_rows :57   -> rw_reduce_rows   segment walk over (jk, pk)
//   merge_side        :83   -> rw_side_combine  merge-path placement +
//                                               presence combine
//   probe             :118  -> rw_probe         binary-search ranges, count
//                                               scan, per-slot expansion
//
// In the JAX package these are XLA programs built from a two-key
// lax.sort, segment ops, searchsorted and cumsum. Like the sorted-run
// cores they move a few words per row and do almost no arithmetic, so
// each is bound by device-memory bytes — except probe's expansion, whose
// floor is the ~log2(q) dependent reads of one binary search per output
// slot. The design mirrors sorted_runs.cu: coalesced streaming passes,
// data-dependent work (segment walks, binary searches) per thread, the
// shared three-phase scan. batch_reduce_rows sorts with the two-key
// radix sort of sorted_runs.cu (launched by the wrapper) and merge_side
// compacts with its compact_rows; neither re-sorts what is already
// sorted. Simple and correct first: one thread walks each segment, one
// binary search per row or slot.
#include "join_runs.h"

#include "rw_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// batch_reduce_rows: segment ids by a scan of (jk, pk) boundaries; one
// thread per segment start sums its signs in sorted (= arrival) order and
// records the row whose payload the slot takes; a gather pass then copies
// every payload column through those rows.
// ---------------------------------------------------------------------------

__global__ void k_rows_gather_pk(const int64_t* pk, const int64_t* perm,
                                 int64_t n, int64_t* spk) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i < n) spk[i] = pk[perm[i]];
}

__global__ void k_rows_segments(const int64_t* sk, const int64_t* spk,
                                const int64_t* perm, const int32_t* sign,
                                int64_t n, const int32_t* seg, const int* nseg,
                                int64_t* ujk, int64_t* upk, int32_t* usign,
                                int64_t* usrc) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  if (i >= *nseg) {                        // past the last segment
    ujk[i] = EMPTY_KEY;
    upk[i] = EMPTY_KEY;
    usign[i] = 0;
    usrc[i] = perm[0];
  }
  const int64_t k = sk[i], p = spk[i];
  if (i > 0 && sk[i - 1] == k && spk[i - 1] == p) return;
  const int64_t s = seg[i];
  ujk[s] = k;
  upk[s] = p;
  if (k == EMPTY_KEY) {                    // masked rows: no sign, no arrival
    usign[s] = 0;
    usrc[s] = perm[0];
    return;
  }
  // int32 sum with wraparound, as the reference's int32 segment_sum
  uint32_t sum = uint32_t(sign[perm[i]]);
  int64_t e = i + 1;
  while (e < n && sk[e] == k && spk[e] == p) sum += uint32_t(sign[perm[e++]]);
  usign[s] = int32_t(sum);
  usrc[s] = perm[e - 1];                   // last arrival wins
}

__global__ void k_gather_cols(RwCols cols, const int64_t* src, int64_t n) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int64_t r = src[i];
  for (int j = 0; j < cols.n; ++j)
    copy_elem(cols.dtype[j], cols.a[j], r, cols.out[j], i);
}

// ---------------------------------------------------------------------------
// merge_side: both runs sorted on (jk, pk) and unique, so no sort — the
// shared two-key placement (k_place2, side row first on ties). Each live
// key then forms a run of <= 2 rows, combined with its successor by one
// compare.
// ---------------------------------------------------------------------------

__global__ void k_side_combine(const int64_t* mjk, const int64_t* mpk,
                               const int32_t* src, int64_t c, int64_t n,
                               const int64_t* s_jk, const int32_t* d_sign,
                               RwCols cols, uint8_t* alive) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= n) return;
  const int64_t k1 = mjk[p], k2 = mpk[p];
  const bool same_next = p + 1 < n && mjk[p + 1] == k1 && mpk[p + 1] == k2;
  const bool same_prev = p > 0 && mjk[p - 1] == k1 && mpk[p - 1] == k2;
  // presence: a side row is present unless its slot is empty; a delta row
  // carries its net sign (+1 insert, -1 delete, 0 no-op, or more)
  auto pres = [&](int32_t r) -> int32_t {
    return r < c ? (s_jk[r] != EMPTY_KEY ? 1 : 0) : d_sign[r - c];
  };
  int32_t r = src[p];
  int32_t pres_m = pres(r);
  if (same_next) {
    const int32_t rn = src[p + 1];
    const int32_t pn = pres(rn);
    const int32_t s = pres_m + pn;
    pres_m = s < 0 ? 0 : (s > 1 ? 1 : s);
    if (pn > 0) r = rn;                    // an upsert takes the delta payload
  }
  for (int j = 0; j < cols.n; ++j) {
    if (r < c)
      copy_elem(cols.dtype[j], cols.a[j], r, cols.out[j], p);
    else
      copy_elem(cols.dtype[j], cols.b[j], r - c, cols.out[j], p);
  }
  alive[p] = !same_prev && k1 != EMPTY_KEY && pres_m > 0;
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
  return 2 * align256(n * 8) + align256(n * 4) + scan_bytes<int>(n);
}

int64_t rw_probe_scratch_bytes(int64_t q) {
  return 3 * align256(q * 8) + scan_bytes<int64_t>(q);
}

int rw_reduce_rows(const int64_t* sk, const int64_t* pk, const int64_t* perm,
                   const int32_t* sign, int64_t n, RwCols cols, int64_t* ujk,
                   int64_t* upk, int32_t* usign, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  char* p = static_cast<char*>(scratch);
  int64_t* spk = reinterpret_cast<int64_t*>(p);
  p += align256(n * 8);
  int64_t* usrc = reinterpret_cast<int64_t*>(p);
  p += align256(n * 8);
  int32_t* seg = reinterpret_cast<int32_t*>(p);
  p += align256(n * 4);
  int* sums = reinterpret_cast<int*>(p);
  k_rows_gather_pk<<<blocks_of(n), BLOCK, 0, st>>>(pk, perm, n, spk);
  RW_CHECK(RW_S_ROWS_GATHER_PK);
  if (int rc = scan_apply(Boundary2{sk, spk}, StoreSeg{seg}, n, sums, nullptr,
                          st))
    return rc;
  k_rows_segments<<<blocks_of(n), BLOCK, 0, st>>>(
      sk, spk, perm, sign, n, seg, sums + tiles_of(n), ujk, upk, usign, usrc);
  RW_CHECK(RW_S_ROWS_SEGMENTS);
  if (cols.n > 0) {
    k_gather_cols<<<blocks_of(n), BLOCK, 0, st>>>(cols, usrc, n);
    RW_CHECK(RW_S_GATHER_COLS);
  }
  return 0;
}

int rw_side_combine(const int64_t* s_jk, const int64_t* s_pk, int64_t c,
                    const int64_t* d_jk, const int64_t* d_pk,
                    const int32_t* d_sign, int64_t b, RwCols cols,
                    int64_t* mjk, int64_t* mpk, uint8_t* alive, int32_t* src,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  k_place2<<<blocks_of(n), BLOCK, 0, st>>>(s_jk, s_pk, c, d_jk, d_pk, b, mjk,
                                           mpk, src);
  RW_CHECK(RW_S_SIDE_PLACE);
  k_side_combine<<<blocks_of(n), BLOCK, 0, st>>>(mjk, mpk, src, c, n, s_jk,
                                                 d_sign, cols, alive);
  RW_CHECK(RW_S_SIDE_COMBINE);
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

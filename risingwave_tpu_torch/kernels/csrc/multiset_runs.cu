// Hand-written CUDA kernels (sm_90a) for the three ★ cores of the
// retractable min/max multiset, risingwave_tpu/device/minput.py:
//
//   ms_batch_reduce :79   -> rw_ms_reduce   the tiled segmented reduce over
//                                           (k1, k2), one int64 SUM
//   ms_merge        :98   -> rw_ms_combine  merge-path placement + count
//                                           combine (compaction: the
//                                           compact_rows kernel)
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
// ~400-row segments before). ms_merge places both sorted runs by binary
// search (k_place2, state row first on ties) instead of re-sorting C + B
// rows, then combines each pair with its successor.
#include "multiset_runs.h"

#include "reduce_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// ms_merge: after k_place2, a merged row combines its count with its
// successor's when the two pairs are equal (a run is at most a state row
// and its delta). A pair is alive at the first row of its run when its
// group is not EMPTY_KEY and the combined count is not 0 — a count below
// 0 stays alive, as in the reference.
// ---------------------------------------------------------------------------

__global__ void k_ms_combine(const int64_t* m1, const int64_t* m2,
                             const int32_t* src, int64_t c, int64_t n,
                             const int64_t* s_cnt, const int64_t* d_cnt,
                             int64_t* m_cnt, uint8_t* alive) {
  const int64_t p = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= n) return;
  const int64_t k1 = m1[p], k2 = m2[p];
  const bool same_next = p + 1 < n && m1[p + 1] == k1 && m2[p + 1] == k2;
  const bool same_prev = p > 0 && m1[p - 1] == k1 && m2[p - 1] == k2;
  auto cnt = [&](int32_t r) -> uint64_t {
    return uint64_t(r < c ? s_cnt[r] : d_cnt[r - c]);
  };
  uint64_t v = cnt(src[p]);
  if (same_next) v += cnt(src[p + 1]);
  m_cnt[p] = int64_t(v);
  alive[p] = !same_prev && k1 != EMPTY_KEY && v != 0;
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

int rw_ms_combine(const int64_t* s1, const int64_t* s2, const int64_t* s_cnt,
                  int64_t c, const int64_t* d1, const int64_t* d2,
                  const int64_t* d_cnt, int64_t b, int64_t* m1, int64_t* m2,
                  int64_t* m_cnt, uint8_t* alive, int32_t* src,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = c + b;
  if (n <= 0) return 0;
  k_place2<<<blocks_of(n), BLOCK, 0, st>>>(s1, s2, c, d1, d2, b, m1, m2, src);
  RW_CHECK(RW_S_MS_PLACE);
  k_ms_combine<<<blocks_of(n), BLOCK, 0, st>>>(m1, m2, src, c, n, s_cnt,
                                               d_cnt, m_cnt, alive);
  RW_CHECK(RW_S_MS_COMBINE);
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

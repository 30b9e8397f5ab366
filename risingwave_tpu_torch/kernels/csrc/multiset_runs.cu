// Hand-written CUDA kernels (sm_90a) for the three ★ cores of the
// retractable min/max multiset, risingwave_tpu/device/minput.py:
//
//   ms_batch_reduce :79   -> rw_ms_reduce   (k1, k2) segment walk, int64 sums
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
// The design is the join cores' (join_runs.cu): ms_batch_reduce sorts
// with the two-key radix sort of sorted_runs.cu (launched by the
// wrapper), then a boundary scan gives segment ids and one thread walks
// each segment; ms_merge places both sorted runs by binary search
// (k_place2, state row first on ties) instead of re-sorting C + B rows,
// then combines each pair with its successor. Simple and correct first.
#include "multiset_runs.h"

#include "rw_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// ms_batch_reduce: k2 in sorted order, segment ids by a scan of (k1, k2)
// boundaries, one thread per segment start sums its deltas.
// ---------------------------------------------------------------------------

__global__ void k_ms_gather_k2(const int64_t* k2, const int64_t* perm,
                               int64_t n, int64_t* sk2) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i < n) sk2[i] = k2[perm[i]];
}

__global__ void k_ms_segments(const int64_t* sk1, const int64_t* sk2,
                              const int64_t* perm, const int64_t* delta,
                              int64_t n, const int32_t* seg, const int* nseg,
                              int64_t* u1, int64_t* u2, int64_t* ud) {
  const int64_t i = int64_t(blockIdx.x) * BLOCK + threadIdx.x;
  if (i >= n) return;
  if (i >= *nseg) {                        // past the last pair
    u1[i] = EMPTY_KEY;
    u2[i] = EMPTY_KEY;
    ud[i] = 0;
  }
  const int64_t k1 = sk1[i], k2 = sk2[i];
  if (i > 0 && sk1[i - 1] == k1 && sk2[i - 1] == k2) return;
  const int64_t s = seg[i];
  u1[s] = k1;
  u2[s] = k2;
  if (k1 == EMPTY_KEY) {                   // masked rows count nothing
    ud[s] = 0;
    return;
  }
  // int64 sum with wraparound, as the reference's segment_sum
  uint64_t sum = uint64_t(delta[perm[i]]);
  int64_t e = i + 1;
  while (e < n && sk1[e] == k1 && sk2[e] == k2) sum += uint64_t(delta[perm[e++]]);
  ud[s] = int64_t(sum);
}

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
  return align256(n * 8) + align256(n * 4) + scan_bytes<int>(n);
}

int rw_ms_reduce(const int64_t* sk1, const int64_t* k2, const int64_t* perm,
                 const int64_t* delta, int64_t n, int64_t* u1, int64_t* u2,
                 int64_t* ud, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  char* p = static_cast<char*>(scratch);
  int64_t* sk2 = reinterpret_cast<int64_t*>(p);
  p += align256(n * 8);
  int32_t* seg = reinterpret_cast<int32_t*>(p);
  p += align256(n * 4);
  int* sums = reinterpret_cast<int*>(p);
  k_ms_gather_k2<<<blocks_of(n), BLOCK, 0, st>>>(k2, perm, n, sk2);
  RW_CHECK(RW_S_MS_GATHER_K2);
  if (int rc = scan_apply(Boundary2{sk1, sk2}, StoreSeg{seg}, n, sums,
                          nullptr, st))
    return rc;
  k_ms_segments<<<blocks_of(n), BLOCK, 0, st>>>(
      sk1, sk2, perm, delta, n, seg, sums + tiles_of(n), u1, u2, ud);
  RW_CHECK(RW_S_MS_SEGMENTS);
  return 0;
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

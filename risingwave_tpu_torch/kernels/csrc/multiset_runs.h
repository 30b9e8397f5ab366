// Plain C interface of the multiset kernels (multiset_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for the first refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwJoinSite` (binding.SITES order).
enum RwMultisetSite : int32_t {
  RW_S_MS_GATHER_K2 = 20,
  RW_S_MS_SEGMENTS,
  RW_S_MS_PLACE,
  RW_S_MS_COMBINE,
  RW_S_MS_FIND,
};

#ifdef __cplusplus
extern "C" {
#endif

// Scratch bytes of rw_ms_reduce for n rows.
int64_t rw_ms_scratch_bytes(int64_t n);

// Unique (k1, k2) pairs of a batch already sorted by (k1, k2): sorted k1
// `sk1`, the row permutation `perm`, and — in ORIGINAL row order — k2 and
// the int64 count deltas. Writes u1/u2[n] (EMPTY_KEY past the last pair)
// and the summed deltas ud[n] (0 where u1 is EMPTY_KEY).
int rw_ms_reduce(const int64_t* sk1, const int64_t* k2, const int64_t* perm,
                 const int64_t* delta, int64_t n, int64_t* u1, int64_t* u2,
                 int64_t* ud, void* scratch, void* stream);

// Merge placement + count combine of a (k1, k2)-sorted unique multiset
// (c rows, counts s_cnt) and (k1, k2)-sorted unique pair deltas (b rows,
// d_cnt): writes the merged pairs m1/m2[c+b], the combined counts
// m_cnt[c+b] and alive flags (uint8) for rw_compact_rows.
int rw_ms_combine(const int64_t* s1, const int64_t* s2, const int64_t* s_cnt,
                  int64_t c, const int64_t* d1, const int64_t* d2,
                  const int64_t* d_cnt, int64_t b, int64_t* m1, int64_t* m2,
                  int64_t* m_cnt, uint8_t* alive, int32_t* src, void* stream);

// Multiplicity of each (q1, q2) query pair in a multiset of c >= 1 rows:
// found (uint8) and the count (int64, 0 where not found).
int rw_ms_find(const int64_t* k1, const int64_t* k2, const int64_t* cnt,
               int64_t c, const int64_t* q1, const int64_t* q2, int64_t q,
               uint8_t* found, int64_t* out, void* stream);

#ifdef __cplusplus
}
#endif

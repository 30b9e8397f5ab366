// Plain C interface of the multiset kernels (multiset_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for the first refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwJoinSite` (binding.SITES order).
enum RwMultisetSite : int32_t {
  RW_S_MS_TILES = 20,
  RW_S_MS_CARRY,
  RW_S_MS_CUTS,
  RW_S_MS_MERGE,
  RW_S_MS_FIND,
};

// Sites added after datagen.h's, continuing the numbering.
enum RwMultisetSite2 : int32_t {
  RW_S_MS_FILL = 40,
};

#ifdef __cplusplus
extern "C" {
#endif

// Scratch bytes of rw_ms_reduce for n rows.
int64_t rw_ms_scratch_bytes(int64_t n);

// Unique (k1, k2) pairs of a batch already sorted by (k1, k2): sorted k1
// `sk1`, the row permutation `perm`, and — in ORIGINAL row order — k2 and
// the int64 count deltas. Writes u1/u2[n] (EMPTY_KEY past the last pair)
// and the summed deltas ud[n] (wrapping int64 sums; 0 where u1 is
// EMPTY_KEY).
int rw_ms_reduce(const int64_t* sk1, const int64_t* k2, const int64_t* perm,
                 const int64_t* delta, int64_t n, int64_t* u1, int64_t* u2,
                 int64_t* ud, void* scratch, void* stream);

// Merge (k1, k2)-sorted unique pair deltas (b rows, counts d_cnt, EMPTY
// pairs only at the tail) into a (k1, k2)-sorted unique multiset (c rows,
// counts s_cnt): a pair's counts add (wrapping int64), and the pairs
// whose k1 is not EMPTY_KEY and whose count is not 0 are written in
// order to o1/o2/o_cnt[c], the first c of them, then (EMPTY_KEY,
// EMPTY_KEY, 0). needed[0] = the pairs alive, needed[1] = min(that, c).
// `scratch`: rw_sweep_scratch_bytes(c + b) bytes.
int rw_ms_merge(const int64_t* s1, const int64_t* s2, const int64_t* s_cnt,
                int64_t c, const int64_t* d1, const int64_t* d2,
                const int64_t* d_cnt, int64_t b, int64_t* o1, int64_t* o2,
                int64_t* o_cnt, int32_t* needed, void* scratch,
                void* stream);

// Multiplicity of each (q1, q2) query pair in a multiset of c >= 1 rows:
// found (uint8) and the count (int64, 0 where not found).
int rw_ms_find(const int64_t* k1, const int64_t* k2, const int64_t* cnt,
               int64_t c, const int64_t* q1, const int64_t* q2, int64_t q,
               uint8_t* found, int64_t* out, void* stream);

#ifdef __cplusplus
}
#endif

// Plain C interface of the state-tiering kernels (tier_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwSkewSite` (binding.SITES).
enum RwTierSite : int32_t {
  RW_T_TOUCH_STAMP = 29,
  RW_T_PARTITION_FILL,
};

#ifdef __cplusplus
extern "C" {
#endif

// One touch stamp per row of the new key table `keys` (n rows):
//   carried = old_touch[j] when old_keys (sorted, n_old rows) has the key
//             at its lower bound j, else 0;
//   hit     = src_keys (sorted, n_src rows) has the key at its lower
//             bound s;
//   stamp mode (src_vals null):  hit ? *tick : carried
//   promote mode (src_vals set): old row found ? carried
//                                : (hit ? src_vals[s] : 0)
// and 0 for rows whose key is empty_key. Adds to counts[0] the rows whose
// key is not empty_key and to counts[1] those of them with
// *tick - stamp >= ttl (counts holds two int64, added to, not
// overwritten; integer adds, so the result does not depend on order).
int rw_touch_stamp(const int64_t* keys, int64_t n, const int64_t* old_keys,
                   const int64_t* old_touch, int64_t n_old,
                   const int64_t* src_keys, const int64_t* src_vals,
                   int64_t n_src, const int64_t* tick, int64_t ttl,
                   int64_t empty_key, int64_t* ntouch, int64_t* counts,
                   void* stream);

// Scratch bytes rw_tier_partition needs for n rows.
int64_t rw_tier_scratch_bytes(int64_t n);

// Stable partition of a table of n rows by membership of its key in the
// sorted, empty_key-padded `dkeys` (L rows): a row is a hit when its key
// is not empty_key and is found in dkeys, kept when its key is not
// empty_key and it is not a hit. Every column of `cols` (cols.a, n rows
// each) goes, for the kept rows in order, to cols.out[0 .. kept), the
// rest of cols.out up to n getting cols.fill; with `want_hits`, the hit
// rows likewise to cols.b (used here as a second set of OUTPUT columns),
// filled past the hits. counts (int32[2]) receives (kept, hits).
int rw_tier_partition(const int64_t* keys, int64_t n, const int64_t* dkeys,
                      int64_t L, RwCols cols, int want_hits,
                      int64_t empty_key, int32_t* counts, void* scratch,
                      void* stream);

#ifdef __cplusplus
}
#endif

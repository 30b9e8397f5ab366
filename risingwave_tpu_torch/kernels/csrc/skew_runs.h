// Plain C interface of the key-skew telemetry kernels (skew_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwWindowSite` (binding.SITES).
enum RwSkewSite : int32_t {
  RW_S_VNODE_HIST = 25,
  RW_S_TOPK_ROWS,
  RW_S_TOPK_MERGE,
};

#ifdef __cplusplus
extern "C" {
#endif

// Adds, for each of the n rows that is live, its weight (1 when `weights`
// is null) to out[vnode(key) * 16 / 256], vnode(key) = CRC32 of the key's
// 8 big-endian bytes mod 256. A row is live when live[i] != 0, or, with
// `live` null, when keys[i] != empty_key. `out` holds 16 int64 and is
// added to, not overwritten.
int rw_vnode_hist(const int64_t* keys, const uint8_t* live,
                  const int64_t* weights, int64_t n, int64_t empty_key,
                  int64_t* out, void* stream);

// Scratch bytes rw_topk_packed needs for n rows.
int64_t rw_topk_scratch_bytes(int64_t n);

// Writes to out[0..3] the four largest values
//   (min(count, 2^22 - 1) << 40) | (key & (2^40 - 1)),
// descending, padded with 0; equal values keep their multiplicity.
// With `counts` non-null, one value per row whose count is > 0 and whose
// key is not empty_key. With `counts` null, `keys` is sorted and each
// run of equal keys other than empty_key gives one value, its length as
// the count.
int rw_topk_packed(const int64_t* keys, const int64_t* counts, int64_t n,
                   int64_t empty_key, int64_t* out, void* scratch,
                   void* stream);

#ifdef __cplusplus
}
#endif

// Plain C interface of the join-side kernels (join_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for the first refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwSite` (binding.SITES order).
enum RwJoinSite : int32_t {
  RW_S_ROWS_TILES = 12,
  RW_S_ROWS_CARRY,
  RW_S_ROWS_GATHER,
  RW_S_SIDE_CUTS,
  RW_S_SIDE_MERGE,
  RW_S_SIDE_FILL,
  RW_S_PROBE_BOUNDS,
  RW_S_PROBE_EXPAND,
};

#ifdef __cplusplus
extern "C" {
#endif

// Scratch bytes of rw_reduce_rows / rw_side_merge / rw_probe for n rows /
// n merged rows / q queries.
int64_t rw_rows_scratch_bytes(int64_t n);
int64_t rw_side_scratch_bytes(int64_t n);
int64_t rw_probe_scratch_bytes(int64_t q);

// Unique (jk, pk) rows of a batch already sorted by (jk, pk): sorted jk
// `sk`, the row permutation `perm`, and — in ORIGINAL row order — pk `pk`
// and the columns cols.a: the int32 sign first (kind RW_SUM, fill 0),
// then the payload (RW_REPLACE). Writes the unique keys ujk/upk[n]
// (EMPTY_KEY past the last segment), the summed sign (0 where ujk is
// EMPTY_KEY) and the payload of each key's last arrival to cols.out[n];
// slots past the last segment, and segments whose jk is EMPTY_KEY, take
// the first sorted row's payload.
int rw_reduce_rows(const int64_t* sk, const int64_t* pk, const int64_t* perm,
                   int64_t n, RwCols cols, int64_t* ujk, int64_t* upk,
                   void* scratch, void* stream);

// Merge of a (jk, pk)-sorted multimap side (c rows, payload cols.a; a row
// is present when its jk is not EMPTY_KEY) and unique (jk, pk)-sorted
// delta rows (b rows, int32 presence deltas d_sign, payload cols.b), in
// one pass that writes the new side: its live rows in (jk, pk) order into
// o_jk / o_pk / cols.out[c], the first c of them when more live, the rest
// EMPTY_KEY / EMPTY_KEY / 0; `needed` (int32 scalar) = the live rows.
// c + b < 2^31.
int rw_side_merge(const int64_t* s_jk, const int64_t* s_pk, int64_t c,
                  const int64_t* d_jk, const int64_t* d_pk,
                  const int32_t* d_sign, int64_t b, RwCols cols,
                  int64_t* o_jk, int64_t* o_pk, int32_t* needed,
                  void* scratch, void* stream);

// All matches of each query key in the sorted jk column of a side (c
// rows), expanded into m output slots: probe row (int32), side index
// (int64), slot mask (uint8) and the total match count (int64 scalar).
int rw_probe(const int64_t* side_jk, int64_t c, const int64_t* qjk,
             const uint8_t* qmask, int64_t q, int64_t m, int32_t* row,
             int64_t* sidx, uint8_t* mask, int64_t* total, void* scratch,
             void* stream);

#ifdef __cplusplus
}
#endif

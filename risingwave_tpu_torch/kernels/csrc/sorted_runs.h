// Plain C interface of the sorted-run kernels (sorted_runs.cu).
//
// Every launcher takes device pointers, enqueues its kernels on `stream`
// without synchronising, allocates nothing (outputs and scratch come
// from the caller), and checks cudaGetLastError() right after each
// launch. It returns 0 when every launch was accepted; otherwise it stops
// at the first refused launch and returns
// `site * RW_SITE_STRIDE + cudaError`, `site` naming that kernel.
#pragma once

#include <cstdint>

#define RW_MAX_COLS 32
#define RW_SITE_STRIDE 1024

// Launch sites, in the order of `binding.SITES` (join_runs.h continues
// the numbering).
enum RwSite : int32_t {
  RW_S_SORT_UPSWEEP = 1,
  RW_S_SORT_PLAN,
  RW_S_TILE_SUMS,
  RW_S_SCAN_SUMS,
  RW_S_TILE_APPLY,
  RW_S_SORT_PASS,
  RW_S_REDUCE_TILES,
  RW_S_REDUCE_CARRY,
  RW_S_MERGE_PLACE,
  RW_S_MERGE_COMBINE,
  RW_S_COMPACT_FILL,
};

// Column element types (the port's dtypes: int64 keys and accumulators,
// int32 counts, f64 sums, bool flags).
enum RwDType : int32_t { RW_I64 = 0, RW_I32 = 1, RW_F64 = 2, RW_BOOL = 3 };
// How a column combines across rows of one key (sorted_state.ReduceKind).
enum RwKind : int32_t { RW_SUM = 0, RW_MIN = 1, RW_MAX = 2, RW_REPLACE = 3 };

// Up to RW_MAX_COLS payload columns, passed to kernels by value.
// `fill` holds each column's fill / neutral value as raw 64-bit bits
// (an f64 neutral is its IEEE bit pattern).
struct RwCols {
  int32_t n;
  int32_t dtype[RW_MAX_COLS];
  int32_t kind[RW_MAX_COLS];
  int64_t fill[RW_MAX_COLS];
  const void* a[RW_MAX_COLS];   // input (merge: the state side)
  const void* b[RW_MAX_COLS];   // merge: the delta side
  void* out[RW_MAX_COLS];
};

#ifdef __cplusplus
extern "C" {
#endif

// Scratch bytes each launcher needs for `n` rows.
int64_t rw_sort_scratch_bytes(int64_t n);
int64_t rw_scan_scratch_bytes(int64_t n);
int64_t rw_reduce_scratch_bytes(int64_t n);

// Stable one-sweep LSD radix sort of rows by (k1, k2) — k2 may be null;
// n < 2^31. Writes the permutation (int64) and, when non-null, k1 in
// sorted order.
int rw_sort_perm(const int64_t* k1, const int64_t* k2, int64_t n,
                 int64_t* perm, int64_t* sorted_k1, void* scratch,
                 void* stream);

// Segmented reduce of rows already sorted by key: sorted keys `sk`,
// row permutation `perm` (cols.a are in ORIGINAL row order). Writes
// ukeys[n], cols.out[n] and ucount (int32 scalar). A float SUM combines
// in an order fixed by n and the tile size.
int rw_batch_reduce(const int64_t* sk, const int64_t* perm, int64_t n,
                    RwCols cols, int64_t* ukeys, int32_t* ucount,
                    void* scratch, void* stream);

// Merge placement + run-of-<=2 combine of sorted unique state rows
// (keys s, cols.a, c rows) and sorted unique delta rows (keys d,
// cols.b, b rows): writes merged keys mk[c+b], combined values
// cols.out[c+b] and alive flags (uint8).
int rw_merge_combine(const int64_t* s, int64_t c, const int64_t* d,
                     int64_t b, RwCols cols, int drop_dead, int dead_col,
                     int64_t* mk, uint8_t* alive, int32_t* src,
                     void* stream);

// Stable compaction of alive rows (uint8 flags) to the front of
// cols.out[out_len], the rest filled with cols.fill; total = #alive.
int rw_compact_rows(const uint8_t* alive, int64_t n, RwCols cols,
                    int64_t out_len, int32_t* total, void* scratch,
                    void* stream);

#ifdef __cplusplus
}
#endif

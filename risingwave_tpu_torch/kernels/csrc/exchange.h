// Plain C interface of the bucket-exchange kernel (exchange.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwAggPackSite` (binding.SITES).
enum RwExchangeSite : int32_t {
  RW_S_EXCH_COUNT = 36,
  RW_S_EXCH_SCAN,
  RW_S_EXCH_PLACE,
};

#define RW_EXCH_MAX_SHARDS 64
#define RW_EXCH_MAX_HOT 16

// How rows route (shard_exec._route_dest and the hot-key policy).
enum RwExchRoute : int32_t { RW_ROUTE_UNIFORM = 0, RW_ROUTE_BOUNDS = 1 };
enum RwExchHot : int32_t { RW_HOT_NONE = 0, RW_HOT_BCAST = 1,
                           RW_HOT_SALT = 2 };

// Routing of one source shard's rows, passed to the kernels by value.
struct RwExchArgs {
  int32_t n;                // destination shards, 1..RW_EXCH_MAX_SHARDS
  int32_t route;            // RwExchRoute
  int32_t hot;              // RwExchHot
  int32_t n_hot;            // hot keys in `hot_keys`
  int32_t bounds[RW_EXCH_MAX_SHARDS + 1];   // RW_ROUTE_BOUNDS: shard s
                            // owns vnodes [bounds[s], bounds[s + 1])
  int64_t hot_keys[RW_EXCH_MAX_HOT];        // (key & hot_mask) == one
  int64_t hot_mask;
  uint64_t vmask[8];        // vnode bit j = parity(key & vmask[j]) ^
  uint32_t vflip;           //   (vflip >> j & 1) (core/vnode.bucket_parity)
  int32_t vbits;            // log2 of the vnode count
  int64_t cap;              // slots per destination
  const int64_t* key;       // routing key [b]
  const uint8_t* mask;      // row mask [b] (bool)
  const int32_t* sign;      // null, or a row is live only if sign != 0
  const int64_t* pk;        // row identity [b]: salted hot rows (may be
                            // null unless hot == RW_HOT_SALT)
};

#ifdef __cplusplus
extern "C" {
#endif

// Scratch bytes of rw_bucket_exchange for b rows and n shards.
int64_t rw_exchange_scratch_bytes(int64_t b, int32_t n);

// Route b rows (b < 2^31) to n destination buckets and place every
// column: a live row goes to its destination (or, broadcast, to every
// one) at its rank among the earlier live rows bound there, stable in row
// order; a slot at or past `cap` drops. cols.a[j] is column j ([b]),
// cols.out[j] its [n, cap] buffer,
// cols.fill[j] the bits of its fill, written to every slot no row takes.
// counts[d] (int64 [n]) is destination d's fill before the drop, *need
// (int64) the largest.
int rw_bucket_exchange(RwExchArgs args, RwCols cols, int64_t b,
                       int64_t* counts, int64_t* need, void* scratch,
                       void* stream);

#ifdef __cplusplus
}
#endif

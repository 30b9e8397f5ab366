// Plain C interface of the bucket-exchange kernel (exchange.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwAggPackSite` (binding.SITES).
enum RwExchangeSite : int32_t {
  RW_S_EXCH_ZERO = 36,      // the memset of the call's work words
  RW_S_EXCH_PLACE,
  RW_S_EXCH_FILL,
};

#define RW_EXCH_MAX_SHARDS 64     // destinations
#define RW_EXCH_MAX_SOURCES 64    // source shards of one call
#define RW_EXCH_MAX_HOT 16

// How rows route (shard_exec._route_dest and the hot-key policy).
enum RwExchRoute : int32_t { RW_ROUTE_UNIFORM = 0, RW_ROUTE_BOUNDS = 1 };
enum RwExchHot : int32_t { RW_HOT_NONE = 0, RW_HOT_BCAST = 1,
                           RW_HOT_SALT = 2 };

// One exchange: the routing, every source shard's rows and every
// column's receiver-major buffer. Passed to the place kernel by value as
// a __grid_constant__ parameter (about 20 KB with the limits above; CUDA
// 12.1+ takes up to 32,764 bytes of parameters on sm_90), so a call
// copies no pointer table to the card.
struct RwExchArgs {
  int32_t n;                // destination shards, 1..RW_EXCH_MAX_SHARDS
  int32_t n_src;            // source shards, 1..RW_EXCH_MAX_SOURCES
  int32_t route;            // RwExchRoute
  int32_t hot;              // RwExchHot
  int32_t n_hot;            // hot keys in `hot_keys`
  int32_t ncols;            // shipped columns, 0..RW_MAX_COLS
  int32_t bounds[RW_EXCH_MAX_SHARDS + 1];   // RW_ROUTE_BOUNDS: shard s
                            // owns vnodes [bounds[s], bounds[s + 1])
  int64_t hot_keys[RW_EXCH_MAX_HOT];        // (key & hot_mask) == one
  int64_t hot_mask;
  uint64_t vmask[8];        // vnode bit j = parity(key & vmask[j]) ^
  uint32_t vflip;           //   (vflip >> j & 1) (core/vnode.bucket_parity)
  int32_t vbits;            // log2 of the vnode count
  int64_t cap;              // slots per (destination, source)
  int64_t b;                // rows of every source (< 2^31)
  int32_t dtype[RW_MAX_COLS];               // RwDType of column j
  int64_t fill[RW_MAX_COLS];                // its fill's bits
  void* out[RW_MAX_COLS];   // column j's buffer [n, n_src, cap]
  // per source s: routing key [b], row mask [b] (bool), sign [b] (null:
  // none; else a row is live only if sign != 0), row identity [b] (read
  // only for salted hot rows; may be null unless hot == RW_HOT_SALT)
  const int64_t* key[RW_EXCH_MAX_SOURCES];
  const uint8_t* mask[RW_EXCH_MAX_SOURCES];
  const int32_t* sign[RW_EXCH_MAX_SOURCES];
  const int64_t* pk[RW_EXCH_MAX_SOURCES];
  const void* col[RW_EXCH_MAX_SOURCES][RW_MAX_COLS];   // [b] each
};

#ifdef __cplusplus
extern "C" {
#endif

// Bytes of the call's work buffer: counts (int64 [n_src, n]) and need
// (int64 [n_src]) first — the call's outputs — then the tiles' ticket
// and look-back words.
int64_t rw_exchange_work_bytes(int64_t b, int32_t n_src, int32_t n);

// Route every source's b rows to n destination buckets and place every
// column: a live row goes to its destination (or, broadcast, to every
// one) at its rank among the earlier live rows of its source bound
// there, stable in row order; a slot at or past `cap` drops. Column j's
// rows from source s bound for destination d land in out[j][d][s][:],
// and every slot no row takes holds fill[j]. counts[s][d] is that
// bucket's fill before the drop, need[s] source s's largest. `work`
// holds rw_exchange_work_bytes(b, n_src, n) bytes; counts and need are
// its first (n_src * n + n_src) int64 words. Three launches: a memset
// of the work words, the place pass and the fill pass.
int rw_bucket_exchange(const RwExchArgs* args, void* work, void* stream);

#ifdef __cplusplus
}
#endif

// Plain C interface of the key-skew telemetry kernels (skew_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch sites of this file, continuing `RwWindowSite` (binding.SITES).
enum RwSkewSite : int32_t {
  RW_S_VNODE_HIST = 26,
  RW_S_TOPK,
  RW_S_TOPK_UNUSED,   // no launch: keeps binding.SITES' numbering
};

#ifdef __cplusplus
extern "C" {
#endif

#define RW_HIST_SEGS 4
#define RW_HIST_BUCKETS 16

// One table of rows of a vnode histogram: n keys, each live when
// live[i] != 0 or, with `live` null, when keys[i] != empty_key, weighing
// weights[i] (1 when `weights` is null); counted into histogram `row`.
struct RwHistSeg {
  const int64_t* keys;
  const uint8_t* live;
  const int64_t* weights;
  int64_t n;
  int32_t row;
};

// Up to RW_HIST_SEGS tables into `rows` histograms, passed by value. A
// key's bucket (vnode(key) * 16 / 256, vnode(key) = CRC32 of its 8
// big-endian bytes mod 256) is bit j = parity(key & mask[j]) ^ bit j of
// `flip`: the CRC of a fixed-length message is affine over GF(2), and
// the caller derives the masks from the CRC (core/vnode.py).
struct RwHistArgs {
  int32_t nseg;
  int32_t rows;
  int32_t add;                     // add into `out` instead of writing it
  RwHistSeg seg[RW_HIST_SEGS];
  uint64_t mask[4];
  uint32_t flip;
  int64_t empty_key;
};

// Writes (or, with `add`, adds into) out[rows][16]: each histogram the
// live rows of its tables by bucket, weighted, over `blocks` blocks (at
// least one per non-empty table). `state` holds 1 + 16 x RW_HIST_SEGS
// int64, zero before the call and left zero after it (the last block to
// finish resets them): a counter, then an accumulator. Calls sharing it
// must be ordered on one stream.
int rw_vnode_hists(RwHistArgs args, int32_t blocks, int64_t* out,
                   int64_t* state, void* stream);

// The most blocks rw_topk_packed launches, and the int64 words of its
// `state`: a ticket, then a 4-list per block.
#define RW_TOPK_MAX_BLOCKS 1024
#define RW_TOPK_STATE_WORDS (1 + 4 * RW_TOPK_MAX_BLOCKS)

// Writes to out[0..3] the four largest values
//   (min(count, 2^22 - 1) << 40) | (key & (2^40 - 1)),
// descending, padded with 0; equal values keep their multiplicity.
// With `counts` non-null, one value per row whose count is > 0 and whose
// key is not empty_key. With `counts` null, `keys` is sorted and each
// run of equal keys other than empty_key gives one value, its length as
// the count. One launch of at most `max_blocks` blocks. `state` holds
// RW_TOPK_STATE_WORDS int64, its first word zero before the call and
// left zero after it (the last block to finish resets it); calls sharing
// it must be ordered on one stream.
int rw_topk_packed(const int64_t* keys, const int64_t* counts, int64_t n,
                   int64_t empty_key, int32_t max_blocks, int64_t* out,
                   int64_t* state, void* stream);

#ifdef __cplusplus
}
#endif

// Plain C interface of the window kernel (window_runs.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch site of this file, continuing `RwMultisetSite` (binding.SITES).
enum RwWindowSite : int32_t {
  RW_S_HOP_EXPAND = 25,
};

#ifdef __cplusplus
extern "C" {
#endif

// Hop / tumble window expansion of `rows` input rows into rows * n output
// rows, row-major (input row i -> outputs i*n .. i*n+n-1): every column
// of cols.a copied into cols.out, then for copy k
//   start = floor(ts / hop) * hop - k * hop,  end = start + size,
//   pk_out = pk * n + k (wrapping int64; both pk pointers may be null),
// and the int32 sign and uint8 mask repeated. hop must be > 0.
int rw_hop_expand(RwCols cols, int64_t rows, int n, const int64_t* ts,
                  int64_t hop, int64_t size, const int64_t* pk,
                  const int32_t* sign, const uint8_t* mask, int64_t* start,
                  int64_t* end, int64_t* pk_out, int32_t* sign_out,
                  uint8_t* mask_out, void* stream);

#ifdef __cplusplus
}
#endif

// Plain C interface of the agg-unpack kernel (agg_pack.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch site of this file, continuing `RwExprSite` (binding.SITES).
enum RwAggPackSite : int32_t {
  RW_S_AGG_UNPACK = 35,
};

#ifdef __cplusplus
extern "C" {
#endif

// Unpack the per-operator agg step's int8 flag matrix p8 [2 + n_calls, b]
// (row-major): signs[c] = p8[0][c] sign-extended, mask[c] = p8[1][c] != 0,
// valid[i * b + c] = p8[2 + i][c] != 0 (bools as bytes 0 / 1). `aligned`
// (b % 4 == 0 and p8 4-byte aligned) lets every row be read and valid's
// rows written a 32-bit word at a time; signs, mask and valid are fresh
// allocations (16-byte aligned).
int rw_agg_unpack(const int8_t* p8, int64_t b, int n_calls, int aligned,
                  int32_t* signs, uint8_t* mask, uint8_t* valid,
                  void* stream);

#ifdef __cplusplus
}
#endif

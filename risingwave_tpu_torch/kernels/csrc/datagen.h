// Plain C interface of the bid generator kernel (datagen.cu).
//
// The same conventions as sorted_runs.h: device pointers in, enqueue on
// `stream` without synchronising, allocate nothing, and return 0 or
// `site * RW_SITE_STRIDE + cudaError` for a refused launch.
#pragma once

#include "sorted_runs.h"

// Launch site of this file, continuing `RwExchangeSite` (binding.SITES).
enum RwDatagenSite : int32_t {
  RW_S_GEN_BIDS = 39,
};

// How `u ** skew` is computed: the forms XLA's simplifier gives pow under
// jit (skew 1.0, 2.0, 3.0, 0.5), or a general pow for any other skew.
enum RwSkewForm : int32_t {
  RW_SKEW_ONE = 0,     // u
  RW_SKEW_SQUARE = 1,  // u * u
  RW_SKEW_CUBE = 2,    // (u * u) * u
  RW_SKEW_SQRT = 3,    // sqrt(u)
  RW_SKEW_POW = 4,     // powf(u, skew)
};

#ifdef __cplusplus
extern "C" {
#endif

// One epoch of bids from the threefry key key[0..1] (two 32-bit words
// held as int64, in device memory): split(key, 3) -> (next, k1, k2);
// auction[i] = trunc(scale * uniform(k1)[i] ** skew) and price[i] =
// minval + randint offset under split(k2, 2), the offset
// ((hi mod span) * mult + lo mod span) mod span in uint32; next_key[0..1]
// = next. n may be 0 (only the next key is written). next_key must not
// alias key.
int rw_gen_bids(const int64_t* key, int64_t n, float scale, int form,
                float skew, int32_t minval, uint32_t span, uint32_t mult,
                int64_t* auction, int64_t* price, int64_t* next_key,
                void* stream);

#ifdef __cplusplus
}
#endif

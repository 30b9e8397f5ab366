// Hand-written CUDA kernel (sm_90a) for the unpack half of the ★
// per-operator agg step of risingwave_tpu/device/agg_step.py:
//
//   agg_epoch_step_packed :338 (p8 -> signs, mask, valid)  -> rw_agg_unpack
//
// The host ships an epoch's flags as one int8 matrix p8 [2 + n, B]: row 0
// the signs, row 1 the row mask, row 2 + i call i's validity. In the JAX
// package XLA fuses their unpack into the jitted step; eager torch would
// run one elementwise kernel per row. Here it is one launch that reads
// p8 once and writes signs (int32 [B]), mask (bool [B]) and valid (bool
// [n, B]) once: (2 + n) B bytes in, (5 + n) B out, so it is bound by
// those bytes over the memory rate — at B = 2^20 and n = 3, 13.6 MB, or
// about 4 us at 3.35 TB/s.
//
// A thread takes four consecutive columns: from each row one 32-bit word
// (neighbouring threads on neighbouring words, so each row's loads
// coalesce), and it writes its four signs as one 16-byte store and each
// bool row's four bytes as one 32-bit store. The `!= 0` of four bytes is
// one SWAR step. Rows are read eight at a time into registers before any
// store. Where B is not a multiple of four (rows not 4-byte aligned), or
// in the last, partial group, bytes are moved one at a time.
#include "agg_pack.h"

#include "rw_common.cuh"

namespace {

constexpr int COLS = 4;          // columns per thread
constexpr int ROWS_IN_FLIGHT = 8;

// 1 in each byte of w that is nonzero, else 0: bit 7 of
// (low 7 bits + 0x7f) is set iff the low 7 bits are nonzero (no carry
// leaves the byte); OR-ing w adds its own bit 7
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t w) {
  return ((((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) >> 7) & 0x01010101u;
}

__device__ __forceinline__ uint32_t load4(const int8_t* __restrict__ row,
                                          int64_t c0, int64_t b,
                                          bool word) {
  if (word) return *reinterpret_cast<const uint32_t*>(row + c0);
  uint32_t w = 0;
  for (int j = 0; j < COLS; ++j)
    if (c0 + j < b) w |= uint32_t(uint8_t(row[c0 + j])) << (8 * j);
  return w;
}

__device__ __forceinline__ void store_bools(uint8_t* __restrict__ out,
                                            int64_t c0, int64_t b,
                                            uint32_t nz, bool word) {
  if (word) {
    *reinterpret_cast<uint32_t*>(out + c0) = nz;
    return;
  }
  for (int j = 0; j < COLS; ++j)
    if (c0 + j < b) out[c0 + j] = uint8_t((nz >> (8 * j)) & 1u);
}

__global__ void k_agg_unpack(const int8_t* __restrict__ p8, int64_t b,
                             int n_calls, int aligned,
                             int32_t* __restrict__ signs,
                             uint8_t* __restrict__ mask,
                             uint8_t* __restrict__ valid) {
  const int64_t c0 = (int64_t(blockIdx.x) * BLOCK + threadIdx.x) * COLS;
  if (c0 >= b) return;
  const bool full = c0 + COLS <= b;
  const bool word = aligned && full;
  const int rows = 2 + n_calls;
  for (int r0 = 0; r0 < rows; r0 += ROWS_IN_FLIGHT) {
    uint32_t w[ROWS_IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < ROWS_IN_FLIGHT; ++k)
      if (r0 + k < rows) w[k] = load4(p8 + int64_t(r0 + k) * b, c0, b, word);
#pragma unroll
    for (int k = 0; k < ROWS_IN_FLIGHT; ++k) {
      const int r = r0 + k;
      if (r >= rows) break;
      if (r == 0) {
        // sign-extend each byte (arithmetic shifts of the int32 word)
        const int4 s = make_int4(int32_t(w[k] << 24) >> 24,
                                 int32_t(w[k] << 16) >> 24,
                                 int32_t(w[k] << 8) >> 24,
                                 int32_t(w[k]) >> 24);
        if (full) {
          *reinterpret_cast<int4*>(signs + c0) = s;
        } else {
          const int v[COLS] = {s.x, s.y, s.z, s.w};
          for (int j = 0; j < COLS; ++j)
            if (c0 + j < b) signs[c0 + j] = v[j];
        }
      } else {
        uint8_t* out = r == 1 ? mask : valid + int64_t(r - 2) * b;
        store_bools(out, c0, b, nonzero_bytes(w[k]), word);
      }
    }
  }
}

}  // namespace

extern "C" {

int rw_agg_unpack(const int8_t* p8, int64_t b, int n_calls, int aligned,
                  int32_t* signs, uint8_t* mask, uint8_t* valid,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b <= 0) return 0;
  const int64_t groups = (b + COLS - 1) / COLS;
  k_agg_unpack<<<blocks_of(groups), BLOCK, 0, st>>>(p8, b, n_calls, aligned,
                                                    signs, mask, valid);
  RW_CHECK(RW_S_AGG_UNPACK);
  return 0;
}

}  // extern "C"

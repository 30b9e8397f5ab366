// Host kernels of risingwave_tpu_torch (the port's own copy of the JAX
// package's `native/rw_native.cpp`): CRC32 vnode hashing and the int64
// memcomparable encoding over caller-provided numpy buffers, loaded with
// ctypes by `native/__init__.py`, which builds this file with g++ at
// first use. Nothing here allocates.
//
// The CRC tables are a compile-time constant: the reference fills them at
// its first call behind a plain flag, which two threads entering at once
// (ctypes releases the GIL) could both do; here there is nothing to fill.
//
// Bound: one pass over the keys, the CRC's 8 table loads a key from an
// 8 KB slice-by-8 table that stays in L1; a host core, not the card.

#include <cstdint>
#include <cstring>

namespace {

// CRC32 (IEEE, reflected: zlib's), slice-by-8 tables.
struct Tables {
    uint32_t t[8][256];
};

constexpr Tables make_tables() {
    Tables tb{};
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c >> 1) ^ (0xEDB88320u & (~((c & 1u) - 1u)));
        tb.t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int s = 1; s < 8; s++)
            tb.t[s][i] = (tb.t[s - 1][i] >> 8) ^ tb.t[0][tb.t[s - 1][i] & 0xFF];
    return tb;
}

constexpr Tables T8 = make_tables();

inline uint32_t crc32_bytes(const uint8_t* p, int64_t len, uint32_t crc) {
    const auto& t = T8.t;
    crc = ~crc;
    while (len >= 8) {
        uint32_t lo;
        uint32_t hi;
        std::memcpy(&lo, p, 4);
        std::memcpy(&hi, p + 4, 4);
        lo ^= crc;
        crc = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^
              t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
              t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF] ^
              t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24];
        p += 8;
        len -= 8;
    }
    while (len--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
    return ~crc;
}

// The 8 big-endian bytes of an int64 key (the vnode key serialization).
inline void be_bytes(int64_t v, uint8_t* be) {
    uint64_t u = static_cast<uint64_t>(v);
    for (int b = 0; b < 8; b++) be[b] = (u >> (56 - 8 * b)) & 0xFF;
}

}  // namespace

extern "C" {

// CRC32 of each row of an (n, k) row-major uint8 matrix.
void rw_crc32_rows(const uint8_t* data, int64_t n, int64_t k, uint32_t* out) {
    for (int64_t i = 0; i < n; i++)
        out[i] = crc32_bytes(data + i * k, k, 0);
}

// CRC32 over the 8 big-endian bytes of each int64.
void rw_crc32_i64_be(const int64_t* vals, int64_t n, uint32_t* out) {
    for (int64_t i = 0; i < n; i++) {
        uint8_t be[8];
        be_bytes(vals[i], be);
        out[i] = crc32_bytes(be, 8, 0);
    }
}

// vnode = crc32(key) % vnode_count (as uint32), fused.
void rw_vnodes_i64(const int64_t* vals, int64_t n, int32_t vnode_count,
                   int32_t* out) {
    const uint32_t vc = static_cast<uint32_t>(vnode_count);
    for (int64_t i = 0; i < n; i++) {
        uint8_t be[8];
        be_bytes(vals[i], be);
        out[i] = static_cast<int32_t>(crc32_bytes(be, 8, 0) % vc);
    }
}

// FNV-1a 64 over the first lens[i] bytes of each row of an (n, stride)
// uint8 matrix (`core/vnode.py` `_fnv1a64_bytes_matrix`). It starts from
// FNV's offset basis, 0xCBF29CE484222325; the reference's entry starts
// from 1469598103934665603, the basis in decimal with its last digit
// lost.
void rw_fnv1a64_rows(const uint8_t* data, const int64_t* lens, int64_t n,
                     int64_t stride, uint64_t* out) {
    for (int64_t i = 0; i < n; i++) {
        const uint8_t* p = data + i * stride;
        uint64_t h = 0xCBF29CE484222325ull;
        for (int64_t j = 0; j < lens[i]; j++) {
            h ^= p[j];
            h *= 1099511628211ull;
        }
        out[i] = h;
    }
}

// Memcomparable int64: big-endian with the sign bit flipped, 8 bytes a
// value into out (n * 8).
void rw_memcmp_i64(const int64_t* vals, int64_t n, uint8_t* out) {
    for (int64_t i = 0; i < n; i++)
        be_bytes(static_cast<int64_t>(static_cast<uint64_t>(vals[i]) ^
                                      (1ull << 63)),
                 out + i * 8);
}

}  // extern "C"

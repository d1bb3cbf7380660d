// Host CRC32C (Castagnoli) for the storage path's host-side checksums: the
// client's per-chunk checksum, a replica's recompute after an overwrite or a
// truncate, the RPC envelope and header CRCs, and payloads below the device
// cutoff.  The port's own copy of the reference's host CRC
// (t3fs/native/chunk_engine.cpp, crc32c / crc32c_combine): the SSE4.2
// crc32 instruction, 8 bytes a step, where the compiler targets it, else a
// slice-by-8 table loop; crc32c_combine by 32x32 matrices over GF(2).
//
// Built by g++ (t3fs_torch/ops/_build.py, host_library) into a shared
// library with a plain C interface, loaded with ctypes.  It runs on the
// host, not the card: it replaces no Pallas kernel.

#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__SSE4_2__)
#include <nmmintrin.h>
#endif

namespace {

uint32_t crc32c_table[8][256];

struct TableInit {
  TableInit() {
    const uint32_t poly = 0x82F63B78u;  // reflected Castagnoli polynomial
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int j = 0; j < 8; j++) c = (c >> 1) ^ ((c & 1) ? poly : 0);
      crc32c_table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
      for (uint32_t i = 0; i < 256; i++)
        crc32c_table[t][i] = (crc32c_table[t - 1][i] >> 8) ^
                             crc32c_table[0][crc32c_table[t - 1][i] & 0xFF];
  }
} table_init;

uint32_t crc32c_sw(const uint8_t* p, size_t n, uint32_t crc) {
  crc = ~crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= crc;
    crc = crc32c_table[7][w & 0xFF] ^ crc32c_table[6][(w >> 8) & 0xFF] ^
          crc32c_table[5][(w >> 16) & 0xFF] ^ crc32c_table[4][(w >> 24) & 0xFF] ^
          crc32c_table[3][(w >> 32) & 0xFF] ^ crc32c_table[2][(w >> 40) & 0xFF] ^
          crc32c_table[1][(w >> 48) & 0xFF] ^ crc32c_table[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ crc32c_table[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

#if defined(__SSE4_2__)
uint32_t crc32c_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = ~crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    n -= 8;
  }
  while (n--) c = _mm_crc32_u8(static_cast<uint32_t>(c), *p++);
  return ~static_cast<uint32_t>(c);
}
#endif

// col[i] = M * e_i over GF(2)
struct Mat32 {
  uint32_t col[32];
};

uint32_t mat_apply(const Mat32& m, uint32_t v) {
  uint32_t r = 0;
  for (int i = 0; i < 32 && v; i++, v >>= 1)
    if (v & 1) r ^= m.col[i];
  return r;
}

Mat32 mat_mul(const Mat32& a, const Mat32& b) {
  Mat32 r;
  for (int i = 0; i < 32; i++) r.col[i] = mat_apply(a, b.col[i]);
  return r;
}

}  // namespace

extern "C" {

uint32_t t3fs_crc32c(const uint8_t* p, uint64_t n, uint32_t crc) {
#if defined(__SSE4_2__)
  return crc32c_hw(p, n, crc);
#else
  return crc32c_sw(p, n, crc);
#endif
}

// crc(a || b) from crc(a), crc(b) and len(b): the raw state of a advanced
// by len_b zero bytes (the one-byte shift matrix raised to len_b by
// squaring), XOR crc(b); the init and final XORs cancel.
uint32_t t3fs_crc32c_combine(uint32_t crc_a, uint32_t crc_b, uint64_t len_b) {
  if (len_b == 0) return crc_a;
  Mat32 mb;
  for (int i = 0; i < 32; i++) {
    uint32_t v = 1u << i;
    mb.col[i] = (v >> 8) ^ crc32c_table[0][v & 0xFF];
  }
  Mat32 acc;
  for (int i = 0; i < 32; i++) acc.col[i] = 1u << i;
  Mat32 sq = mb;
  for (uint64_t n = len_b; n; n >>= 1) {
    if (n & 1) acc = mat_mul(sq, acc);
    sq = mat_mul(sq, sq);
  }
  return mat_apply(acc, crc_a) ^ crc_b;
}

}  // extern "C"

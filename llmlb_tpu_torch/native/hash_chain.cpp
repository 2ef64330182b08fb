// hash_chain: SHA-256 + audit batch chaining.
//
// Native twin of gateway/audit.py's batch_hash (the reference implements its
// chain in Rust over the `sha2` crate, audit/hash_chain.rs:33-91). One call
// hashes prev_hash + all canonical entry strings, avoiding per-entry Python
// overhead when flushing large batches.
//
// SHA-256 per FIPS 180-4 (public algorithm), implemented directly.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint8_t buf[64];
  size_t buflen = 0;
  uint64_t total = 0;

  void block(const uint8_t *p) {
    uint32_t w[64];
    for (int i = 0; i < 16; ++i)
      w[i] = uint32_t(p[4 * i]) << 24 | uint32_t(p[4 * i + 1]) << 16 |
             uint32_t(p[4 * i + 2]) << 8 | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t *data, size_t len) {
    total += len;
    while (len > 0) {
      size_t take = 64 - buflen;
      if (take > len)
        take = len;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) {
        block(buf);
        buflen = 0;
      }
    }
  }

  void finish(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56)
      update(&zero, 1);
    uint8_t lenbuf[8];
    for (int i = 0; i < 8; ++i)
      lenbuf[i] = uint8_t(bits >> (56 - 8 * i));
    update(lenbuf, 8);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

void to_hex(const uint8_t *digest, char *out) {
  static const char *hexd = "0123456789abcdef";
  for (int i = 0; i < 32; ++i) {
    out[2 * i] = hexd[digest[i] >> 4];
    out[2 * i + 1] = hexd[digest[i] & 0xf];
  }
  out[64] = '\0';
}

} // namespace

extern "C" {

// out must hold 65 bytes (64 hex chars + NUL).
void sha256_hex(const uint8_t *data, int64_t len, char *out) {
  Sha256 s;
  s.update(data, size_t(len));
  uint8_t digest[32];
  s.finish(digest);
  to_hex(digest, out);
}

// Chain hash: sha256(prev_hash_hex || entry_0 || ... || entry_{n-1}).
// entries: array of pointers; lens: matching byte lengths.
void chain_hash_hex(const char *prev_hash_hex, const uint8_t *const *entries,
                    const int64_t *lens, int64_t n, char *out) {
  Sha256 s;
  s.update(reinterpret_cast<const uint8_t *>(prev_hash_hex),
           std::strlen(prev_hash_hex));
  for (int64_t i = 0; i < n; ++i)
    s.update(entries[i], size_t(lens[i]));
  uint8_t digest[32];
  s.finish(digest);
  to_hex(digest, out);
}

} // extern "C"

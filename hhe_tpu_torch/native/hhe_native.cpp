// Native host-side primitives of hhe_tpu_torch: a copy of the JAX package's
// hhe_native.cpp, so that the port builds it from its own sources.
//
// Implements, from the FIPS-202 specification (not copied from the vendored
// Keccak library), the Keccak-f[1600] permutation and SHAKE128 XOF, plus the
// PASTA-3 per-(nonce, block) randomness expansion (SHAKE rejection sampling +
// the sequential random-matrix recurrence, reference semantics
// src/pasta/pasta_3_plain.cpp:56-129) — the host side of the transcipher's
// round material.
//
// Exposed as a plain C ABI for ctypes (no Python headers needed).
//
// Built by hhe_tpu_torch/native/__init__.py at first use:
//   g++ -O3 -shared -fPIC -o build/hhe_tpu_torch/libhhe_native_<hash>.so hhe_native.cpp

#include <cstdint>
#include <cstring>

namespace {

// ----------------------------------------------------------------------
// Keccak-f[1600] (FIPS-202)
// ----------------------------------------------------------------------

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

// rotation offsets r[x][y] (FIPS-202 Table 2, x = column, y = row)
constexpr int RHO[5][5] = {{0, 36, 3, 41, 18},
                           {1, 44, 10, 45, 2},
                           {62, 6, 43, 15, 61},
                           {28, 55, 25, 21, 56},
                           {27, 20, 39, 8, 14}};

inline uint64_t rotl(uint64_t v, int s) {
  return s == 0 ? v : (v << s) | (v >> (64 - s));
}

void keccak_f1600(uint64_t A[25]) {  // A[x + 5*y]
  uint64_t B[25], C[5], D[5];
  for (int round = 0; round < 24; ++round) {
    // theta
    for (int x = 0; x < 5; ++x)
      C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    for (int x = 0; x < 5; ++x) D[x] = C[(x + 4) % 5] ^ rotl(C[(x + 1) % 5], 1);
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y) A[x + 5 * y] ^= D[x];
    // rho + pi
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(A[x + 5 * y], RHO[x][y]);
    // chi
    for (int x = 0; x < 5; ++x)
      for (int y = 0; y < 5; ++y)
        A[x + 5 * y] =
            B[x + 5 * y] ^ ((~B[(x + 1) % 5 + 5 * y]) & B[(x + 2) % 5 + 5 * y]);
    // iota
    A[0] ^= RC[round];
  }
}

struct Shake128 {
  static constexpr size_t RATE = 168;  // 1344-bit rate
  uint64_t state[25];
  uint8_t buf[RATE];
  size_t pos;  // squeeze position within current block

  void init(const uint8_t* seed, size_t len) {
    std::memset(state, 0, sizeof(state));
    // absorb (seed lengths here are < RATE, single block)
    uint8_t block[RATE];
    std::memset(block, 0, RATE);
    std::memcpy(block, seed, len);
    block[len] = 0x1F;   // SHAKE domain separation + pad10*1 start
    block[RATE - 1] |= 0x80;
    for (size_t i = 0; i < RATE / 8; ++i) {
      uint64_t w = 0;
      for (int b = 0; b < 8; ++b) w |= (uint64_t)block[8 * i + b] << (8 * b);
      state[i] ^= w;
    }
    keccak_f1600(state);
    extract();
    pos = 0;
  }

  void extract() {
    for (size_t i = 0; i < RATE / 8; ++i)
      for (int b = 0; b < 8; ++b) buf[8 * i + b] = (uint8_t)(state[i] >> (8 * b));
  }

  void squeeze(uint8_t* out, size_t n) {
    while (n) {
      if (pos == RATE) {
        keccak_f1600(state);
        extract();
        pos = 0;
      }
      size_t take = RATE - pos < n ? RATE - pos : n;
      std::memcpy(out, buf + pos, take);
      out += take;
      pos += take;
      n -= take;
    }
  }

  // one uint64 drawn as 8 big-endian bytes (reference
  // pasta_3_plain.cpp generate_random_field_element byte order)
  uint64_t next_u64be() {
    uint8_t b[8];
    squeeze(b, 8);
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | b[i];
    return v;
  }
};

inline uint64_t bit_mask(uint64_t p) {
  uint64_t m = 1;
  while (m < p) m = (m << 1) | 1;
  return m;  // (1 << bitlen(p)) - 1
}

}  // namespace

extern "C" {

// SHAKE128 XOF: out[outlen] from seed[seedlen]  (single-block seeds)
void hhe_shake128(const uint8_t* seed, uint64_t seedlen, uint8_t* out,
                  uint64_t outlen) {
  Shake128 s;
  s.init(seed, (size_t)seedlen);
  s.squeeze(out, (size_t)outlen);
}

// Full PASTA-3 per-(nonce, counter) randomness for T=128, R=3:
// mats1/mats2: [4][128][128], rcs1/rcs2: [4][128] (row-major uint64).
// Draw order per linear layer r: mat1 first row (no zero), mat2 first row
// (no zero), rc1 (zero ok), rc2 (zero ok); matrices expanded by the
// sequential recurrence row_i = first * row_{i-1}[T-1] + shift(row_{i-1}).
void hhe_pasta_block_randomness(uint64_t p, uint64_t nonce, uint64_t counter,
                                uint64_t* mats1, uint64_t* mats2,
                                uint64_t* rcs1, uint64_t* rcs2) {
  constexpr int T = 128, ROUNDS = 4;  // PASTA_R + 1 linear layers
  uint8_t seed[16];
  for (int i = 0; i < 8; ++i) seed[i] = (uint8_t)(nonce >> (56 - 8 * i));
  for (int i = 0; i < 8; ++i) seed[8 + i] = (uint8_t)(counter >> (56 - 8 * i));
  Shake128 xof;
  xof.init(seed, 16);
  const uint64_t mask = bit_mask(p);

  auto draw = [&](bool allow_zero) {
    for (;;) {
      uint64_t v = xof.next_u64be() & mask;
      if (v < p && (allow_zero || v != 0)) return v;
    }
  };
  auto expand = [&](uint64_t* mat) {  // mat[T*T]; first row already present
    for (int i = 1; i < T; ++i) {
      const uint64_t* prev = mat + (i - 1) * T;
      uint64_t* row = mat + i * T;
      // row[j] = first[j] * prev[T-1] + prev[j-1]  (mod p)
      unsigned __int128 last = prev[T - 1];
      row[0] = (uint64_t)((unsigned __int128)mat[0] * last % p);
      for (int j = 1; j < T; ++j)
        row[j] =
            (uint64_t)(((unsigned __int128)mat[j] * last + prev[j - 1]) % p);
    }
  };

  for (int r = 0; r < ROUNDS; ++r) {
    uint64_t* m1 = mats1 + (uint64_t)r * T * T;
    uint64_t* m2 = mats2 + (uint64_t)r * T * T;
    for (int j = 0; j < T; ++j) m1[j] = draw(false);
    expand(m1);
    for (int j = 0; j < T; ++j) m2[j] = draw(false);
    expand(m2);
    for (int j = 0; j < T; ++j) rcs1[r * T + j] = draw(true);
    for (int j = 0; j < T; ++j) rcs2[r * T + j] = draw(true);
  }
}

// Batched keystreams for one block counter: out[nkeys][128];
// keys[nkeys][256]. Full plain PASTA keystream (linear layers + sboxes).
void hhe_pasta_keystreams(uint64_t p, uint64_t nonce, uint64_t counter,
                          const uint64_t* keys, uint64_t nkeys,
                          uint64_t* out) {
  constexpr int T = 128;
  static thread_local uint64_t m1[4 * T * T], m2[4 * T * T], r1[4 * T],
      r2[4 * T];
  hhe_pasta_block_randomness(p, nonce, counter, m1, m2, r1, r2);
  for (uint64_t s = 0; s < nkeys; ++s) {
    uint64_t s1[T], s2[T], t1[T], t2[T];
    const uint64_t* key = keys + s * 2 * T;
    for (int i = 0; i < T; ++i) s1[i] = key[i] % p;
    for (int i = 0; i < T; ++i) s2[i] = key[T + i] % p;
    for (int r = 0; r < 4; ++r) {
      const uint64_t* M1 = m1 + (uint64_t)r * T * T;
      const uint64_t* M2 = m2 + (uint64_t)r * T * T;
      for (int i = 0; i < T; ++i) {
        unsigned __int128 a1 = 0, a2 = 0;
        const uint64_t* row1 = M1 + i * T;
        const uint64_t* row2 = M2 + i * T;
        for (int j = 0; j < T; ++j) {
          a1 += (unsigned __int128)row1[j] * s1[j];
          a2 += (unsigned __int128)row2[j] * s2[j];
        }
        t1[i] = (uint64_t)((a1 + r1[r * T + i]) % p);
        t2[i] = (uint64_t)((a2 + r2[r * T + i]) % p);
      }
      for (int i = 0; i < T; ++i) {
        uint64_t tot = (t1[i] + t2[i]) % p;
        s1[i] = (t1[i] + tot) % p;
        s2[i] = (t2[i] + tot) % p;
      }
      if (r == 2) {  // cube sbox
        for (int i = 0; i < T; ++i) {
          unsigned __int128 sq = (unsigned __int128)s1[i] * s1[i] % p;
          s1[i] = (uint64_t)(sq * s1[i] % p);
          sq = (unsigned __int128)s2[i] * s2[i] % p;
          s2[i] = (uint64_t)(sq * s2[i] % p);
        }
      } else if (r < 2) {  // feistel sbox
        for (int i = T - 1; i > 0; --i) {
          s1[i] = (uint64_t)((s1[i] +
                              (unsigned __int128)s1[i - 1] * s1[i - 1]) %
                             p);
          s2[i] = (uint64_t)((s2[i] +
                              (unsigned __int128)s2[i - 1] * s2[i - 1]) %
                             p);
        }
      }
    }
    for (int i = 0; i < T; ++i) out[s * T + i] = s1[i];
  }
}

}  // extern "C"

// Native prime generation for Paillier keygen (host-side, data-dependent).
//
// The port's copy of tpu_mpc/native/primegen.cpp: the same draw, bit for
// bit, so that a keygen under a pinned seed gives the JAX package's keys.
// A self-contained C++ Miller-Rabin prime searcher with 64-bit-limb
// Montgomery arithmetic, deterministic given a seed, exposed to python by
// ctypes (tpu_mpc_torch/native/__init__.py).
//
// One entry is the port's own: tpu_mpc_is_safe_prime runs the safe-prime
// draw's double sieve and Miller-Rabin rounds on a q that the caller drew,
// for the unseeded search (tpu_mpc_torch/host/primes.py), whose candidates
// come from the OS and never from a 64-bit seed.
//
// Build: g++ -O2 -shared -fPIC -o libprimegen-<hash>.so primegen.cpp

#include <cstdint>
#include <cstring>
#include <vector>

using u64 = uint64_t;
using u128 = unsigned __int128;

namespace {

constexpr int MAX_LIMBS = 64;  // up to 4096-bit

struct Big {
  u64 w[MAX_LIMBS];
  int n;  // limbs in use
  Big() : n(0) { std::memset(w, 0, sizeof(w)); }
};

int cmp(const Big& a, const Big& b) {
  int n = a.n > b.n ? a.n : b.n;
  for (int i = n - 1; i >= 0; --i) {
    u64 x = i < a.n ? a.w[i] : 0, y = i < b.n ? b.w[i] : 0;
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

void sub_inplace(Big& a, const Big& b) {  // a -= b, requires a >= b
  u64 borrow = 0;
  for (int i = 0; i < a.n; ++i) {
    u64 bi = i < b.n ? b.w[i] : 0;
    u64 t = a.w[i] - bi;
    u64 borrow2 = (a.w[i] < bi);
    a.w[i] = t - borrow;
    borrow = borrow2 | (t < borrow);
  }
}

// Montgomery context for odd modulus m (fixed limb count)
struct Mont {
  Big m;
  u64 m0inv;  // -m^{-1} mod 2^64
  Big r2;     // R^2 mod m, R = 2^(64*n)
  int n;

  explicit Mont(const Big& mod) {
    m = mod;
    n = mod.n;
    // Newton iteration for inverse mod 2^64
    u64 inv = 1, x = m.w[0];
    for (int i = 0; i < 6; ++i) inv *= 2 - x * inv;
    m0inv = ~inv + 1;  // -inv
    // r2 = 2^(128n) mod m by repeated doubling
    Big r;
    r.n = n;
    // start with R mod m: compute 2^(64n) mod m via shifting
    // simple: r = 1; double 128*64*? -> do r=1; for bits in 2*64*n: r = 2r mod m
    r.w[0] = 1;
    for (int i = 0; i < 2 * 64 * n; ++i) {
      // r <<= 1
      u64 carry = 0;
      for (int j = 0; j < n; ++j) {
        u64 nc = r.w[j] >> 63;
        r.w[j] = (r.w[j] << 1) | carry;
        carry = nc;
      }
      if (carry || cmp(r, m) >= 0) sub_inplace(r, m);
    }
    r2 = r;
  }

  // out = a * b * R^{-1} mod m (CIOS)
  void mul(const Big& a, const Big& b, Big& out) const {
    u64 t[MAX_LIMBS + 2];
    std::memset(t, 0, sizeof(u64) * (n + 2));
    for (int i = 0; i < n; ++i) {
      u64 carry = 0;
      u64 ai = i < a.n ? a.w[i] : 0;
      for (int j = 0; j < n; ++j) {
        u128 cur = (u128)ai * (j < b.n ? b.w[j] : 0) + t[j] + carry;
        t[j] = (u64)cur;
        carry = (u64)(cur >> 64);
      }
      u128 cur = (u128)t[n] + carry;
      t[n] = (u64)cur;
      t[n + 1] = (u64)(cur >> 64);
      u64 mfac = t[0] * m0inv;
      carry = 0;
      for (int j = 0; j < n; ++j) {
        u128 c2 = (u128)mfac * m.w[j] + t[j] + carry;
        t[j] = (u64)c2;
        carry = (u64)(c2 >> 64);
      }
      cur = (u128)t[n] + carry;
      t[n] = (u64)cur;
      t[n + 1] += (u64)(cur >> 64);
      for (int j = 0; j <= n; ++j) t[j] = t[j + 1];
      t[n + 1] = 0;
    }
    Big res;
    res.n = n;
    std::memcpy(res.w, t, sizeof(u64) * n);
    if (t[n] || cmp(res, m) >= 0) sub_inplace(res, m);
    out = res;
  }

  void exp(const Big& base, const Big& e, Big& out) const {
    Big xm, acc;
    mul(base, r2, xm);  // to Montgomery form
    // acc = R mod m = mont(r2, 1)
    Big one;
    one.n = n;
    one.w[0] = 1;
    mul(r2, one, acc);
    int bits = 64 * e.n;
    for (int i = bits - 1; i >= 0; --i) {
      mul(acc, acc, acc);
      if ((e.w[i / 64] >> (i % 64)) & 1) mul(acc, xm, acc);
    }
    mul(acc, one, out);  // from Montgomery form
  }
};

u64 splitmix64(u64& s) {
  u64 z = (s += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

const int SMALL_PRIMES[] = {
    3,   5,   7,   11,  13,  17,  19,  23,  29,  31,  37,  41,  43,  47,  53,
    59,  61,  67,  71,  73,  79,  83,  89,  97,  101, 103, 107, 109, 113, 127,
    131, 137, 139, 149, 151, 157, 163, 167, 173, 179, 181, 191, 193, 197, 199,
    211, 223, 227, 229, 233, 239, 241, 251, 257, 263, 269, 271, 277, 281, 283,
    293, 307, 311, 313, 317, 331, 337, 347, 349, 353, 359, 367, 373, 379, 383,
    389, 397, 401, 409, 419, 421, 431, 433, 439, 443, 449, 457, 461, 463, 467,
    479, 487, 491, 499, 503, 509, 521, 523, 541, 547, 557, 563, 569, 571, 577,
    587, 593, 599, 601, 607, 613, 617, 619, 631, 641, 643, 647, 653, 659, 661,
    673, 677, 683, 691, 701, 709, 719, 727, 733, 739, 743, 751, 757, 761, 769,
    773, 787, 797, 809, 811, 821, 823, 827, 829, 839, 853, 857, 859, 863, 877,
    881, 883, 887, 907, 911, 919, 929, 937, 941, 947, 953, 967, 971, 977, 983,
    991, 997};

u64 mod_small(const Big& a, u64 p) {
  u64 r = 0;
  for (int i = a.n - 1; i >= 0; --i) r = (u64)((((u128)r << 64) | a.w[i]) % p);
  return r;
}

bool miller_rabin(const Big& num, int rounds, u64& rng_state) {
  const Mont mont(num);
  Big nm1 = num;
  nm1.w[0] -= 1;  // n odd => no borrow
  // n-1 = d * 2^r
  Big d = nm1;
  int r = 0;
  while (!(d.w[0] & 1)) {
    for (int j = 0; j < d.n - 1; ++j) d.w[j] = (d.w[j] >> 1) | (d.w[j + 1] << 63);
    d.w[d.n - 1] >>= 1;
    ++r;
  }
  Big one;
  one.n = num.n;
  one.w[0] = 1;
  for (int it = 0; it < rounds; ++it) {
    Big a;
    a.n = num.n;
    for (int j = 0; j < a.n; ++j) a.w[j] = splitmix64(rng_state);
    a.w[a.n - 1] = 0;  // a < n comfortably
    a.w[0] |= 2;       // a >= 2
    Big x;
    mont.exp(a, d, x);
    if (cmp(x, one) == 0 || cmp(x, nm1) == 0) continue;
    bool witness = true;
    for (int j = 0; j < r - 1; ++j) {
      // plain-domain square: x^2 = mont(to_mont(x), x)
      Big xm;
      mont.mul(x, mont.r2, xm);
      mont.mul(xm, x, x);
      if (cmp(x, nm1) == 0) {
        witness = false;
        break;
      }
      if (cmp(x, one) == 0) break;  // definitely composite
    }
    if (witness) return false;
  }
  return true;
}

bool is_probable_prime_big(const Big& num, u64& rng_state) {
  for (u64 p : SMALL_PRIMES) {
    u64 r = mod_small(num, p);
    if (r == 0) return false;
  }
  return miller_rabin(num, 28, rng_state);
}

// q and p = 2q + 1 (written to p, q.n limbs; q < 2^(64 q.n - 1)) against
// the safe-prime draw's tests: the double sieve, then Miller-Rabin rounds
// 2 (q), 2 (p), 26 (q), 26 (p), witnesses from rng.  The draw below and
// tpu_mpc_is_safe_prime both run it, so they consume rng alike.
bool safe_pair(const Big& q, Big& p, u64& rng) {
  for (u64 sp : SMALL_PRIMES) {
    u64 r = mod_small(q, sp);
    if (r == 0 || (2 * r + 1) % sp == 0) return false;
  }
  p.n = q.n;
  u64 carry = 1;  // 2q + 1: shift-left with +1 in the low bit
  for (int i = 0; i < q.n; ++i) {
    u64 nc = q.w[i] >> 63;
    p.w[i] = (q.w[i] << 1) | carry;
    carry = nc;
  }
  return miller_rabin(q, 2, rng) && miller_rabin(p, 2, rng) &&
         miller_rabin(q, 26, rng) && miller_rabin(p, 26, rng);
}

}  // namespace

extern "C" {

// Generate a prime of exactly `bits` bits (top bit set), deterministic in
// `seed`.  Writes little-endian bytes to out (bits/8 bytes).  Returns 0 on
// success.
int tpu_mpc_gen_prime(int bits, u64 seed, uint8_t* out) {
  if (bits < 128 || bits > 64 * MAX_LIMBS || bits % 64 != 0) return -1;
  int limbs = bits / 64;
  u64 rng = seed ^ 0xA5A5A5A5DEADBEEFULL;
  for (;;) {
    Big cand;
    cand.n = limbs;
    for (int i = 0; i < limbs; ++i) cand.w[i] = splitmix64(rng);
    cand.w[limbs - 1] |= 0x8000000000000000ULL;
    cand.w[0] |= 1;
    if (!is_probable_prime_big(cand, rng)) continue;
    std::memcpy(out, cand.w, bits / 8);
    return 0;
  }
}

// Generate a safe prime p = 2q+1 of exactly `bits` bits, deterministic in
// `seed` (Paillier::keypair_safe_primes role, gg_2018/party_i.rs:163-175).
// Double-sieves q and 2q+1 against the small-prime table before any
// Miller-Rabin, then cheap 2-round pre-checks before the full rounds —
// the sieve rejects ~95% of candidates in O(limbs) word ops.
int tpu_mpc_gen_safe_prime(int bits, u64 seed, uint8_t* out) {
  if (bits < 128 || bits > 64 * MAX_LIMBS || bits % 64 != 0) return -1;
  int limbs = bits / 64;
  u64 rng = seed ^ 0x5AFE5AFE5AFE5AFEULL;
  for (;;) {
    Big q;
    q.n = limbs;
    for (int i = 0; i < limbs; ++i) q.w[i] = splitmix64(rng);
    // q has exactly bits-1 bits so p = 2q+1 has exactly `bits`
    q.w[limbs - 1] = (q.w[limbs - 1] | 0x4000000000000000ULL) & 0x7FFFFFFFFFFFFFFFULL;
    q.w[0] |= 1;
    Big p;
    if (!safe_pair(q, p, rng)) continue;
    std::memcpy(out, p.w, bits / 8);
    return 0;
  }
}

// Primality test of a little-endian byte string. Returns 1 prime, 0 not.
int tpu_mpc_is_prime(const uint8_t* data, int nbytes, u64 seed) {
  if (nbytes <= 0 || nbytes > 8 * MAX_LIMBS) return -1;
  Big num;
  num.n = (nbytes + 7) / 8;
  std::memcpy(num.w, data, nbytes);
  if (num.n == 1 && num.w[0] < 2) return 0;
  if (!(num.w[0] & 1)) return (num.n == 1 && num.w[0] == 2) ? 1 : 0;
  u64 rng = seed ^ 0x1234567890ABCDEFULL;
  for (u64 p : SMALL_PRIMES) {
    u64 r = mod_small(num, p);
    if (r == 0) return (num.n == 1 && num.w[0] == p) ? 1 : 0;
  }
  return miller_rabin(num, 28, rng) ? 1 : 0;
}

// The safe-prime draw's tests (safe_pair) on a q of the caller's: nbytes
// little-endian bytes, a multiple of 8, with the top bit of the top word
// clear so that 2q + 1 fits.  Returns 1 when q and 2q + 1 pass, 0 when
// not, -1 on a bad size.
int tpu_mpc_is_safe_prime(const uint8_t* q_bytes, int nbytes, u64 seed) {
  if (nbytes < 16 || nbytes > 8 * MAX_LIMBS || nbytes % 8 != 0) return -1;
  Big q, p;
  q.n = nbytes / 8;
  std::memcpy(q.w, q_bytes, nbytes);
  if (q.w[q.n - 1] >> 63 || !(q.w[0] & 1)) return -1;
  u64 rng = seed ^ 0x5AFE5AFE5AFE5AFEULL;
  return safe_pair(q, p, rng) ? 1 : 0;
}
}

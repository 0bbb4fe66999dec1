// Native batched modular products for the host-side bigint seams.
//
// The port's copy of tpu_mpc/native/hostmul.cpp, the GMP helper behind
// core/modctx.py:host_mulmod and host_prod_axis0 (the role rust-gmp plays
// for curv's BigInt products).  libgmp.so.10 ships no headers where this
// builds, so the (ABI-stable since GMP 4) prototypes are declared locally.
//
// Layout contract (little-endian fixed-width W bytes per element):
//   mulmod_batch:  ops = k contiguous arrays [B x W]; mod [B x W]; out [B x W]
//                  out[b] = prod_i ops_i[b] mod m[b]
//   prodmod_axis0: vals [S x J x W]; mod [J x W]; out [J x W]
//                  out[j] = prod_s vals[s][j] mod m[j]
//
// A zero modulus gives 0 here; the python callers never pass one.
//
// Build: g++ -O2 -shared -fPIC -o libhostmul-<hash>.so hostmul.cpp \
//            <path of libgmp.so.10> -lpthread

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
typedef struct {
  int _mp_alloc;
  int _mp_size;
  unsigned long* _mp_d;
} __mpz_struct;
typedef __mpz_struct mpz_t[1];
void __gmpz_init(mpz_t);
void __gmpz_clear(mpz_t);
void __gmpz_mul(mpz_t, const mpz_t, const mpz_t);
void __gmpz_mod(mpz_t, const mpz_t, const mpz_t);
void __gmpz_set_ui(mpz_t, unsigned long);
int __gmpz_cmp_ui(const mpz_t, unsigned long);
void __gmpz_import(mpz_t, size_t, int, size_t, int, size_t, const void*);
void* __gmpz_export(void*, size_t*, int, size_t, int, size_t, const mpz_t);
}

namespace {

struct Z {
  mpz_t v;
  Z() { __gmpz_init(v); }
  ~Z() { __gmpz_clear(v); }
};

void imp(Z& z, const uint8_t* p, long W) {
  __gmpz_import(z.v, (size_t)W, -1, 1, 0, 0, p);
}

void expo(uint8_t* p, long W, const Z& z) {
  std::memset(p, 0, (size_t)W);
  if (__gmpz_cmp_ui(z.v, 0) != 0) {
    size_t cnt = 0;
    __gmpz_export(p, &cnt, -1, 1, 0, 0, z.v);
  }
}

int nthreads_for(long work) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw < 1) hw = 1;
  long by_work = work / 256 + 1;
  return (int)(by_work < (long)hw ? by_work : (long)hw);
}

}  // namespace

extern "C" {

// out[b] = prod_{i<k} ops[i*B*W + b*W ..] mod m[b]
int tpu_mpc_mulmod_batch(const uint8_t* ops, int k, const uint8_t* mod,
                         uint8_t* out, long B, long W) {
  if (k < 1 || B < 1 || W < 1) return 1;
  int nt = nthreads_for(B * k);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([=]() {
      Z acc, x, m;
      for (long b = t; b < B; b += nt) {
        imp(m, mod + b * W, W);
        if (__gmpz_cmp_ui(m.v, 0) == 0) {
          std::memset(out + b * W, 0, (size_t)W);
          continue;
        }
        imp(acc, ops + b * W, W);
        __gmpz_mod(acc.v, acc.v, m.v);
        for (int i = 1; i < k; ++i) {
          imp(x, ops + (long)i * B * W + b * W, W);
          __gmpz_mul(acc.v, acc.v, x.v);
          __gmpz_mod(acc.v, acc.v, m.v);
        }
        expo(out + b * W, W, acc);
      }
    });
  }
  for (auto& th : ths) th.join();
  return 0;
}

// out[j] = prod_{s<S} vals[s*J*W + j*W ..] mod m[j]
int tpu_mpc_prodmod_axis0(const uint8_t* vals, long S, const uint8_t* mod,
                          uint8_t* out, long J, long W) {
  if (S < 1 || J < 1 || W < 1) return 1;
  int nt = nthreads_for(S * J);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; ++t) {
    ths.emplace_back([=]() {
      Z acc, x, m;
      for (long j = t; j < J; j += nt) {
        imp(m, mod + j * W, W);
        if (__gmpz_cmp_ui(m.v, 0) == 0) {
          std::memset(out + j * W, 0, (size_t)W);
          continue;
        }
        __gmpz_set_ui(acc.v, 1);
        for (long s = 0; s < S; ++s) {
          imp(x, vals + s * J * W + j * W, W);
          __gmpz_mul(acc.v, acc.v, x.v);
          __gmpz_mod(acc.v, acc.v, m.v);
        }
        expo(out + j * W, W, acc);
      }
    });
  }
  for (auto& th : ths) th.join();
  return 0;
}

}  // extern "C"

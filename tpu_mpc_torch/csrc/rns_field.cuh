// RNS Montgomery arithmetic shared by K1 (rns_exp.cu) and K2 (rns_fixed.cu).
//
// Same Bajard-Imbert scheme as tpu_mpc_torch/core/rns.py, value for value:
// every channel value stays canonical (< p).  A block works on one lane (one
// big integer); thread t owns A-channel t (t < K), B-channel t (t < Kp) and,
// on thread Kp, the redundant 2^16 channel r.
//
// One Montgomery multiply is two exact dot products over the channels
// (2*K*(K+1) 32x32->64-bit multiply-adds) and three block barriers.  The
// extension matrices W1/W2 are shared by every lane and stay in L2.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rnsf {

struct Dims {
  int K, Kp, CH, Lin, Lout;
};

// Views into the flat constant vector (core/rns.py:RnsParams.const_vector).
struct Cst {
  const uint32_t *pA, *pB, *invMAk, *invMA_B, *invMBj, *MB_A, *W1, *W2,
      *W16A, *W16B, *Wbin;
};

__device__ __forceinline__ Cst cst_views(const uint32_t* c, const Dims& d) {
  Cst s;
  s.pA = c;
  s.pB = s.pA + d.K;
  s.invMAk = s.pB + d.Kp;
  s.invMA_B = s.invMAk + d.K;
  s.invMBj = s.invMA_B + d.Kp;
  s.MB_A = s.invMBj + d.Kp;
  s.W1 = s.MB_A + d.K;
  s.W2 = s.W1 + d.K * (d.Kp + 1);
  s.W16A = s.W2 + d.Kp * (d.K + 1);
  s.W16B = s.W16A + d.Lin * d.K;
  s.Wbin = s.W16B + d.Lin * d.Kp;
  return s;
}

// a, b < 2^16: the product fits 32 bits
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t p) {
  return (a * b) % p;
}

// Per-thread view of one value: the thread's A, B and r channels.
struct Val {
  uint32_t a, b, r;
};

// Shared scratch of one multiply: the two extension inputs and alpha.
struct Shm {
  uint32_t* xi1;    // [K]
  uint32_t* xi2;    // [Kp]
  uint32_t* alpha;  // [1]
};

// Words of shared memory the scratch takes; carve() lays it out at `base`.
__host__ __device__ __forceinline__ int shm_words(int K, int Kp) { return K + Kp + 1; }

__device__ __forceinline__ Shm carve(uint32_t* base, const Dims& d) {
  Shm sh;
  sh.xi1 = base;
  sh.xi2 = sh.xi1 + d.K;
  sh.alpha = sh.xi2 + d.Kp;
  return sh;
}

// Per-thread constants of its own channels and of the lane's modulus.
struct Thr {
  int t;
  bool isA, isB, isR;
  uint32_t pa, pb, invMA_B, invMBj, MB_A, invMAk;
  uint32_t cA, NB, Nr;
  uint32_t invMA_r, invMB_r;
};

// The thread's constants; `c` is the lane's RnsCtx row [3*CH]:
// [cA | N_B | N_r] [mon] [r2] (core/rns.py:RnsCtx).
__device__ __forceinline__ Thr thr_init(const Cst& cs, const Dims& d, const uint32_t* c,
                                        uint32_t invMA_r, uint32_t invMB_r) {
  Thr th;
  const int t = threadIdx.x;
  th.t = t;
  th.isA = t < d.K;
  th.isB = t < d.Kp;
  th.isR = t == d.Kp;
  th.pa = th.isA ? cs.pA[t] : 1u;
  th.pb = th.isB ? cs.pB[t] : 1u;
  th.invMA_B = th.isB ? cs.invMA_B[t] : 0u;
  th.invMBj = th.isB ? cs.invMBj[t] : 0u;
  th.MB_A = th.isA ? cs.MB_A[t] : 0u;
  th.invMAk = th.isA ? cs.invMAk[t] : 0u;
  th.cA = th.isA ? c[t] : 0u;
  th.NB = th.isB ? c[d.K + t] : 0u;
  th.Nr = c[d.K + d.Kp];
  th.invMA_r = invMA_r;
  th.invMB_r = invMB_r;
  return th;
}

// The thread's channels of one [CH] residue row (A | B | r).
__device__ __forceinline__ Val load_val(const uint32_t* row, const Thr& th, const Dims& d) {
  return Val{th.isA ? row[th.t] : 0u, th.isB ? row[d.K + th.t] : 0u, row[d.K + d.Kp]};
}

__device__ __forceinline__ void store_val(uint32_t* row, const Val& v, const Thr& th,
                                          const Dims& d) {
  if (th.isA) row[th.t] = v.a;
  if (th.isB) row[d.K + th.t] = v.b;
  if (th.isR) row[d.K + d.Kp] = v.r;
}

// x <- x * y * MA^{-1} mod N.  Every thread of the block calls it.
__device__ void montmul(Val& x, const Val& y, const Thr& th, const Cst& cs,
                        const Dims& d, const Shm& sh) {
  const int t = th.t;
  // 1. channel products; xi = s * (-N^{-1}) * invMAk on base A
  if (th.isA) sh.xi1[t] = mulmod(mulmod(x.a, y.a, th.pa), th.cA, th.pa);
  const uint32_t sB = th.isB ? mulmod(x.b, y.b, th.pb) : 0u;
  const uint32_t sr = (x.r * y.r) & 0xFFFFu;
  __syncthreads();
  // 2. approximate extension A -> (B | r): column t of W1
  if (t <= d.Kp) {
    unsigned long long acc = 0ull;
    const uint32_t* w = cs.W1 + t;
    for (int k = 0; k < d.K; ++k)
      acc += (unsigned long long)__ldg(w + k * (d.Kp + 1)) * sh.xi1[k];
    if (th.isB) {
      const uint32_t qh = (uint32_t)(acc % th.pb);
      uint32_t num = sB + mulmod(qh, th.NB, th.pb);
      num = num >= th.pb ? num - th.pb : num;
      const uint32_t tb = mulmod(num, th.invMA_B, th.pb);
      x.b = tb;
      sh.xi2[t] = mulmod(tb, th.invMBj, th.pb);
    } else {  // t == Kp: the redundant channel
      const uint32_t qh_r = (uint32_t)(acc & 0xFFFFull);
      x.r = (((sr + qh_r * th.Nr) & 0xFFFFu) * th.invMA_r) & 0xFFFFu;
    }
  }
  __syncthreads();
  // 3. exact extension B -> A (columns 0..K-1 of W2) and, on the r thread,
  //    the redundant-channel sum (column K) that yields alpha
  uint32_t tA = 0u;
  const int j = t < d.K ? t : (th.isR ? d.K : -1);
  if (j >= 0) {
    unsigned long long acc = 0ull;
    const uint32_t* w = cs.W2 + j;
    for (int i = 0; i < d.Kp; ++i)
      acc += (unsigned long long)__ldg(w + i * (d.K + 1)) * sh.xi2[i];
    if (th.isA) {
      tA = (uint32_t)(acc % th.pa);
    } else {
      const uint32_t sum_r = (uint32_t)(acc & 0xFFFFull);
      sh.alpha[0] = (((sum_r - x.r) & 0xFFFFu) * th.invMB_r) & 0xFFFFu;
    }
  }
  __syncthreads();
  if (th.isA) {
    const uint32_t corr = mulmod(sh.alpha[0], th.MB_A, th.pa);
    x.a = tA >= corr ? tA - corr : tA + th.pa - corr;
  }
}

// Decode epilogue: strip MA (multiply by the integer 1), xi = res * invMAk,
// then the exact binary column sums v[l] = sum_k xi_k * limb_l(MA/p_k) of
// the lane into out[Lout] (< K * 2^32 each; core/rns.py:RnsLazy decodes).
__device__ void decode_cols(Val acc, const Thr& th, const Cst& cs, const Dims& d,
                            const Shm& sh, unsigned long long* __restrict__ out) {
  montmul(acc, Val{1u, 1u, 1u}, th, cs, d, sh);
  if (th.isA) sh.xi1[th.t] = mulmod(acc.a, th.invMAk, th.pa);
  __syncthreads();
  for (int o = th.t; o < d.Lout; o += blockDim.x) {
    unsigned long long s = 0ull;
    for (int k = 0; k < d.K; ++k)
      s += (unsigned long long)__ldg(cs.Wbin + k * d.Lout + o) * sh.xi1[k];
    out[o] = s;
  }
}

// Threads of one block: the Kp + 1 channel owners, rounded up to whole warps.
__host__ __forceinline__ int block_threads(int Kp) { return ((Kp + 1 + 31) / 32) * 32; }

}  // namespace rnsf

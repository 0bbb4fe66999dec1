// secp256k1 field and point routines shared by K3, K4 and K5.
//
// Field elements are 8 x 32-bit limbs, little-endian, always fully reduced
// (< p).  Points are homogeneous projective (X : Y : Z) under the Renes-
// Costello-Batina complete formulas for a = 0, b3 = 3*7 = 21, the same
// formulas in the same order as the plain versions in
// tpu_mpc_torch/ec/pallas_ec.py, so the canonical outputs agree bit for bit.
//
// Arithmetic runs on the PTX carry flag (add.cc / addc / mad.lo.cc /
// madc.hi.cc).  A product a*b is scanned row by row (row i: a * b_i), and
// each row is two independent carry chains: the even-indexed limbs a_0, a_2,
// a_4, a_6 give (lo, hi) pairs on consecutive columns from column i, the odd
// ones from column i + 1, so each chain adds a row's high halves with its
// low ones, and the chains of neighbouring rows overlap (ptxas gives each
// its own carry predicate).  The two accumulators hold columns k (Ev) and
// k + 1 (Od), and a row puts each chain where it starts on an even index,
// so every (lo, hi) pair is an aligned register pair: one IMAD.WIDE each,
// no moves.  Ev + Od is one add chain.  A square takes its 28 cross
// products once (the same rows), doubles them with a funnel shift and adds
// the 8 diagonal squares: 36 products.  A multiply by a small constant is
// 8 products.  The 512-bit result folds by
// 2^256 = 2^32 + 977 (mod p): hi * 977 (even/odd chains) and hi << 32 into
// lo, the top word (< 2^32 + 978) once more, a last carry (the value is then
// tiny) once more, and one conditional subtract of p.  Every output is
// canonical, so any exact reduction gives the same limbs.

#pragma once
#include <cstdint>

namespace ec {

// -- begin ptx: carry-flag primitives ----------------------------------------
// Each is one PTX instruction; consecutive calls pass the carry flag on, so
// the compiler must not move anything that writes it between them (asm
// volatile keeps their order).
namespace ptx {

__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

}  // namespace ptx
// -- end ptx ------------------------------------------------------------------

struct Fe {
  uint32_t v[8];
};

struct Pt {
  Fe X, Y, Z;
};

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = 0u;
  return r;
}

__device__ __forceinline__ Fe fe_small(uint32_t k) {
  Fe r = fe_zero();
  r.v[0] = k;
  return r;
}

constexpr uint32_t kP0 = 0xFFFFFC2Fu, kP1 = 0xFFFFFFFEu, kPn = 0xFFFFFFFFu;

// r - p if r >= p or carry is set (r + 2^256 carry < 2p)
__device__ __forceinline__ Fe fe_reduce_once(const Fe& r, uint32_t carry) {
  using namespace ptx;
  Fe t;
  t.v[0] = sub_cc(r.v[0], kP0);
  t.v[1] = subc_cc(r.v[1], kP1);
#pragma unroll
  for (int i = 2; i < 8; ++i) t.v[i] = subc_cc(r.v[i], kPn);
  const uint32_t bw = subc(0u, 0u);          // 0 or 0xFFFFFFFF
  const bool take = carry != 0u || bw == 0u;
  Fe o;
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = take ? t.v[i] : r.v[i];
  return o;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  using namespace ptx;
  Fe s;
  s.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) s.v[i] = addc_cc(a.v[i], b.v[i]);
  return fe_reduce_once(s, addc(0u, 0u));
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  using namespace ptx;
  Fe d;
  d.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
  for (int i = 1; i < 8; ++i) d.v[i] = subc_cc(a.v[i], b.v[i]);
  const uint32_t m = subc(0u, 0u);           // borrow: add p back (mod 2^256)
  d.v[0] = add_cc(d.v[0], kP0 & m);
  d.v[1] = addc_cc(d.v[1], kP1 & m);
#pragma unroll
  for (int i = 2; i < 7; ++i) d.v[i] = addc_cc(d.v[i], m);
  d.v[7] = addc(d.v[7], m);
  return d;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub(fe_zero(), a); }

// lo + hi * 2^256 (t[16]) -> canonical residue
__device__ __forceinline__ Fe fe_fold(const uint32_t (&t)[16]) {
  using namespace ptx;
  const uint32_t* h = t + 8;
  uint32_t s[10];
  // s = lo + hi * 977: even limbs of hi, then odd (s8 < 2^10 + 1)
  s[0] = mad_lo_cc(h[0], 977u, t[0]);
  s[1] = madc_hi_cc(h[0], 977u, t[1]);
  s[2] = madc_lo_cc(h[2], 977u, t[2]);
  s[3] = madc_hi_cc(h[2], 977u, t[3]);
  s[4] = madc_lo_cc(h[4], 977u, t[4]);
  s[5] = madc_hi_cc(h[4], 977u, t[5]);
  s[6] = madc_lo_cc(h[6], 977u, t[6]);
  s[7] = madc_hi_cc(h[6], 977u, t[7]);
  s[8] = addc(0u, 0u);
  s[1] = mad_lo_cc(h[1], 977u, s[1]);
  s[2] = madc_hi_cc(h[1], 977u, s[2]);
  s[3] = madc_lo_cc(h[3], 977u, s[3]);
  s[4] = madc_hi_cc(h[3], 977u, s[4]);
  s[5] = madc_lo_cc(h[5], 977u, s[5]);
  s[6] = madc_hi_cc(h[5], 977u, s[6]);
  s[7] = madc_lo_cc(h[7], 977u, s[7]);
  s[8] = madc_hi(h[7], 977u, s[8]);
  // s += hi << 32: top T = s8 + 2^32 s9 < 2^32 + 978
  s[1] = add_cc(s[1], h[0]);
#pragma unroll
  for (int i = 2; i < 9; ++i) s[i] = addc_cc(s[i], h[i - 1]);
  s[9] = addc(0u, 0u);
  // r = s[0..7] + T * 977 + T * 2^32; T * 977 = (w_lo, w_hi)
  const uint32_t w_lo = s[8] * 977u;
  const uint32_t w_hi = __umulhi(s[8], 977u) + s[9] * 977u;
  Fe r;
  r.v[0] = add_cc(s[0], w_lo);
  r.v[1] = addc_cc(s[1], w_hi);
  r.v[2] = addc_cc(s[2], s[9]);
#pragma unroll
  for (int i = 3; i < 8; ++i) r.v[i] = addc_cc(s[i], 0u);
  uint32_t c = addc(0u, 0u);
  r.v[1] = add_cc(r.v[1], s[8]);
#pragma unroll
  for (int i = 2; i < 8; ++i) r.v[i] = addc_cc(r.v[i], 0u);
  c = addc(c, 0u);                           // the sum carries at most once
  // a carry out leaves r < 2^66: adding 2^32 + 977 cannot carry again
  const uint32_t cm = 0u - c;
  r.v[0] = add_cc(r.v[0], 977u & cm);
  r.v[1] = addc_cc(r.v[1], 1u & cm);
#pragma unroll
  for (int i = 2; i < 7; ++i) r.v[i] = addc_cc(r.v[i], 0u);
  r.v[7] = addc(r.v[7], 0u);
  return fe_reduce_once(r, 0u);
}

// One row chain: lo/hi of a_j * bi for j = j0, j0 + 2, ... (n terms) added
// into acc[o], acc[o + 1], ... with a carry into acc[o + 2n] (which holds 0
// or an earlier row's carry); last: the row cannot carry out (no carry word).
__device__ __forceinline__ void row_chain(uint32_t (&acc)[16], int o, const Fe& a, int j0,
                                          int n, uint32_t bi, bool last = false) {
  using namespace ptx;
  acc[o] = mad_lo_cc(a.v[j0], bi, acc[o]);
  acc[o + 1] = madc_hi_cc(a.v[j0], bi, acc[o + 1]);   // (last rows have n = 4)
#pragma unroll
  for (int k = 1; k < n; ++k) {
    const int j = j0 + 2 * k;
    acc[o + 2 * k] = madc_lo_cc(a.v[j], bi, acc[o + 2 * k]);
    if (last && k == n - 1)
      acc[o + 2 * k + 1] = madc_hi(a.v[j], bi, acc[o + 2 * k + 1]);
    else
      acc[o + 2 * k + 1] = madc_hi_cc(a.v[j], bi, acc[o + 2 * k + 1]);
  }
  if (!last) acc[o + 2 * n] = addc(acc[o + 2 * n], 0u);
}

// Ev[k] holds column k, Od[k] column k + 1: every row chain starts on an
// even index of one of them, so its (lo, hi) pairs stay aligned register
// pairs (no moves between the 64-bit multiply-adds)
__device__ __forceinline__ void merge_cols(const uint32_t (&Ev)[16], const uint32_t (&Od)[16],
                                           uint32_t (&t)[16]) {
  using namespace ptx;
  t[0] = Ev[0];
  t[1] = add_cc(Ev[1], Od[0]);
#pragma unroll
  for (int k = 2; k < 15; ++k) t[k] = addc_cc(Ev[k], Od[k - 1]);
  t[15] = addc(Ev[15], Od[14]);
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  // row i = a * b_i: the pairs of a_0, a_2, a_4, a_6 from column i, those of
  // a_1, a_3, a_5, a_7 from column i + 1: even i puts them at Ev[i], Od[i],
  // odd i at Od[i - 1], Ev[i + 1]
  uint32_t Ev[16], Od[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Ev[k] = Od[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if ((i & 1) == 0) {
      row_chain(Ev, i, a, 0, 4, b.v[i]);
      row_chain(Od, i, a, 1, 4, b.v[i]);
    } else {
      row_chain(Od, i - 1, a, 0, 4, b.v[i]);
      row_chain(Ev, i + 1, a, 1, 4, b.v[i], i == 7);   // column 16 stays 0
    }
  }
  uint32_t t[16];
  merge_cols(Ev, Od, t);
  return fe_fold(t);
}

__device__ __forceinline__ Fe fe_sq(const Fe& a) {
  using namespace ptx;
  // cross products a_i a_j (i < j): row i = a_i * (a_(i+1), ..., a_7) from
  // column 2i + 1; its terms j = i+1, i+3, ... start on odd columns (Od[2i]),
  // j = i+2, i+4, ... on even ones (Ev[2i + 2])
  uint32_t Ev[16], Od[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) Ev[k] = Od[k] = 0u;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    row_chain(Od, 2 * i, a, i + 1, (7 - i + 1) / 2, a.v[i]);
    if (i + 2 < 8) row_chain(Ev, 2 * i + 2, a, i + 2, (7 - i) / 2, a.v[i]);
  }
  // cross sum C < 2^511, doubled
  uint32_t t[16];
  merge_cols(Ev, Od, t);
#pragma unroll
  for (int k = 15; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] <<= 1;
  // + the diagonal a_i^2 at columns 2i, 2i + 1
  t[0] = mad_lo_cc(a.v[0], a.v[0], t[0]);
  t[1] = madc_hi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
  for (int i = 1; i < 7; ++i) {
    t[2 * i] = madc_lo_cc(a.v[i], a.v[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a.v[i], a.v[i], t[2 * i + 1]);
  }
  t[14] = madc_lo_cc(a.v[7], a.v[7], t[14]);
  t[15] = madc_hi(a.v[7], a.v[7], t[15]);
  return fe_fold(t);
}

// a * k for a constant k < 2^16: 8 products and a short fold
__device__ __forceinline__ Fe fe_muli(const Fe& a, uint32_t k) {
  using namespace ptx;
  uint32_t t[9];
  t[0] = a.v[0] * k;
  t[1] = __umulhi(a.v[0], k);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    t[j] = a.v[j] * k;
    t[j + 1] = __umulhi(a.v[j], k);
  }
  t[1] = mad_lo_cc(a.v[1], k, t[1]);
#pragma unroll
  for (int j = 1; j < 7; j += 2) {
    t[j + 1] = madc_hi_cc(a.v[j], k, t[j + 1]);
    t[j + 2] = madc_lo_cc(a.v[j + 2], k, t[j + 2]);
  }
  t[8] = madc_hi(a.v[7], k, 0u);
  // t8 * 2^256 = t8 (2^32 + 977), < 2^49
  const uint64_t w = (uint64_t)t[8] * 977u + ((uint64_t)t[8] << 32);
  Fe r;
  r.v[0] = add_cc(t[0], (uint32_t)w);
  r.v[1] = addc_cc(t[1], (uint32_t)(w >> 32));
#pragma unroll
  for (int i = 2; i < 8; ++i) r.v[i] = addc_cc(t[i], 0u);
  const uint32_t cm = 0u - addc(0u, 0u);    // then r < 2^49: one more fold
  r.v[0] = add_cc(r.v[0], 977u & cm);
  r.v[1] = addc_cc(r.v[1], 1u & cm);
#pragma unroll
  for (int i = 2; i < 7; ++i) r.v[i] = addc_cc(r.v[i], 0u);
  r.v[7] = addc(r.v[7], 0u);
  return fe_reduce_once(r, 0u);
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t o = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) o |= a.v[i];
  return o == 0u;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = c ? a.v[i] : b.v[i];
  return r;
}

// 16 x 16-bit limbs (int32 storage) <-> 8 x 32-bit limbs
__device__ __forceinline__ Fe fe_load16(const int32_t* l) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r.v[i] = ((uint32_t)l[2 * i] & 0xFFFFu) | (((uint32_t)l[2 * i + 1] & 0xFFFFu) << 16);
  return r;
}

__device__ __forceinline__ void fe_store16(const Fe& a, int32_t* l) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    l[2 * i] = (int32_t)(a.v[i] & 0xFFFFu);
    l[2 * i + 1] = (int32_t)(a.v[i] >> 16);
  }
}

// ---------------------------------------------------------------------------
// complete projective formulas (RCB 2015, a = 0, b3 = 21), one thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ Pt pt_identity() {
  Pt r;
  r.X = fe_zero();
  r.Y = fe_small(1u);
  r.Z = fe_zero();
  return r;
}

// Jacobian (X, Y, Z) -> homogeneous (XZ, Y, Z^3)
__device__ __forceinline__ Pt jac_in(const int32_t* l) {
  const Fe X = fe_load16(l), Y = fe_load16(l + 16), Z = fe_load16(l + 32);
  Pt r;
  r.X = fe_mul(X, Z);
  r.Y = Y;
  r.Z = fe_mul(fe_sq(Z), Z);
  return r;
}

// homogeneous (U, V, W) -> Jacobian (UW, VW^2, W), canonical 16-bit limbs
__device__ __forceinline__ void jac_out(const Pt& P, int32_t* l) {
  fe_store16(fe_mul(P.X, P.Z), l);
  fe_store16(fe_mul(P.Y, fe_sq(P.Z)), l + 16);
  fe_store16(P.Z, l + 32);
}

// ---------------------------------------------------------------------------
// the same formulas on a group of 4 threads of one warp (K3, K4)
// ---------------------------------------------------------------------------
//
// The 4 threads of a lane's group (q = 0..3, consecutive lanes of the warp)
// hold the same point.  Each round of independent products is split among
// them: every thread computes one or two products, in the operand order of
// the one-thread formula, and the group exchanges them by __shfl_sync, so
// every thread ends with the same canonical values.  The add/sub glue and
// the multiplies by 21 run on every thread.  rcb_add: t0..t5 (two products
// a thread, threads 2 and 3 repeat t4 and t5), then the six output products
// as three pairs (thread q' = q mod 3 computes one coordinate; thread 3
// repeats X).  rcb_dbl: four and four.  Every thread of the warp must call
// these together (full-mask shuffles).

constexpr int GROUP = 4;

__device__ __forceinline__ Fe fe_shfl(const Fe& a, int src) {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __shfl_sync(0xFFFFFFFFu, a.v[i], src);
  return r;
}

// a[q] for a public selector q in 0..3 (no local-memory indexing)
__device__ __forceinline__ Fe fe_pick(int q, const Fe& a0, const Fe& a1, const Fe& a2,
                                      const Fe& a3) {
  return fe_select(q == 0, a0, fe_select(q == 1, a1, fe_select(q == 2, a2, a3)));
}

struct Grp {
  int q;      // this thread's index in the group
  int base;   // warp lane of thread 0 of the group
};

__device__ __forceinline__ Grp grp_this() {
  const int ln = threadIdx.x & 31;
  return Grp{ln & (GROUP - 1), ln & ~(GROUP - 1)};
}

__device__ __forceinline__ Pt grp_add(const Pt& P, const Pt& Q, const Grp& g) {
  const bool odd = g.q & 1;
  // round 1: thread q: t_q and t_(4 + q%2)
  const Fe sxy1 = fe_add(P.X, P.Y), sxy2 = fe_add(Q.X, Q.Y);
  const Fe a0 = fe_pick(g.q, P.X, P.Y, P.Z, sxy1);
  const Fe b0 = fe_pick(g.q, Q.X, Q.Y, Q.Z, sxy2);
  const Fe a1 = fe_add(fe_select(odd, P.X, P.Y), P.Z);   // t4: (Y1+Z1), t5: (X1+Z1)
  const Fe b1 = fe_add(fe_select(odd, Q.X, Q.Y), Q.Z);
  const Fe p0 = fe_mul(a0, b0), p1 = fe_mul(a1, b1);
  const Fe t0 = fe_shfl(p0, g.base), t1 = fe_shfl(p0, g.base + 1);
  const Fe t2 = fe_shfl(p0, g.base + 2);
  Fe t3 = fe_shfl(p0, g.base + 3);
  Fe t4 = fe_shfl(p1, g.base), t5 = fe_shfl(p1, g.base + 1);
  t3 = fe_sub(fe_sub(t3, t0), t1);
  t4 = fe_sub(fe_sub(t4, t1), t2);
  t5 = fe_sub(fe_sub(t5, t0), t2);
  const Fe t0_3 = fe_add(fe_add(t0, t0), t0);
  const Fe t2b = fe_muli(t2, 21u);
  const Fe zt = fe_add(t1, t2b);
  const Fe t1m = fe_sub(t1, t2b);
  const Fe yb = fe_muli(t5, 21u);
  // round 2: q' = 0: X = t3 t1m - t4 yb; 1: Y = t1m zt + yb t0_3;
  // 2: Z = zt t4 + t0_3 t3
  const int qq = g.q == 3 ? 0 : g.q;
  const Fe c0 = fe_pick(qq, t3, t1m, zt, t3), d0 = fe_pick(qq, t1m, zt, t4, t1m);
  const Fe c1 = fe_pick(qq, t4, yb, t0_3, t4), d1 = fe_pick(qq, yb, t0_3, t3, yb);
  const Fe m0 = fe_mul(c0, d0), m1 = fe_mul(c1, d1);
  const Fe r = fe_add(m0, fe_select(qq == 0, fe_neg(m1), m1));   // m0 - m1 = m0 + (-m1)
  Pt R;
  R.X = fe_shfl(r, g.base);
  R.Y = fe_shfl(r, g.base + 1);
  R.Z = fe_shfl(r, g.base + 2);
  return R;
}

__device__ __forceinline__ Pt grp_dbl(const Pt& P, const Grp& g) {
  // round 1: t0 = Y Y, t1 = Y Z, zz = Z Z, xy = X Y
  const Fe a = fe_pick(g.q, P.Y, P.Y, P.Z, P.X);
  const Fe b = fe_pick(g.q, P.Y, P.Z, P.Z, P.Y);
  const Fe p = fe_mul(a, b);
  const Fe t0 = fe_shfl(p, g.base), t1 = fe_shfl(p, g.base + 1);
  const Fe zz = fe_shfl(p, g.base + 2), xy = fe_shfl(p, g.base + 3);
  Fe z3 = fe_add(t0, t0);
  z3 = fe_add(z3, z3);
  z3 = fe_add(z3, z3);
  const Fe t2 = fe_muli(zz, 21u);
  const Fe y3a = fe_add(t0, t2);
  const Fe t1b = fe_add(t2, t2);
  const Fe t2b = fe_add(t1b, t2);
  const Fe t0b = fe_sub(t0, t2b);
  // round 2: x3 = t2 z3, Z = t1 z3, ty = t0b y3a, tx = t0b xy
  const Fe c = fe_pick(g.q, t2, t1, t0b, t0b);
  const Fe d = fe_pick(g.q, z3, z3, y3a, xy);
  const Fe m = fe_mul(c, d);
  const Fe x3 = fe_shfl(m, g.base), zn = fe_shfl(m, g.base + 1);
  const Fe ty = fe_shfl(m, g.base + 2), tx = fe_shfl(m, g.base + 3);
  Pt R;
  R.Z = zn;
  R.Y = fe_add(x3, ty);
  R.X = fe_add(tx, tx);
  return R;
}

}  // namespace ec

// secp256k1 field and point routines shared by K3, K4 and K5.
//
// Field elements are 8 x 32-bit limbs, little-endian, always fully reduced
// (< p): products are 64-bit multiply-adds and the 512-bit product folds
// with 2^256 = 2^32 + 977 (mod p) twice before one conditional subtract.
// Points are homogeneous projective (X : Y : Z) under the Renes-Costello-
// Batina complete formulas for a = 0, b3 = 3*7 = 21, the same formulas in
// the same order as the plain versions in tpu_mpc_torch/ec/pallas_ec.py,
// so the canonical outputs agree bit for bit.

#pragma once
#include <cstdint>

namespace ec {

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

__device__ __forceinline__ void p_limbs(uint32_t* p) {
  p[0] = 0xFFFFFC2Fu;
  p[1] = 0xFFFFFFFEu;
#pragma unroll
  for (int i = 2; i < 8; ++i) p[i] = 0xFFFFFFFFu;
}

// r - p if r >= p (r < 2p, or r + 2^256*carry < 2p when carry is set)
__device__ __forceinline__ Fe fe_reduce_once(const Fe& r, uint32_t carry) {
  uint32_t p[8];
  p_limbs(p);
  Fe t;
  int64_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t u = (int64_t)r.v[i] - (int64_t)p[i] - bw;
    t.v[i] = (uint32_t)u;
    bw = u < 0 ? 1 : 0;
  }
  const bool take = carry || !bw;
  Fe o;
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] = take ? t.v[i] : r.v[i];
  return o;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t u = (uint64_t)a.v[i] + b.v[i] + c;
    s.v[i] = (uint32_t)u;
    c = u >> 32;
  }
  return fe_reduce_once(s, (uint32_t)c);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  uint32_t p[8];
  p_limbs(p);
  Fe d;
  int64_t bw = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t u = (int64_t)a.v[i] - (int64_t)b.v[i] - bw;
    d.v[i] = (uint32_t)u;
    bw = u < 0 ? 1 : 0;
  }
  // on borrow add p back (mod 2^256)
  const uint32_t m = bw ? 0xFFFFFFFFu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint64_t u = (uint64_t)d.v[i] + (p[i] & m) + c;
    d.v[i] = (uint32_t)u;
    c = u >> 32;
  }
  return d;
}

__device__ __forceinline__ Fe fe_neg(const Fe& a) { return fe_sub(fe_zero(), a); }

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t t[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t u = (uint64_t)a.v[i] * b.v[j] + t[i + j] + c;
      t[i + j] = (uint32_t)u;
      c = u >> 32;
    }
    t[i + 8] = (uint32_t)c;
  }
  // fold 1: lo + hi * (977 + 2^32)
  Fe r;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t u = (uint64_t)t[8 + i] * 977u + t[i] + c;
    if (i > 0) u += t[7 + i];
    r.v[i] = (uint32_t)u;
    c = u >> 32;
  }
  const uint64_t top = c + t[15];  // weight 2^256, < 2^34
  // fold 2: r + top * (977 + 2^32)
  uint64_t u = (uint64_t)r.v[0] + top * 977u;
  r.v[0] = (uint32_t)u;
  c = u >> 32;
  u = (uint64_t)r.v[1] + (top & 0xFFFFFFFFull) + c;
  r.v[1] = (uint32_t)u;
  c = u >> 32;
  u = (uint64_t)r.v[2] + (top >> 32) + c;
  r.v[2] = (uint32_t)u;
  c = u >> 32;
#pragma unroll
  for (int i = 3; i < 8; ++i) {
    u = (uint64_t)r.v[i] + c;
    r.v[i] = (uint32_t)u;
    c = u >> 32;
  }
  // a carry out leaves r tiny: one more fold cannot overflow
  const uint32_t cm = c ? 0xFFFFFFFFu : 0u;
  u = (uint64_t)r.v[0] + (977u & cm);
  r.v[0] = (uint32_t)u;
  c = u >> 32;
  u = (uint64_t)r.v[1] + (1u & cm) + c;
  r.v[1] = (uint32_t)u;
  c = u >> 32;
#pragma unroll
  for (int i = 2; i < 8; ++i) {
    u = (uint64_t)r.v[i] + c;
    r.v[i] = (uint32_t)u;
    c = u >> 32;
  }
  return fe_reduce_once(r, 0u);
}

__device__ __forceinline__ Fe fe_sq(const Fe& a) { return fe_mul(a, a); }

__device__ __forceinline__ Fe fe_muli(const Fe& a, uint32_t k) { return fe_mul(a, fe_small(k)); }

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
// complete projective formulas (RCB 2015, a = 0, b3 = 21)
// ---------------------------------------------------------------------------

__device__ __forceinline__ Pt pt_identity() {
  Pt r;
  r.X = fe_zero();
  r.Y = fe_small(1u);
  r.Z = fe_zero();
  return r;
}

__device__ inline Pt rcb_add(const Pt& P, const Pt& Q) {
  Fe t0 = fe_mul(P.X, Q.X);
  Fe t1 = fe_mul(P.Y, Q.Y);
  Fe t2 = fe_mul(P.Z, Q.Z);
  Fe t3 = fe_mul(fe_add(P.X, P.Y), fe_add(Q.X, Q.Y));
  Fe t4 = fe_mul(fe_add(P.Y, P.Z), fe_add(Q.Y, Q.Z));
  Fe t5 = fe_mul(fe_add(P.X, P.Z), fe_add(Q.X, Q.Z));
  t3 = fe_sub(fe_sub(t3, t0), t1);
  t4 = fe_sub(fe_sub(t4, t1), t2);
  t5 = fe_sub(fe_sub(t5, t0), t2);
  const Fe t0_3 = fe_add(fe_add(t0, t0), t0);
  const Fe t2b = fe_muli(t2, 21u);
  const Fe zt = fe_add(t1, t2b);
  const Fe t1m = fe_sub(t1, t2b);
  const Fe yb = fe_muli(t5, 21u);
  Pt R;
  R.X = fe_sub(fe_mul(t3, t1m), fe_mul(t4, yb));
  R.Y = fe_add(fe_mul(t1m, zt), fe_mul(yb, t0_3));
  R.Z = fe_add(fe_mul(zt, t4), fe_mul(t0_3, t3));
  return R;
}

__device__ inline Pt rcb_dbl(const Pt& P) {
  const Fe t0 = fe_mul(P.Y, P.Y);
  const Fe t1 = fe_mul(P.Y, P.Z);
  const Fe zz = fe_mul(P.Z, P.Z);
  const Fe xy = fe_mul(P.X, P.Y);
  Fe z3 = fe_add(t0, t0);
  z3 = fe_add(z3, z3);
  z3 = fe_add(z3, z3);
  const Fe t2 = fe_muli(zz, 21u);
  const Fe y3a = fe_add(t0, t2);
  const Fe t1b = fe_add(t2, t2);
  const Fe t2b = fe_add(t1b, t2);
  const Fe t0b = fe_sub(t0, t2b);
  const Fe x3 = fe_mul(t2, z3);
  Pt R;
  R.Z = fe_mul(t1, z3);
  R.Y = fe_add(x3, fe_mul(t0b, y3a));
  const Fe tx = fe_mul(t0b, xy);
  R.X = fe_add(tx, tx);
  return R;
}

// Jacobian (X, Y, Z) -> homogeneous (XZ, Y, Z^3)
__device__ __forceinline__ Pt jac_in(const int32_t* l) {
  const Fe X = fe_load16(l), Y = fe_load16(l + 16), Z = fe_load16(l + 32);
  Pt r;
  r.X = fe_mul(X, Z);
  r.Y = Y;
  r.Z = fe_mul(fe_mul(Z, Z), Z);
  return r;
}

// homogeneous (U, V, W) -> Jacobian (UW, VW^2, W), canonical 16-bit limbs
__device__ __forceinline__ void jac_out(const Pt& P, int32_t* l) {
  fe_store16(fe_mul(P.X, P.Z), l);
  fe_store16(fe_mul(P.Y, fe_mul(P.Z, P.Z)), l + 16);
  fe_store16(P.Z, l + 32);
}

}  // namespace ec

// K3, K4, K5: batched secp256k1 kernels.
//
//   K3 k3_glv_ladder  replaces tpu_mpc/ec/pallas_ec.py:_ladder_kernel
//   K4 k4_comb        replaces tpu_mpc/ec/pallas_ec.py:_comb_kernel
//   K5 k5_affine      replaces tpu_mpc/ec/pallas_ec.py:_affine_kernel
//
// What bounds them on the H100: integer operations, and the latency of each
// lane's chain of them.  A GLV ladder (K3, ns = 2) is ~2,350 dependent field
// products per lane, the comb (K4) ~450; the inversion (K5) is 600 divsteps
// of a few dependent 32-bit operations each, 40 matrix updates and 4 field
// products.  Inputs and outputs are a few hundred bytes per lane.  The main
// path's 256 or 512 lanes are few for 132 SMs: each lane's chain, not the
// card's throughput, sets the time.
//
// Design.  The field (ec_field.cuh) runs on the PTX carry flag: a product is
// rows of two independent multiply-add chains, a square 36 products, a
// multiply by 21 eight.  K3 and K4 spread each lane over a group of 4
// threads of one warp: every round of independent products of an RCB
// formula is split among the group and exchanged by shuffles (grp_add,
// grp_dbl), in the same formula order as the plain versions, so the outputs
// equal them bit for bit, Z included.
//
// K3 (8 lanes, one warp a block: 32 blocks at 256 lanes) builds each lane's
// 16-entry base tables (one per base, two at ns = 4) in shared memory, then
// runs 33 windows of 4 doublings and ns additions.  The digits are secret
// (GLV halves of signing nonces and shares): every thread reads its 6 of the
// 24 words of all 16 entries under a mask and the group gathers the
// selected entry, so no address depends on a digit.  The beta endomorphism
// and the GLV sign apply to the selected entry.
//
// K4 (16 lanes, two warps a block: 16 blocks at 256 lanes) selects a comb
// entry as a one-hot product on the tensor cores, as the TPU kernel does on
// its MXU: the A operand of mma.sync.m16n8k32 u8 is built in registers as
// the rows (k == digit) of the block's 16 lanes, the B operand is the
// window's table as u8 planes (256 entries x 64 bytes, x then y, in fragment
// order: tpu_mpc_torch/ec/pallas_ec.py:comb_planes), and each s32 output is
// exactly one byte of the selected entry (one nonzero term).  8 k-steps x 8
// n-tiles = 64 mma a window, split between the two warps.  The planes of
// window w + 1 are staged into shared memory by cp.async while window w
// runs.  Digit 0 selects the entry (0, 1) with Z = 0, which the complete
// formulas add as the identity.  Windows run 0..31 on one accumulator per
// lane (a split over blocks would change the projective representative).
//
// K5 (one thread per lane, 32-lane blocks: 8 SMs at 256 lanes; 128-lane
// blocks measured slower) inverts Z by Bernstein and Yang's constant-time
// divsteps in libsecp256k1's 30-bit form, in place of the Fermat chain
// Z^(p - 2) of the TPU kernel and of the plain version (~340 dependent field
// products on one thread and a 16-entry table in local memory; libsecp256k1's
// fixed addition chain, 255 squarings and 15 products, measured 2.7x slower
// than the divsteps).  The divsteps run on the low words of two 9-limb signed
// 30-bit numbers, 30 at a time; after each 30 a 2x2 matrix updates the limbs
// by 64-bit multiply-adds.  The iteration count is fixed and every step is a
// mask, so no branch or address depends on Z; everything stays in registers.
// The inverse is unique, so the output equals the plain version's bit for
// bit; the projection (X Z^-2, Y Z^-3) runs on fe_mul / fe_sq.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

using namespace ec;

namespace {

// -- begin ptx: tensor-core and async-copy primitives -------------------------
// d += a . b: a the 16 x 32 u8 A fragment, b the 32 x 8 u8 B fragment.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// -- end ptx ------------------------------------------------------------------

constexpr int kWindows = 33;

__device__ __forceinline__ Fe beta_fe() {
  // GLV beta, a cube root of unity mod p (little-endian 32-bit limbs)
  Fe b;
  b.v[0] = 0x719501EEu; b.v[1] = 0xC1396C28u; b.v[2] = 0x12F58995u; b.v[3] = 0x9CF04975u;
  b.v[4] = 0xAC3434E9u; b.v[5] = 0x6E64479Eu; b.v[6] = 0x657C0710u; b.v[7] = 0x7AE96A2Bu;
  return b;
}

__device__ __forceinline__ uint32_t pick_u32(int q, uint32_t a0, uint32_t a1, uint32_t a2,
                                             uint32_t a3) {
  return q == 0 ? a0 : (q == 1 ? a1 : (q == 2 ? a2 : a3));
}

// word w (constant) of a point as 24 words X | Y | Z
__device__ __forceinline__ uint32_t pt_word(const Pt& P, int w) {
  return w < 8 ? P.X.v[w] : (w < 16 ? P.Y.v[w - 8] : P.Z.v[w - 16]);
}

// ---- K3 -----------------------------------------------------------------------

constexpr int kLadderLanes = 8;                          // one warp a block
constexpr int kLadderThreads = kLadderLanes * GROUP;
constexpr int kEntPairs = 12;                            // 24 words as uint2

// Table entries lie at tab[m][d][lane][12 uint2]; thread q of a group owns
// words 6q .. 6q + 5 of each entry (it writes and reads those).
__device__ __forceinline__ void put_entry(uint2* ent, const Pt& P, int q) {
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    uint2 v;
    v.x = pick_u32(q, pt_word(P, 2 * u), pt_word(P, 6 + 2 * u), pt_word(P, 12 + 2 * u),
                   pt_word(P, 18 + 2 * u));
    v.y = pick_u32(q, pt_word(P, 2 * u + 1), pt_word(P, 7 + 2 * u), pt_word(P, 13 + 2 * u),
                   pt_word(P, 19 + 2 * u));
    ent[3 * q + u] = v;
  }
}

__global__ void __launch_bounds__(kLadderThreads)
k3_kernel(const int32_t* __restrict__ pts,  // [B, ns/2, 3, 16]
          const int32_t* __restrict__ dg,   // [B, ns, 33]
          const int32_t* __restrict__ neg,  // [B, ns]
          int B, int ns, int32_t* __restrict__ out) {  // [B, 3, 16]
  __shared__ uint2 tab[2][16][kLadderLanes][kEntPairs];   // 24 KB
  const Grp g = grp_this();
  const int li = threadIdx.x / GROUP;
  const int i = blockIdx.x * kLadderLanes + li;
  const bool live = i < B;
  const int il = live ? i : B - 1;     // lanes past B repeat the last one, store nothing
  const int nb = ns / 2;
  for (int m = 0; m < nb; ++m) {
    const Pt base = jac_in(pts + ((size_t)il * nb + m) * 48);
    put_entry(tab[m][0][li], pt_identity(), g.q);
    put_entry(tab[m][1][li], base, g.q);
    Pt cur = base;
    for (int d = 2; d < 16; ++d) {
      cur = grp_add(cur, base, g);
      put_entry(tab[m][d][li], cur, g.q);
    }
  }
  __syncwarp();
  const Fe beta = beta_fe();
  Pt acc = pt_identity();
  for (int j = 0; j < kWindows; ++j) {
    const int wj = kWindows - 1 - j;
#pragma unroll 1
    for (int q = 0; q < 4; ++q) acc = grp_dbl(acc, g);
#pragma unroll 1
    for (int s = 0; s < ns; ++s) {
      const int m = s >> 1;
      const uint32_t d = (uint32_t)dg[((size_t)il * ns + s) * kWindows + wj];
      // masked select over all 16 entries: this thread's 6 words of each
      uint2 w[3];
#pragma unroll
      for (int u = 0; u < 3; ++u) w[u] = make_uint2(0u, 0u);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const uint32_t msk = d == (uint32_t)k ? 0xFFFFFFFFu : 0u;
        const uint2* e = tab[m][k][li] + 3 * g.q;
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const uint2 v = e[u];
          w[u].x |= v.x & msk;
          w[u].y |= v.y & msk;
        }
      }
      // word W of the entry sits in slot W % 6 of thread W / 6
      Pt e;
#pragma unroll
      for (int W = 0; W < 24; ++W) {
        const int sl = W % 6;
        const uint32_t mine = (sl & 1) ? w[sl >> 1].y : w[sl >> 1].x;
        const uint32_t v = __shfl_sync(0xFFFFFFFFu, mine, g.base + W / 6);
        if (W < 8) e.X.v[W] = v;
        else if (W < 16) e.Y.v[W - 8] = v;
        else e.Z.v[W - 16] = v;
      }
      if (s & 1) e.X = fe_mul(e.X, beta);
      const bool ng = neg[(size_t)il * ns + s] != 0;
      e.Y = fe_select(ng, fe_neg(e.Y), e.Y);
      acc = grp_add(acc, e, g);
    }
  }
  if (live && g.q == 0) jac_out(acc, out + (size_t)i * 48);
}

// ---- K4 -----------------------------------------------------------------------

constexpr int kCombLanes = 16;                           // the M of one mma
constexpr int kCombThreads = kCombLanes * GROUP;         // two warps
constexpr int kCombWin = 32;
constexpr int kPlaneBytes = 256 * 64;                    // one window's planes

// byte b of the result is 1 where digit d == e0 + b (b = 0..3): four
// one-hot A-fragment entries, from arithmetic on d only
__device__ __forceinline__ uint32_t onehot4(uint32_t d, uint32_t e0) {
  const uint32_t rel = d - e0;
  return rel < 4u ? 1u << (8u * rel) : 0u;
}

__global__ void __launch_bounds__(kCombThreads)
k4_kernel(const int32_t* __restrict__ dg,     // [B, 32]
          const uint8_t* __restrict__ planes,  // [32, 16384] (pallas_ec.comb_planes)
          int B, int32_t* __restrict__ out) {  // [B, 3, 16]
  __shared__ __align__(16) uint8_t stage[2][kPlaneBytes];     // 32 KB
  __shared__ __align__(16) uint32_t sel[kCombLanes][16];      // selected (x, y) per lane
  __shared__ uint8_t sdg[kCombLanes][kCombWin];
  const Grp g = grp_this();
  const int li = threadIdx.x / GROUP;
  const int i0 = blockIdx.x * kCombLanes;
  const bool live = i0 + li < B;
  for (int k = threadIdx.x; k < kCombLanes * kCombWin; k += kCombThreads) {
    const int l = k / kCombWin, w = k % kCombWin;
    sdg[l][w] = i0 + l < B ? (uint8_t)((uint32_t)dg[(size_t)(i0 + l) * kCombWin + w] & 0xFFu)
                           : (uint8_t)0;
  }
  auto stage_window = [&](int w) {
    const uint8_t* src = planes + (size_t)w * kPlaneBytes;
    uint8_t* dst = stage[w & 1];
    for (int k = threadIdx.x; k < kPlaneBytes / 16; k += kCombThreads)
      cp_async16(dst + 16 * k, src + 16 * k);
  };
  stage_window(0);
  // mma fragment coordinates: warp wp computes n-tiles 4 wp .. 4 wp + 3
  const int wp = threadIdx.x >> 5, ln = threadIdx.x & 31, fg = ln >> 2, ft = ln & 3;
  uint16_t* sel16 = reinterpret_cast<uint16_t*>(&sel[0][0]);
  Pt acc = pt_identity();
  for (int w = 0; w < kCombWin; ++w) {
    cp_async_wait_all();
    __syncthreads();                 // window w staged; window w - 1 fully read
    if (w + 1 < kCombWin) stage_window(w + 1);
    const uint32_t d0 = sdg[fg][w], d1 = sdg[fg + 8][w];   // rows fg and fg + 8
    const uint8_t* st = stage[w & 1];
    int dacc[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int r = 0; r < 4; ++r) dacc[jj][r] = 0;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t e0 = 32u * kk + 4u * ft;
      const uint4 a = make_uint4(onehot4(d0, e0), onehot4(d1, e0), onehot4(d0, e0 + 16u),
                                 onehot4(d1, e0 + 16u));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const uint2 b = *reinterpret_cast<const uint2*>(
            st + ((size_t)(kk * 8 + 4 * wp + jj) * 32 + ln) * 8);
        mma_u8(dacc[jj], a, b.x, b.y);
      }
    }
    // output bytes 8 j + 2 ft, 8 j + 2 ft + 1 of rows fg (regs 0, 1) and fg + 8 (2, 3)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = 4 * wp + jj;
      sel16[fg * 32 + 4 * j + ft] = (uint16_t)(dacc[jj][0] | (dacc[jj][1] << 8));
      sel16[(fg + 8) * 32 + 4 * j + ft] = (uint16_t)(dacc[jj][2] | (dacc[jj][3] << 8));
    }
    __syncthreads();
    Pt E;
    const uint4* sp = reinterpret_cast<const uint4*>(sel[li]);
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const uint4 v = sp[h];
      Fe& f = h < 2 ? E.X : E.Y;
      const int o = 4 * (h & 1);
      f.v[o] = v.x; f.v[o + 1] = v.y; f.v[o + 2] = v.z; f.v[o + 3] = v.w;
    }
    E.Z = fe_small(sdg[li][w] != 0 ? 1u : 0u);
    acc = grp_add(acc, E, g);
  }
  if (live && g.q == 0) jac_out(acc, out + (size_t)(i0 + li) * 48);
}

// ---- K5 -----------------------------------------------------------------------
//
// Z^-1 mod p by Bernstein and Yang's constant-time divsteps ("safegcd"), in
// the 30-bit form of libsecp256k1's modinv32 (src/modinv32_impl.h, and its
// doc/safegcd_implementation.md): f = p, g = Z, d = 0, e = 1 as 9 signed
// limbs of 30 bits (value = sum v_i 2^(30 i)); 20 batches of 30 divsteps
// (600 >= the 590 that 256-bit inputs need), each batch on the low words of
// f and g alone, giving a 2x2 matrix t with t [f, g] = 2^30 [f', g'];
// then (d, e) <- (t [d, e] + p [md, me]) / 2^30 and (f, g) <- t [f, g] / 2^30.
// At the end g = 0, f = +-1 and d = +-Z^-1 in (-2p, p): normalise_30 adds p
// and negates by the sign of f, both under masks.  Every step is a mask, a
// shift or a multiply-add: no branch or address depends on Z.

constexpr uint32_t kM30 = 0x3FFFFFFFu;
// p = 2^256 - 2^32 - 977 in signed 30-bit limbs: -977 - 4 * 2^30 + 2^16 * 2^240
// (limbs 2..7 are 0)
constexpr int32_t kP30_0 = -0x3D1, kP30_1 = -4, kP30_8 = 0x10000;
// p^-1 mod 2^30, with p = 0x3FFFFC2F (mod 2^30): Newton's step x <- x (2 - p x)
// from x = p (p^2 = 1 mod 8) doubles the correct low bits, 3 -> 6 -> 12 -> 24
// -> 48, so four steps mod 2^30 give 0x2DDACACF
constexpr uint32_t kPinv30 = 0x2DDACACFu;

struct S30 {
  int32_t v[9];
};

struct Trans {
  int32_t u, v, q, r;
};

__device__ __forceinline__ int32_t p30(int i) {
  return i == 0 ? kP30_0 : (i == 1 ? kP30_1 : (i == 8 ? kP30_8 : 0));
}

// 8 x 32-bit limbs -> signed 30-bit limbs (bits 30 i .. 30 i + 29; limb 8 16 bits)
__device__ __forceinline__ S30 fe_to_s30(const Fe& a) {
  S30 r;
  r.v[0] = (int32_t)(a.v[0] & kM30);
#pragma unroll
  for (int i = 1; i < 8; ++i)
    r.v[i] = (int32_t)(__funnelshift_r(a.v[i - 1], a.v[i], 32 - 2 * i) & kM30);
  r.v[8] = (int32_t)(a.v[7] >> 16);
  return r;
}

// signed 30-bit limbs in [0, 2^30) of a value < 2^256 -> 8 x 32-bit limbs
__device__ __forceinline__ Fe s30_to_fe(const S30& s) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    r.v[k] = ((uint32_t)s.v[k] >> (2 * k)) | ((uint32_t)s.v[k + 1] << (30 - 2 * k));
  return r;
}

// 30 divsteps on the low words of f (odd) and g; zeta = -(delta + 1/2).
// u, v, q, r are signed integers in [-2^30, 2^30] kept mod 2^32.
__device__ __forceinline__ int32_t divsteps_30(int32_t zeta, uint32_t f, uint32_t g, Trans& t) {
  uint32_t u = 1u, v = 0u, q = 0u, r = 1u;
#pragma unroll
  for (int i = 0; i < 30; ++i) {
    const uint32_t c1 = (uint32_t)(zeta >> 31);        // zeta < 0
    const uint32_t c2 = 0u - (g & 1u);                 // g odd
    const uint32_t x = (f ^ c1) - c1, y = (u ^ c1) - c1, z = (v ^ c1) - c1;
    g += x & c2;
    q += y & c2;
    r += z & c2;
    const uint32_t c3 = c1 & c2;                       // both: swap
    zeta = (zeta ^ (int32_t)c3) - 1;
    f += g & c3;
    u += q & c3;
    v += r & c3;
    g >>= 1;
    u <<= 1;
    v <<= 1;
  }
  t.u = (int32_t)u;
  t.v = (int32_t)v;
  t.q = (int32_t)q;
  t.r = (int32_t)r;
  return zeta;
}

// (d, e) <- (t [d, e] + p [md, me]) / 2^30, md and me chosen so that the low
// 30 bits vanish (p^-1 mod 2^30) after adding t's columns where d or e < 0
__device__ __forceinline__ void update_de_30(S30& d, S30& e, const Trans& t) {
  const int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
  int32_t md = (t.u & sd) + (t.v & se);
  int32_t me = (t.q & sd) + (t.r & se);
  int64_t cd = (int64_t)t.u * d.v[0] + (int64_t)t.v * e.v[0];
  int64_t ce = (int64_t)t.q * d.v[0] + (int64_t)t.r * e.v[0];
  md -= (int32_t)((kPinv30 * (uint32_t)cd + (uint32_t)md) & kM30);
  me -= (int32_t)((kPinv30 * (uint32_t)ce + (uint32_t)me) & kM30);
  cd += (int64_t)kP30_0 * md;
  ce += (int64_t)kP30_0 * me;
  cd >>= 30;
  ce >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cd += (int64_t)t.u * d.v[i] + (int64_t)t.v * e.v[i];
    ce += (int64_t)t.q * d.v[i] + (int64_t)t.r * e.v[i];
    if (p30(i) != 0) {                                  // limbs 1 and 8 (compile time)
      cd += (int64_t)p30(i) * md;
      ce += (int64_t)p30(i) * me;
    }
    d.v[i - 1] = (int32_t)((uint32_t)cd & kM30);
    e.v[i - 1] = (int32_t)((uint32_t)ce & kM30);
    cd >>= 30;
    ce >>= 30;
  }
  d.v[8] = (int32_t)cd;
  e.v[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30 (the low 30 bits are 0 by construction of t)
__device__ __forceinline__ void update_fg_30(S30& f, S30& g, const Trans& t) {
  int64_t cf = (int64_t)t.u * f.v[0] + (int64_t)t.v * g.v[0];
  int64_t cg = (int64_t)t.q * f.v[0] + (int64_t)t.r * g.v[0];
  cf >>= 30;
  cg >>= 30;
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    cf += (int64_t)t.u * f.v[i] + (int64_t)t.v * g.v[i];
    cg += (int64_t)t.q * f.v[i] + (int64_t)t.r * g.v[i];
    f.v[i - 1] = (int32_t)((uint32_t)cf & kM30);
    g.v[i - 1] = (int32_t)((uint32_t)cg & kM30);
    cf >>= 30;
    cg >>= 30;
  }
  f.v[8] = (int32_t)cf;
  g.v[8] = (int32_t)cg;
}

// d in (-2p, p), limbs 0..7 in [0, 2^30): + p if d < 0, negate if sign < 0,
// carry, + p if still < 0, carry: the canonical value in [0, p)
__device__ __forceinline__ void normalize_30(S30& d, int32_t sign) {
  const int32_t add1 = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] += p30(i) & add1;
  const int32_t neg = sign >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] = (d.v[i] ^ neg) - neg;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= (int32_t)kM30;
  }
  const int32_t add2 = d.v[8] >> 31;
#pragma unroll
  for (int i = 0; i < 9; ++i) d.v[i] += p30(i) & add2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    d.v[i + 1] += d.v[i] >> 30;
    d.v[i] &= (int32_t)kM30;
  }
}

// z^-1 mod p for a canonical z != 0
__device__ __forceinline__ Fe fe_inv(const Fe& z) {
  S30 f, g = fe_to_s30(z), d, e;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    f.v[i] = p30(i);
    d.v[i] = 0;
    e.v[i] = 0;
  }
  e.v[0] = 1;
  int32_t zeta = -1;                                    // delta = 1/2
#pragma unroll 1
  for (int b = 0; b < 20; ++b) {
    Trans t;
    zeta = divsteps_30(zeta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
    update_de_30(d, e, t);
    update_fg_30(f, g, t);
  }
  normalize_30(d, f.v[8]);
  return s30_to_fe(d);
}

constexpr int kAffineThreads = 32;    // one lane a thread: 256 lanes on 8 SMs

__global__ void __launch_bounds__(kAffineThreads)
k5_kernel(const int32_t* __restrict__ pts,  // [B, 3, 16]
          int B, int32_t* __restrict__ out) {  // [B, 2, 16]
  const int i = blockIdx.x * kAffineThreads + threadIdx.x;
  if (i >= B) return;
  const int32_t* l = pts + (size_t)i * 48;
  const Fe X = fe_load16(l), Y = fe_load16(l + 16);
  Fe z = fe_load16(l + 32);
  z.v[0] |= fe_is_zero(z) ? 1u : 0u;    // Z = 0 lanes invert a dummy 1
  const Fe zi = fe_inv(z);
  const Fe zi2 = fe_sq(zi);
  fe_store16(fe_mul(X, zi2), out + (size_t)i * 32);
  fe_store16(fe_mul(Y, fe_mul(zi2, zi)), out + (size_t)i * 32 + 16);
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int k3_glv_ladder(const int32_t* pts, const int32_t* dg, const int32_t* neg,
                             int B, int ns, int32_t* out, cudaStream_t stream) {
  if ((ns != 2 && ns != 4) || B < 1) return (int)cudaErrorInvalidValue;
  k3_kernel<<<cdiv(B, kLadderLanes), kLadderThreads, 0, stream>>>(pts, dg, neg, B, ns, out);
  return (int)cudaGetLastError();
}

extern "C" int k4_comb(const int32_t* dg, const uint8_t* planes, int B, int32_t* out,
                       cudaStream_t stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  k4_kernel<<<cdiv(B, kCombLanes), kCombThreads, 0, stream>>>(dg, planes, B, out);
  return (int)cudaGetLastError();
}

extern "C" int k5_affine(const int32_t* pts, int B, int32_t* out, cudaStream_t stream) {
  k5_kernel<<<cdiv(B, kAffineThreads), kAffineThreads, 0, stream>>>(pts, B, out);
  return (int)cudaGetLastError();
}

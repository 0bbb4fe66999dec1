// RNS Montgomery arithmetic shared by K1 (rns_exp.cu) and K2 (rns_fixed.cu),
// on a tile of LANES = 8 lanes per thread block (the N of one mma).
//
// Same Bajard-Imbert scheme as tpu_mpc_torch/core/rns.py, value for value:
// every channel value stays canonical (< p), so the kernels equal their plain
// versions bit for bit.  A value has K A-channels, Kp = K + 1 B-channels and
// the redundant 2^16 channel r.
//
// One Montgomery multiply is two base extensions, each a product of a fixed
// matrix with the tile's channel vectors:
//   extension 1 (A -> B|r): [Kp+1 x K] W1^T . xi1 [K x 8]
//   extension 2 (B -> A|r): [K+1 x Kp] W2^T . xi2 [Kp x 8]
// and the decode is a third, [K+1 x K] Wbin^T . xi [K x 8].  They run on the
// tensor cores as exact byte-chunk products (the TPU kernel's _chunk_dot,
// tpu_mpc/core/pallas_rns.py:220, moved from bf16 on the MXU to u8 here):
// a 16-bit entry is lo + 2^8 hi, so one product is three s32 planes
//   p00 = Wlo.xlo,  pm = Wlo.xhi + Whi.xlo,  p11 = Whi.xhi,
//   total = p00 + 2^8 pm + 2^16 p11,
// each from mma.sync.m16n8k32.row.col.s32.u8.u8.s32 with the output channels
// as M, the lanes as N and the summed channels as K.  Bounds: a plane sums at
// most 2 * 288 byte products (pm; the others 288, KT*32 <= 288 at 4096 bits),
// so every plane is < 2 * 288 * 255^2 < 2^26 and exact in s32; the
// redundant channel takes (p00 + (pm << 8)) & 0xFFFF (2^16 p11 vanishes).
//
// Reductions never divide: a channel product a*b < 2^32 reduces by Barrett
// with m = floor(2^32 / p) from the host (bred: one conditional subtract,
// since 2^15 < p < 2^16), a plane total folds with three of them (fold), a
// 64-bit prologue sum with two (bred64).  Results stay canonical, so they
// equal the % of the plain versions.
//
// Layout of a block: warp w owns m-tile w (output rows 16w .. 16w+15) of all
// three products, and keeps in registers the channel values those rows
// produce, in the mma accumulator's layout: thread (g, t) of the warp (g =
// lane/4, t = lane%4) owns rows r = 16w + g + 8h (h = 0, 1) for lanes 2t and
// 2t+1 of the tile: slot s = 2h + c holds row 16w + g + 8h of lane 2t + c.  Row r is A-channel r if r < K (extension 2), B-channel
// r if r < Kp (extension 1); B row Kp is the r channel and A row K yields
// alpha.  Shared memory holds the u8 planes of xi1 and xi2 ([lane][channel],
// a row stride of KT*32 + 16 bytes keeps the B-fragment loads free of bank
// conflicts), t_r and alpha per lane, and the resident k-tiles of the W
// planes (all of them at 2048 bits; a prefix at 4096 bits, the rest read from
// L2 every multiply).  Three block barriers per multiply.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rnsf {

constexpr int LANES = 8;        // lanes of a tile: the wrappers pad to whole tiles
constexpr int MAX_WARPS = 17;   // m-tiles at 4096 bits
// Kernels are built for at most 9 warps (up to 2048 bits, ~168 registers a
// thread) or 17 (96 registers: 5 warps share one of the SM's 4 register files).
constexpr int SMALL_WARPS = 9;

struct Dims {
  int K, Kp, CH, Lin, Lout;
  int MT, KT;   // m-tiles (16 output rows) and k-tiles (32 summed channels)
};

// Dims with the k-tile count known at compile time (KTC > 0: the products'
// k-loops unroll fully; 0: KT at run time).
template <int KTC>
struct DimsT : Dims {
  static constexpr int kKT = KTC;
};

// Views into the flat constant vector (core/rns.py:RnsParams.const_vector).
struct Cst {
  const uint32_t *pA, *pB, *mA, *mB, *invMAk, *invMA_B, *invMBj, *MB_A, *W16A, *W16B;
};

__host__ __device__ inline Cst cst_views(const uint32_t* c, const Dims& d) {
  Cst s;
  s.pA = c;
  s.pB = s.pA + d.K;
  s.mA = s.pB + d.Kp;
  s.mB = s.mA + d.K;
  s.invMAk = s.mB + d.Kp;
  s.invMA_B = s.invMAk + d.K;
  s.invMBj = s.invMA_B + d.Kp;
  s.MB_A = s.invMBj + d.Kp;
  s.W16A = s.MB_A + d.K;
  s.W16B = s.W16A + d.Lin * d.K;
  return s;
}

// ---- planes (core/rns.py:RnsParams.plane_bytes) and shared memory --------

// One k-tile of the extension planes: 2 matrices x MT m-tiles x (lo, hi) x 512 B.
__host__ __device__ inline size_t ktile_bytes(const Dims& d) { return (size_t)4 * d.MT * 512; }
// Byte offset of the decode planes [KT, MT, 2, 512] in the plane buffer.
__host__ __device__ inline size_t dec_offset(const Dims& d) { return d.KT * ktile_bytes(d); }
// Row stride of an xi plane; (stride / 4) % 8 == 4 spreads the 8 lanes of a
// B-fragment load over distinct banks.
__host__ __device__ inline int xi_stride(const Dims& d) { return d.KT * 32 + 16; }

// Bytes of shared memory: rk resident k-tiles, four xi planes, t_r and alpha,
// then `extra` bytes for the kernel (K1's window table, K2's staged entries).
__host__ __device__ inline size_t smem_bytes(const Dims& d, int rk, size_t extra) {
  return (size_t)rk * ktile_bytes(d) + (size_t)4 * LANES * xi_stride(d) + (size_t)8 * LANES +
         extra;
}

struct Shm {
  uint8_t* w;       // resident planes, the first rk k-tiles
  uint8_t* xi[4];   // xi1 lo, xi1 hi, xi2 lo, xi2 hi: [LANES][xi_stride]
  uint32_t* tr;     // [LANES] t_r of the multiply in flight
  uint32_t* alpha;  // [LANES]
  uint8_t* extra;
};

__device__ __forceinline__ Shm carve(uint8_t* base, const Dims& d, int rk) {
  Shm s;
  s.w = base;
  uint8_t* p = base + (size_t)rk * ktile_bytes(d);
  for (int i = 0; i < 4; ++i) {
    s.xi[i] = p;
    p += (size_t)LANES * xi_stride(d);
  }
  s.tr = reinterpret_cast<uint32_t*>(p);
  s.alpha = s.tr + LANES;
  s.extra = reinterpret_cast<uint8_t*>(s.alpha + LANES);
  return s;
}

// Copy the resident k-tiles into shared memory and clear the xi planes (their
// padding columns meet zero W columns, but stay defined).  The caller syncs.
__device__ __forceinline__ void stage_planes(const Shm& sh, const uint8_t* planes,
                                             const Dims& d, int rk) {
  const size_t wb = (size_t)rk * ktile_bytes(d);
  for (size_t i = (size_t)threadIdx.x * 16; i < wb; i += (size_t)blockDim.x * 16)
    *reinterpret_cast<uint4*>(sh.w + i) = __ldg(reinterpret_cast<const uint4*>(planes + i));
  uint32_t* xi = reinterpret_cast<uint32_t*>(sh.xi[0]);
  for (int i = threadIdx.x; i < LANES * xi_stride(d); i += blockDim.x) xi[i] = 0u;
}

// ---- reductions without division -----------------------------------------

// v - p if v >= p, else v (v < 2p): the unsigned minimum of v and v - p, which
// wraps when v < p.
__device__ __forceinline__ uint32_t csub(uint32_t v, uint32_t p) { return min(v, v - p); }

// x mod p for x < 2^32, m = floor(2^32 / p), 2^15 < p < 2^16: the quotient
// estimate is low by at most one, so one conditional subtract.
__device__ __forceinline__ uint32_t bred(uint32_t x, uint32_t p, uint32_t m) {
  return csub(x - __umulhi(x, m) * p, p);
}

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t p, uint32_t m) {
  return bred(a * b, p, m);   // a, b < 2^16
}

// s mod p for s < 2^40 (hi * (2^32 mod p) < 2^24)
__device__ __forceinline__ uint32_t bred64(unsigned long long s, uint32_t p, uint32_t m) {
  const uint32_t c32 = 0u - p * m;   // 2^32 - p floor(2^32 / p) = 2^32 mod p
  return bred(bred((uint32_t)s, p, m) + (uint32_t)(s >> 32) * c32, p, m);
}

// (p00 + 2^8 pm + 2^16 p11) mod p for planes < 2^26, three Barrett steps
__device__ __forceinline__ uint32_t fold(uint32_t p00, uint32_t pm, uint32_t p11, uint32_t p,
                                         uint32_t m) {
  const uint32_t h = pm + (bred(p11, p, m) << 8);    // < 2^26 + 2^24
  return bred(p00 + (bred(h, p, m) << 8), p, m);     // < 2^26 + 2^24
}

// ---- tensor-core products -------------------------------------------------

// d += a . b: a the 16 x 32 u8 tile of one plane (A fragment), b the 32 x 8
// u8 tile of the lanes (B fragment), d the 16 x 8 s32 accumulator.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The four s32 planes of one m-tile of the tile (pm in two halves, so that no
// accumulator chain is longer than KT).
struct Acc {
  int p00[4], q01[4], q10[4], p11[4];
};

// The warp's m-tile of one product: plane chunk (kt, w, lo|hi) lies at
// off + kt * kstride + w * 1024 (+ 512 for hi); k-tiles below rk come from
// the shared copy `res`, the others from `glob` (L2).
template <class D>
__device__ __forceinline__ void ext_dot(Acc& acc, const uint8_t* res, const uint8_t* glob,
                                        int rk, size_t kstride, size_t off, const D& d,
                                        const uint8_t* xlo, const uint8_t* xhi) {
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31, g = ln >> 2, t = ln & 3;
  const int xs = xi_stride(d);
#pragma unroll
  for (int s = 0; s < 4; ++s) acc.p00[s] = acc.q01[s] = acc.q10[s] = acc.p11[s] = 0;
  const size_t base = off + (size_t)w * 1024 + (size_t)ln * 16;
  const int xo = g * xs + 4 * t;
  auto step = [&](const uint4& alo, const uint4& ahi, int kt) {
    const int o = xo + kt * 32;
    const uint32_t l0 = *reinterpret_cast<const uint32_t*>(xlo + o);
    const uint32_t l1 = *reinterpret_cast<const uint32_t*>(xlo + o + 16);
    const uint32_t h0 = *reinterpret_cast<const uint32_t*>(xhi + o);
    const uint32_t h1 = *reinterpret_cast<const uint32_t*>(xhi + o + 16);
    mma_u8(acc.p00, alo, l0, l1);
    mma_u8(acc.q01, alo, h0, h1);
    mma_u8(acc.q10, ahi, l0, l1);
    mma_u8(acc.p11, ahi, h0, h1);
  };
  const uint8_t* rp = res + base;
  const uint8_t* gp = glob + base;
  if constexpr (D::kKT > 0) {
#pragma unroll
    for (int kt = 0; kt < D::kKT; ++kt) {
      uint4 alo, ahi;
      if (kt < rk) {
        alo = *reinterpret_cast<const uint4*>(rp + kt * kstride);
        ahi = *reinterpret_cast<const uint4*>(rp + kt * kstride + 512);
      } else {
        alo = __ldg(reinterpret_cast<const uint4*>(gp + kt * kstride));
        ahi = __ldg(reinterpret_cast<const uint4*>(gp + kt * kstride + 512));
      }
      step(alo, ahi, kt);
    }
  } else {
    for (int kt = 0; kt < rk; ++kt) {
      const uint4 alo = *reinterpret_cast<const uint4*>(rp + kt * kstride);
      const uint4 ahi = *reinterpret_cast<const uint4*>(rp + kt * kstride + 512);
      step(alo, ahi, kt);
    }
    for (int kt = rk; kt < d.KT; ++kt) {
      const uint4 alo = __ldg(reinterpret_cast<const uint4*>(gp + kt * kstride));
      const uint4 ahi = __ldg(reinterpret_cast<const uint4*>(gp + kt * kstride + 512));
      step(alo, ahi, kt);
    }
  }
}

// ---- the thread's rows, slots and constants --------------------------------

// A value of the tile, as the thread holds it: a = A-channel of slot s, b =
// B-channel (the r channel on row Kp).  A slot whose row has no A-channel
// (no B-channel) holds an unspecified a (b), which no result reads.
struct Val {
  uint32_t a[4], b[4];
};

struct Thr {
  int t;
  int row[2];                  // r = 16 w + g + 8 h
  bool va[2], ra[2], vb[2], rb[2];   // r < K, r == K, r < Kp, r == Kp
  uint32_t pa[2], ma[2], mba[2];     // pA, its Barrett m, MB mod pA
  uint32_t pb[2], mb[2], imab[2], imbj[2];   // pB, m, MA^-1 and (MB/pB)^-1 mod pB
  uint32_t ca[4], nb[4];             // the lane's cA (A rows), N_B (B rows; N_r on row Kp)
  bool wr, wk;                       // this warp holds row Kp (t_r) / row K (alpha)
  uint32_t invMA_r, invMB_r;
};

// Lane of slot s (within the tile).
__device__ __forceinline__ int slot_lane(int t, int s) { return 2 * t + (s & 1); }

// The lane's RnsCtx row [3*CH] (core/rns.py:RnsCtx): [cA | N_B | N_r] [mon] [r2].
__device__ __forceinline__ const uint32_t* ctx_row(const uint32_t* ctx, int per_lane, int lane,
                                                   const Dims& d) {
  return ctx + (per_lane ? (size_t)lane * 3 * d.CH : 0);
}

__device__ __forceinline__ Thr thr_init(const Cst& cs, const Dims& d, const uint32_t* ctx,
                                        int per_lane, int lane0, uint32_t invMA_r,
                                        uint32_t invMB_r) {
  Thr th;
  const int ln = threadIdx.x & 31;
  th.t = ln & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * (threadIdx.x >> 5) + (ln >> 2) + 8 * h;
    th.row[h] = r;
    th.va[h] = r < d.K;
    th.ra[h] = r == d.K;
    th.vb[h] = r < d.Kp;
    th.rb[h] = r == d.Kp;
    th.pa[h] = th.va[h] ? cs.pA[r] : 0u;
    th.ma[h] = th.va[h] ? cs.mA[r] : 0u;
    th.mba[h] = th.va[h] ? cs.MB_A[r] : 0u;
    th.pb[h] = th.vb[h] ? cs.pB[r] : 0u;
    th.mb[h] = th.vb[h] ? cs.mB[r] : 0u;
    th.imab[h] = th.vb[h] ? cs.invMA_B[r] : 0u;
    th.imbj[h] = th.vb[h] ? cs.invMBj[r] : 0u;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1;
    const uint32_t* c = ctx_row(ctx, per_lane, lane0 + slot_lane(th.t, s), d);
    th.ca[s] = th.va[h] ? c[th.row[h]] : 0u;
    th.nb[s] = (th.vb[h] || th.rb[h]) ? c[d.K + th.row[h]] : 0u;
  }
  th.wr = (int)(threadIdx.x >> 5) == d.Kp >> 4;
  th.wk = (int)(threadIdx.x >> 5) == d.K >> 4;
  th.invMA_r = invMA_r;
  th.invMB_r = invMB_r;
  return th;
}

// The thread's slots of block `blk` of the lanes' ctx rows (1: mon, 2: r2).
__device__ __forceinline__ Val ctx_val(const Thr& th, const Dims& d, const uint32_t* ctx,
                                       int per_lane, int lane0, int blk) {
  Val v;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1;
    const uint32_t* c = ctx_row(ctx, per_lane, lane0 + slot_lane(th.t, s), d) + blk * d.CH;
    v.a[s] = th.va[h] ? c[th.row[h]] : 0u;
    v.b[s] = (th.vb[h] || th.rb[h]) ? c[d.K + th.row[h]] : 0u;
  }
  return v;
}

// The integer 1 in every channel.
__device__ __forceinline__ Val val_one() {
  Val v;
#pragma unroll
  for (int s = 0; s < 4; ++s) v.a[s] = v.b[s] = 1u;
  return v;
}

// What a kernel does inside a multiply: K2 starts its next window's copies
// after the first barrier (every thread has taken this window's entries) and
// waits for them before the last.
struct NoHook {
  __device__ __forceinline__ void after_first_barrier() const {}
  __device__ __forceinline__ void before_last_barrier() const {}
};

// x <- x * y * MA^{-1} mod N on the tile.  Every thread of the block calls it.
template <class D, class Hook>
__device__ __forceinline__ void montmul(Val& x, const Val& y, const Thr& th, const D& d,
                                        const Shm& sh, const uint8_t* planes, int rk,
                                        const Hook& hook) {
  const int xs = xi_stride(d);
  const size_t ks = ktile_bytes(d), half = (size_t)d.MT * 1024;
  // Slots compute branch-free (rows outside A or B hold zero constants, and
  // bred with p = m = 0 returns its input), so that the four slot chains of
  // a thread interleave; only stores depend on the row.
  // 1. channel products; xi1 = s * (-N^{-1}) * invMAk on base A
  uint32_t sb[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1, lane = slot_lane(th.t, s), r = th.row[h];
    const uint32_t xi =
        mulmod(mulmod(x.a[s], y.a[s], th.pa[h], th.ma[h]), th.ca[s], th.pa[h], th.ma[h]);
    if (th.va[h]) {
      sh.xi[0][lane * xs + r] = (uint8_t)xi;
      sh.xi[1][lane * xs + r] = (uint8_t)(xi >> 8);
    }
    const uint32_t pr = x.b[s] * y.b[s];
    sb[s] = th.vb[h] ? bred(pr, th.pb[h], th.mb[h]) : (pr & 0xFFFFu);
  }
  __syncthreads();
  hook.after_first_barrier();
  // 2. approximate extension A -> B|r
  Acc acc;
  ext_dot(acc, sh.w, planes, rk, ks, 0, d, sh.xi[0], sh.xi[1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1, lane = slot_lane(th.t, s), r = th.row[h];
    const uint32_t p00 = acc.p00[s], pm = acc.q01[s] + acc.q10[s];
    const uint32_t pb = th.pb[h], mb = th.mb[h];
    // t_B = (s_B + q_hat N_B) MA^-1, xi2 = t_B (MB/pB)^-1
    const uint32_t qh = fold(p00, pm, acc.p11[s], pb, mb);
    const uint32_t num = csub(sb[s] + mulmod(qh, th.nb[s], pb, mb), pb);
    const uint32_t tb = mulmod(num, th.imab[h], pb, mb);
    const uint32_t xi = mulmod(tb, th.imbj[h], pb, mb);
    x.b[s] = tb;   // rows past Kp hold values nothing reads
    if (th.vb[h]) {
      sh.xi[2][lane * xs + r] = (uint8_t)xi;
      sh.xi[3][lane * xs + r] = (uint8_t)(xi >> 8);
    }
    if (th.wr) {   // the warp of the redundant channel
      const uint32_t qr = (p00 + (pm << 8)) & 0xFFFFu;
      const uint32_t tr = (((sb[s] + qr * th.nb[s]) & 0xFFFFu) * th.invMA_r) & 0xFFFFu;
      if (th.rb[h]) {
        x.b[s] = tr;
        sh.tr[lane] = tr;
      }
    }
  }
  __syncthreads();
  // 3. exact extension B -> A (rows < K) and the r-channel sum (row K)
  ext_dot(acc, sh.w, planes, rk, ks, half, d, sh.xi[2], sh.xi[3]);
  uint32_t ta[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1, lane = slot_lane(th.t, s);
    const uint32_t p00 = acc.p00[s], pm = acc.q01[s] + acc.q10[s];
    ta[s] = fold(p00, pm, acc.p11[s], th.pa[h], th.ma[h]);
    if (th.wk && th.ra[h]) {
      const uint32_t sum_r = (p00 + (pm << 8)) & 0xFFFFu;
      sh.alpha[lane] = (((sum_r - sh.tr[lane]) & 0xFFFFu) * th.invMB_r) & 0xFFFFu;
    }
  }
  hook.before_last_barrier();
  __syncthreads();
  // 4. t_A = sum - alpha * MB mod pA
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1;
    const uint32_t corr = mulmod(sh.alpha[slot_lane(th.t, s)], th.mba[h], th.pa[h], th.ma[h]);
    const uint32_t v = ta[s] - corr;   // + pA when ta < corr
    x.a[s] = min(v, v + th.pa[h]);
  }
}

// Decode epilogue: strip MA (multiply by the integer 1), xi = res * invMAk,
// then the exact binary column sums v[o] = sum_k xi_k * limb_o(MA/p_k) of
// every lane of the tile, padding lanes included (the wrappers drop those),
// as the third tensor-core product (< K * 2^32 each; core/rns.py:RnsLazy
// decodes them).
template <class D>
__device__ __forceinline__ void decode_cols(Val acc, const Thr& th, const Cst& cs, const D& d,
                                            const Shm& sh, const uint8_t* planes, int rk,
                                            int lane0, unsigned long long* __restrict__ out) {
  montmul(acc, val_one(), th, d, sh, planes, rk, NoHook());
  const int xs = xi_stride(d);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1, r = th.row[h], lane = slot_lane(th.t, s);
    if (th.va[h]) {
      const uint32_t xi = mulmod(acc.a[s], __ldg(cs.invMAk + r), th.pa[h], th.ma[h]);
      sh.xi[0][lane * xs + r] = (uint8_t)xi;
      sh.xi[1][lane * xs + r] = (uint8_t)(xi >> 8);
    }
  }
  __syncthreads();
  Acc p;
  ext_dot(p, nullptr, planes + dec_offset(d), 0, (size_t)d.MT * 1024, 0, d, sh.xi[0], sh.xi[1]);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int o = th.row[s >> 1];
    if (o < d.Lout) {
      const unsigned long long pm = (unsigned long long)(uint32_t)p.q01[s] + (uint32_t)p.q10[s];
      out[(size_t)(lane0 + slot_lane(th.t, s)) * d.Lout + o] =
          (unsigned long long)(uint32_t)p.p00[s] + (pm << 8) +
          ((unsigned long long)(uint32_t)p.p11[s] << 16);
    }
  }
}

// Threads of one block: one warp per m-tile.
__host__ __forceinline__ int block_threads(const Dims& d) { return d.MT * 32; }
__host__ __forceinline__ bool small_block(const Dims& d) { return d.MT <= SMALL_WARPS; }
// The k-tile counts built with fully unrolled k-loops: 2048 and 4096 bits.
__host__ __forceinline__ bool unrolled_kt(const Dims& d, int kt) { return d.KT == kt; }

// Shared memory a block may opt in to on the current device, read once per
// device: a sharded call launches on several cards, which may differ.
constexpr int SMEM_CACHED_DEVICES = 64;
__host__ inline int smem_optin() {
  static int cached[SMEM_CACHED_DEVICES] = {};
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < SMEM_CACHED_DEVICES && cached[dev] != 0) return cached[dev];
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (dev >= 0 && dev < SMEM_CACHED_DEVICES) cached[dev] = v;
  return v;
}

// The most k-tiles of planes that fit beside `extra` bytes, or -1 if not even
// the xi planes fit.
__host__ inline int resident_ktiles(const Dims& d, size_t extra) {
  const size_t base = smem_bytes(d, 0, extra), lim = (size_t)smem_optin();
  if (base > lim) return -1;
  const size_t rk = (lim - base) / ktile_bytes(d);
  return rk < (size_t)d.KT ? (int)rk : d.KT;
}

}  // namespace rnsf

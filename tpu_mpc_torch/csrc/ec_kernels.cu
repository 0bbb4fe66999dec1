// K3, K4, K5: batched secp256k1 kernels.
//
//   K3 k3_glv_ladder  replaces tpu_mpc/ec/pallas_ec.py:_ladder_kernel
//   K4 k4_comb        replaces tpu_mpc/ec/pallas_ec.py:_comb_kernel
//   K5 k5_affine      replaces tpu_mpc/ec/pallas_ec.py:_affine_kernel
//
// What bounds them on the H100: integer multiply-adds, and the latency of
// each lane's chain of them.  A GLV ladder (K3, ns = 2) is ~2,350 dependent
// field products per lane, the comb (K4) ~450, the inversion (K5) ~330;
// inputs and outputs are a few hundred bytes per lane.  At the main path's
// 256 lanes, one thread per lane fills two SMs of 132 and waits on each
// product's carry chain.
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
// K5 (one thread per lane) raises Z to p - 2, a public exponent, so its
// digits index the table.

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

constexpr int kThreads = 128;   // K5
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

// 4-bit digit i (least significant first) of p - 2 = 0xFF..FE FFFFFC2D
__device__ __forceinline__ int pm2_digit(int i) {
  const int limb = i >> 3;
  const uint32_t v = limb == 0 ? 0xFFFFFC2Du : (limb == 1 ? 0xFFFFFFFEu : 0xFFFFFFFFu);
  return (int)((v >> (4 * (i & 7))) & 0xFu);
}

__global__ void k5_kernel(const int32_t* __restrict__ pts,  // [B, 3, 16]
                          int B, int32_t* __restrict__ out) {  // [B, 2, 16]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int32_t* l = pts + (size_t)i * 48;
  const Fe X = fe_load16(l), Y = fe_load16(l + 16);
  Fe z = fe_load16(l + 32);
  if (fe_is_zero(z)) z = fe_small(1u);  // Z = 0 lanes invert a dummy 1
  Fe tab[16];
  tab[0] = fe_small(1u);
  tab[1] = z;
  for (int d = 2; d < 16; ++d) tab[d] = fe_mul(tab[d - 1], z);
  Fe acc = fe_small(1u);
  for (int j = 0; j < 64; ++j) {
    for (int q = 0; q < 4; ++q) acc = fe_sq(acc);
    acc = fe_mul(acc, tab[pm2_digit(63 - j)]);
  }
  const Fe zi2 = fe_sq(acc);
  fe_store16(fe_mul(X, zi2), out + (size_t)i * 32);
  fe_store16(fe_mul(Y, fe_mul(zi2, acc)), out + (size_t)i * 32 + 16);
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
  k5_kernel<<<cdiv(B, kThreads), kThreads, 0, stream>>>(pts, B, out);
  return (int)cudaGetLastError();
}

// K3, K4, K5: batched secp256k1 kernels, one thread per lane.
//
//   K3 k3_glv_ladder  replaces tpu_mpc/ec/pallas_ec.py:_ladder_kernel
//   K4 k4_comb        replaces tpu_mpc/ec/pallas_ec.py:_comb_kernel
//   K5 k5_affine      replaces tpu_mpc/ec/pallas_ec.py:_affine_kernel
//
// What bounds them on the H100: integer operations.  Each field multiply is
// 64 32x32->64-bit multiply-adds plus the fold; a GLV ladder (K3, ns = 2)
// runs ~33 x (4 doublings + 2 additions) ~ 2,400 of them per lane, the comb
// (K4) 32 additions ~ 450, the inversion (K5) ~ 330.  Inputs and outputs are
// a few hundred bytes per lane, so memory traffic is negligible.  K4 also
// pays for its constant-time select: 32 x 256 entries x 16 words of
// AND/OR per lane, about 4x its field arithmetic.
//
// Design: a lane is a thread and the field lives in registers (8 x 32-bit
// limbs, fully reduced).  K3 and K5 need no block synchronisation and
// ragged batches stop at B; in K4 the lanes past B help stage the table and
// store nothing.  K3 keeps its per-lane 16-entry base tables in
// local memory (L1-cached, 1.5 KB per base) and reads them with a masked
// select over all 16 entries, constant time in the secret digit; the beta
// endomorphism and the GLV sign apply to the selected entry.  K4's digits
// are secret too (signing nonces): each block stages one window of the
// 32 x 256 affine table in shared memory (16 KB) and every lane reads all
// 256 entries with a masked select, so its memory accesses do not depend on
// the digit.  K5's exponent p - 2 is a public constant, so its digits index
// the table.

#include <cstdint>
#include <cuda_runtime.h>

#include "ec_field.cuh"

using namespace ec;

namespace {

constexpr int kThreads = 128;
constexpr int kWindows = 33;

__device__ __forceinline__ Fe beta_fe() {
  // GLV beta, a cube root of unity mod p (little-endian 32-bit limbs)
  Fe b;
  b.v[0] = 0x719501EEu; b.v[1] = 0xC1396C28u; b.v[2] = 0x12F58995u; b.v[3] = 0x9CF04975u;
  b.v[4] = 0xAC3434E9u; b.v[5] = 0x6E64479Eu; b.v[6] = 0x657C0710u; b.v[7] = 0x7AE96A2Bu;
  return b;
}

__global__ void k3_kernel(const int32_t* __restrict__ pts,  // [B, ns/2, 3, 16]
                          const int32_t* __restrict__ dg,   // [B, ns, 33]
                          const int32_t* __restrict__ neg,  // [B, ns]
                          int B, int ns, int32_t* __restrict__ out) {  // [B, 3, 16]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int nb = ns / 2;
  Pt tab[2][16];
  for (int m = 0; m < nb; ++m) {
    const Pt base = jac_in(pts + ((size_t)i * nb + m) * 48);
    tab[m][0] = pt_identity();
    tab[m][1] = base;
    for (int d = 2; d < 16; ++d) tab[m][d] = rcb_add(tab[m][d - 1], base);
  }
  const Fe beta = beta_fe();
  Pt acc = pt_identity();
  for (int j = 0; j < kWindows; ++j) {
    const int wj = kWindows - 1 - j;
    for (int q = 0; q < 4; ++q) acc = rcb_dbl(acc);
    for (int s = 0; s < ns; ++s) {
      const int m = s >> 1;
      const uint32_t d = (uint32_t)dg[((size_t)i * ns + s) * kWindows + wj];
      Pt e;
      e.X = fe_zero();
      e.Y = fe_zero();
      e.Z = fe_zero();
      for (int k = 0; k < 16; ++k) {
        const uint32_t msk = d == (uint32_t)k ? 0xFFFFFFFFu : 0u;
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          e.X.v[l] |= tab[m][k].X.v[l] & msk;
          e.Y.v[l] |= tab[m][k].Y.v[l] & msk;
          e.Z.v[l] |= tab[m][k].Z.v[l] & msk;
        }
      }
      if (s & 1) e.X = fe_mul(e.X, beta);
      const bool ng = neg[(size_t)i * ns + s] != 0;
      e.Y = fe_select(ng, fe_neg(e.Y), e.Y);
      acc = rcb_add(acc, e);
    }
  }
  jac_out(acc, out + (size_t)i * 48);
}

// One window of the comb table in shared memory: 256 entries of (x, y),
// each as 8 packed 32-bit limbs, read as 4 x uint4 per entry.
constexpr int kCombThreads = 64;
constexpr int kCombEnt = 256;

__global__ void __launch_bounds__(kCombThreads)
k4_kernel(const int32_t* __restrict__ dg,   // [B, 32]
          const int32_t* __restrict__ tab,  // [32, 256, 2, 16]
          int B, int32_t* __restrict__ out) {
  __shared__ uint4 ent[kCombEnt * 4];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < B;
  const int32_t* dl = dg + (size_t)(live ? i : 0) * 32;
  uint32_t* flat = reinterpret_cast<uint32_t*>(ent);
  Pt acc = pt_identity();
  for (int w = 0; w < 32; ++w) {
    // the block stages window w (16-bit limb pairs -> 32-bit limbs)
    const int2* src = reinterpret_cast<const int2*>(tab + (size_t)w * kCombEnt * 32);
    __syncthreads();
    for (int k = threadIdx.x; k < kCombEnt * 16; k += blockDim.x) {
      const int2 v = __ldg(src + k);
      flat[k] = ((uint32_t)v.x & 0xFFFFu) | ((uint32_t)v.y << 16);
    }
    __syncthreads();
    const uint32_t d = (uint32_t)dl[w] & 0xFFu;
    uint4 sel[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sel[c] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int k = 0; k < kCombEnt; ++k) {
      const uint32_t msk = d == (uint32_t)k ? 0xFFFFFFFFu : 0u;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint4 v = ent[k * 4 + c];
        sel[c].x |= v.x & msk;
        sel[c].y |= v.y & msk;
        sel[c].z |= v.z & msk;
        sel[c].w |= v.w & msk;
      }
    }
    Pt E;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      Fe& f = h ? E.Y : E.X;
      f.v[0] = sel[2 * h].x; f.v[1] = sel[2 * h].y; f.v[2] = sel[2 * h].z; f.v[3] = sel[2 * h].w;
      f.v[4] = sel[2 * h + 1].x; f.v[5] = sel[2 * h + 1].y;
      f.v[6] = sel[2 * h + 1].z; f.v[7] = sel[2 * h + 1].w;
    }
    E.Z = fe_small(d != 0u ? 1u : 0u);
    acc = rcb_add(acc, E);
  }
  if (live) jac_out(acc, out + (size_t)i * 48);
}

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

int blocks_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

extern "C" int k3_glv_ladder(const int32_t* pts, const int32_t* dg, const int32_t* neg,
                             int B, int ns, int32_t* out, cudaStream_t stream) {
  if (ns != 2 && ns != 4) return (int)cudaErrorInvalidValue;
  k3_kernel<<<blocks_for(B), kThreads, 0, stream>>>(pts, dg, neg, B, ns, out);
  return (int)cudaGetLastError();
}

extern "C" int k4_comb(const int32_t* dg, const int32_t* tab, int B, int32_t* out,
                       cudaStream_t stream) {
  k4_kernel<<<(B + kCombThreads - 1) / kCombThreads, kCombThreads, 0, stream>>>(dg, tab, B, out);
  return (int)cudaGetLastError();
}

extern "C" int k5_affine(const int32_t* pts, int B, int32_t* out, cudaStream_t stream) {
  k5_kernel<<<blocks_for(B), kThreads, 0, stream>>>(pts, B, out);
  return (int)cudaGetLastError();
}

// K1: fused RNS Montgomery modexp x^e mod N for a batch of lanes.
//
// Replaces tpu_mpc/core/pallas_rns.py:_exp_kernel (launched by _exp_call).
// Same Bajard-Imbert RNS Montgomery scheme as tpu_mpc_torch/core/rns.py,
// value for value (the multiply is rns_field.cuh:montmul, shared with K2):
// every channel value stays canonical (< p), so the output equals the plain
// PyTorch version (core/pallas_rns.py:exp_plain) bit for bit.
//
// Work per lane: binary -> residues (prologue), a 16-entry window table,
// MSB-first 4-bit windows over packed 32-bit exponent words (4 squarings +
// one table multiply each), then either the decode epilogue (exact binary
// column sums v[l] = sum_k xi_k * limb_l(MA/p_k)) or the big-Montgomery
// residues (for the axis-0 product the caller folds afterwards).
//
// What bounds it on the H100: a modexp with a 2048-bit exponent is a serial
// chain of ~2600 multiplies, each two base extensions of 2*K*(K+1) products
// (34k at 2048 bits, 134k at 4096).  One thread block per lane made every
// multiply of every lane re-read the extension matrices as u32 from L2, one
// multiply-add per 4 bytes.  Here a block takes a tile of 8 lanes, so the extensions become matrix products on the tensor cores
// (rns_field.cuh) whose u8 W planes are read once per tile: from shared
// memory at 2048 bits (92 KB, staged once per launch), and at 4096 bits (313
// KB) the k-tiles that fit from shared memory and the rest from L2.  The
// chain's length stays; each multiply is ~3 barriers and ~4*KT dependent mma
// per extension on its warp.
//
// The window table (16 entries x MT*16 rows x 8 lanes, u32: A and B channel of
// a row) sits in shared memory when it fits beside the planes (2048 bits),
// else in a global scratch buffer from the wrapper (k1_tab_words).  Every thread reads only its own slots' entries,
// with a branch-free masked select over all 16 entries: no address depends
// on a secret digit.  The grid has exactly B / 8 blocks: the wrapper pads the
// batch to whole tiles.

#include "rns_field.cuh"

namespace {

using namespace rnsf;

// The window table: entry dd of a lane holds, for every row r < MT*16, the
// A-channel (low 16 bits) and B-channel (high 16 bits) of that row, with
// the tile's lanes innermost: [16][MT*16][LANES] u32.  A thread's two lanes 2t,
// 2t+1 of one row are one 8-byte word.
__device__ __forceinline__ void tab_store(uint32_t* tab, int dd, const Val& v, const Thr& th,
                                          const Dims& d) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = 2 * h;
    uint2 w;
    // the low half masked: a row that is no A-channel holds any value there
    w.x = (v.a[s] & 0xFFFFu) | (v.b[s] << 16);
    w.y = (v.a[s + 1] & 0xFFFFu) | (v.b[s + 1] << 16);
    *reinterpret_cast<uint2*>(tab + ((size_t)dd * d.MT * 16 + th.row[h]) * LANES +
                              slot_lane(th.t, s)) = w;
  }
}

// The entries of the lanes' digits (wd >> sft) & 15, selected under a mask
// over all 16 entries.
__device__ __forceinline__ Val tab_select(const uint32_t* tab, const uint32_t (&wd)[2], int sft,
                                          const Thr& th, const Dims& d) {
  Val y;
  const size_t ent = (size_t)d.MT * 16 * LANES;
  const uint32_t d0 = (wd[0] >> sft) & 15u, d1 = (wd[1] >> sft) & 15u;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* col = tab + (size_t)th.row[h] * LANES + slot_lane(th.t, 2 * h);
    uint32_t v0 = 0u, v1 = 0u;
#pragma unroll
    for (int dd = 0; dd < 16; ++dd) {
      const uint2 w = *reinterpret_cast<const uint2*>(col + dd * ent);
      v0 |= w.x & (d0 == (uint32_t)dd ? 0xFFFFFFFFu : 0u);
      v1 |= w.y & (d1 == (uint32_t)dd ? 0xFFFFFFFFu : 0u);
    }
    y.a[2 * h] = v0 & 0xFFFFu;
    y.b[2 * h] = v0 >> 16;
    y.a[2 * h + 1] = v1 & 0xFFFFu;
    y.b[2 * h + 1] = v1 >> 16;
  }
  return y;
}

template <int MW, int KTC>
__global__ void __launch_bounds__(MW * 32, 1)
k1_exp_kernel(const uint32_t* __restrict__ xs,   // [B, Lin]
              const uint32_t* __restrict__ es,   // [B, ne2]
              const uint32_t* __restrict__ ctx,  // [C, 3*CH]
              int ctx_per_lane, const uint32_t* __restrict__ cst,
              const uint8_t* __restrict__ planes, Dims dims, int rk, int tab_shared,
              uint32_t* __restrict__ tab_glob, int ne2, uint32_t invMA_r, uint32_t invMB_r,
              int emit_planes, unsigned long long* __restrict__ out_cols,
              uint32_t* __restrict__ out_res) {
  const DimsT<KTC> d{dims};
  extern __shared__ __align__(16) uint8_t smem[];
  const Shm sh = carve(smem, d, rk);
  const Cst cs = cst_views(cst, d);
  const int lane0 = blockIdx.x * LANES;
  stage_planes(sh, planes, d, rk);
  const Thr th = thr_init(cs, d, ctx, ctx_per_lane, lane0, invMA_r, invMB_r);
  const Val one = ctx_val(th, d, ctx, ctx_per_lane, lane0, 1);
  const Val r2 = ctx_val(th, d, ctx, ctx_per_lane, lane0, 2);

  // binary 16-bit limbs -> residues: exact 64-bit sums, two Barrett steps
  Val x;
  {
    unsigned long long sa[4], sb[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) sa[s] = sb[s] = 0ull;
    for (int i = 0; i < d.Lin; ++i) {
      uint32_t wa[2], wb[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        wa[h] = th.va[h] ? __ldg(cs.W16A + i * d.K + th.row[h]) : 0u;
        wb[h] = th.vb[h] ? __ldg(cs.W16B + i * d.Kp + th.row[h]) : 0u;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const unsigned long long v = __ldg(xs + (size_t)(lane0 + 2 * th.t + c) * d.Lin + i);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          sa[2 * h + c] += v * wa[h];
          sb[2 * h + c] += v * wb[h];
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int h = s >> 1;
      x.a[s] = th.va[h] ? bred64(sa[s], th.pa[h], th.ma[h]) : 0u;
      x.b[s] = th.vb[h]   ? bred64(sb[s], th.pb[h], th.mb[h])
               : th.rb[h] ? (__ldg(xs + (size_t)(lane0 + slot_lane(th.t, s)) * d.Lin) & 0xFFFFu)
                          : 0u;
    }
  }
  __syncthreads();   // planes staged

  // table: T[0] = one (MA mod N), T[1] = x*MA, T[i] = T[i-1] * T[1]
  montmul(x, r2, th, d, sh, planes, rk, NoHook());
  // the table in shared memory or in this block's part of the global buffer;
  // the two stay apart so that shared accesses compile to shared loads
  uint32_t* tab_s = reinterpret_cast<uint32_t*>(sh.extra);
  uint32_t* tab_g = tab_glob + (size_t)blockIdx.x * 16 * d.MT * 16 * LANES;
  Val e = one;
  for (int dd = 0; dd < 16; ++dd) {
    if (dd == 1) e = x;
    if (dd >= 2) montmul(e, x, th, d, sh, planes, rk, NoHook());
    if (tab_shared)
      tab_store(tab_s, dd, e, th, d);
    else
      tab_store(tab_g, dd, e, th, d);
  }

  // every thread reads back only the table entries it stored: no barrier
  Val acc = one;
  for (int j = 0; j < ne2; ++j) {
    uint32_t wd[2];
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wd[c] = __ldg(es + (size_t)(lane0 + 2 * th.t + c) * ne2 + (ne2 - 1 - j));
    for (int sft = 28; sft >= 0; sft -= 4) {
      for (int k = 0; k < 5; ++k) {   // 4 squarings, then the table entry
        Val y = acc;
        if (k == 4)
          y = tab_shared ? tab_select(tab_s, wd, sft, th, d) : tab_select(tab_g, wd, sft, th, d);
        montmul(acc, y, th, d, sh, planes, rk, NoHook());
      }
    }
  }

  if (!emit_planes) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int h = s >> 1;
      uint32_t* row = out_res + (size_t)(lane0 + slot_lane(th.t, s)) * d.CH;
      if (th.va[h]) row[th.row[h]] = acc.a[s];
      if (th.vb[h] || th.rb[h]) row[d.K + th.row[h]] = acc.b[s];
    }
    return;
  }
  decode_cols(acc, th, cs, d, sh, planes, rk, lane0, out_cols);
}

// Shared memory of a launch: resident k-tiles, and whether the window table
// fits beside them (2048 bits) or lives in the global scratch buffer.
struct Plan {
  int rk, tab_shared;
  size_t smem;
};

Plan plan(const Dims& d) {
  const size_t tab_bytes = (size_t)16 * d.MT * 16 * LANES * sizeof(uint32_t);
  Plan p;
  p.rk = resident_ktiles(d, 0);
  p.tab_shared = p.rk == d.KT && smem_bytes(d, p.rk, tab_bytes) <= (size_t)smem_optin() ? 1 : 0;
  p.smem = smem_bytes(d, p.rk < 0 ? 0 : p.rk, p.tab_shared ? tab_bytes : 0);
  return p;
}

}  // namespace

// u32 words of the global window table a launch of B lanes needs: 0 when the
// table sits in shared memory, -1 past an int's range (over ~490k lanes at
// 4096 bits: the caller splits the launch).
extern "C" int k1_tab_words(int B, int K, int Kp, int Lin, int Lout, int MT, int KT) {
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout, MT, KT};
  if (plan(d).tab_shared) return 0;
  const size_t words = (size_t)B * 16 * MT * 16;
  return words > (size_t)0x7FFFFFFF ? -1 : (int)words;
}

// B must be a multiple of the lane tile (8); tab_glob holds k1_tab_words u32
// (it is not read when that is 0).
extern "C" int k1_exp(const uint32_t* x, const uint32_t* e, const uint32_t* ctx,
                      int ctx_per_lane, const uint32_t* cst, const uint8_t* planes, int B, int K,
                      int Kp, int Lin, int Lout, int MT, int KT, int ne2, uint32_t invMA_r,
                      uint32_t invMB_r, int emit_planes, uint32_t* tab_glob,
                      unsigned long long* out_cols, uint32_t* out_res, cudaStream_t stream) {
  if (B % LANES != 0 || MT > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout, MT, KT};
  const Plan p = plan(d);
  if (p.rk < 0) return (int)cudaErrorInvalidValue;
  // one instantiation per register budget (9 or 17 warps)
  auto go = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kern<<<B / LANES, block_threads(d), p.smem, stream>>>(
        x, e, ctx, ctx_per_lane, cst, planes, d, p.rk, p.tab_shared, tab_glob, ne2, invMA_r,
        invMB_r, emit_planes, out_cols, out_res);
    return cudaGetLastError();
  };
  // 2048 bits (9 warps, KT = 5) and 4096 bits (17 warps, KT = 9) with fully
  // unrolled k-loops; other widths with KT at run time
  if (small_block(d))
    return (int)(unrolled_kt(d, 5) ? go(k1_exp_kernel<SMALL_WARPS, 5>)
                                   : go(k1_exp_kernel<SMALL_WARPS, 0>));
  return (int)(unrolled_kt(d, 9) ? go(k1_exp_kernel<MAX_WARPS, 9>)
                                 : go(k1_exp_kernel<MAX_WARPS, 0>));
}

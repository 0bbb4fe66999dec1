// K2: fixed-base window product prod_i base_i^{e_i} mod N from precomputed
// per-window tables, with zero squarings.
//
// Replaces tpu_mpc/core/pallas_rns.py:_fixed_kernel (launched by _fixed_call,
// dispatched by fixed_prod_dispatch).  It computes the same product, the
// same per-lane key-group rows and the same decode columns as the TPU
// kernel, in the plain-residue formulation of K1 (rns_field.cuh:montmul):
// every channel value stays canonical, so the output equals the plain
// PyTorch version (core/pallas_rns.py:fixed_plain) bit for bit.
//
// Tables (core/rns.py:rns_make_tables): one int32 tensor per base,
// [nw, 16, G, CH] canonical residues, T[j][d][g] = base_g^(d * 16^j) in
// Montgomery form; entry 0 of every window is the Montgomery one.  G is the
// number of key groups (the flattened table batch); each lane reads the 16
// entries of its own group row g = grow[lane] (the TPU kernel's `gofs` / 16).
//
// Work per lane: for each base, windows j = 0 .. nwin-1 LSB-first from the
// packed 32-bit e-words (window j is bits 4j..4j+3 of word woff + j/8), one
// Montgomery multiply by that window's entry each; then K1's decode
// epilogue into [Lout] exact column sums.
//
// What bounds it on the H100: integer operations, as for K1 (one multiply
// per window is 2*K*(K+1) multiply-adds: 34k at 2048 bits, 134k at 4096).
// Per window it also reads 16 table entries (16 x CH x 4 B = 16.8 KB at
// 2048 bits) from device memory; lanes of one key group read the same
// entries, which then come from L2.
//
// Design: one thread block per lane, one thread per channel, as K1.  The
// digits are secret (randomizer exponents, commitment masks), so the entry
// is taken with a branch-free masked select over all 16 entries of the
// lane's group: the addresses a lane reads depend on the public group row
// and window index only, never on a digit.  The group row is public.

#include "rns_field.cuh"

namespace {

using namespace rnsf;

constexpr int MAX_BASES = 4;

struct Bases {
  const uint32_t* tab[MAX_BASES];  // [nw_b, 16, G, CH] per base
  int nwin[MAX_BASES];             // windows this call runs for the base
  int woff[MAX_BASES];             // the base's first packed e-word
  int n;
};

__global__ void k2_fixed_kernel(const uint32_t* __restrict__ es,    // [B, ne2]
                                int ne2,
                                const uint32_t* __restrict__ grow,  // [B]
                                const uint32_t* __restrict__ ctx,   // [C, 3*CH]
                                int ctx_per_lane,
                                const uint32_t* __restrict__ cst, Dims d, int G,
                                Bases bs, uint32_t invMA_r, uint32_t invMB_r,
                                unsigned long long* __restrict__ out_cols) {
  extern __shared__ uint32_t smem[];
  const Shm sh = carve(smem, d);
  const Cst cs = cst_views(cst, d);
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const uint32_t* c = ctx + (ctx_per_lane ? (size_t)lane * 3 * d.CH : 0);
  const Thr th = thr_init(cs, d, c, invMA_r, invMB_r);

  Val acc = load_val(c + d.CH, th, d);      // the Montgomery one
  const uint32_t* el = es + (size_t)lane * ne2;
  const size_t g = __ldg(grow + lane);
  const size_t ent = (size_t)G * d.CH;      // entry stride within a window
  for (int b = 0; b < bs.n; ++b) {
    const uint32_t* tb = bs.tab[b] + g * d.CH;
    for (int j = 0; j < bs.nwin[b]; ++j) {
      const uint32_t word = __ldg(el + bs.woff[b] + (j >> 3));
      const uint32_t dig = (word >> (4 * (j & 7))) & 15u;
      const uint32_t* w = tb + (size_t)j * 16 * ent;
      Val sel{0u, 0u, 0u};
      for (int dd = 0; dd < 16; ++dd) {
        const uint32_t msk = dig == (uint32_t)dd ? 0xFFFFFFFFu : 0u;
        const uint32_t* row = w + dd * ent;
        if (th.isA) sel.a |= __ldg(row + t) & msk;
        if (th.isB) sel.b |= __ldg(row + d.K + t) & msk;
        sel.r |= __ldg(row + d.K + d.Kp) & msk;
      }
      montmul(acc, sel, th, cs, d, sh);
    }
  }
  decode_cols(acc, th, cs, d, sh, out_cols + (size_t)lane * d.Lout);
}

}  // namespace

// tabs/nwin/woff are host arrays of nbases entries (1 <= nbases <= 4).
extern "C" int k2_fixed(const uint32_t* e, int ne2, const uint32_t* grow,
                        const uint32_t* ctx, int ctx_per_lane, const uint32_t* cst,
                        int B, int K, int Kp, int Lin, int Lout, uint32_t invMA_r,
                        uint32_t invMB_r, int nbases, const unsigned long long* tabs,
                        const int* nwin, const int* woff, int G,
                        unsigned long long* out_cols, cudaStream_t stream) {
  if (nbases < 1 || nbases > MAX_BASES) return (int)cudaErrorInvalidValue;
  Bases bs;
  bs.n = nbases;
  for (int b = 0; b < MAX_BASES; ++b) {
    const bool on = b < nbases;
    bs.tab[b] = on ? reinterpret_cast<const uint32_t*>(tabs[b]) : nullptr;
    bs.nwin[b] = on ? nwin[b] : 0;
    bs.woff[b] = on ? woff[b] : 0;
  }
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout};
  const size_t smem = (size_t)shm_words(K, Kp) * sizeof(uint32_t);
  k2_fixed_kernel<<<B, block_threads(Kp), smem, stream>>>(
      e, ne2, grow, ctx, ctx_per_lane, cst, d, G, bs, invMA_r, invMB_r, out_cols);
  return (int)cudaGetLastError();
}

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
// What bounds it on the H100: integer operations.  One Montgomery multiply
// is two exact dot products over the channels, 2*K*(K+1) 32x32->64-bit
// multiply-adds (34k at 2048 bits, 134k at 4096 bits), and a modexp with a
// 2048-bit exponent runs ~2600 of them.  The extension matrices W1/W2
// (68 KB each at 2048 bits, 268 KB at 4096) are shared by every lane and
// stay in L2.
//
// Design: one thread block per lane; thread t owns A-channel t, B-channel t
// and (t == Kp) the 2^16 channel.  The window table (16 x CH words) sits in
// dynamic shared memory and is read with a branch-free masked select over
// all 16 entries (constant time in the secret digit).  Dot sums accumulate
// exactly in 64 bits (< K * 2^32) and reduce once per output channel.
// Three block barriers per multiply.  The grid has exactly B blocks, so
// there is no ragged edge.

#include "rns_field.cuh"

namespace {

using namespace rnsf;

__global__ void k1_exp_kernel(const uint32_t* __restrict__ xs,   // [B, Lin]
                              const uint32_t* __restrict__ es,   // [B, ne2]
                              const uint32_t* __restrict__ ctx,  // [C, 3*CH]
                              int ctx_per_lane,
                              const uint32_t* __restrict__ cst, Dims d, int ne2,
                              uint32_t invMA_r, uint32_t invMB_r,
                              int emit_planes,
                              unsigned long long* __restrict__ out_cols,
                              uint32_t* __restrict__ out_res) {
  extern __shared__ uint32_t smem[];
  uint32_t* tab = smem;                       // [16][CH]
  const Shm sh = carve(tab + 16 * d.CH, d);

  const Cst cs = cst_views(cst, d);
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const uint32_t* c = ctx + (ctx_per_lane ? (size_t)lane * 3 * d.CH : 0);
  const Thr th = thr_init(cs, d, c, invMA_r, invMB_r);
  const Val one = load_val(c + d.CH, th, d);
  const Val r2 = load_val(c + 2 * d.CH, th, d);
  // binary 16-bit limbs -> residues
  const uint32_t* xl = xs + (size_t)lane * d.Lin;
  unsigned long long sa = 0ull, sb = 0ull;
  for (int i = 0; i < d.Lin; ++i) {
    const unsigned long long v = __ldg(xl + i);
    if (th.isA) sa += v * cs.W16A[i * d.K + t];
    if (th.isB) sb += v * cs.W16B[i * d.Kp + t];
  }
  Val x{th.isA ? (uint32_t)(sa % th.pa) : 0u, th.isB ? (uint32_t)(sb % th.pb) : 0u,
        __ldg(xl) & 0xFFFFu};

  // table: T[0] = one (MA mod N), T[1] = x*MA, T[i] = T[i-1] * T[1]
  montmul(x, r2, th, cs, d, sh);
  Val e = one;
  for (int dd = 0; dd < 16; ++dd) {
    if (dd == 1) e = x;
    if (dd >= 2) montmul(e, x, th, cs, d, sh);
    store_val(tab + dd * d.CH, e, th, d);
  }
  __syncthreads();

  Val acc = one;
  const uint32_t* el = es + (size_t)lane * ne2;
  for (int j = 0; j < ne2; ++j) {
    const uint32_t word = __ldg(el + (ne2 - 1 - j));
    for (int s = 28; s >= 0; s -= 4) {
      for (int k = 0; k < 4; ++k) montmul(acc, acc, th, cs, d, sh);
      const uint32_t dig = (word >> s) & 15u;
      Val sel{0u, 0u, 0u};
      for (int dd = 0; dd < 16; ++dd) {
        const uint32_t msk = dig == (uint32_t)dd ? 0xFFFFFFFFu : 0u;
        const uint32_t* row = tab + dd * d.CH;
        if (th.isA) sel.a |= row[t] & msk;
        if (th.isB) sel.b |= row[d.K + t] & msk;
        sel.r |= row[d.K + d.Kp] & msk;
      }
      montmul(acc, sel, th, cs, d, sh);
    }
  }

  if (!emit_planes) {
    store_val(out_res + (size_t)lane * d.CH, acc, th, d);
    return;
  }
  decode_cols(acc, th, cs, d, sh, out_cols + (size_t)lane * d.Lout);
}

}  // namespace

extern "C" int k1_exp(const uint32_t* x, const uint32_t* e, const uint32_t* ctx,
                      int ctx_per_lane, const uint32_t* cst, int B, int K, int Kp,
                      int Lin, int Lout, int ne2, uint32_t invMA_r,
                      uint32_t invMB_r, int emit_planes,
                      unsigned long long* out_cols, uint32_t* out_res,
                      cudaStream_t stream) {
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout};
  const int threads = block_threads(Kp);
  const size_t smem = (size_t)(16 * d.CH + shm_words(K, Kp)) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      k1_exp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k1_exp_kernel<<<B, threads, smem, stream>>>(x, e, ctx, ctx_per_lane, cst, d, ne2,
                                              invMA_r, invMB_r, emit_planes, out_cols,
                                              out_res);
  return (int)cudaGetLastError();
}

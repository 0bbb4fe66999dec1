// K1: fused RNS Montgomery modexp x^e mod N for a batch of lanes.
//
// Replaces tpu_mpc/core/pallas_rns.py:_exp_kernel (launched by _exp_call).
// Same Bajard-Imbert RNS Montgomery scheme as tpu_mpc_torch/core/rns.py,
// value for value: every channel value stays canonical (< p), so the output
// equals the plain PyTorch version (core/pallas_rns.py:exp_plain) bit for bit.
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Dims {
  int K, Kp, CH, Lin, Lout, ne2;
};

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

struct Shm {
  uint32_t* tab;    // [16][CH]
  uint32_t* xi1;    // [K]
  uint32_t* xi2;    // [Kp]
  uint32_t* alpha;  // [1]
};

// Per-thread constants of its own channels and of the lane's modulus.
struct Thr {
  int t;
  bool isA, isB, isR;
  uint32_t pa, pb, invMA_B, invMBj, MB_A, invMAk;
  uint32_t cA, NB, Nr;
};

// x <- x * y * MA^{-1} mod N.  Every thread of the block calls it.
__device__ void montmul(Val& x, const Val& y, const Thr& th, const Cst& cs,
                        const Dims& d, const Shm& sh, uint32_t invMA_r,
                        uint32_t invMB_r) {
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
      x.r = (((sr + qh_r * th.Nr) & 0xFFFFu) * invMA_r) & 0xFFFFu;
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
      sh.alpha[0] = (((sum_r - x.r) & 0xFFFFu) * invMB_r) & 0xFFFFu;
    }
  }
  __syncthreads();
  if (th.isA) {
    const uint32_t corr = mulmod(sh.alpha[0], th.MB_A, th.pa);
    x.a = tA >= corr ? tA - corr : tA + th.pa - corr;
  }
}

__global__ void k1_exp_kernel(const uint32_t* __restrict__ xs,   // [B, Lin]
                              const uint32_t* __restrict__ es,   // [B, ne2]
                              const uint32_t* __restrict__ ctx,  // [C, 3*CH]
                              int ctx_per_lane,
                              const uint32_t* __restrict__ cst, Dims d,
                              uint32_t invMA_r, uint32_t invMB_r,
                              int emit_planes,
                              unsigned long long* __restrict__ out_cols,
                              uint32_t* __restrict__ out_res) {
  extern __shared__ uint32_t smem[];
  Shm sh;
  sh.tab = smem;
  sh.xi1 = sh.tab + 16 * d.CH;
  sh.xi2 = sh.xi1 + d.K;
  sh.alpha = sh.xi2 + d.Kp;

  const Cst cs = cst_views(cst, d);
  Thr th;
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
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

  const uint32_t* c = ctx + (ctx_per_lane ? (size_t)lane * 3 * d.CH : 0);
  th.cA = th.isA ? c[t] : 0u;
  th.NB = th.isB ? c[d.K + t] : 0u;
  th.Nr = c[d.K + d.Kp];
  const uint32_t* m = c + d.CH;
  const uint32_t* q = c + 2 * d.CH;
  const Val one{th.isA ? m[t] : 0u, th.isB ? m[d.K + t] : 0u, m[d.K + d.Kp]};
  const Val r2{th.isA ? q[t] : 0u, th.isB ? q[d.K + t] : 0u, q[d.K + d.Kp]};
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
  montmul(x, r2, th, cs, d, sh, invMA_r, invMB_r);
  Val e = one;
  for (int dd = 0; dd < 16; ++dd) {
    if (dd == 1) e = x;
    if (dd >= 2) montmul(e, x, th, cs, d, sh, invMA_r, invMB_r);
    uint32_t* row = sh.tab + dd * d.CH;
    if (th.isA) row[t] = e.a;
    if (th.isB) row[d.K + t] = e.b;
    if (th.isR) row[d.K + d.Kp] = e.r;
  }
  __syncthreads();

  Val acc = one;
  const uint32_t* el = es + (size_t)lane * d.ne2;
  for (int j = 0; j < d.ne2; ++j) {
    const uint32_t word = __ldg(el + (d.ne2 - 1 - j));
    for (int s = 28; s >= 0; s -= 4) {
      for (int k = 0; k < 4; ++k) montmul(acc, acc, th, cs, d, sh, invMA_r, invMB_r);
      const uint32_t dig = (word >> s) & 15u;
      Val sel{0u, 0u, 0u};
      for (int dd = 0; dd < 16; ++dd) {
        const uint32_t msk = dig == (uint32_t)dd ? 0xFFFFFFFFu : 0u;
        const uint32_t* row = sh.tab + dd * d.CH;
        if (th.isA) sel.a |= row[t] & msk;
        if (th.isB) sel.b |= row[d.K + t] & msk;
        sel.r |= row[d.K + d.Kp] & msk;
      }
      montmul(acc, sel, th, cs, d, sh, invMA_r, invMB_r);
    }
  }

  if (!emit_planes) {
    uint32_t* o = out_res + (size_t)lane * d.CH;
    if (th.isA) o[t] = acc.a;
    if (th.isB) o[d.K + t] = acc.b;
    if (th.isR) o[d.K + d.Kp] = acc.r;
    return;
  }
  // decode epilogue: strip MA (multiply by the integer 1), xi = res*invMAk,
  // column sums of xi against the limbs of MA/p_k
  montmul(acc, Val{1u, 1u, 1u}, th, cs, d, sh, invMA_r, invMB_r);
  if (th.isA) sh.xi1[t] = mulmod(acc.a, th.invMAk, th.pa);
  __syncthreads();
  for (int o = t; o < d.Lout; o += blockDim.x) {
    unsigned long long s = 0ull;
    for (int k = 0; k < d.K; ++k)
      s += (unsigned long long)__ldg(cs.Wbin + k * d.Lout + o) * sh.xi1[k];
    out_cols[(size_t)lane * d.Lout + o] = s;
  }
}

}  // namespace

extern "C" int k1_exp(const uint32_t* x, const uint32_t* e, const uint32_t* ctx,
                      int ctx_per_lane, const uint32_t* cst, int B, int K, int Kp,
                      int Lin, int Lout, int ne2, uint32_t invMA_r,
                      uint32_t invMB_r, int emit_planes,
                      unsigned long long* out_cols, uint32_t* out_res,
                      cudaStream_t stream) {
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout, ne2};
  const int threads = ((d.Kp + 1 + 31) / 32) * 32;
  const size_t smem = (size_t)(16 * d.CH + d.K + d.Kp + 1) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      k1_exp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k1_exp_kernel<<<B, threads, smem, stream>>>(x, e, ctx, ctx_per_lane, cst, d, invMA_r,
                                              invMB_r, emit_planes, out_cols, out_res);
  return (int)cudaGetLastError();
}

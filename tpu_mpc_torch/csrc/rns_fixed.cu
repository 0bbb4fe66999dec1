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
// What bounds it on the H100: as K1, the extension products of one multiply
// per window (rns_field.cuh runs them on the tensor cores for a tile of 8
// lanes, W planes shared by the tile), and per window 16 table entries per
// key group (16 x CH x 4 B = 16.8 KB at 2048 bits).
//
// Design: a block takes a tile of 8 lanes.  It stages the 16 entries of the
// current window of the first two key groups of its tile in shared memory,
// one copy per group, with cp.async; the next window's copies run during
// this window's multiply (issued after its first barrier, when every thread
// has taken its entry, and awaited before its last).  The wrapper sorts the
// lanes by group row, so a tile holds one or two groups; a lane of any
// further group reads its entries from L2 (correct, slower).  The digits are
// secret (randomizer exponents, commitment masks), so every lane takes its
// entry with a branch-free masked select over all 16 entries of its group:
// addresses depend on the public group rows and window index only.

#include "rns_field.cuh"

namespace {

using namespace rnsf;

constexpr int MAX_BASES = 4;
constexpr int NSTAGE = 2;   // key groups staged per tile

struct Bases {
  const uint32_t* tab[MAX_BASES];  // [nw_b, 16, G, CH] per base
  int nwin[MAX_BASES];             // windows this call runs for the base
  int woff[MAX_BASES];             // the base's first packed e-word
  int n;
};

// A tile value as [LANES][CH] u32 rows in global memory (K2's chunk products);
// loads bypass L1, since another block wrote them.
__device__ __forceinline__ void val_store(uint32_t* base, const Val& v, const Thr& th,
                                          const Dims& d) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1;
    uint32_t* row = base + (size_t)slot_lane(th.t, s) * d.CH;
    if (th.va[h]) row[th.row[h]] = v.a[s];
    if (th.vb[h] || th.rb[h]) row[d.K + th.row[h]] = v.b[s];
  }
}

__device__ __forceinline__ Val val_load_cg(const uint32_t* base, const Thr& th, const Dims& d) {
  Val v;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int h = s >> 1;
    const uint32_t* row = base + (size_t)slot_lane(th.t, s) * d.CH;
    v.a[s] = th.va[h] ? __ldcg(row + th.row[h]) : 0u;
    v.b[s] = (th.vb[h] || th.rb[h]) ? __ldcg(row + d.K + th.row[h]) : 0u;
  }
  return v;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A staged table row: the 16-byte lines that cover its CH words (a row starts
// 0 or 2 words past a line: CH is even and the tables are 16-byte aligned).
__host__ __device__ inline int stage_row_words(int CH) { return 4 * ((CH + 2 + 3) / 4); }

// Words a table row starts past its 16-byte line.
__device__ __forceinline__ int row_mis(const uint32_t* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

// Copies of one window's 16 entries of the staged groups into `stage`
// [16][NSTAGE][stage_row_words(CH)], 16 bytes a copy (8 for a row's last
// half line).  Thread t copies line k of row r for (r, k) = t, t + nthreads,
// ... in row-major order over 16 * ng rows of R lines.
struct Stager {
  uint32_t* stage;
  const uint32_t* src;   // entry 0 of the window, group row 0
  size_t ent;            // G * CH: entry stride in the table
  uint32_t grp[NSTAGE];
  int ng, CH, R;
  int r0, k0, dr, dk;    // this thread's first (row, line) and its step
  bool active;

  __device__ __forceinline__ void issue() const {
    const int rows = 16 * ng, rw = 4 * R;
    int row = r0, k = k0;
    while (row < rows) {
      const int dd = ng == 2 ? row >> 1 : row, gs = ng == 2 ? row & 1 : 0;
      const uint32_t* a = src + dd * ent + (size_t)grp[gs] * CH;
      const int mis = row_mis(a), w0 = 4 * k, left = mis + CH - w0;
      if (left > 0) {
        uint32_t* dst = stage + (dd * NSTAGE + gs) * rw + w0;
        if (left >= 4)
          cp_async16(dst, a - mis + w0);
        else
          cp_async8(dst, a - mis + w0);
      }
      k += dk;
      row += dr;
      if (k >= R) {
        k -= R;
        ++row;
      }
    }
  }
  __device__ __forceinline__ void after_first_barrier() const {
    if (active) issue();
  }
  __device__ __forceinline__ void before_last_barrier() const {
    if (active) cp_async_wait_all();
  }
};

// Where a lane's 16 entries of this window lie: entry dd at col + dd * stride,
// shifted by (mis + dd * G * CH) mod 4 words if staged (mis >= 0).
struct Pick {
  const uint32_t* col;
  size_t stride;
  int mis;
};

// The entries of the digits of the thread's two lanes (slots 2h and 2h + 1),
// each masked over all 16; `same`: one group, one set of loads.
__device__ __forceinline__ Val select_pair(const Thr& th, const Dims& d, const Pick& p0,
                                           const Pick& p1, bool same, const uint32_t (&dig)[2],
                                           size_t ent) {
  Val y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = th.row[h];
    const bool wa = th.va[h], wb = th.vb[h] || th.rb[h];
    uint32_t a0 = 0u, b0 = 0u, a1 = 0u, b1 = 0u;
#pragma unroll
    for (int dd = 0; dd < 16; ++dd) {
      const uint32_t m0 = dig[0] == (uint32_t)dd ? 0xFFFFFFFFu : 0u;
      const uint32_t m1 = dig[1] == (uint32_t)dd ? 0xFFFFFFFFu : 0u;
      const int dm = (int)((dd * ent) & 3);
      const uint32_t* r0 = p0.col + dd * p0.stride + (p0.mis < 0 ? 0 : (p0.mis + dm) & 3);
      const uint32_t va0 = wa ? r0[r] : 0u, vb0 = wb ? r0[d.K + r] : 0u;
      uint32_t va1 = va0, vb1 = vb0;
      if (!same) {
        const uint32_t* r1 = p1.col + dd * p1.stride + (p1.mis < 0 ? 0 : (p1.mis + dm) & 3);
        va1 = wa ? r1[r] : 0u;
        vb1 = wb ? r1[d.K + r] : 0u;
      }
      a0 |= va0 & m0;
      b0 |= vb0 & m0;
      a1 |= va1 & m1;
      b1 |= vb1 & m1;
    }
    y.a[2 * h] = a0;
    y.b[2 * h] = b0;
    y.a[2 * h + 1] = a1;
    y.b[2 * h + 1] = b1;
  }
  return y;
}

template <int MW, int KTC>
__global__ void __launch_bounds__(MW * 32, 1)
k2_fixed_kernel(const uint32_t* __restrict__ es,    // [B, ne2]
                int ne2,
                const uint32_t* __restrict__ grow,  // [B]
                const uint32_t* __restrict__ ctx,   // [C, 3*CH]
                int ctx_per_lane, const uint32_t* __restrict__ cst,
                const uint8_t* __restrict__ planes, Dims dims, int rk, int G, Bases bs,
                int nsplit, uint32_t* __restrict__ partial, int* __restrict__ ticket,
                uint32_t invMA_r, uint32_t invMB_r,
                unsigned long long* __restrict__ out_cols) {
  const DimsT<KTC> d{dims};
  extern __shared__ __align__(16) uint8_t smem[];
  const Shm sh = carve(smem, d, rk);
  const Cst cs = cst_views(cst, d);
  const int tile = blockIdx.x / nsplit, part = blockIdx.x - tile * nsplit;
  const int lane0 = tile * LANES;
  stage_planes(sh, planes, d, rk);
  const Thr th = thr_init(cs, d, ctx, ctx_per_lane, lane0, invMA_r, invMB_r);

  // the tile's staged groups: its first lane's, then the first that differs
  Stager st;
  st.stage = reinterpret_cast<uint32_t*>(sh.extra);
  st.ent = (size_t)G * d.CH;
  st.CH = d.CH;
  st.R = stage_row_words(d.CH) / 4;
  st.r0 = threadIdx.x / st.R;
  st.k0 = threadIdx.x - st.r0 * st.R;
  st.dr = blockDim.x / st.R;
  st.dk = blockDim.x - st.dr * st.R;
  st.grp[0] = st.grp[1] = __ldg(grow + lane0);
  for (int i = 1; i < LANES; ++i) {
    const uint32_t gi = __ldg(grow + lane0 + i);
    if (gi != st.grp[0]) {
      st.grp[1] = gi;
      break;
    }
  }
  st.ng = st.grp[1] != st.grp[0] ? 2 : 1;
  // per slot: the staged group it reads (-1: its own rows in L2)
  uint32_t gl[2];
  int gs[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    gl[c] = __ldg(grow + lane0 + 2 * th.t + c);
    gs[c] = gl[c] == st.grp[0] ? 0 : (gl[c] == st.grp[1] ? 1 : -1);
  }

  Val acc = ctx_val(th, d, ctx, ctx_per_lane, lane0, 1);   // the Montgomery one
  // this block's chunk of the windows (all bases' windows in one sequence)
  int nw = 0;
  for (int i = 0; i < bs.n; ++i) nw += bs.nwin[i];
  const int chunk = (nw + nsplit - 1) / nsplit;
  int left = min(chunk, nw - part * chunk);
  int b = 0, j = part * chunk;
  while (b < bs.n && j >= bs.nwin[b]) {
    j -= bs.nwin[b];
    ++b;
  }
  if (left > 0) {
    st.src = bs.tab[b] + (size_t)j * 16 * st.ent;
    st.issue();
    cp_async_wait_all();
  }
  __syncthreads();   // planes and the first window staged
  while (left > 0) {
    // this window's entries, masked over all 16; the two lanes of a thread
    // that share a staged group share its loads
    const int rw = stage_row_words(d.CH);
    uint32_t dig[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t word =
          __ldg(es + (size_t)(lane0 + 2 * th.t + c) * ne2 + bs.woff[b] + (j >> 3));
      dig[c] = (word >> (4 * (j & 7))) & 15u;
    }
    Val y;
    if (gs[0] >= 0 && gs[1] >= 0) {   // both staged: shared memory only
      // a staged row keeps its word offset in its 16-byte line, which is
      // (dd * G * CH + g * CH) mod 4 for entry dd (the tables are aligned)
      const Pick p0{st.stage + gs[0] * rw, (size_t)NSTAGE * rw, (int)(((size_t)gl[0] * d.CH) & 3)};
      const Pick p1{st.stage + gs[1] * rw, (size_t)NSTAGE * rw, (int)(((size_t)gl[1] * d.CH) & 3)};
      y = select_pair(th, d, p0, p1, gs[0] == gs[1], dig, st.ent);
    } else {
      const uint32_t* win = bs.tab[b] + (size_t)j * 16 * st.ent;
      Pick p[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        p[c] = gs[c] >= 0 ? Pick{st.stage + gs[c] * rw, (size_t)NSTAGE * rw,
                                 (int)(((size_t)gl[c] * d.CH) & 3)}
                          : Pick{win + (size_t)gl[c] * d.CH, st.ent, -1};
      y = select_pair(th, d, p[0], p[1], false, dig, st.ent);
    }
    // the next window, staged while this one multiplies
    int bn = b, jn = j + 1;
    while (bn < bs.n && jn >= bs.nwin[bn]) {
      ++bn;
      jn = 0;
    }
    --left;
    st.active = left > 0;
    if (st.active) st.src = bs.tab[bn] + (size_t)jn * 16 * st.ent;
    montmul(acc, y, th, d, sh, planes, rk, st);
    b = bn;
    j = jn;
  }
  if (nsplit > 1) {
    // the chunk products of a tile meet in the block that finishes last,
    // which multiplies them in chunk order (the order fixed_plain takes)
    const size_t vals = (size_t)LANES * d.CH;
    val_store(partial + ((size_t)tile * nsplit + part) * vals, acc, th, d);
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) sh.tr[0] = atomicAdd(ticket + tile, 1) == nsplit - 1 ? 1u : 0u;
    __syncthreads();
    if (sh.tr[0] == 0u) return;
    __threadfence();
    acc = val_load_cg(partial + (size_t)tile * nsplit * vals, th, d);
    for (int q = 1; q < nsplit; ++q) {
      const Val y = val_load_cg(partial + ((size_t)tile * nsplit + q) * vals, th, d);
      montmul(acc, y, th, d, sh, planes, rk, NoHook());
    }
  }
  decode_cols(acc, th, cs, d, sh, planes, rk, lane0, out_cols);
}

}  // namespace

// tabs/nwin/woff are host arrays of nbases entries (1 <= nbases <= 4); B is a
// multiple of the lane tile (8); every table is 16-byte aligned.  The windows
// split into nsplit chunks of ceil(total / nsplit), one block each per tile;
// with nsplit > 1, partial holds B * nsplit * CH u32 and ticket B / 8 zeroed
// ints.
extern "C" int k2_fixed(const uint32_t* e, int ne2, const uint32_t* grow,
                        const uint32_t* ctx, int ctx_per_lane, const uint32_t* cst,
                        const uint8_t* planes, int B, int K, int Kp, int Lin, int Lout,
                        int MT, int KT, uint32_t invMA_r, uint32_t invMB_r, int nbases,
                        const unsigned long long* tabs, const int* nwin, const int* woff, int G,
                        int nsplit, uint32_t* partial, int* ticket,
                        unsigned long long* out_cols, cudaStream_t stream) {
  if (nbases < 1 || nbases > MAX_BASES || B % LANES != 0 || MT > MAX_WARPS || nsplit < 1)
    return (int)cudaErrorInvalidValue;
  Bases bs;
  bs.n = nbases;
  for (int b = 0; b < MAX_BASES; ++b) {
    const bool on = b < nbases;
    bs.tab[b] = on ? reinterpret_cast<const uint32_t*>(tabs[b]) : nullptr;
    bs.nwin[b] = on ? nwin[b] : 0;
    bs.woff[b] = on ? woff[b] : 0;
  }
  const Dims d{K, Kp, K + Kp + 1, Lin, Lout, MT, KT};
  const size_t stage_bytes = (size_t)16 * NSTAGE * stage_row_words(d.CH) * sizeof(uint32_t);
  const int rk = resident_ktiles(d, stage_bytes);
  if (rk < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(d, rk, stage_bytes);
  // one instantiation per register budget (9 or 17 warps)
  auto go = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<B / LANES * nsplit, block_threads(d), smem, stream>>>(
        e, ne2, grow, ctx, ctx_per_lane, cst, planes, d, rk, G, bs, nsplit, partial, ticket,
        invMA_r, invMB_r, out_cols);
    return cudaGetLastError();
  };
  // 2048 bits (9 warps, KT = 5) and 4096 bits (17 warps, KT = 9) with fully
  // unrolled k-loops; other widths with KT at run time
  if (small_block(d))
    return (int)(unrolled_kt(d, 5) ? go(k2_fixed_kernel<SMALL_WARPS, 5>)
                                   : go(k2_fixed_kernel<SMALL_WARPS, 0>));
  return (int)(unrolled_kt(d, 9) ? go(k2_fixed_kernel<MAX_WARPS, 9>)
                                 : go(k2_fixed_kernel<MAX_WARPS, 0>));
}

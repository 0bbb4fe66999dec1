#!/usr/bin/env python3
"""Chip smoke test of tpu_mpc_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root; needs one card)
    python3 chip_smoke.py --host-profile   (also prints a cProfile of one pass)

Phases (any failure exits non-zero and prints no result line):
  1. build   every CUDA kernel from tpu_mpc_torch/csrc/ (one nvcc per
             source, all started together) and print the build seconds;
  2. check   every kernel (K1-K5) against its plain PyTorch version on the
             card, exactly (integers: tolerance 0), at the slice's shapes,
             with samples against python pow() and the host EC oracle, and
             time both (CUDA events); K2's table builds are timed too.  K1
             and K2 also at lane counts that are not a multiple of their
             lane tile (1, L - 1, L + 1; 513 for K1), with one modulus per
             lane inside a tile, K2 with three key groups in every tile,
             and K1 at 4096 bits, whose tensor-core planes partly stream
             from L2 (also at 512 lanes with 256-bit exponents, blame's
             shape).  K3 (ns = 2 and 4, an infinity base and k = 0) and
             K4 (bases G and BASE_POINT2, digits 0 and 255 in every lane)
             at lane counts 1, 7, 9, 33, 257; K3 timed at 128, 256 and 512
             lanes, K4 at 256 and 512 for both bases; K5 (lanes with Z = 0
             and with edge Z values, those also against python pow) at 1,
             7, 9, 33, 257, and timed at 256 and 512;
  3. keygen  GG20 keygen (t = 1, n = 3, 2048-bit Paillier) on the card in
             the tables configuration: keygen(16, ...) under SessionRng(0xFACE)
             and keygen(1, ...) under SessionRng(0xBE7C), each held equal,
             field for field, to the JAX package's key file of that seed
             (benches/bench_keys_S16_2048.json, benches/bench_key_2048.json),
             every launch shape of K1-K5 held against its plain version on
             its first call; prints the host prime-search seconds, kernel
             device time, table-build seconds and bytes, launches and ms per
             kernel, and the prime search over worker processes against one;
  4. slice   GG20 2-of-3 signing at 2048-bit Paillier: the S = 1 key of the
             keygen phase (equal to benches/bench_key_2048.json) tiled to
             S = 128 sessions, in both
             configurations (TPU_MPC_TORCH_ENC_TABLES): "tables" (h1/h2 and
             randomizer tables, the default on the card) and "uniform" (no
             tables); one warm-up pass each, then timed passes of
             offline_stage + sign_online in the order uniform, tables,
             tables, uniform.  The first K3/K4/K5 launch at each shape of
             the warm-up passes is held against its plain version on its
             inputs.  Every signature must verify under the
             pure-python ECDSA verifier; every kernel must have been
             launched in each tables pass, every kernel but K2 in each
             uniform pass.  Each timed pass prints K1's device time split by
             operand width (2048-bit N, 4096-bit N^2) and the K3, K4 and
             K5 launches by lane count (and ns).
  5. multitenant  G = 8 key sets of the S = 16 keygen serving S = 128
             sessions interleaved (session s on key group s % 8), tables
             configuration with the tables compressed at 8 key sets behind a
             gmap: K2 over the key's 24 flattened table groups, then one
             warm-up pass, both with every K1-K5 launch shape held against
             its plain version; two timed passes, which must launch all five
             kernels and take the G = 8 batch verification with no
             per-session fallback; every signature verifies under its own
             group's y.
  6. blame   GG20 identifiable aborts on the slice's tables key (S = 128,
             signers [0, 1]): offline_stage with delta_i (step 5), sigma_i
             (step 6) or the committed g_gamma ("decommit") of per-session
             corruption matrices, a clean offline_stage with s_i corrupted
             at sign_online (step 7), and forged phase-6 ECDDH proofs; every
             phase5/6/7_blame list must equal its session's spec, off.ok fail
             exactly in the corrupted sessions, honest sessions verify; every
             K1-K5 launch shape held against its plain version; prints each
             blame function's seconds and the host Paillier open loop's;
  7. gg18    GG18 keygen(16, 1, 3) at 2048 bits (every check, y = (sum u) G,
             every signer pair reconstructs sum u, every launch shape held),
             then GG18 sign at S = 128 on the slice's tables key for the
             signer subsets [0, 1], [1, 2], [0, 2] (one warm-up pass with the
             holds, then one timed pass each): every signature verifies with
             low s; prints the prime-search seconds and sig/s.
Then it prints one JSON line {"kernels": [...]} (launches: the first timed
tables pass of the slice; launches_keygen: the S = 16 keygen;
launches_multitenant: the first timed multi-tenant pass; launches_blame:
the blame phase; launches_gg18: the timed GG18 [0, 1] pass), the card's
name and power limit, and last {"ok": true, "device": {...}}.  It imports
nothing of jax or of the reference package tpu_mpc.
"""

from __future__ import annotations

import json
import math
import os
import random
import subprocess
import sys
import time

S_SESSIONS = 128
K1_LANES = {2048: 512, 4096: 256}   # the slice's K1 batches: S*tp*2 (CRT halves), S*tp*2 (N^2)
EC_LANES = 256                       # S*tp
EC_RAGGED = (1, 7, 9, 33, 257)       # K3/K4/K5 lane counts off their 8-, 16-, 32-lane blocks
K3_TIMED = (128, 256, 512)
K4_TIMED = (256, 512)                # the lane counts of K4 on the main path
K5_TIMED = (256, 512)                # K5 timed here (the main path runs 128 to 1792)
K2_LANES = 256                       # S*tp*(tp-1)
K1_BLAME_LANES = 512                 # S*tp*tp: phase-5 blame's c_A^gamma mod N^2
MSG = 0x1C8AA4E93D8F4D7C9E21B5A7D301F2B8D4E6C0A9F3B5D7E9C1A3B5D7E9F10203
# H100 SXM peaks.  HBM: 3.35 TB/s (NVIDIA's data sheet).  The kernels'
# arithmetic is 32x32-bit integer multiply-adds (IMAD, one each, widening or
# not): 132 SMs x 64 INT32 lanes per clock x 1.98 GHz (the boost clock behind
# the data sheet's 67 TFLOP/s float32 = 132 x 128 x 2 x 1.98 GHz).  A
# widening IMAD counted as one instruction keeps the bound a lower bound.
PEAK_BYTES = 3.35e12
PEAK_IMAD = 132 * 64 * 1.98e9
# K1 and K2 run their extension and decode dots as u8 products on the tensor
# cores: 1979 T int8 operations/s dense (NVIDIA's data sheet) = 989.5 T MAC/s
PEAK_U8_MAC = 1979e12 / 2
# multiply-adds of one secp256k1 field operation on 8 x 32-bit limbs
# (reductions not counted): product, square, multiply by a small constant
FE_MUL, FE_SQ, FE_MULI = 64, 36, 8
RCB_ADD = 12 * FE_MUL + 2 * FE_MULI
RCB_DBL = 6 * FE_MUL + 2 * FE_SQ + FE_MULI
JAC_IO = 2 * FE_MUL + FE_SQ                 # jac_in and jac_out alike
# INT32 operations of one K5 lane as csrc/ec_kernels.cu writes them: 20
# batches of 30 divsteps of 27 operations (masks, adds, shifts) and of the
# two matrix updates (80 multiply-adds: 4 a limb each for t [d, e] and
# t [f, g], 2 for md, me and 6 for p [md, me] on p's nonzero limbs 0, 1, 8);
# then Z^-2 (a square) and the three products of the projection
K5_DIVSTEP_OPS = 20 * (30 * 27 + 80) + FE_SQ + 3 * FE_MUL
# multiply-adds of one K5 lane in the fewest of the designs measured, the
# fixed addition chain for Z^(p-2) (255 squarings and 15 products), then
# Z^-2 and the projection: K5's bound
K5_CHAIN_OPS = 256 * FE_SQ + 18 * FE_MUL


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    """A failed check fails the run (not an assert: it must survive -O)."""
    if not ok:
        raise RuntimeError(msg)


def _events_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _bound(nbytes: float, imads: float, u8_macs: float = 0.0):
    """Least time (ms) for `nbytes` moved once, `imads` INT32 multiply-adds
    and `u8_macs` u8 tensor-core multiply-adds: the largest of the three.
    Bytes count each value at the width it needs: 16-bit limbs and residues
    2 B, digits and signs 1 B, exponent words and K1's constants 4 B, the
    tensor-core planes 1 B, K1's column sums 8 B."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = max(imads / PEAK_IMAD, u8_macs / PEAK_U8_MAC) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _rns_work(par, mm: int, lanes: int, prologue: bool):
    """(u8 MACs, IMADs, IMAD-only count) of `mm` RNS Montgomery multiplies
    plus the decode (and K1's prologue) on `lanes` lanes.  A multiply is two
    extension products, K (Kp+1) + Kp (K+1) entries, each 4 u8 chunk
    products on the tensor cores; the decode is K Lout entries.  Channel
    work: 3 products on each A-channel, 4 on each B-channel and 3 on the r
    channel, each one multiply-add plus a Barrett reduction (2), and the
    three-reduction fold of every extension output (6 per channel).  The
    IMAD-only count runs the dots as IMADs beside 7 CH channel products, as
    the one-lane-per-block kernels did: the row's imad_bound_ms, which
    compares with the bounds recorded for those."""
    K, Kp, CH = par.K, par.Kp, par.CH
    ext = K * (Kp + 1) + Kp * (K + 1)
    u8 = lanes * 4 * (mm * ext + K * par.Lout)
    chan = 3 * (3 * K + 4 * Kp + 3) + 6 * (K + Kp)
    imad = lanes * (mm * chan + (par.Lin * (K + Kp) + 4 * (K + Kp) if prologue else 0)
                    + 3 * K)
    old = lanes * (mm * (ext + 7 * CH) + (par.Lin * (K + Kp) if prologue else 0)
                   + K * par.Lout)
    return u8, imad, old


def _maxerr(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def _k1_bound(par, lanes, ne2, x, e, rows, dev):
    """K1's bound (ms, by) and its IMAD-only bound (ms) for one launch."""
    from tpu_mpc_torch.core import pallas_rns as pr

    # Montgomery multiplies: x*R^2, 14 table entries, 8 windows of 4
    # squarings + 1 multiply per e-word, the decode's *1
    mm = 1 + 14 + ne2 * 8 * 5 + 1
    u8, imad, old = _rns_work(par, mm, lanes, prologue=True)
    cs = pr.dev_consts(par, dev)
    nbytes = (2 * (x.numel() + rows.numel()) + 4 * e.numel() + 4 * cs["flat32"].numel()
              + cs["planes"].numel() + 8 * lanes * par.Lout)
    bms, bby = _bound(nbytes, imad, u8)
    return bms, bby, _bound(nbytes, old)[0]


def check_k1(dev, rnd):
    """K1 at the slice's shapes: 512 lanes at 2048 bits and 256 lanes at 4096
    bits (whose planes do not all fit in shared memory: the streamed path),
    one modulus for all lanes or one per lane, decode columns or residues for
    the axis-0 fold; exact against exp_plain, samples against python pow.
    Then ragged lane counts (1, L - 1, L + 1, 513) with one modulus per lane
    inside every tile.  Times both widths."""
    import numpy as np
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    worst, entry = 0, None
    for bits in (2048, 4096):
        par = RnsParams(bits)
        for per_lane in (False, True):
            for reduce in (False, True):
                lanes, ebits = K1_LANES[bits], 2048
                # reduce with per-lane moduli: S = 2 rows of `rest` distinct moduli
                S, rest = (2, lanes // 2) if (reduce and per_lane) else (lanes, 1)
                nmods = (rest if reduce else lanes) if per_lane else 1
                ns = _odd_moduli(rnd, bits, nmods, par)
                n_arr = np.asarray(ns, dtype=object)
                n_b = np.broadcast_to(n_arr, (S, rest)) if (per_lane and reduce) else \
                    np.broadcast_to(n_arr, (lanes,))
                flat_n = n_b.reshape(-1)
                base = np.asarray([rnd.getrandbits(bits) % int(v) for v in flat_n], dtype=object)
                expo = np.asarray([rnd.getrandbits(ebits) for _ in range(lanes)], dtype=object)
                expo[0] = 0
                ctx = RnsCtx.from_ints(n_arr, bits, dev)
                x = torch.as_tensor(batch_to_limbs(base, par.Lin), device=dev)
                e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(ebits))),
                                    device=dev)
                rows = ctx.rows.reshape(-1, ctx.rows.shape[-1])
                if per_lane and reduce:
                    rows = rows.repeat(S, 1).contiguous()      # row s*rest + j = modulus j
                emit = not reduce
                out_k = pr.exp_call(x, e, rows, bits, emit_planes=emit)
                out_p = pr.exp_plain(x, e, rows, bits, emit_planes=emit)
                torch.cuda.synchronize()
                err = _maxerr(out_k, out_p)
                worst = max(worst, err)
                if err:
                    raise AssertionError(f"K1 {bits}b per_lane={per_lane} reduce={reduce}: "
                                         f"kernel != plain (max |diff| {err})")
                if reduce:
                    cols = pr._finish_reduce(out_k, rows, bits, lanes, S)
                    got = RnsLazy((cols,), (1, rest), n_b[:1].reshape(1, rest), par.MA).ints()
                    for j in range(min(rest, 8)):
                        m = int(n_b.reshape(S, rest)[0, j])
                        want = 1
                        for s in range(S):
                            i = s * rest + j
                            want = want * pow(int(base[i]), int(expo[i]), m) % m
                        require(int(got[0, j]) == want, "K1 reduce_axis0 != pow product")
                else:
                    got = RnsLazy((out_k[:8],), (8,), flat_n[:8], par.MA).ints()
                    for i in range(8):
                        want = pow(int(base[i]), int(expo[i]), int(flat_n[i]))
                        require(int(got[i]) == want, "K1 != python pow")
                line = f"K1 {bits}b lanes={lanes} per_lane={per_lane} reduce={reduce}: exact"
                if per_lane and not reduce:
                    ms = _events_ms(lambda: pr.exp_call(x, e, rows, bits, emit), 3)
                    pms = _events_ms(lambda: pr.exp_plain(x, e, rows, bits, emit), 1)
                    bms, bby, ims = _k1_bound(par, lanes, e.shape[1], x, e, rows, dev)
                    line += (f"; kernel {ms:.3f} ms, plain {pms:.1f} ms, bound {bms:.4f} ms "
                             f"({bby}), IMAD bound {ims:.4f} ms")
                    if bits == 2048:
                        entry = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                     imad_bound_ms=ims,
                                     shape=f"{lanes} lanes, {bits}-bit moduli (one per lane), "
                                           f"{ebits}-bit exponents")
                    else:
                        entry.update(ms_4096=ms, plain_ms_4096=pms, bound_ms_4096=bms,
                                     imad_bound_ms_4096=ims)
                log(line)
    # ragged lane counts, one modulus per lane, both emit modes
    par = RnsParams(2048)
    L = pr.LANE_TILE
    for B in (1, L - 1, L + 1, 513):
        ns = np.asarray(_odd_moduli(rnd, 2048, B, par), dtype=object)
        base = np.asarray([rnd.getrandbits(2048) % int(v) for v in ns], dtype=object)
        expo = np.asarray([rnd.getrandbits(256) for _ in range(B)], dtype=object)
        x = torch.as_tensor(batch_to_limbs(base, par.Lin), device=dev)
        e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(256))), device=dev)
        rows = RnsCtx.from_ints(ns, 2048, dev).rows
        for emit in (True, False):
            out_k = pr.exp_call(x, e, rows, 2048, emit_planes=emit)
            out_p = pr.exp_plain(x, e, rows, 2048, emit_planes=emit)
            torch.cuda.synchronize()
            err = _maxerr(out_k, out_p)
            worst = max(worst, err)
            require(err == 0 and out_k.shape == out_p.shape,
                    f"K1 ragged B={B} emit={emit}: kernel != plain (max |diff| {err})")
        got = RnsLazy((pr.exp_call(x, e, rows, 2048),), (B,), ns, par.MA).ints()
        for i in sorted({0, B - 1, B // 2}):
            require(int(got[i]) == pow(int(base[i]), int(expo[i]), int(ns[i])),
                    f"K1 ragged B={B} lane {i} != python pow")
        log(f"K1 2048b ragged lanes={B} (tile {L}), one modulus per lane: exact")
    # the shape GG20 blame adds: c_A^gamma mod N^2 over [S, tp, tp] = 512
    # lanes at S = 128, 4096-bit moduli, 256-bit exponents; one modulus per lane
    bits, B = 4096, K1_BLAME_LANES
    par = RnsParams(bits)
    ns = np.asarray(_odd_moduli(rnd, bits, B, par), dtype=object)
    base = np.asarray([rnd.getrandbits(bits) % int(v) for v in ns], dtype=object)
    expo = np.asarray([rnd.getrandbits(256) for _ in range(B)], dtype=object)
    expo[0] = 0
    x = torch.as_tensor(batch_to_limbs(base, par.Lin), device=dev)
    e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(256))), device=dev)
    rows = RnsCtx.from_ints(ns, bits, dev).rows
    for emit in (True, False):
        out_k = pr.exp_call(x, e, rows, bits, emit_planes=emit)
        out_p = pr.exp_plain(x, e, rows, bits, emit_planes=emit)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0 and out_k.shape == out_p.shape,
                f"K1 {bits}b lanes={B} 256-bit exponents emit={emit}: kernel != plain "
                f"(max |diff| {err})")
    got = RnsLazy((pr.exp_call(x, e, rows, bits),), (B,), ns, par.MA).ints()
    for i in (0, 1, 7, 8, 255, 256, 510, 511):
        require(int(got[i]) == pow(int(base[i]), int(expo[i]), int(ns[i])),
                f"K1 {bits}b lanes={B} 256-bit exponents: lane {i} != python pow")
    ms = _events_ms(lambda: pr.exp_call(x, e, rows, bits, True), 3)
    pms = _events_ms(lambda: pr.exp_plain(x, e, rows, bits, True), 1)
    bms, bby, ims = _k1_bound(par, B, e.shape[1], x, e, rows, dev)
    entry.update(ms_4096_e256=ms, plain_ms_4096_e256=pms, bound_ms_4096_e256=bms,
                 imad_bound_ms_4096_e256=ims)
    log(f"K1 {bits}b lanes={B} (one modulus per lane) 256-bit exponents, the blame shape: exact "
        f"against plain and python pow; kernel {ms:.3f} ms, plain {pms:.1f} ms, bound "
        f"{bms:.4f} ms ({bby}), IMAD bound {ims:.4f} ms")
    entry["max_abs_err"] = worst
    return entry


def _odd_moduli(rnd, bits, n, par):
    out = []
    while len(out) < n:
        v = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
        if math.gcd(v, par.MA * par.MB) == 1:
            out.append(v)
    return out


def check_k2(dev, rnd):
    """K2 at the slice's shapes, exact against fixed_plain, samples against
    python pow().  Cases: (a) 2048-bit h1/h2 pair, 256 lanes = S*tp*(tp-1),
    group rows from the party batch [1, 2, 1], exponent classes (776, 3104)
    of alice_prove's w commitment; (b) 4096-bit h mod N^2 at the randomizer
    width (2112 -> class 2320), 256 lanes over two keys; (c) an explicit
    gmap: 256 lanes over G = 3 groups of a 2048-bit g table at the folded
    response width (class 2576).  Also times the table builds."""
    import numpy as np
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.modctx import ModCtx, ebits_class
    from tpu_mpc_torch.core.rns import RnsLazy, RnsParams

    lanes = K2_LANES
    cases = []
    builds = {}
    # (a) h1/h2 of two parties, the [S, alice, peer] call against tables [1, 2, 1]
    par = RnsParams(2048)
    nt = np.asarray(_odd_moduli(rnd, 2048, 2, par), dtype=object)
    h = np.asarray([[rnd.getrandbits(2048) % int(n) for n in nt] for _ in range(2)], dtype=object)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tabs = ModCtx.from_ints(nt, 2048, dev).make_tables_rns(h, 768 + 2048 + 16 + 160)
    torch.cuda.synchronize()
    builds["h1/h2 2048-bit, 2 bases x 2 keys"] = time.perf_counter() - t0
    S = lanes // 2
    e1 = np.asarray([[rnd.getrandbits(768) for _ in range(2)] for _ in range(S)], dtype=object)
    e2 = np.asarray([[rnd.getrandbits(2816) for _ in range(2)] for _ in range(S)], dtype=object)
    ctx = ModCtx.from_ints(nt.reshape(1, 2, 1), 2048, dev)     # the [S, alice, peer] batch
    cases.append(("h1h2", 2048, ctx, [t.reshape(t.shape[0], 16, 1, 2, 1, -1) for t in tabs],
                  [e1[:, :, None], e2[:, :, None]], (776, 3104), None,
                  lambda i, j: (h[0, j], h[1, j], nt[j])))
    # (b) h mod N^2 of two keys, randomizer width
    par4 = RnsParams(4096)
    nn = np.asarray(_odd_moduli(rnd, 4096, 2, par4), dtype=object)
    ctx4 = ModCtx.from_ints(nn, 4096, dev)
    hb = np.asarray([[rnd.getrandbits(4096) % int(n) for n in nn]], dtype=object)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab4 = ctx4.make_tables_rns(hb, 2048 + 64 + 256 + 8)
    torch.cuda.synchronize()
    builds["h mod N^2 4096-bit, 1 base x 2 keys"] = time.perf_counter() - t0
    et = np.asarray([[rnd.getrandbits(2112) for _ in range(2)] for _ in range(S)], dtype=object)
    cases.append(("h4096", 4096, ctx4, tab4, [et], (ebits_class(2112),), None,
                  lambda i, j: (hb[0, j], None, nn[j])))
    # (c) g tables of three keys behind an explicit gmap
    ng = np.asarray(_odd_moduli(rnd, 2048, 3, par), dtype=object)
    gb = np.asarray([[rnd.getrandbits(2048) % int(n) for n in ng]], dtype=object)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tabg = ModCtx.from_ints(ng, 2048, dev).make_tables_rns(gb, 2048 + 64 + 256 + 8)
    torch.cuda.synchronize()
    builds["g 2048-bit, 1 base x 3 keys"] = time.perf_counter() - t0
    # the card's build (one squaring step replayed as a CUDA graph) equals
    # the CPU's eager build residue for residue
    ref = ModCtx.from_ints(ng, 2048, "cpu").make_tables_rns(gb, 2048 + 64 + 256 + 8)[0]
    require(torch.equal(tabg[0].cpu(), ref), "K2 table built on the card != CPU build")
    gmap = np.asarray([rnd.randrange(3) for _ in range(lanes)])
    ctxg = ModCtx.from_ints(ng[gmap], 2048, dev)
    eg = np.asarray([rnd.getrandbits(2376) for _ in range(lanes)], dtype=object)
    cases.append(("gmap", 2048, ctxg, tabg, [eg], (ebits_class(2376),), gmap,
                  lambda i, j: (gb[0, gmap[i]], None, ng[gmap[i]])))

    worst, entry = 0, None
    for name, bits, mc, T, exps, ebs, gm, ref in cases:
        par = RnsParams(bits)
        # the wrapper's inputs, exactly as fixed_prod_dispatch builds them
        # (lanes sorted by group row)
        cap = {}
        real = pr.fixed_call
        pr.fixed_call = lambda *a: cap.setdefault("a", a) and real(*a)
        try:
            lz = pr.fixed_prod_dispatch(mc.rns_ctx(), mc.n_ints, T, exps, list(ebs), bits,
                                        gmap=gm)
        finally:
            pr.fixed_call = real
        args = cap["a"]
        e, grow, rows, tabs_k, nwins, woffs, _ = args
        out_k = pr.fixed_call(*args)
        out_p = pr.fixed_plain(*args)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0, f"K2 {name}: kernel != plain (max |diff| {err})")
        got = lz.ints().reshape(-1)
        flat = [np.broadcast_to(x, lz.shape).reshape(-1) for x in exps]
        for i in range(8):
            j = i % 2
            b1, b2, m = ref(i // 2 if name != "gmap" else i, j)
            want = pow(int(b1), int(flat[0][i]), int(m))
            if b2 is not None:
                want = want * pow(int(b2), int(flat[1][i]), int(m)) % int(m)
            require(int(got[i]) == want, f"K2 {name} lane {i} != python pow")
        ms = _events_ms(lambda: pr.fixed_call(*args), 3)
        pms = _events_ms(lambda: pr.fixed_plain(*args), 1)
        B = e.shape[0]
        mm = sum(nwins) + 1                    # one multiply per window, the decode's *1
        u8, imad, old = _rns_work(par, mm, B, prologue=False)
        # table entries this run's digits touch (per base: window, digit, group)
        touched = 0
        for t_, nwin, woff in zip(tabs_k, nwins, woffs):
            j = torch.arange(nwin, device=dev)
            dig = (e[:, woff + j // 8] >> (4 * (j % 8))) & 15
            key = (j * 16 + dig) * t_.shape[2] + grow[:, None]
            touched += int(torch.unique(key).numel())
        cs = pr.dev_consts(par, dev)
        nbytes = (2 * touched * par.CH + 2 * rows.numel() + 4 * e.numel() + 4 * grow.numel()
                  + 4 * cs["flat32"].numel() + cs["planes"].numel() + 8 * B * par.Lout)
        bms, bby = _bound(nbytes, imad, u8)
        ims = _bound(nbytes, old)[0]
        log(f"K2 {name} {bits}b lanes={B} windows={nwins}: exact; kernel {ms:.3f} ms, "
            f"plain {pms:.1f} ms, bound {bms:.4f} ms ({bby}), IMAD bound {ims:.4f} ms")
        if name == "h1h2":
            entry = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, imad_bound_ms=ims,
                         shape=f"{B} lanes, 2048-bit h1/h2 pair, exponent classes "
                               f"{ebs[0]} + {ebs[1]}, G = 2")
        else:
            entry[f"ms_{name}"] = ms
        if name != "h1h2":
            # the lanes in the caller's order, which mixes group rows inside
            # every tile (gmap: two groups staged, a third read from L2; h4096:
            # two keys, at 4096 bits), and ragged lane counts
            L = pr.LANE_TILE
            g_caller = gm if gm is not None else \
                np.broadcast_to(np.arange(T[0].shape[2]), (S, T[0].shape[2])).reshape(-1)
            inv = torch.as_tensor(np.argsort(np.argsort(g_caller, kind="stable")), device=dev)
            for B2 in (B, 1, L - 1, L + 1):
                sub = inv[:B2]
                a2 = (e[sub], grow[sub], rows[sub] if rows.shape[0] > 1 else rows, tabs_k,
                      nwins, woffs, bits)
                out_k = pr.fixed_call(*a2)
                out_p = pr.fixed_plain(*a2)
                torch.cuda.synchronize()
                err = _maxerr(out_k, out_p)
                worst = max(worst, err)
                require(err == 0 and out_k.shape == out_p.shape,
                        f"K2 {name} unsorted lanes={B2}: kernel != plain (max |diff| {err})")
            log(f"K2 {name}, lanes in the caller's order (mixed groups in a tile of {L}), "
                f"lanes {B}, 1, {L - 1}, {L + 1}: exact")
    worst = max(worst, _check_k2_three_groups_4096(dev, rnd))
    for k, v in builds.items():
        log(f"K2 table build {k}: {v:.2f} s")
    entry["max_abs_err"] = worst
    return entry


def _check_k2_three_groups_4096(dev, rnd) -> int:
    """K2 at 4096 bits (17 warps, part of the planes read from L2) with three
    key groups interleaved in every tile, so that the third group's entries
    come from L2; one modulus per lane, ragged lane counts; exact against
    fixed_plain and python pow.  Returns the largest |diff| (0)."""
    import numpy as np
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    bits, G, ebits = 4096, 3, 64
    par = RnsParams(bits)
    ns = np.asarray(_odd_moduli(rnd, bits, G, par), dtype=object)
    hb = np.asarray([[rnd.getrandbits(bits) % int(n) for n in ns]], dtype=object)
    T = ModCtx.from_ints(ns, bits, dev).make_tables_rns(hb, ebits)[0]
    L = pr.LANE_TILE
    worst = 0
    for B in (L - 1, L + 1, 3 * L + 1):
        gmap = np.asarray([(7 * i + i // 3) % G for i in range(B)])
        expo = np.asarray([rnd.getrandbits(ebits) for _ in range(B)], dtype=object)
        e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(ebits))), device=dev)
        grow = torch.as_tensor(gmap, device=dev)
        rows = RnsCtx.from_ints(ns[gmap], bits, dev).rows
        args = (e, grow, rows, [T], [ebits // 4], [0], bits)
        out_k = pr.fixed_call(*args)
        out_p = pr.fixed_plain(*args)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0 and out_k.shape == out_p.shape,
                f"K2 4096b three groups lanes={B}: kernel != plain (max |diff| {err})")
        got = RnsLazy((out_k,), (B,), ns[gmap], par.MA).ints()
        for i in sorted({0, 1, 2, B - 1}):
            want = pow(int(hb[0, gmap[i]]), int(expo[i]), int(ns[gmap[i]]))
            require(int(got[i]) == want, f"K2 4096b three groups lane {i} != python pow")
    log(f"K2 4096b, three key groups in every tile of {L}, lanes {L - 1}, {L + 1}, "
        f"{3 * L + 1}: exact")
    return worst


def _rand_points(dev, rnd, B):
    """B canonical Jacobian points with Z != 1 (plain comb on the card)."""
    import numpy as np
    import torch

    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    ks = np.asarray([rnd.randrange(1, hec.N) for _ in range(B)], dtype=object)
    out = pe.comb_plain(pe._comb_digits(ec.sc_from_ints(ks, dev)),
                        pe._comb8_for(hec.G, dev)[0])
    return out, ks


def check_ec(dev, rnd):
    import numpy as np
    import torch

    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    B = EC_LANES
    # multiply-adds per lane: per base jac_in and a 14-add table; 33 windows
    # of 4 doublings, ns additions and ns/2 beta multiplies; jac_out
    imad_k3 = lambda ns, n: n * ((ns // 2) * (JAC_IO + 14 * RCB_ADD)
                                 + 33 * (4 * RCB_DBL + ns * RCB_ADD + (ns // 2) * FE_MUL)
                                 + JAC_IO)
    res = {}
    # K3, ns = 2 and 4: lane 0 an infinity base, lane 1 k = 0; exact at lane
    # counts that are not a multiple of the 8-lane block and at the timed
    # counts (128, 256, 512)
    nmax = max(K3_TIMED)
    pts, pk = _rand_points(dev, rnd, 2 * nmax)
    ks = [rnd.randrange(ec.Q_INT) for _ in range(2 * nmax)]
    ks[1] = 0
    pts[0, 0], pts[0, 1], pts[0, 2] = 0, 0, 0
    pts[0, 0, 0] = pts[0, 1, 0] = 1                     # lane 0: infinity base
    k = ec.sc_from_ints(np.asarray(ks, dtype=object), dev)
    worst = 0
    for ns in (2, 4):
        for n in sorted(set(EC_RAGGED + K3_TIMED)):
            if ns == 2:
                DG, NEG = pe._glv_prep(k[:n])
                P = pts[:n, None]
            else:
                DGa, NEGa = pe._glv_prep(k[:n])
                DGb, NEGb = pe._glv_prep(k[nmax:nmax + n])
                DG, NEG = torch.cat([DGa, DGb], 1), torch.cat([NEGa, NEGb], 1)
                P = torch.stack([pts[:n], pts[nmax:nmax + n]], 1)
            out_k = pe.ladder_call(P, DG, NEG)
            out_p = pe.ladder_plain(P, DG, NEG)
            torch.cuda.synchronize()
            err = _maxerr(out_k, out_p)
            worst = max(worst, err)
            require(err == 0 and out_k.shape == out_p.shape,
                    f"K3 ns={ns} lanes={n}: kernel != plain (max |diff| {err})")
            if n not in K3_TIMED:
                continue
            ms = _events_ms(lambda: pe.ladder_call(P, DG, NEG), 3)
            bms, bby = _bound(2 * (P.numel() + n * 48) + DG.numel() + NEG.numel(),
                              imad_k3(ns, n))
            if n != B:
                log(f"K3 ns={ns} lanes={n}: exact; kernel {ms:.3f} ms, bound {bms:.5f} ms")
                continue
            got = ec.points_to_host_list(ec._from_rows(out_k[:8], (8,)))
            for i in range(8):
                a = None if i == 0 else hec.mul(int(pk[i]))
                want = hec.mul(ks[i], a) if a is not None else None
                if ns == 4:
                    want = hec.add(want, hec.mul(ks[nmax + i], hec.mul(int(pk[nmax + i]))))
                require(got[i] == want, f"K3 ns={ns} lane {i} != host oracle")
            pms = _events_ms(lambda: pe.ladder_plain(P, DG, NEG), 1)
            log(f"K3 ns={ns} lanes={n}: exact; kernel {ms:.3f} ms, plain {pms:.1f} ms, "
                f"bound {bms:.5f} ms")
            if ns == 2:
                res["K3"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                 shape=f"{n} lanes, ns=2 (scalar_mul)")
            else:
                res["K3"].update(ms_ns4=ms, plain_ms_ns4=pms, bound_ms_ns4=bms)
        log(f"K3 ns={ns} lanes {', '.join(map(str, EC_RAGGED))}: exact (infinity base, k = 0)")
    res["K3"]["max_abs_err"] = worst
    # K4 for G and BASE_POINT2: lane 0 k = 0 (every digit 0), lane 1 k = 1,
    # digits 0 and 255 in two windows of every other lane
    worst = 0
    for base, name in ((hec.G, "G"), (hec.BASE_POINT2, "BASE_POINT2")):
        tab, planes = pe._comb8_for(base, dev)
        for n in sorted(set(EC_RAGGED + K4_TIMED)):
            kk = [rnd.randrange(ec.Q_INT) for _ in range(n)]
            kk[:2] = [0, 1][:n]
            dg = pe._comb_digits(ec.sc_from_ints(np.asarray(kk, dtype=object), dev))
            lane = torch.arange(min(2, n), n, device=dev)
            dg[lane, lane % 32] = 0
            dg[lane, (lane + 7) % 32] = 255
            out_k = pe.comb_call(dg, tab, planes)
            out_p = pe.comb_plain(dg, tab)
            torch.cuda.synchronize()
            err = _maxerr(out_k, out_p)
            worst = max(worst, err)
            require(err == 0 and out_k.shape == out_p.shape,
                    f"K4 {name} lanes={n}: kernel != plain (max |diff| {err})")
            if n not in K4_TIMED:
                continue
            got = ec.points_to_host_list(ec._from_rows(out_k[:4], (4,)))
            want = [hec.mul(int.from_bytes(bytes(dg[i].to(torch.uint8).cpu().tolist()),
                                           "little"), base) for i in range(4)]
            require(got[0] is None and got == want, f"K4 {name} lanes={n} != host oracle")
            ms = _events_ms(lambda: pe.comb_call(dg, tab, planes), 3)
            pms = _events_ms(lambda: pe.comb_plain(dg, tab), 1)
            # the table entries these digits touch, 64 B each (x, y)
            touched = int(torch.unique(dg + 256 * torch.arange(32, device=dev)).numel())
            bms, bby = _bound(dg.numel() + 2 * n * 48 + 64 * touched,
                              n * (32 * RCB_ADD + JAC_IO))
            log(f"K4 {name} lanes={n}: exact; kernel {ms:.3f} ms, plain {pms:.1f} ms, "
                f"bound {bms:.5f} ms")
            if n != B:
                continue
            if name == "G":
                res["K4"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                 shape=f"{n} lanes, base G")
            else:
                res["K4"].update(ms_bp2=ms, plain_ms_bp2=pms, bound_ms_bp2=bms)
        log(f"K4 {name} lanes {', '.join(map(str, EC_RAGGED))}: exact (k = 0, k = 1, "
            f"digits 0 and 255 in every other lane)")
    res["K4"]["max_abs_err"] = worst
    # K5: lane 0 the infinity base (Z = 0), lane 3 Z = 0 with X, Y of a point,
    # lane 2 a real point (host oracle), lanes 4.. the edge Z values
    # (pe.Z_EDGE, with the X, Y of real points); exact at lane counts off the
    # 32-lane block and at K5_TIMED, where it is timed.  Every K5 shape of the
    # main path (128 to 1792 lanes) is held in run_slice's first warm-up pass.
    worst = 0
    P = hec.P
    zedge = pe.Z_EDGE
    limbs = lambda v: torch.as_tensor([(v >> (16 * i)) & 0xFFFF for i in range(16)],
                                      dtype=torch.int64, device=dev)
    as_int = lambda t: int.from_bytes(t.cpu().numpy().astype("<u2").tobytes(), "little")
    for n in sorted(set(EC_RAGGED + K5_TIMED)):
        P5 = pts[:n].clone()
        if n > 3:
            P5[3, 2] = 0
        for j, z in enumerate(zedge[:max(0, n - 4)]):
            P5[4 + j, 2] = limbs(z)
        out_k = pe.affine_call(P5)
        out_p = pe.affine_plain(P5)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0 and out_k.shape == out_p.shape,
                f"K5 lanes={n}: kernel != plain (max |diff| {err})")
        for j in (j for j in (0, 3, *range(4, 4 + len(zedge))) if j < n):
            zi = pow(as_int(P5[j, 2]) or 1, -1, P)
            want = (as_int(P5[j, 0]) * zi * zi % P, as_int(P5[j, 1]) * zi ** 3 % P)
            require((as_int(out_k[j, 0]), as_int(out_k[j, 1])) == want,
                    f"K5 lanes={n} lane {j} != python pow")
        if n not in K5_TIMED:
            continue
        x, y, inf = pe.affine(ec.Point(P5[:, 0], P5[:, 1], P5[:, 2]))
        require(bool(inf[0]) and bool(inf[3]) and not bool(inf[2]), "K5 infinity flags wrong")
        require((as_int(x[2]), as_int(y[2])) == hec.mul(int(pk[2])), "K5 != host oracle")
        ms = _events_ms(lambda: pe.affine_call(P5), 3)
        pms = _events_ms(lambda: pe.affine_plain(P5), 1)
        nbytes = 2 * n * (48 + 32)
        bms, bby = _bound(nbytes, n * K5_CHAIN_OPS)
        # the divstep kernel's own INT32 operations (K5_DIVSTEP_OPS)
        dms = _bound(nbytes, n * K5_DIVSTEP_OPS)[0]
        log(f"K5 lanes={n}: exact (Z = 0 and edge Z lanes); kernel {ms:.4f} ms, plain "
            f"{pms:.1f} ms, bound {bms:.5f} ms, divstep bound {dms:.5f} ms")
        if n == B:
            res["K5"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                             bound_ms_divstep=dms, shape=f"{n} lanes")
        else:
            res["K5"].update({f"ms_{n}": ms, f"plain_ms_{n}": pms, f"bound_ms_{n}": bms})
    log(f"K5 lanes {', '.join(map(str, EC_RAGGED))}: exact (Z = 0, edge Z)")
    res["K5"]["max_abs_err"] = worst
    return res


# --------------------------------------------------------------------------
# instrumentation of the main paths: holds against the plain versions, and
# CUDA events around every kernel call
# --------------------------------------------------------------------------

ENC_ENV = "TPU_MPC_TORCH_ENC_TABLES"
CONFIGS = {"uniform": "0", "tables": "1"}     # the value of ENC_ENV per configuration


def _wrappers():
    """kernel -> (module, wrapper name, plain version taking the same args)."""
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.ec import pallas_ec as pe

    return {"K1": (pr, "exp_call", pr.exp_plain), "K2": (pr, "fixed_call", pr.fixed_plain),
            "K3": (pe, "ladder_call", pe.ladder_plain),
            "K4": (pe, "comb_call", lambda *a: pe.comb_plain(*a[:2])),
            "K5": (pe, "affine_call", pe.affine_plain)}


def launch_shape(name, a, kw) -> str:
    """The launch shape of a wrapper call's inputs."""
    if name == "K1":
        emit = kw.get("emit_planes", a[4] if len(a) > 4 else True)
        return (f"K1 {a[3]}b lanes={a[0].shape[0]} exp_bits={32 * a[1].shape[1]} "
                f"moduli={a[2].shape[0]} {'cols' if emit else 'residues'}")
    if name == "K2":
        return (f"K2 {a[6]}b lanes={a[0].shape[0]} groups={a[3][0].shape[2]} "
                f"windows={'+'.join(map(str, a[4]))}")
    if name == "K3":
        return f"K3 ns={2 * a[0].shape[1]} lanes={a[0].shape[0]}"
    return f"{name} lanes={a[0].shape[0]}"


class Instrument:
    """Patches the kernel wrappers for the life of a `with` block.

    hold: the kernels whose first call at each launch shape not yet in
    `held` is held exactly against the plain version on the same inputs
    (the hold runs outside the events).  Every call of every kernel is
    counted by shape in `by_shape` and timed by CUDA events on the stream
    around the kernel call (no extra synchronisation): `spans[K]`, and K1
    also by width under "K1 <bits>b"."""

    def __init__(self, held: set, hold=()):
        self.held, self.hold = held, set(hold)
        self.spans, self.by_shape, self.new_holds = {}, {}, []

    def _wrap(self, name, fn, plain):
        import torch

        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.spans.setdefault(name, []).append(ev)
            shape = launch_shape(name, a, kw)
            if name == "K1":
                self.spans.setdefault(f"K1 {a[3]}b", []).append(ev)
            self.by_shape[shape] = self.by_shape.get(shape, 0) + 1
            if name in self.hold and shape not in self.held:
                want = plain(*a, **kw)
                err = _maxerr(out, want)
                require(err == 0 and out.shape == want.shape,
                        f"{shape} on a main path: kernel != plain (max |diff| {err})")
                self.held.add(shape)
                self.new_holds.append(shape)
            return out
        return run

    def __enter__(self):
        self.saved = []
        for name, (mod, attr, plain) in _wrappers().items():
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, fn, plain))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)
        return False

    def busy(self) -> dict:
        """Device ms per kernel (and K1 per width); call after a sync."""
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.spans.items()}


class _Timed:
    """Patches mod.attr for the life of a `with` block and accumulates its
    calls' host seconds (sync: the device's work inside them too)."""

    def __init__(self, mod, attr, sync: bool = False):
        self.mod, self.attr, self.fn, self.sync = mod, attr, getattr(mod, attr), sync
        self.secs, self.calls = 0.0, 0

    def __enter__(self):
        import torch

        def run(*a, **kw):
            if self.sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                if self.sync:
                    torch.cuda.synchronize()
                self.secs += time.perf_counter() - t
                self.calls += 1
        setattr(self.mod, self.attr, run)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)
        return False


def _kernel_summary(inst, launches) -> str:
    busy = inst.busy()
    per = {k: round(busy.get(k, 0.0), 3) for k in launches}
    k1w = {k: round(v, 3) for k, v in sorted(busy.items()) if k.startswith("K1 ")}
    return (f"kernel device time (ms) {json.dumps(per)}, sum {sum(per.values()):.1f} ms; "
            f"K1 by width {json.dumps(k1w)}; launches {json.dumps(launches)}")


# --------------------------------------------------------------------------
# phase 3: keygen
# --------------------------------------------------------------------------

PAILLIER_BITS = 2048
KEYGEN_RUNS = ((16, 0xFACE, "bench_keys_S16_2048.json"), (1, 0xBE7C, "bench_key_2048.json"))
PRIME_POOL_COUNT = 16        # 1024-bit primes timed serially and over the worker processes


def _material(key) -> dict:
    """A port key's plain-int material, in the form of benches/bench_key_2048.json."""
    from tpu_mpc_torch.ec import secp256k1 as ec

    ints = lambda a: [[int(v) for v in row] for row in a]
    return {"S": key.S, "t": key.t, "n": key.n, "bits": key.paillier_bits,
            "p": ints(key.p), "q": ints(key.q), "nt": ints(key.dlog_stmt.ctx.n_ints),
            "h1": ints(key.dlog_stmt.h1), "h2": ints(key.dlog_stmt.h2),
            "u": ints(key.u), "x": ints(key.x),
            "y_i": ec.points_to_host_list(key.y_i),
            "vss": ec.points_to_host_list(key.vss.commitments)}


def _key_diff(key, d) -> list:
    """The fields of `key` that differ from the committed key file `d`."""
    import numpy as np

    from tpu_mpc_torch.protocols.gg20 import batch as gg20

    m = _material(key)
    bad = [f for f in ("p", "q", "nt", "h1", "h2", "u", "x")
           if not np.array_equal(gg20._ints(m[f]), gg20._ints(d[f]))]
    bad += [f for f in ("y_i", "vss") if m[f] != gg20._tuplify(d[f])]
    if int(d.get("S", 1)) != key.S or int(d["t"]) != key.t or int(d["n"]) != key.n:
        bad.append("S/t/n")
    return bad


def run_keygen(dev, repo):
    """GG20 keygen on the card in the tables configuration, every K1-K5
    launch shape held against its plain version on its first call: keygen(16,
    1, 3) under SessionRng(0xFACE), then keygen(1, 1, 3) under
    SessionRng(0xBE7C), each held equal, field for field, to the JAX
    package's committed key file of that seed.  Kernel counts are set to 0
    just before each keygen and read just after.  Returns (S = 16 result,
    S = 1 key's material, the S = 16 keygen's launches)."""
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.host import primes
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk.range_proofs import DlogStatementBatch, PaillierCtxBatch

    os.environ[ENC_ENV] = "1"
    held, out = set(), []
    for S, seed, fname in KEYGEN_RUNS:
        with open(os.path.join(repo, "benches", fname)) as f:
            d = json.load(f)
        require(int(d["seed"]) == seed, f"keygen: {fname} is not the key of seed {seed:#x}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        with _Timed(gg20, "gen_paillier_batch") as primes_t, \
                _Timed(DlogStatementBatch, "ensure_tables", sync=True) as tab_h, \
                _Timed(PaillierCtxBatch, "ensure_enc_tables", sync=True) as tab_enc, \
                Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
            t0 = time.perf_counter()
            res = gg20.keygen(S, 1, 3, SessionRng(seed), PAILLIER_BITS, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        secs = {"primes": primes_t.secs, "tables": tab_h.secs + tab_enc.secs}
        launches = dict(kernels.LAUNCHES)
        key = res.key
        require(res.ok.all() and not res.bad_actors.any(),
                f"keygen S={S}: a check failed: bad actors {res.bad_actors.tolist()}")
        diff = _key_diff(key, d)
        require(not diff, f"keygen S={S}: fields differ from benches/{fname}: {diff}")
        missing = [k for k in ("K1", "K3", "K4", "K5") if launches[k] == 0]
        require(not missing, f"keygen S={S}: kernels not launched: {missing}")
        tabs = list(key.dlog_stmt.tables_rns) + [key.ek.enc_tab_g, key.ek.enc_tab_h]
        nbytes = sum(t.numel() * t.element_size() for t in tabs)
        busy = inst.busy()
        dev_s = sum(v for k, v in busy.items() if not k.startswith("K1 ")) / 1e3
        log(f"keygen S={S} (seed {seed:#x}, t=1, n=3, {PAILLIER_BITS}-bit Paillier): res.ok all true "
            f"({S} of {S}); p, q, nt, h1, h2, u, x, y_i, vss equal benches/{fname}; "
            f"wall {dt:.2f} s (the plain holds included), host prime search {secs['primes']:.2f} s "
            f"({4 * S * 3} primes of {PAILLIER_BITS // 2} bits), kernel device time {dev_s:.3f} s, table "
            f"builds {secs['tables']:.2f} s for {nbytes / 1e9:.3f} GB "
            f"({len(tabs)} tables over {3 * S} (key set, party) slots)")
        log(f"keygen S={S}: " + _kernel_summary(inst, launches))
        log(f"keygen S={S}: launch shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; "
            f"held against plain in this keygen: {', '.join(inst.new_holds)}")
        out.append((res, launches))
    # the prime search over worker processes against one process, same seeds
    for workers in (1, None):
        t = time.perf_counter()
        got = primes.gen_primes_parallel(1024, PRIME_POOL_COUNT, random.Random(0x9E1),
                                         workers=workers)
        dtp = time.perf_counter() - t
        if workers == 1:
            serial = got
        require(got == serial, "prime search: worker processes changed the primes")
        log(f"prime search: {PRIME_POOL_COUNT} primes of 1024 bits in {dtp:.2f} s with "
            f"{'1 process' if workers == 1 else f'{os.cpu_count()} worker processes'}")
    return out[0][0], _material(out[1][0].key), out[0][1]


# --------------------------------------------------------------------------
# phase 4: the slice
# --------------------------------------------------------------------------

def run_slice(dev, material, host_profile: bool = False):
    """Both configurations of the slice at S = 128 on the key of the keygen
    phase (keygen(1, 1, 3) under SessionRng(0xBE7C), equal to
    benches/bench_key_2048.json): load each key set (the tables one builds
    its h1/h2 and randomizer tables), one warm-up pass each (the first
    K3/K4/K5 call at each shape held exactly against its plain version),
    then timed passes in the order uniform, tables, tables, uniform.  Kernel
    counts are set to 0 just before each timed pass and read just after it;
    the tables passes must launch all five kernels, the uniform ones every
    kernel but K2."""
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng

    keys, rngs = {}, {}
    for cfg, flag in CONFIGS.items():
        os.environ[ENC_ENV] = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        key1 = gg20.key_from_material(material, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require((key1.dlog_stmt.tables_rns is not None) == (flag == "1")
                and (key1.ek.enc_tab_h is not None) == (flag == "1"),
                f"slice[{cfg}]: the key's tables do not match the configuration")
        keys[cfg] = gg20.tile_key(key1, S_SESSIONS)
        rngs[cfg] = SessionRng(0xC41B)
        log(f"slice[{cfg}]: the keygen's bench key loaded in {dt:.2f} s"
            + (" (h1/h2 and randomizer tables built)" if flag == "1" else "")
            + f", tiled to S={S_SESSIONS}")

    def one_pass(cfg):
        os.environ[ENC_ENV] = CONFIGS[cfg]
        t = time.perf_counter()
        off = gg20.offline_stage(keys[cfg], [0, 1], rngs[cfg])
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t
        sig = gg20.sign_online(off, MSG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        require(off.ok.all(), f"slice[{cfg}]: offline stage failed: {off.debug_masks}")
        require(sig.sig_valid.all() and sig.ok.all(), f"slice[{cfg}]: a signature failed")
        return dt, t_off

    # warm-up passes: the first K3/K4/K5 call at each shape of the main path
    # is held exactly against its plain version on that call's inputs
    held = set()
    for cfg in CONFIGS:
        with Instrument(held, hold=("K3", "K4", "K5")):
            dt, t_off = one_pass(cfg)
        log(f"slice[{cfg}]: warm-up pass {dt:.2f} s (offline {t_off:.2f} s), "
            f"{S_SESSIONS} signatures verify; K3/K4/K5 exact against plain at the main "
            f"path's shapes so far: {', '.join(sorted(held))}")

    runs = []
    for cfg in ("uniform", "tables", "tables", "uniform"):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Instrument(held) as inst:
            dt, t_off = one_pass(cfg)
        launches = dict(kernels.LAUNCHES)
        busy = inst.busy()
        tot = sum(busy.get(k, 0.0) for k in launches)
        ec_shapes = {k: v for k, v in inst.by_shape.items() if k[:2] in ("K3", "K4", "K5")}
        runs.append((cfg, launches, busy, dt))
        log(f"slice[{cfg}]: timed pass {dt:.2f} s (offline {t_off:.2f} s, online "
            f"{dt - t_off:.2f} s), {S_SESSIONS / dt:.2f} sig/s, all {S_SESSIONS} signatures "
            f"verify; " + _kernel_summary(inst, launches)
            + f" ({100 * tot / (dt * 1e3):.1f}% of the pass); K3/K4/K5 launches by shape "
            + json.dumps(dict(sorted(ec_shapes.items()))))
        want = [k for k in launches if cfg == "tables" or k != "K2"]
        missing = [k for k in want if launches[k] == 0]
        require(not missing, f"slice[{cfg}]: kernels not launched on the main path: {missing}")
        require(cfg == "tables" or launches["K2"] == 0, "slice[uniform]: K2 was launched")
        require(set(ec_shapes) <= held, f"slice[{cfg}]: K3/K4/K5 shapes never held against "
                f"plain: {sorted(set(ec_shapes) - held)}")
    for cfg in CONFIGS:
        rates = [S_SESSIONS / dt for c, _, _, dt in runs if c == cfg]
        log(f"slice[{cfg}]: sig/s over its two timed passes " + ", ".join(f"{r:.2f}" for r in rates))
    if host_profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        one_pass("tables")
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(30)
        log("slice[tables]: host profile of one more pass (cProfile, by own time)\n"
            + buf.getvalue())
    # the main path is the tables configuration: its first timed pass
    return next(r[1] for r in runs if r[0] == "tables"), keys["tables"]


# --------------------------------------------------------------------------
# phase 5: multi-tenant signing
# --------------------------------------------------------------------------

MT_GROUPS = 8


def run_multitenant(dev, res16):
    """G = 8 key groups of the S = 16 keygen serving S = 128 sessions
    interleaved (session s on group s % 8, R = 16), tables configuration:
    the tables stay compressed at the 8 key sets behind a gmap.  First K2
    over the key's 24 flattened table groups (8 key sets x 3 parties), then
    one warm-up pass, both with every K1-K5 launch shape held against its
    plain version on its first call; then two timed passes, kernel counts
    set to 0 just before each and read just after.  Each pass must launch
    all five kernels and take the G = 8 batch verification with no
    per-session fallback; every signature must verify under its own group's
    y."""
    import numpy as np
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import batch_verify as bv

    os.environ[ENC_ENV] = "1"
    G, S = MT_GROUPS, S_SESSIONS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    keyG = gg20.take_key_sets(res16.key, G)
    key = gg20.repeat_key(keyG, S)
    torch.cuda.synchronize()
    log(f"multitenant: first {G} key sets of the S=16 keygen, repeated to S={S} "
        f"(R={S // G}) in {time.perf_counter() - t0:.2f} s; h1/h2 tables "
        f"{tuple(key.dlog_stmt.tables_rns[0].shape)}, gmap period {key.dlog_stmt.n_groups}")
    held = set()
    # K2 over the key's own tables: 24 flattened groups, every party of every session
    rnd = random.Random(0x24)
    stmt = key.dlog_stmt
    # the exponent widths of alice_prove's w commitment (classes 776 and 3104)
    n, eb2 = key.n, 768 + key.paillier_bits + 16 + 160
    e1 = np.asarray([[rnd.getrandbits(776) for _ in range(n)] for _ in range(S)], dtype=object)
    e2 = np.asarray([[rnd.getrandbits(eb2) for _ in range(n)] for _ in range(S)], dtype=object)
    with Instrument(held, hold=("K2",)) as inst:
        got = stmt.pow_h1h2(e1, e2, (776, eb2))
    require(any(f"groups={G * n} " in k for k in inst.by_shape),
            f"multitenant: K2 did not run over {G * n} groups: {list(inst.by_shape)}")
    for s, i in ((0, 0), (1, n - 1), (G + 1, 1), (S - 1, n - 1)):
        g, nt = s % G, int(keyG.dlog_stmt.ctx.n_ints[s % G, i])
        want = pow(int(keyG.dlog_stmt.h1[g, i]), int(e1[s, i]), nt) * \
            pow(int(keyG.dlog_stmt.h2[g, i]), int(e2[s, i]), nt) % nt
        require(int(got[s, i]) == want, f"multitenant: K2 over 24 groups != python pow at {s, i}")
    log(f"multitenant: K2 over the key's {G * n} flattened groups exact against plain and "
        f"python pow: {', '.join(inst.new_holds)}")

    rng = SessionRng(0x6B05)
    y_host = ec.points_to_host_list(keyG.y)

    def one_pass(check_y):
        bv.reset_stats()
        t = time.perf_counter()
        off = gg20.offline_stage(key, [0, 1], rng)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t
        sig = gg20.sign_online(off, MSG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        require(off.ok.all(), f"multitenant: offline stage failed: {off.debug_masks}")
        require(sig.sig_valid.all() and sig.ok.all(), "multitenant: a signature failed")
        stats = {"grouped": dict(bv.STATS["grouped"]), "per_session": bv.STATS["per_session"]}
        require(stats == {"grouped": {G: 2}, "per_session": 0},
                f"multitenant: batch verification did not take the G={G} reduction: {stats}")
        if check_y:
            for s in range(S):
                require(hec.ecdsa_verify(y_host[s % G], MSG % hec.N, int(sig.r[s]),
                                         int(sig.s[s])),
                        f"multitenant: session {s} does not verify under group {s % G}'s y")
        return dt, t_off, stats

    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
        dt, t_off, stats = one_pass(True)
    log(f"multitenant: warm-up pass {dt:.2f} s (offline {t_off:.2f} s); all {S} signatures "
        f"verify under their own group's y; batch verification {json.dumps(stats)}; "
        f"held against plain: {', '.join(inst.new_holds)}")
    first = None
    for i in range(2):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Instrument(held) as inst:
            dt, t_off, stats = one_pass(i == 1)
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in launches if launches[k] == 0]
        require(not missing, f"multitenant: kernels not launched: {missing}")
        require(set(inst.by_shape) <= held, f"multitenant: launch shapes never held against "
                f"plain: {sorted(set(inst.by_shape) - held)}")
        k2 = {k: v for k, v in inst.by_shape.items() if k.startswith("K2")}
        log(f"multitenant: timed pass {dt:.2f} s (offline {t_off:.2f} s, online "
            f"{dt - t_off:.2f} s), {S / dt:.2f} sig/s, G={G}, all {S} signatures verify; "
            f"batch verification {json.dumps(stats)}; " + _kernel_summary(inst, launches)
            + f"; K2 launches by shape {json.dumps(dict(sorted(k2.items())))}")
        first = first or launches
    return first


# --------------------------------------------------------------------------
# phase 6: identifiable aborts (blame)
# --------------------------------------------------------------------------

BLAME_PATTERNS = {5: [[], [0], [1], [0, 1]], 6: [[], [0], [1], [0, 1]],
                  "decommit": [[], [0], [1]], 7: [[], [0], [1], [0, 1]]}


def _spec(step, S) -> list:
    """Session b's corrupted signer slots: pattern b % len of its step."""
    pat = BLAME_PATTERNS[step]
    return [pat[b % len(pat)] for b in range(S)]


def run_blame(dev, key, held: set):
    """GG20 identifiable aborts on the slice's tables key (S = 128, signers
    [0, 1]): one offline_stage per corruption step (5, 6, "decommit"), each
    with a per-session matrix (session b on pattern b % 4 of [[], [0], [1],
    [0, 1]], b % 3 of [[], [0], [1]] for "decommit"), then its blame; a clean
    offline_stage, sign_online with s_i doubled on the b % 4 matrix and
    phase-7 blame; phase-6 blame of forged local proofs (sigma_0 doubled in
    the sessions with b % 4 == 1).  Every blame list must equal its
    session's spec (honest sessions []), off.ok must fail exactly in the
    corrupted sessions, honest step-7 sessions must verify, every K1-K5
    launch shape is held against its plain version on its first call, and
    all five kernels must launch.  Kernel counts are set to 0 just before
    the phase and read just after."""
    import dataclasses

    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.host import paillier as hp
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.protocols.gg20 import blame
    from tpu_mpc_torch.utils.rng import SessionRng

    os.environ[ENC_ENV] = "1"
    S = key.S
    rng = SessionRng(0xB1A3)
    secs = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(time.perf_counter() - t, 3)
        return out

    def offline(step):
        corrupt = None if step is None else {"step": step, "parties": _spec(step, S)}
        off = timed(f"offline_stage[{step}]", gg20.offline_stage, key, [0, 1], rng,
                    corrupt=corrupt)
        want = [True] * S if step is None else [not p for p in corrupt["parties"]]
        require([bool(v) for v in off.ok] == want,
                f"blame[{step}]: off.ok is not False exactly in the corrupted sessions")
        return off

    def gate(name, got, want):
        require(got == want, f"blame: {name} lists differ from the spec: "
                f"{[(b, g, w) for b, (g, w) in enumerate(zip(got, want)) if g != w][:4]}")

    torch.cuda.synchronize()
    kernels.reset_launches()
    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
        off = offline(5)
        gate("phase5_blame[5]", timed("phase5_blame[5]", blame.phase5_blame, key, off),
             _spec(5, S))
        off = offline(6)
        with _Timed(hp, "open") as opens:
            got = timed("phase6_blame[6]", blame.phase6_blame, key, off, rng)
        gate("phase6_blame[6]", got, _spec(6, S))
        off = offline("decommit")
        gate("phase5_blame[decommit]",
             timed("phase5_blame[decommit]", blame.phase5_blame, key, off), _spec("decommit", S))
        off = offline(None)
        gate("phase5_blame[clean]", timed("phase5_blame[clean]", blame.phase5_blame, key, off),
             [[]] * S)
        sig = timed("sign_online[7]", gg20.sign_online, off, MSG,
                    corrupt={"step": 7, "parties": _spec(7, S)})
        require([bool(v) for v in sig.sig_valid] == [not p for p in _spec(7, S)],
                "blame[7]: the honest sessions must verify and the corrupted ones fail")
        gate("phase7_blame", timed("phase7_blame", blame.phase7_blame, off, sig.s_i, MSG),
             _spec(7, S))
        forged = dataclasses.replace(off)
        forged.sigma_i = off.sigma_i.copy()
        for b in range(1, S, 4):
            forged.sigma_i[b, 0] = int(off.sigma_i[b, 0]) * 2 % hec.N
        proofs = timed("phase6_local_proofs[forged]", blame.phase6_local_proofs, forged, rng)
        with _Timed(hp, "open") as opens2:
            got = timed("phase6_blame[forged]", blame.phase6_blame, key, off, rng,
                        ecddh_proofs=proofs)
        gate("phase6_blame[forged]", got, [[0] if b % 4 == 1 else [] for b in range(S)])
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in launches if launches[k] == 0]
    require(not missing, f"blame: kernels not launched: {missing}")
    log(f"blame: S={S}, signers [0, 1], tables; every blame list equals its session's spec "
        f"(steps 5, 6, decommit, 7 and forged phase-6 proofs; honest sessions []), off.ok "
        f"False exactly in the corrupted sessions, honest step-7 sessions verify; seconds "
        f"{json.dumps(secs)}")
    log(f"blame: phase6_blame's host Paillier open loop ({opens.calls} opens at "
        f"{key.paillier_bits} bits, pure python): {opens.secs:.2f} s of "
        f"{secs['phase6_blame[6]']:.2f} s; forged run {opens2.calls} opens {opens2.secs:.2f} s "
        f"of {secs['phase6_blame[forged]']:.2f} s")
    log("blame: " + _kernel_summary(inst, launches))
    log(f"blame: launch shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; held "
        f"against plain in this phase: {', '.join(inst.new_holds)}")
    return launches


# --------------------------------------------------------------------------
# phase 7: GG18
# --------------------------------------------------------------------------

GG18_KEYGEN = (16, 0x6618)          # S, SessionRng seed
GG18_SUBSETS = ([0, 1], [1, 2], [0, 2])


def run_gg18(dev, key, held: set):
    """GG18 on the card.  keygen(16, 1, 3, SessionRng(0x6618), 2048): every
    check passes, y = (sum u) G and the x shares of every signer pair
    reconstruct sum u, every launch shape held against its plain version.
    Then sign at S = 128 on the slice's tiled tables key (GG18's sign reads
    S, t, x, ek, dk and y of it, which a GG20 key has): one warm-up pass
    ([0, 1], every launch shape held), then one timed pass per subset [0, 1],
    [1, 2], [0, 2], kernel counts set to 0 just before each and read just
    after; each must launch all five kernels, every signature must verify
    with low s and sig.ok.  Returns the launches of the timed [0, 1] pass."""
    import numpy as np
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg18 import batch as gg18
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.vss import feldman

    os.environ[ENC_ENV] = "1"
    S_kg, seed = GG18_KEYGEN
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst, \
            _Timed(gg18, "gen_paillier_batch") as primes_t:
        t0 = time.perf_counter()
        res = gg18.keygen(S_kg, 1, 3, SessionRng(seed), PAILLIER_BITS, device=dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    kg_launches = dict(kernels.LAUNCHES)
    require(res.ok.all() and not res.bad_actors.any(),
            f"gg18 keygen: a check failed: bad actors {res.bad_actors.tolist()}")
    kg = res.key
    y = ec.points_to_host_list(kg.y)
    for b in range(S_kg):
        total = sum(int(v) for v in kg.u[b]) % hec.N
        require(y[b] == hec.mul(total), f"gg18 keygen: y != (sum u) G in key set {b}")
        for pair in GG18_SUBSETS:
            require(feldman.reconstruct(pair, [int(kg.x[b, j]) for j in pair]) == total,
                    f"gg18 keygen: x shares of {pair} do not reconstruct sum u in key set {b}")
    missing = [k for k in ("K1", "K3", "K4", "K5") if kg_launches[k] == 0]
    require(not missing, f"gg18 keygen: kernels not launched: {missing}")
    busy = inst.busy()
    dev_s = sum(v for k, v in busy.items() if not k.startswith("K1 ")) / 1e3
    log(f"gg18 keygen S={S_kg} (seed {seed:#x}, t=1, n=3, {PAILLIER_BITS}-bit Paillier): res.ok "
        f"all true, y = (sum u) G and every signer pair's x shares reconstruct sum u; wall "
        f"{dt:.2f} s (the plain holds included), host prime search {primes_t.secs:.2f} s "
        f"({2 * S_kg * 3} primes of {PAILLIER_BITS // 2} bits), kernel device time {dev_s:.3f} s")
    log("gg18 keygen: " + _kernel_summary(inst, kg_launches))
    log(f"gg18 keygen: launch shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; held "
        f"against plain: {', '.join(inst.new_holds)}")

    S = key.S
    rng = SessionRng(0x618)

    def one_pass(subset):
        t = time.perf_counter()
        sig = gg18.sign(key, subset, MSG, rng)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        # sig_valid: every signature checked by the pure-python ECDSA verifier under y
        require(bool(np.asarray(sig.ok).all()) and sig.sig_valid.all(),
                f"gg18 sign {subset}: a check or a signature failed")
        require(all(int(v) <= hec.N // 2 for v in sig.s), f"gg18 sign {subset}: a high s")
        return dt

    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
        dt = one_pass(GG18_SUBSETS[0])
    log(f"gg18 sign: warm-up pass {dt:.2f} s, S={S}; held against plain: "
        f"{', '.join(inst.new_holds)}")
    first = None
    for subset in GG18_SUBSETS:
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Instrument(held) as inst:
            dt = one_pass(subset)
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in launches if launches[k] == 0]
        require(not missing, f"gg18 sign {subset}: kernels not launched: {missing}")
        require(set(inst.by_shape) <= held, f"gg18 sign {subset}: launch shapes never held "
                f"against plain: {sorted(set(inst.by_shape) - held)}")
        log(f"gg18 sign {subset}: timed pass {dt:.2f} s, {S / dt:.2f} sig/s, S={S}, all {S} "
            f"signatures verify with low s, sig.ok all true; " + _kernel_summary(inst, launches))
        first = first or launches
    return first


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else "nvidia-smi unavailable"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from tpu_mpc_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: the tpu_mpc_torch package is missing beside this script: {exc}",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = kernels.build_all()
    log(f"build: {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(one nvcc per source, in parallel)")
    for name, (_, blog) in sorted(built.items()):
        # ptxas -v: per kernel, "Function properties" then the register line
        for line in blog.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    for name in kernels.SOURCES:
        kernels.lib(name)

    rnd = random.Random(20261016)
    t0 = time.perf_counter()
    k1 = check_k1(dev, rnd)
    k2 = check_k2(dev, rnd)
    ec_res = check_ec(dev, rnd)
    log(f"check: every kernel equals its plain version in {time.perf_counter() - t0:.1f} s")

    res16, material, kg_launches = run_keygen(dev, repo)
    launches, key128 = run_slice(dev, material, host_profile="--host-profile" in sys.argv[1:])
    mt_launches = run_multitenant(dev, res16)
    held = set()
    blame_launches = run_blame(dev, key128, held)
    gg18_launches = run_gg18(dev, key128, held)

    src = {"K1": ("tpu_mpc_torch/csrc/rns_exp.cu",
                  "tpu_mpc/core/pallas_rns.py:371 (_exp_kernel)"),
           "K2": ("tpu_mpc_torch/csrc/rns_fixed.cu",
                  "tpu_mpc/core/pallas_rns.py:483 (_fixed_kernel)"),
           "K3": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:329 (_ladder_kernel)"),
           "K4": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:411 (_comb_kernel)"),
           "K5": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:477 (_affine_kernel)")}
    rows = []
    for name, r in (("K1", k1), ("K2", k2), ("K3", ec_res["K3"]), ("K4", ec_res["K4"]),
                    ("K5", ec_res["K5"])):
        rows.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "launches_keygen": kg_launches[name], "launches_multitenant": mt_launches[name],
            "launches_blame": blame_launches[name], "launches_gg18": gg18_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "imad_bound_ms": r.get("imad_bound_ms", r["bound_ms"]), "library_ms": None,
            **{k: v for k, v in r.items() if k.startswith(("ms_", "plain_ms_", "bound_ms_",
                                                           "imad_bound_ms_"))},
            "shape": r["shape"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

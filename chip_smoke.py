#!/usr/bin/env python3
"""Chip smoke test of tpu_mpc_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root; needs one card)
    python3 chip_smoke.py --host-profile   (also prints a cProfile of one S = 128
                                            tables pass and of each S = 4096 pass)

Phases (any failure exits non-zero and prints no result line):
  1. build   every CUDA kernel from tpu_mpc_torch/csrc/ (one nvcc per
             source, all started together) and print the build seconds;
  2. native  the native host layer (tpu_mpc_torch/native/): prints the g++
             version, the build seconds and the paths of libgmp, libcrypto
             and the two libraries; seeded 1024-bit primes (2 seeds) and
             512-bit safe primes (2 seeds), each equal to its plain python
             draw; two unseeded 1024-bit primes that pass
             is_probable_prime; host_mulmod and host_prod_axis0 at the
             S = 4096 shapes (2048- and 4096-bit moduli, 2 and 4 operands,
             4096 lanes) on GMP, plus a negative operand and 31 lanes on the
             python loop, each equal to the python loop (the GMP call split
             into packing, call and unpacking); ecdsa_verify_batch
             (OpenSSL) on 4096 signatures of one key and the edge cases of
             tests/gpu/test_torch_verify.py, equal to
             ecdsa_verify_batch_plain.  Both times of each;
  3. check   every kernel (K1-K5) against its plain PyTorch version on the
             card, exactly (integers: tolerance 0), at the slice's shapes,
             with samples against python pow() and the host EC oracle, and
             time both (CUDA events); K2's table builds are timed too.  K1
             and K2 also at lane counts that are not a multiple of their
             lane tile (1, L - 1, L + 1; 513 for K1), with one modulus per
             lane inside a tile, K2 with three key groups in every tile
             (and at 2048 bits with 5 and 8 groups a call in the caller's
             lane order, up to 8 groups in a tile), and K1 at 4096 bits,
             whose tensor-core planes partly stream from L2 (also at 512
             lanes with 256-bit exponents, blame's shape, and the two-party
             shapes: 5120 lanes with 2048-bit
             exponents, range_proof_ni's stacked encryptions, more than one
             wave of blocks; 64 lanes with 256-bit exponents, Lindell'17
             sign's c_key^v).  K3 (ns = 2 and 4, an infinity base and k = 0) and
             K4 (bases G and BASE_POINT2, digits 0 and 255 in every lane)
             at lane counts 1, 7, 9, 33, 257; K3 timed at 128, 256 and 512
             lanes, K4 at 256 and 512 for both bases; K5 (lanes with Z = 0
             and with edge Z values, those also against python pow) at 1,
             7, 9, 33, 257, and timed at 256 and 512;
  4. keygen  GG20 keygen (t = 1, n = 3, 2048-bit Paillier) on the card in
             the tables configuration: keygen(16, ...) under SessionRng(0xFACE)
             and keygen(1, ...) under SessionRng(0xBE7C), each held equal,
             field for field, to the JAX package's key file of that seed
             (benches/bench_keys_S16_2048.json, benches/bench_key_2048.json),
             every launch shape of K1-K5 held against its plain version on
             its first call; prints the host prime-search seconds, kernel
             device time, table-build seconds and bytes, launches and ms per
             kernel, and the prime search over worker processes against one;
  5. slice   GG20 2-of-3 signing at 2048-bit Paillier: the S = 1 key of the
             keygen phase (equal to benches/bench_key_2048.json) tiled to
             S = 128 sessions, in both
             configurations (TPU_MPC_TORCH_ENC_TABLES): "tables" (h1/h2 and
             randomizer tables, the default on the card) and "uniform" (no
             tables); one warm-up pass each, then one timed pass of
             offline_stage + sign_online each, uniform then tables.  The
             first K3/K4/K5 launch at each shape of
             the warm-up passes is held against its plain version on its
             inputs.  Every signature must verify under the batched
             verifier (host/ec.py:ecdsa_verify_batch); every kernel must
             have been launched in each tables pass, every kernel but K2 in
             each uniform pass.  Each timed pass prints K1's device time
             split by operand width (2048-bit N, 4096-bit N^2) and the K3,
             K4 and K5 launches by lane count (and ns).  Then the first
             timed tables pass's signatures and as many tampered cases (s+1,
             m+1, r+1, a None key, a key off the curve, an (x + P, y) alias)
             through ecdsa_verify_batch (OpenSSL), ecdsa_verify_batch_plain
             and ecdsa_verify: equal answers but on the off-curve keys,
             which the batch verifiers reject; prints the host times.  Then
             one more tables pass with the launch log
             on (TPU_MPC_TORCH_PROFILE=1) from a fresh SessionRng: (r, s,
             recid) equal to the tables warm-up pass, only the reference's
             kinds logged, the TOTAL count equal to the rows; prints
             profile_summary().
  6. scale   the same key tiled to S = 4096 sessions, bench.py's default S,
             one pass in each of bench.py:main's configurations under
             SessionRng(SCALE_SEED): "tables" (the default: tables, batch
             verification on) and "refexact" (TPU_MPC_TORCH_BATCH_VERIFY=0,
             TPU_MPC_TORCH_ENC_TABLES=0: every proof verified on its own,
             uniform randomizers; no batched check may run, K2 may not
             launch).  Every offline check holds, all 4096 signatures pass
             ecdsa_verify_batch and 64 of them ecdsa_verify; the first launch
             at each shape keeps 64 lanes (the first and the last 8, the rest
             spread), which are held after the pass against python: K1 and K2
             against pow() and products of pow(), K3 and K4 against the host
             EC, K5 against python's inverse (the plain versions are far too
             slow at these shapes).  Prints each pass's seconds, sig/s,
             kernel ms and launches, launch shapes, each shape's ms and
             bound, and peak card memory, beside the card's name and limit.
  7. multitenant  G = 8 key sets of the S = 16 keygen serving S = 128
             sessions interleaved (session s on key group s % 8), tables
             configuration with the tables compressed at 8 key sets behind a
             gmap: K2 over the key's 24 flattened table groups, then one
             warm-up pass, both with every K1-K5 launch shape held against
             its plain version; one timed pass, which must launch all five
             kernels and take the G = 8 batch verification with no
             per-session fallback; every signature of the warm-up pass
             verifies under its own group's y.
  8. blame   GG20 identifiable aborts on the slice's tables key (S = 8,
             signers [0, 1]): offline_stage with delta_i (step 5), sigma_i
             (step 6) or the committed g_gamma ("decommit") of per-session
             corruption matrices, a clean offline_stage with s_i corrupted
             at sign_online (step 7), and forged phase-6 ECDDH proofs; every
             phase5/6/7_blame list must equal its session's spec, off.ok fail
             exactly in the corrupted sessions, honest sessions verify; every
             K1-K5 launch shape held against its plain version; prints each
             blame function's seconds and the host Paillier open loop's;
  9. quorum  GG20 with more than two signers at 2048-bit Paillier and N~:
             keygen(1, 2, 5) and keygen(1, 4, 8) under fixed seeds (res.ok,
             no bad actors), then one timed tables pass of the n = 5 key
             with signers [0, 2, 3, 4] at S = 512 and of the n = 8 key with
             signers [0, 1, 2, 4, 6, 7] at S = 256, and one uniform pass of
             the n = 5 quorum at S = 128 (no K2): every offline check, every
             signature through ecdsa_verify_batch; prints each pass's
             seconds, sig/s, kernel ms and launches by kernel and shape,
             each shape's bound and peak card memory; then n = 5 blame on
             the tables key at S = 2 (steps 5 and 6 on [[0], [0, 3]], step
             7 on [[1, 3], []]), every list equal to its spec.  The first
             launch at each shape of each run keeps up to 64 lanes, held
             after the phase against the kernel's plain version;
 10. gg18    GG18 keygen(16, 1, 3) at 2048 bits (every check, y = (sum u) G,
             every signer subset reconstructs sum u, every launch shape
             held), then GG18 sign at S = 128 on the slice's tables key for
             the signer subsets [0, 1], [1, 2], [0, 2] and [0, 1, 2] (a
             warm-up pass with the holds for two and for three signers, then
             one timed pass each): every signature verifies with low s;
             prints the prime-search seconds and sig/s.
 11. lindell17  Lindell'17 two-party ECDSA at S = 64 sessions, 2048-bit
             Paillier and N~, each session its own key (no tables, no K2):
             keygen (every ok, y = (x1 x2) G), sign of MSG_2P (a warm-up
             pass with the holds, a timed pass; every signature verifies
             with low s), the MtA conversion (alpha + beta = x1 x2),
             refresh (pubkey unchanged) and sign again, the interactive PDL
             with its range proof (honest sessions accept, x = q - 5 is
             rejected); every launch shape held against its plain version;
             prints keygen's prime search, kernel and other seconds, sig/s,
             the refresh and PDL seconds, and per kernel ms and launches;
 12. cclst19 CCLST'19 keygen(1) at the 1348-bit discriminant and sign of
             MSG_2P, host only: valid, low s, no kernel launched; prints
             the host seconds.
 13. runtime the GG20 state machines in this process on the card, replaying
             the JAX package's transcript tests/gpu/fixtures/runtime_768.json
             (run_simulation over three Gg20Keygen at 768 bits, an offline
             stage and sign_manual): every message string and output equal
             to it, every launch shape held, K1, K3, K4, K5 launched and K2
             not; then party processes on the card: the relay on a free
             port, three `tpu_mpc_torch.runtime.cli keygen` at 2048-bit
             Paillier at once, `cli sign` for the quorums 1,2 and 2,3 at once
             (equal valid (r, s) under the one y); the GG18 KV relay with
             three keygen and two sign clients at 1024 bits (one y = sum y_i,
             shares reconstruct, equal valid low-s signatures).  Every child
             must exit 0 on the card with K1, K3, K4, K5 launched; prints the
             walls and one process's import-torch-and-CUDA-context time.
 14. sharding the slice's tables pass (S = 128, SessionRng(SLICE_SEED))
             under sessions_mesh() (every visible card), under a mesh that
             repeats the card 4 times, and over two real cards where there
             are two: a warm-up pass holding every K1-K5 piece shape against
             its plain version and a timed pass, each with (r, s, recid)
             equal, bit for bit, to the slice's unsharded pass, the timed
             one logged beside the slice's; one uniform pass under
             sessions_mesh(), equal to the slice's unsharded uniform warm-up
             pass; then a one-rank NCCL group in this
             process (TPU_MPC_TORCH_DISTRIBUTED=1): ModCtx.pow and
             mul_generator + to_affine over the mesh of ranks against python
             pow and the host EC; prints the passes' seconds and launches.
Then it prints one JSON line {"kernels": [...]} (launches: the first timed
tables pass of the slice; launches_keygen: the S = 16 keygen;
launches_scale_tables, launches_scale_refexact: the scale phase's passes;
launches_multitenant: the timed multi-tenant pass; launches_blame:
the blame phase; launches_quorum_keygen_n5, _keygen_n8, _tables_n5,
_tables_n8, _uniform_n5, _blame_n5: the quorum phase's runs;
launches_gg18: the timed GG18 [0, 1] pass;
launches_lindell17: the lindell17 phase; launches_runtime: the runtime
phase's replay; launches_sharding: the timed pass under the 4-entry mesh,
one launch a piece), the card's name and power limit,
and last {"ok": true, "device": {...}}.  It imports nothing of jax or of
the reference package tpu_mpc.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import random
import signal
import subprocess
import sys
import time

S_SESSIONS = 128
SLICE_SEED = 0xC41B                  # the slice's SessionRng seed
# blame's sessions: its host Paillier opens (~0.24 s each on the card's host)
# grow with S, so it runs at an eighth of the slice's S to keep the whole
# run in time (64 until the sharding phase came, 32 until the scale phase,
# 16 until the quorum phase)
BLAME_S = 8
K1_LANES = {2048: 512, 4096: 256}   # the slice's K1 batches: S*tp*2 (CRT halves), S*tp*2 (N^2)
EC_LANES = 256                       # S*tp
EC_RAGGED = (1, 7, 9, 33, 257)       # K3/K4/K5 lane counts off their 8-, 16-, 32-lane blocks
K3_TIMED = (128, 256, 512)
K4_TIMED = (256, 512)                # the lane counts of K4 on the main path
K5_TIMED = (256, 512)                # K5 timed here (the main path runs 128 to 1792)
K2_LANES = 256                       # S*tp*(tp-1)
K1_BLAME_LANES = 512                 # S*tp*tp: phase-5 blame's c_A^gamma mod N^2
K1_RANGE_NI_LANES = 64 * 2 * 40      # Lindell'17 at S = 64: range_proof_ni's r^N over [S, 2 x REPS]
K1_L17_LANES = 64                    # Lindell'17 sign's c_key^v mod N^2
MSG = 0x1C8AA4E93D8F4D7C9E21B5A7D301F2B8D4E6C0A9F3B5D7E9C1A3B5D7E9F10203
# The card's peaks (PEAK_BYTES, PEAK_IMAD, PEAK_U8_MAC) and the RNS work
# model (rns_work, k1_montmuls, k2_montmuls) are tpu_mpc_torch/core/modctx.py's,
# which its launch log's summary shares.
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


def _events_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device ms of `reps` calls of fn, after one warm-up call (warm:
    False where fn just ran on the same inputs, as a plain version does in
    the exactness check before its timing)."""
    import torch

    if warm:
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
    from tpu_mpc_torch.core.modctx import PEAK_BYTES, PEAK_IMAD, PEAK_U8_MAC

    tb = nbytes / PEAK_BYTES * 1e3
    to = max(imads / PEAK_IMAD, u8_macs / PEAK_U8_MAC) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _maxerr(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# --------------------------------------------------------------------------
# phase 2: the native host layer
# --------------------------------------------------------------------------

NATIVE_PRIME_SEEDS = (1, 2)          # seeded 1024-bit primes
NATIVE_SAFE_SEEDS = (1, 2)           # seeded 512-bit safe primes
GMP_LANES = 4096                     # host_mulmod's lanes at S = 4096
VERIFY_SIGS = 4096                   # signatures of one key through both verifiers


def _rand_ints(rnd, n: int, bits: int, odd: bool = False):
    import numpy as np

    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = rnd.getrandbits(bits) | (1 if odd else 0)
    return out


def _gmp_case(kind: str, args) -> str:
    """One host_mulmod (kind "mulmod": args = operands then modulus) or
    host_prod_axis0 (kind "prodax0": args = (vals, modulus row)) call on
    GMP, held against the python loop; the GMP route is also run step by
    step (packing, call, unpacking).  Returns the log fragment."""
    from tpu_mpc_torch import native
    from tpu_mpc_torch.core import modctx

    fn = modctx.host_mulmod if kind == "mulmod" else modctx.host_prod_axis0
    with _Timed(native.hostmul, "mulmod_batch") as gm, \
            _Timed(native.hostmul, "prodmod_axis0") as gp:
        t = time.perf_counter()
        got = fn(*args)
        t_whole = time.perf_counter() - t
    on_gmp = gm.calls + gp.calls
    t = time.perf_counter()
    if kind == "mulmod":
        *ops, mod = args
        cols = [modctx._ints(a) for a in ops]
        mods = modctx._ints(mod)
        W = modctx._native_width(cols, mods, len(mods))
        steps = None
        if W is not None:
            bufs = [modctx._pack_ints(c, W) for c in cols] + [modctx._pack_ints(mods, W)]
            t1 = time.perf_counter()
            raw = native.hostmul.mulmod_batch(bufs[:-1], bufs[-1], len(mods), W)
            t2 = time.perf_counter()
            steps = modctx._unpack_ints(raw, len(mods), W)
    else:
        vals, row = args
        mods = modctx._ints(row)
        flat = modctx._ints(vals)
        W = modctx._native_width([flat], mods, len(flat))
        steps = None
        if W is not None:
            vb, mb = modctx._pack_ints(flat, W), modctx._pack_ints(mods, W)
            t1 = time.perf_counter()
            raw = native.hostmul.prodmod_axis0(vb, vals.shape[0], mb, len(mods), W)
            t2 = time.perf_counter()
            steps = modctx._unpack_ints(raw, len(mods), W)
    t3 = time.perf_counter()
    saved = modctx.NATIVE_MIN_LANES
    modctx.NATIVE_MIN_LANES = 1 << 62
    try:
        t4 = time.perf_counter()
        want = fn(*args)
        t_loop = time.perf_counter() - t4
    finally:
        modctx.NATIVE_MIN_LANES = saved
    require(got.shape == want.shape and got.tolist() == want.tolist(),
            f"native: {kind} differs from the python loop")
    if steps is None:
        return (f"python loop (GMP calls {on_gmp}) {t_whole:.4f} s, equal to the loop's "
                f"{t_loop:.4f} s")
    require(on_gmp == 1 and steps.tolist() == want.reshape(-1).tolist(),
            f"native: {kind}'s GMP route was not taken or its steps differ")
    return (f"GMP {t_whole:.4f} s (pack {t1 - t:.4f}, call {t2 - t1:.4f}, unpack "
            f"{t3 - t2:.4f}; W = {W} bytes) against the loop's {t_loop:.4f} s "
            f"({t_loop / t_whole:.1f}x), equal")


def _verify_cases(rnd):
    """VERIFY_SIGS signatures of one key (nonces k0, k0 + 1, ..., so that R
    walks by G), then the edge cases of tests/gpu/test_torch_verify.py on
    the first: [(label, pubkey, m, r, s)] and the answer each must get."""
    from tpu_mpc_torch.host import ec as hec

    N, P = hec.N, hec.P
    d, k0 = rnd.randrange(1, N), rnd.randrange(1, N - VERIFY_SIGS)
    Y, R = hec.mul(d), hec.mul(k0)
    cases = []
    for i in range(VERIFY_SIGS):
        if i:
            R = hec.add(R, hec.G)
        m = rnd.getrandbits(256)
        r = R[0] % N
        cases.append((f"sig {i}", Y, m, r, pow(k0 + i, -1, N) * (m + r * d) % N))
    _, _, m, r, s = cases[0]
    x, y = Y
    t = 0x1234567
    Q = (5, 123456789)
    rq = hec.mul(t, Q)[0] % N
    edges = {"s + 1": (Y, m, r, s + 1, False), "r = 0": (Y, m, 0, s, False),
             "s = N": (Y, m, r, N, False), "m + 1": (Y, m + 1, r, s, False),
             "m + N": (Y, m + N, r, s, True), "high s": (Y, m, r, N - s, True),
             "None key": (None, m, r, s, False), "(x + P, y)": ((x + P, y), m, r, s, True),
             "(x, y + P)": ((x, y + P), m, r, s, True), "(x, y + 1)": ((x, y + 1), m, r, s, False),
             "-r": (Y, m, -r, s, False), "r + N": (Y, m, r + N, s, False),
             "(-x, y)": ((-x, y), m, r, s, False), "(x + 5P, y)": ((x + 5 * P, y), m, r, s, True),
             "off curve": (Q, 0, rq, rq * pow(t, -1, N) % N, False)}
    want = [True] * VERIFY_SIGS + [e[4] for e in edges.values()]
    cases += [(label,) + e[:4] for label, e in edges.items()]
    return cases, want


def run_native() -> None:
    """The native host layer: its builds, each helper against its plain
    version on the card's host, with both times (see the module docstring,
    phase 2).  Host only: no kernel runs here."""
    import numpy as np

    from tpu_mpc_torch import native
    from tpu_mpc_torch.core import modctx
    from tpu_mpc_torch.host import ec as hec, primes

    t_phase = time.perf_counter()
    ver = subprocess.run([native.gxx(), "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    t = time.perf_counter()
    fresh = [name for name in native.SOURCES if not os.path.exists(native.lib_path(name))]
    paths = {name: native.build(name) for name in native.SOURCES}
    t_build = time.perf_counter() - t
    for name in (*native.SOURCES, "crypto"):
        native.lib(name)
    log(f"native: {ver}; built {fresh} in {t_build:.2f} s (g++ {' '.join(native.GXX_FLAGS)}); "
        f"libgmp {native.gmp_path()}; libcrypto {native.libcrypto_path()}; "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))

    rows = []
    for bits, seeds, fast, plain in ((1024, NATIVE_PRIME_SEEDS, native.primegen.gen_prime,
                                      primes._helper_gen_prime),
                                     (512, NATIVE_SAFE_SEEDS, native.primegen.gen_safe_prime,
                                      primes._helper_gen_safe_prime)):
        for seed in seeds:
            t = time.perf_counter()
            a = fast(bits, seed)
            t1 = time.perf_counter()
            b = plain(bits, seed)
            t2 = time.perf_counter()
            require(a == b and a.bit_length() == bits,
                    f"native: {fast.__name__}({bits}, {seed}) differs from its plain version")
            rows.append(f"{fast.__name__}({bits}, {seed}) {t1 - t:.3f} / {t2 - t1:.3f} s")
    log("native: seeded draws equal their plain versions (native / plain): " + "; ".join(rows))
    t = time.perf_counter()
    unseeded = [primes.gen_prime(1024) for _ in range(2)]
    require(len(set(unseeded)) == 2 and all(p.bit_length() == 1024 and primes.is_probable_prime(p)
                                            for p in unseeded),
            "native: an unseeded 1024-bit prime failed")
    log(f"native: two unseeded 1024-bit primes (OS candidates, the helper's 28 rounds) in "
        f"{time.perf_counter() - t:.3f} s, both pass is_probable_prime")

    rnd = random.Random(0x6A9)
    for bits in (2048, 4096):
        mod = _rand_ints(rnd, GMP_LANES, bits, odd=True)
        ops = [_rand_ints(rnd, GMP_LANES, bits - 1) for _ in range(4)]
        for k in (2, 4):
            log(f"native: host_mulmod, {k} operands, {GMP_LANES} lanes, {bits}-bit moduli: "
                + _gmp_case("mulmod", ops[:k] + [mod]))
        for S in (2, 4):
            vals = np.stack(ops[:S])
            log(f"native: host_prod_axis0, [{S}, {GMP_LANES}], {bits}-bit moduli: "
                + _gmp_case("prodax0", (vals, mod.reshape(1, -1))))
    neg = _rand_ints(rnd, GMP_LANES, 2048)
    neg[17] = -neg[17]
    mod = _rand_ints(rnd, GMP_LANES, 2048, odd=True)
    log(f"native: host_mulmod with a negative operand, {GMP_LANES} lanes: "
        + _gmp_case("mulmod", [neg, _rand_ints(rnd, GMP_LANES, 2048), mod]))
    small = [_rand_ints(rnd, 31, 2048) for _ in range(2)] + [_rand_ints(rnd, 31, 2048, True)]
    log("native: host_mulmod at 31 lanes: " + _gmp_case("mulmod", small))
    require(modctx.NATIVE_MIN_LANES == 32, "native: the GMP threshold was not restored")

    cases, want = _verify_cases(rnd)
    cols = list(zip(*cases))[1:]
    t = time.perf_counter()
    got = hec.ecdsa_verify_batch(*cols)
    t1 = time.perf_counter()
    plain = hec.ecdsa_verify_batch_plain(*cols)
    t2 = time.perf_counter()
    bad = [cases[i][0] for i in range(len(cases)) if got[i] != want[i]]
    require(not bad and got == plain, f"native: ecdsa_verify_batch wrong at {bad[:8]}, or "
            f"unequal to ecdsa_verify_batch_plain")
    sigs = [c[1:] for c in cases[:VERIFY_SIGS]]
    t3 = time.perf_counter()
    require(all(hec.ecdsa_verify_batch(*zip(*sigs))), "native: a signature failed")
    t_sigs = time.perf_counter() - t3
    log(f"native: ecdsa_verify_batch (OpenSSL) on {VERIFY_SIGS} signatures of one key and "
        f"{len(cases) - VERIFY_SIGS} edge cases {t1 - t:.3f} s against "
        f"ecdsa_verify_batch_plain's {t2 - t1:.3f} s ({(t2 - t1) / (t1 - t):.1f}x), equal; "
        f"the {VERIFY_SIGS} signatures alone {t_sigs:.3f} s "
        f"({1e6 * t_sigs / VERIFY_SIGS:.1f} us a signature)")
    log(f"native: the phase {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _k1_bound(par, lanes, ne2, x, e, rows, dev):
    """K1's bound (ms, by) and its IMAD-only bound (ms) for one launch."""
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import k1_montmuls, rns_work

    u8, imad, old = rns_work(par, k1_montmuls(ne2), lanes, prologue=True)
    cs = pr.dev_consts(par, dev)
    nbytes = (2 * (x.numel() + rows.numel()) + 4 * e.numel() + 4 * cs["flat32"].numel()
              + cs["planes"].numel() + 8 * lanes * par.Lout)
    bms, bby = _bound(nbytes, imad, u8)
    return bms, bby, _bound(nbytes, old)[0]


def launch_bound(name, a):
    """(bound ms, "bytes" or "operations", second bound ms) of one launch of
    kernel `name` on the wrapper's arguments `a`.  The second bound is K1's
    and K2's IMAD-only bound, K5's divstep bound (K5_DIVSTEP_OPS), and K3's
    and K4's bound again.  K2 and K4 count the table entries this launch's
    digits touch (a synchronisation)."""
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.modctx import k2_montmuls, rns_work
    from tpu_mpc_torch.core.rns import RnsParams

    if name == "K1":
        return _k1_bound(RnsParams(a[3]), a[0].shape[0], a[1].shape[1], *a[:3], a[0].device)
    if name == "K2":
        e, grow, rows, tabs, nwins, woffs, nbits = a[:7]
        par, B = RnsParams(nbits), e.shape[0]
        u8, imad, old = rns_work(par, k2_montmuls(nwins), B, prologue=False)
        # table entries this run's digits touch (per base: window, digit, group)
        touched = 0
        for t_, nwin, woff in zip(tabs, nwins, woffs):
            j = torch.arange(nwin, device=e.device)
            dig = (e[:, woff + j // 8] >> (4 * (j % 8))) & 15
            key = (j * 16 + dig) * t_.shape[2] + grow[:, None]
            touched += int(torch.unique(key).numel())
        cs = pr.dev_consts(par, e.device)
        nbytes = (2 * touched * par.CH + 2 * rows.numel() + 4 * e.numel() + 4 * grow.numel()
                  + 4 * cs["flat32"].numel() + cs["planes"].numel() + 8 * B * par.Lout)
        bms, bby = _bound(nbytes, imad, u8)
        return bms, bby, _bound(nbytes, old)[0]
    n = a[0].shape[0]
    if name == "K3":
        P, DG, NEG = a[:3]
        ns = DG.shape[1]
        # multiply-adds per lane: per base jac_in and a 14-add table; 33
        # windows of 4 doublings, ns additions and ns/2 beta multiplies; jac_out
        imad = n * ((ns // 2) * (JAC_IO + 14 * RCB_ADD)
                    + 33 * (4 * RCB_DBL + ns * RCB_ADD + (ns // 2) * FE_MUL) + JAC_IO)
        bms, bby = _bound(2 * (P.numel() + n * 48) + DG.numel() + NEG.numel(), imad)
        return bms, bby, bms
    if name == "K4":
        dg = a[0]
        # the table entries these digits touch, 64 B each (x, y)
        touched = int(torch.unique(dg + 256 * torch.arange(32, device=dg.device)).numel())
        bms, bby = _bound(dg.numel() + 2 * n * 48 + 64 * touched, n * (32 * RCB_ADD + JAC_IO))
        return bms, bby, bms
    nbytes = 2 * n * (48 + 32)
    bms, bby = _bound(nbytes, n * K5_CHAIN_OPS)
    # the divstep kernel's own INT32 operations (K5_DIVSTEP_OPS)
    return bms, bby, _bound(nbytes, n * K5_DIVSTEP_OPS)[0]


def check_k1(dev, rnd):
    """K1 at the slice's shapes: 512 lanes at 2048 bits and 256 lanes at 4096
    bits (whose planes do not all fit in shared memory: the streamed path),
    one modulus for all lanes or one per lane, decode columns or residues for
    the axis-0 fold; exact against exp_plain, samples against python pow.
    Then ragged lane counts (1, L - 1, L + 1, 513) with one modulus per lane
    inside every tile.  Times both widths, then the later phases' 4096-bit
    shapes (_k1_shape): blame's, and Lindell'17's at 5120 and 64 lanes."""
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
                    pms = _events_ms(lambda: pr.exp_plain(x, e, rows, bits, emit), 1, warm=False)
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
    # the shapes of the later phases, 4096-bit moduli (N^2): GG20 blame's
    # c_A^gamma over [S, tp, tp] = 512 lanes at S = 128 with 256-bit
    # exponents, one modulus per lane; Lindell'17 at S = 64 (each session's
    # modulus over consecutive lanes, as a trailing axis lays them out): the
    # range proof's stacked encryptions r^N over [S, 2 x 40] = 5120 lanes
    # with 2048-bit exponents (more than one wave of blocks), and sign's
    # c_key^v over 64 lanes with 256-bit exponents
    for suffix, B, ebits, per_mod, emits, what in (
            ("_4096_e256", K1_BLAME_LANES, 256, 1, (True, False), "the blame shape"),
            ("_4096_l5120", K1_RANGE_NI_LANES, 2048, 2 * 40, (True,),
             "range_proof_ni's stacked encryptions"),
            ("_4096_e256_l64", K1_L17_LANES, 256, 1, (True,), "Lindell'17 sign's c_key^v")):
        row, err = _k1_shape(dev, rnd, 4096, B, ebits, per_mod, emits, what)
        worst = max(worst, err)
        entry.update({k + suffix: v for k, v in row.items()})
    entry["max_abs_err"] = worst
    return entry


def _k1_shape(dev, rnd, bits, B, ebits, per_mod, emits, what):
    """K1 at B lanes of `bits`-bit moduli, B // per_mod distinct moduli, each
    on per_mod consecutive lanes, with `ebits`-bit exponents (lane 0's is 0):
    exact against exp_plain in each emit mode of `emits` and against python
    pow on sampled lanes, then timed.  -> (ms, plain_ms, bound_ms,
    imad_bound_ms as a dict, largest |diff|)."""
    import numpy as np
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    par = RnsParams(bits)
    ns = np.asarray(_odd_moduli(rnd, bits, B // per_mod, par), dtype=object)
    n_l = np.repeat(ns, per_mod)
    base = np.asarray([rnd.getrandbits(bits) % int(v) for v in n_l], dtype=object)
    expo = np.asarray([rnd.getrandbits(ebits) for _ in range(B)], dtype=object)
    expo[0] = 0
    x = torch.as_tensor(batch_to_limbs(base, par.Lin), device=dev)
    e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(ebits))), device=dev)
    rows = RnsCtx.from_ints(ns, bits, dev).rows.repeat_interleave(per_mod, 0).contiguous()
    worst = 0
    for emit in emits:
        out_k = pr.exp_call(x, e, rows, bits, emit_planes=emit)
        out_p = pr.exp_plain(x, e, rows, bits, emit_planes=emit)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0 and out_k.shape == out_p.shape,
                f"K1 {bits}b lanes={B} {ebits}-bit exponents emit={emit}: kernel != plain "
                f"(max |diff| {err})")
    got = RnsLazy((pr.exp_call(x, e, rows, bits),), (B,), n_l, par.MA).ints()
    for i in sorted({i for i in (0, 1, 7, 8, B // 2 - 1, B // 2, B - 2, B - 1) if 0 <= i < B}):
        require(int(got[i]) == pow(int(base[i]), int(expo[i]), int(n_l[i])),
                f"K1 {bits}b lanes={B} {ebits}-bit exponents: lane {i} != python pow")
    ms = _events_ms(lambda: pr.exp_call(x, e, rows, bits, True), 3)
    pms = _events_ms(lambda: pr.exp_plain(x, e, rows, bits, True), 1, warm=False)
    bms, bby, ims = _k1_bound(par, B, e.shape[1], x, e, rows, dev)
    log(f"K1 {bits}b lanes={B} ({B // per_mod} moduli) {ebits}-bit exponents, {what}: exact "
        f"against plain and python pow; kernel {ms:.3f} ms, plain {pms:.1f} ms, bound "
        f"{bms:.4f} ms ({bby}), IMAD bound {ims:.4f} ms")
    return dict(ms=ms, plain_ms=pms, bound_ms=bms, imad_bound_ms=ims), worst


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
    from tpu_mpc_torch.core.modctx import ModCtx, ebits_class
    from tpu_mpc_torch.core.rns import RnsParams

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
        pms = _events_ms(lambda: pr.fixed_plain(*args), 1, warm=False)
        B = e.shape[0]
        bms, bby, ims = launch_bound("K2", args)
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
    worst = max(worst, _check_k2_many_groups(dev, rnd))
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


K2_MANY_GROUPS = (5, 8)                # key groups of one call: the n = 5 and n = 8 keys


def _check_k2_many_groups(dev, rnd) -> int:
    """K2 at 2048 bits with 5 and then 8 key groups in one call, the lanes in
    the caller's order, so that a tile of 8 lanes holds up to 8 groups (two
    staged, the others read from L2), at ragged lane counts; exact against
    fixed_plain, and python pow on the first and last lanes.  Returns the
    largest |diff| (0)."""
    import numpy as np
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.core.limbs import batch_to_limbs, nlimbs
    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.core.rns import RnsCtx, RnsLazy, RnsParams

    bits, ebits = 2048, 64
    par = RnsParams(bits)
    L = pr.LANE_TILE
    worst = 0
    for G in K2_MANY_GROUPS:
        ns = np.asarray(_odd_moduli(rnd, bits, G, par), dtype=object)
        hb = np.asarray([[rnd.getrandbits(bits) % int(n) for n in ns]], dtype=object)
        T = ModCtx.from_ints(ns, bits, dev).make_tables_rns(hb, ebits)[0]
        for B in (L - 1, L + 1, G * L + 3):
            gmap = np.asarray([(3 * i + i // G) % G for i in range(B)])
            expo = np.asarray([rnd.getrandbits(ebits) for _ in range(B)], dtype=object)
            e = torch.as_tensor(pr._pack_words(batch_to_limbs(expo, nlimbs(ebits))), device=dev)
            args = (e, torch.as_tensor(gmap, device=dev),
                    RnsCtx.from_ints(ns[gmap], bits, dev).rows, [T], [ebits // 4], [0], bits)
            out_k = pr.fixed_call(*args)
            out_p = pr.fixed_plain(*args)
            torch.cuda.synchronize()
            err = _maxerr(out_k, out_p)
            worst = max(worst, err)
            require(err == 0 and out_k.shape == out_p.shape,
                    f"K2 {G} groups lanes={B}: kernel != plain (max |diff| {err})")
            got = RnsLazy((out_k,), (B,), ns[gmap], par.MA).ints()
            for i in sorted({0, 1, B - 1}):
                want = pow(int(hb[0, gmap[i]]), int(expo[i]), int(ns[gmap[i]]))
                require(int(got[i]) == want, f"K2 {G} groups lane {i} != python pow")
    log(f"K2 {bits}b, {' and '.join(map(str, K2_MANY_GROUPS))} key groups a call in the caller's "
        f"lane order (up to 8 groups in a tile of {L}), lanes {L - 1}, {L + 1}, G * {L} + 3: "
        f"exact")
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
            bms, bby, _ = launch_bound("K3", (P, DG, NEG))
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
            pms = _events_ms(lambda: pe.ladder_plain(P, DG, NEG), 1, warm=False)
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
            pms = _events_ms(lambda: pe.comb_plain(dg, tab), 1, warm=False)
            bms, bby, _ = launch_bound("K4", (dg, tab, planes))
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
        pms = _events_ms(lambda: pe.affine_plain(P5), 1, warm=False)
        bms, bby, dms = launch_bound("K5", (P5,))
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
    """kernel -> (module, name, plain version taking the same args) of the
    function that launches one piece of a wrapper call (the whole call when
    no sessions mesh is active)."""
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.ec import pallas_ec as pe

    return {"K1": (pr, "exp_launch", pr.exp_plain), "K2": (pr, "fixed_launch", pr.fixed_plain),
            "K3": (pe, "ladder_launch", pe.ladder_plain),
            "K4": (pe, "comb_launch", lambda *a: pe.comb_plain(*a[:2])),
            "K5": (pe, "affine_launch", pe.affine_plain)}


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


# every launch shape of every instrumented call so far (all phases)
SEEN_SHAPES: set = set()


class Instrument:
    """Patches the kernels' piece launchers (_wrappers) for the life of a
    `with` block.

    hold: the kernels whose first call at each launch shape not yet in
    `held` is held exactly against the plain version on the same inputs
    (the hold runs outside the events).  sampled: where given, the first
    call at each launch shape not yet in it keeps SAMPLE_LANES of its
    lanes, inputs and output, on the card (`samples`; check_samples holds
    them against python after the block).  Every call of every kernel is
    counted by shape in `by_shape` and timed by CUDA events on the stream
    around the kernel call (no extra synchronisation): `spans[K]`, and K1
    also by width under "K1 <bits>b"."""

    def __init__(self, held: set, hold=(), sampled: set | None = None):
        self.held, self.hold, self.sampled = held, set(hold), sampled
        self.spans, self.by_shape, self.new_holds, self.samples = {}, {}, [], []
        self.shape_spans = {}

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
            self.shape_spans.setdefault(shape, []).append(ev)
            if self.sampled is not None and shape not in self.sampled:
                self.sampled.add(shape)
                self.samples.append(take_sample(name, shape, shape not in SEEN_SHAPES,
                                                a, kw, out))
            SEEN_SHAPES.add(shape)
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

    def shape_ms(self, shape) -> float:
        """Mean device ms of a launch at `shape`; call after a sync."""
        v = self.shape_spans[shape]
        return sum(a.elapsed_time(b) for a, b in v) / len(v)


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
# phase 4: keygen
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
# phase 5: the slice
# --------------------------------------------------------------------------

def run_slice(dev, material, host_profile: bool = False):
    """Both configurations of the slice at S = 128 on the key of the keygen
    phase (keygen(1, 1, 3) under SessionRng(0xBE7C), equal to
    benches/bench_key_2048.json): load each key set (the tables one builds
    its h1/h2 and randomizer tables), one warm-up pass each (the first
    K3/K4/K5 call at each shape held exactly against its plain version),
    then one timed pass each, uniform then tables.  Kernel
    counts are set to 0 just before each timed pass and read just after it;
    the tables passes must launch all five kernels, the uniform ones every
    kernel but K2.  Returns (the first timed tables pass's launches, and per
    configuration the key at S = 128, its 1-session key and the (r, s,
    recid) of its warm-up pass, the first under a fresh
    SessionRng(SLICE_SEED); then the first timed tables pass's seconds)."""
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng

    keys, rngs, key1s = {}, {}, {}
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
        keys[cfg], key1s[cfg] = gg20.tile_key(key1, S_SESSIONS), key1
        rngs[cfg] = SessionRng(SLICE_SEED)
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
        return dt, t_off, sig

    # warm-up passes: the first K3/K4/K5 call at each shape of the main path
    # is held exactly against its plain version on that call's inputs
    held, first = set(), {}
    for cfg in CONFIGS:
        with Instrument(held, hold=("K3", "K4", "K5")):
            dt, t_off, sig = one_pass(cfg)
        first[cfg] = _sig_ints(sig)
        log(f"slice[{cfg}]: warm-up pass {dt:.2f} s (offline {t_off:.2f} s), "
            f"{S_SESSIONS} signatures verify; K3/K4/K5 exact against plain at the main "
            f"path's shapes so far: {', '.join(sorted(held))}")

    # one timed pass a configuration (uniform, tables; a second of each ran
    # until the scale phase took their time)
    runs, timed_sig = [], {}
    for cfg in ("uniform", "tables"):
        torch.cuda.synchronize()
        kernels.reset_launches()
        with Instrument(held) as inst:
            dt, t_off, sig = one_pass(cfg)
        launches = dict(kernels.LAUNCHES)
        timed_sig.setdefault(cfg, sig)
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
    check_verifiers(keys["tables"], timed_sig["tables"])
    profiled_pass(keys["tables"], first["tables"])
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
    t_launches, t_dt = next((r[1], r[3]) for r in runs if r[0] == "tables")
    return t_launches, keys, key1s, first, t_dt


def check_verifiers(key, sig):
    """The batched verifier (host/ec.py:ecdsa_verify_batch, OpenSSL, on every
    batched signing path) against its plain version ecdsa_verify_batch_plain
    and the single-signature oracle ecdsa_verify on the S signatures of a
    timed tables pass and S tampered cases: s + 1, m + 1, r + 1, a None
    key, a key off the curve with a signature the affine formulas accept
    (Q = (5, 123456789), r = x(t Q) mod N, s = r / t, m = 0), and the key's
    (x + P, y) alias.  The two batch verifiers must agree on every case,
    and with ecdsa_verify on every case but the off-curve ones, which they
    (as OpenSSL, the reference's) must reject; prints the three host times,
    and the batch verifier's on the S signatures alone (its share of a
    pass)."""
    from tpu_mpc_torch.ec import secp256k1 as dec
    from tpu_mpc_torch.host import ec as hec

    N, P = hec.N, hec.P
    y = dec.points_to_host(key.y)
    m = MSG % N
    cases, want = [], []
    for b in range(S_SESSIONS):
        Y, r, s = y[b], int(sig.r[b]), int(sig.s[b])
        cases.append((Y, m, r, s))
        want.append(True)
        kind = b % 6
        if kind == 4:
            t = 0x1234567 + b
            Q = (5, 123456789)
            rq = hec.mul(t, Q)[0] % N
            cases.append((Q, 0, rq, rq * pow(t, -1, N) % N))
        else:
            cases.append(((Y, m, r, s + 1), (Y, m + 1, r, s), (Y, m, r + 1, s), (None, m, r, s),
                          None, ((Y[0] + P, Y[1]), m, r, s))[kind])
        want.append(kind == 5)
    t0 = time.perf_counter()
    require(all(hec.ecdsa_verify_batch(*zip(*cases[0::2]))), "verify: a signature failed")
    t_pass = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = hec.ecdsa_verify_batch(*zip(*cases))
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = hec.ecdsa_verify_batch_plain(*zip(*cases))
    t_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = [pub is not None and hec.ecdsa_verify(pub, mv, r, s) for pub, mv, r, s in cases]
    t_single = time.perf_counter() - t0
    off = [i for i in range(len(cases)) if i % 2 and (i // 2) % 6 == 4]
    require(got == want, f"verify: the batch verifier's answers differ from the expected at "
            f"{[i for i in range(len(cases)) if got[i] != want[i]][:8]}")
    require(plain == got, "verify: ecdsa_verify_batch_plain differs from ecdsa_verify_batch")
    require(all(got[i] == single[i] for i in range(len(cases)) if i not in off),
            "verify: ecdsa_verify_batch and ecdsa_verify disagree on the curve")
    log(f"verify: {len(cases)} cases ({S_SESSIONS} signatures of a timed tables pass, "
        f"{S_SESSIONS} tampered: s+1, m+1, r+1, None key, off curve, (x+P, y)): "
        f"ecdsa_verify_batch (OpenSSL) {t_batch:.3f} s, ecdsa_verify_batch_plain "
        f"{t_plain:.3f} s (equal answers), ecdsa_verify {t_single:.3f} s "
        f"({t_single / t_batch:.1f}x); equal on the curve; the {len(off)} off-curve cases "
        f"rejected by the batch verifier, accepted by ecdsa_verify in "
        f"{sum(single[i] for i in off)}; the {S_SESSIONS} signatures alone through "
        f"ecdsa_verify_batch {t_pass:.3f} s")


def profiled_pass(key, want):
    """One more tables pass with the launch log on (TPU_MPC_TORCH_PROFILE=1,
    core/modctx.py:PROFILE), from a fresh SessionRng(SLICE_SEED): its
    (r, s, recid) must equal the slice's tables warm-up pass under the same
    seed, every kind it logs must be one of the reference's names, and the
    summary's TOTAL count must equal the log's rows.  Prints the summary."""
    import torch

    from tpu_mpc_torch.core import modctx
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng

    os.environ[ENC_ENV] = CONFIGS["tables"]
    os.environ["TPU_MPC_TORCH_PROFILE"] = "1"
    modctx.PROFILE_LOG.clear()
    modctx.PROFILE = True
    try:
        t0 = time.perf_counter()
        off = gg20.offline_stage(key, [0, 1], SessionRng(SLICE_SEED))
        sig = gg20.sign_online(off, MSG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        modctx.PROFILE = False
        os.environ.pop("TPU_MPC_TORCH_PROFILE")
    require(off.ok.all() and sig.sig_valid.all(), "profile: a signature failed")
    require(_sig_ints(sig) == want, "profile: (r, s, recid) differ from the tables warm-up pass")
    kinds = {row[0] for row in modctx.PROFILE_LOG}
    require(kinds <= set(modctx.PROFILE_KINDS),
            f"profile: kinds that are not the reference's: {sorted(kinds - set(modctx.PROFILE_KINDS))}")
    n_rows = len(modctx.PROFILE_LOG)
    logged = sum(row[4] for row in modctx.PROFILE_LOG if not row[0].startswith("host:"))
    summary = modctx.profile_summary()
    total = summary.splitlines()[-1]
    require(total.startswith(f"TOTAL modexp launches: {n_rows}  "),
            f"profile: {total!r} against {n_rows} rows")
    log(f"profile: a tables pass under TPU_MPC_TORCH_PROFILE=1 in {dt:.2f} s, (r, s, recid) "
        f"equal to the warm-up pass's; {n_rows} rows, {len(kinds)} kinds, device rows "
        f"{logged:.2f} s (host rows nest inside them)\n" + summary)


def _sig_ints(sig):
    """(r, s, recid) of a pass's signatures as lists of ints."""
    return tuple([int(v) for v in a] for a in (sig.r, sig.s, sig.recid))


# --------------------------------------------------------------------------
# phase 6: the main path at the JAX package's own scale
# --------------------------------------------------------------------------

SCALE_S = 4096                       # bench.py:62, the JAX package's default S
SCALE_SEED = 0x5CA1E
BV_ENV = "TPU_MPC_TORCH_BATCH_VERIFY"
# bench.py:main's two passes: the default (tables, batch verification on at
# S >= 8: the variable unset) and the reference-exact companion pass
# (bench.py:146-147: per-proof verification, uniform randomizers)
SCALE_CONFIGS = {"tables": {ENC_ENV: "1", BV_ENV: None},
                 "refexact": {ENC_ENV: "0", BV_ENV: "0"}}
SAMPLE_LANES = 64                    # lanes of a launch held against python
SIG_SAMPLE = 64                      # signatures of a pass also through ecdsa_verify


def sample_lanes(B: int, n: int = SAMPLE_LANES) -> list:
    """n lanes of a B-lane launch (all when B <= n): the first 8, the last 8
    (the first and the last lane tile of K1-K3) and the rest spread evenly
    between them."""
    if B <= n:
        return list(range(B))
    ends = set(range(8)) | set(range(B - 8, B))
    rest = n - len(ends)
    mid = {8 + (B - 16) * (2 * j + 1) // (2 * rest) for j in range(rest)}
    out = sorted(ends | mid)
    return out if len(out) == n else sorted(set(out) | set(range(8, 8 + n - len(out))))


def take_sample(name, shape, new, a, kw, out) -> dict:
    """SAMPLE_LANES lanes of a launch's inputs and output, gathered on the
    card (no synchronisation), for check_samples."""
    import torch

    a = list(a)
    B = out.shape[0]
    lanes = sample_lanes(B)
    idx = torch.as_tensor(lanes, device=out.device)
    pick = lambda t: t.index_select(0, idx) if t.shape[0] == B else t[:1]
    # the whole launch's arguments stay referenced for its bound (launch_bound)
    smp = {"name": name, "shape": shape, "new": new, "lanes": lanes, "out": pick(out),
           "args": a}
    if name == "K1":
        x, e, rows, nbits = a[:4]
        emit = kw.get("emit_planes", a[4] if len(a) > 4 else True)
        smp.update(x=pick(x), e=pick(e), rows=pick(rows), nbits=nbits, emit=emit)
    elif name == "K2":
        e, grow, rows, tables, nwins, woffs, nbits = a[:7]
        g = pick(grow).long()
        # each base's entry T[0][1] (its base x, in Montgomery form) per lane
        smp.update(e=pick(e), grow=pick(grow), rows=pick(rows), nbits=nbits, nwins=list(nwins),
                   woffs=list(woffs), bases=[T[0, 1].index_select(0, g) for T in tables])
    elif name == "K3":
        smp.update(pts=pick(a[0]), dg=pick(a[1]), neg=pick(a[2]))
    elif name == "K4":
        from tpu_mpc_torch.ec import pallas_ec as pe

        base = next(k[0] for k, v in pe._COMB8_CACHE.items() if v[0] is a[1])
        smp.update(dg=pick(a[0]), base=base)
    else:
        smp.update(pts=pick(a[0]))
    return smp


def _ints_of(t, bits: int) -> list:
    """[n, L] tensor of `bits`-bit limbs (little-endian) -> n python ints."""
    m = (1 << bits) - 1
    return [sum((int(v) & m) << (bits * i) for i, v in enumerate(row)) for row in t.tolist()]


_CRT: dict = {}


def _crt(res: list, primes: tuple) -> int:
    """The value below prod(primes) with residues `res`."""
    if primes not in _CRT:
        M = math.prod(primes)
        _CRT[primes] = (M, [(M // p) * pow(M // p % p, -1, p) for p in primes])
    M, c = _CRT[primes]
    return sum(int(r) * ci for r, ci in zip(res, c)) % M


def _jac_affine(X: int, Y: int, Z: int, P: int):
    """Canonical Jacobian -> affine (None for Z = 0)."""
    if Z == 0:
        return None
    zi = pow(Z, -1, P)
    return X * zi * zi % P, Y * zi * zi * zi % P


def lane_pow(job) -> bool:
    """(modulus, [(base, exponent), ...], value the kernel gave): the
    value equals the product of pow()."""
    n, terms, got = job
    want = 1
    for b, e in terms:
        want = want * pow(b, e, n) % n
    return got == want


def lane_ec(job) -> bool:
    """([(scalar, affine point or None), ...], affine point the kernel gave):
    it equals the sum of the scalar multiples (host/ec.py)."""
    from tpu_mpc_torch.host import ec as hec

    terms, got = job
    want = None
    for k, pt in terms:
        if pt is not None:
            want = hec.add(want, hec.mul(k, pt))
    return got == want


def _sample_jobs(smp) -> tuple:
    """A sample -> (checker, per-lane jobs): K1 and K2 against pow() and
    products of pow(), K3 and K4 against the host EC, K5 against python's
    modular inverse (its jobs are already decided)."""
    from tpu_mpc_torch.core.rns import RnsParams
    from tpu_mpc_torch.ec.secp256k1 import GLV_LAMBDA
    from tpu_mpc_torch.host import ec as hec

    name = smp["name"]
    cpu = {k: v.cpu() for k, v in smp.items() if hasattr(v, "cpu")}
    if name in ("K1", "K2"):
        par = RnsParams(smp["nbits"])
        K, Kp = par.K, par.Kp
        rows = cpu["rows"].tolist()
        mods = []
        for r in rows:
            n = _crt(r[K:K + Kp], par.pB)
            require(n % (1 << 16) == r[K + Kp], f"{smp['shape']}: a ctx row is not one modulus's")
            mods.append(n)
        mod = lambda i: mods[i if len(mods) > 1 else 0]
        if name == "K1" and not smp["emit"]:
            # big-Montgomery residues: the value below MA is x^e MA mod N
            outs = [_crt(r[:K], par.pA) * pow(par.MA, -1, mod(i)) % mod(i)
                    for i, r in enumerate(cpu["out"].tolist())]
        else:
            # exact column sums of 16-bit columns (core/rns.py:_rns_decode)
            outs = [sum(int(c) << (16 * j) for j, c in enumerate(row)) % par.MA % mod(i)
                    for i, row in enumerate(cpu["out"].tolist())]
        ew = cpu["e"].tolist()
        bases = [T.cpu().tolist() for T in smp.get("bases", ())]
        word = lambda row, lo, nw: sum((int(v) & 0xFFFFFFFF) << (32 * j)
                                       for j, v in enumerate(row[lo:lo + nw]))
        jobs = []
        for i, got in enumerate(outs):
            if name == "K1":
                terms = [(_ints_of(cpu["x"][i:i + 1], 16)[0], word(ew[i], 0, len(ew[i])))]
            else:
                terms = []
                for T, nwin, woff in zip(bases, smp["nwins"], smp["woffs"]):
                    xm = _crt(T[i][:K], par.pA)
                    e = word(ew[i], woff, -(-nwin // 8)) & ((1 << (4 * nwin)) - 1)
                    terms.append((xm * pow(par.MA, -1, mod(i)) % mod(i), e))
            jobs.append((mod(i), terms, got))
        return lane_pow, jobs
    P = hec.P
    jac = lambda row: _jac_affine(*_ints_of(row, 16), P)
    outs = cpu["out"]
    if name == "K5":
        ok = []
        for i, (X, Y, Z) in enumerate(_ints_of(r, 16) for r in cpu["pts"]):
            zi = pow(Z or 1, -1, P)
            ok.append(tuple(_ints_of(outs[i], 16)) == (X * zi * zi % P, Y * zi ** 3 % P))
        return None, ok
    jobs = []
    for i in range(outs.shape[0]):
        if name == "K3":
            dg, neg = cpu["dg"][i].tolist(), cpu["neg"][i].tolist()
            k = [sum(d << (4 * j) for j, d in enumerate(ds)) for ds in dg]
            sgn = [-1 if v else 1 for v in neg]
            terms = [((sgn[2 * m] * k[2 * m] + sgn[2 * m + 1] * GLV_LAMBDA * k[2 * m + 1])
                      % hec.N, jac(cpu["pts"][i, m])) for m in range(len(k) // 2)]
        else:
            k = sum(d << (8 * w) for w, d in enumerate(cpu["dg"][i].tolist()))
            terms = [(k % hec.N, smp["base"])]
        jobs.append((terms, jac(outs[i])))
    return lane_ec, jobs


def check_samples(samples, pool) -> list:
    """Holds every sampled launch against python on its SAMPLE_LANES lanes
    (the jobs over `pool`, worker processes); any difference fails.
    -> [(sample, lanes held)]."""
    pending = []
    for smp in samples:
        fn, jobs = _sample_jobs(smp)
        pending.append((smp, pool.map(fn, jobs, chunksize=4) if fn else jobs))
    out = []
    for smp, ok in pending:
        ok = list(ok)
        bad = [smp["lanes"][i] for i, v in enumerate(ok) if not v]
        require(not bad, f"{smp['shape']}: lanes {bad[:8]} differ from python")
        out.append((smp, len(ok)))
    return out


def run_scale(dev, key1s: dict, host_profile: bool = False) -> dict:
    """GG20 2-of-3 signing at S = SCALE_S sessions on the slice's bench key
    (key1s: its 1-session key per configuration, loaded by run_slice), one
    pass in each of bench.py:main's configurations under
    SessionRng(SCALE_SEED): "tables" (the default: tables, batch
    verification) and "refexact" (TPU_MPC_TORCH_BATCH_VERIFY=0,
    TPU_MPC_TORCH_ENC_TABLES=0: every proof verified on its own, uniform
    randomizers).  Kernel counts are set to 0 just before each pass and read
    just after: the tables pass must launch all five kernels, the
    reference-exact one every kernel but K2, and run no batched check
    (zk/batch_verify.py:STATS).  Every offline check must hold, every
    signature verify under the pass's own ecdsa_verify_batch call (timed;
    SIG_SAMPLE of them also under ecdsa_verify), and the first launch at
    each shape keeps SAMPLE_LANES lanes that are held against python after
    the pass.  Logs each pass's seconds, kernel ms and launches, launch
    shapes, each shape's ms and bound, and peak card memory; host_profile:
    each pass under cProfile, its top functions by own time printed after
    it.  Returns each configuration's launches."""
    import cProfile
    import io
    import multiprocessing
    import pstats
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpu_mpc_torch import kernels, native
    from tpu_mpc_torch.ec import secp256k1 as dec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import batch_verify as bv

    S = SCALE_S
    card = card_line()
    saved = {k: os.environ.get(k) for k in (ENC_ENV, BV_ENV)}
    sampled, out = set(), {}
    t_phase = time.perf_counter()
    with ProcessPoolExecutor(os.cpu_count() or 1,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        try:
            for cfg, env in SCALE_CONFIGS.items():
                for k, v in env.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
                key = gg20.tile_key(key1s["tables" if env[ENC_ENV] == "1" else "uniform"], S)
                bv.reset_stats()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                kernels.reset_launches()
                prof = cProfile.Profile() if host_profile else None
                with Instrument(set(), sampled=sampled) as inst, \
                        _Timed(hec, "ecdsa_verify_batch") as vb, \
                        _Timed(native.hostmul, "mulmod_batch") as gmp:
                    t = time.perf_counter()
                    if prof:
                        prof.enable()
                    off = gg20.offline_stage(key, [0, 1], SessionRng(SCALE_SEED))
                    torch.cuda.synchronize()
                    t_off = time.perf_counter() - t
                    sig = gg20.sign_online(off, MSG)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t
                    if prof:
                        prof.disable()
                launches = dict(kernels.LAUNCHES)
                peak = torch.cuda.max_memory_allocated()
                stats = {"grouped": dict(bv.STATS["grouped"]),
                         "per_session": bv.STATS["per_session"]}
                bad = [k for k, v in off.debug_masks.items() if not bool(v.all())]
                require(off.ok.all() and not bad, f"scale[{cfg}]: offline checks failed: {bad}")
                require(sig.ok.all() and sig.sig_valid.all(), f"scale[{cfg}]: a signature failed")
                want = [k for k in launches if cfg == "tables" or k != "K2"]
                missing = [k for k in want if launches[k] == 0]
                require(not missing, f"scale[{cfg}]: kernels not launched: {missing}")
                if cfg == "tables":
                    require(stats["grouped"] and not stats["per_session"],
                            f"scale[tables]: the batched checks did not run alone: {stats}")
                else:
                    require(launches["K2"] == 0 and not stats["grouped"]
                            and stats["per_session"] > 0,
                            f"scale[refexact]: a batched check or K2 ran: {stats}, {launches}")
                # sig_valid is the pass's one ecdsa_verify_batch call over all
                # S signatures; a sample also through the single-signature oracle
                require(vb.calls == 1 and sig.sig_valid.shape == (S,),
                        f"scale[{cfg}]: {vb.calls} ecdsa_verify_batch calls in the pass")
                y = dec.points_to_host(key.y)
                picks = sample_lanes(S, SIG_SAMPLE)
                require(all(hec.ecdsa_verify(y[b], MSG % hec.N, int(sig.r[b]), int(sig.s[b]))
                            for b in picks), f"scale[{cfg}]: ecdsa_verify rejects a signature")
                busy = inst.busy()
                tot = sum(busy.get(k, 0.0) for k in launches)
                log(f"scale[{cfg}] S={S} ({card}): pass {dt:.2f} s (offline {t_off:.2f} s, "
                    f"online {dt - t_off:.2f} s), {S / dt:.2f} sig/s; every offline check "
                    f"holds; all {S} signatures pass ecdsa_verify_batch (OpenSSL, {vb.secs:.2f} s "
                    f"of the pass), {len(picks)} also ecdsa_verify; {gmp.calls} host_mulmod "
                    f"calls on GMP, their C calls {gmp.secs:.2f} s; batch verification "
                    f"{json.dumps(stats)}; " + _kernel_summary(inst, launches)
                    + f" ({100 * tot / (dt * 1e3):.1f}% of the pass); peak card memory "
                    f"{peak / 2 ** 30:.2f} GiB, {(peak - base) / 2 ** 30:.2f} GiB over the "
                    f"{base / 2 ** 30:.2f} GiB allocated before the pass")
                log(f"scale[{cfg}]: launch shapes "
                    + json.dumps(dict(sorted(inst.by_shape.items()))))
                if prof:
                    buf = io.StringIO()
                    pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(25)
                    log(f"scale[{cfg}]: host profile of the pass (cProfile, by own time)\n"
                        + buf.getvalue())
                t = time.perf_counter()
                held = check_samples(inst.samples, pool)
                log(f"scale[{cfg}]: {len(held)} launch shapes held against python on up to "
                    f"{SAMPLE_LANES} lanes each ({sum(smp['new'] for smp, _ in held)} new at "
                    f"S={S}) in {time.perf_counter() - t:.2f} s")
                for smp, k in held:
                    bms, bby, ims = launch_bound(smp["name"], smp["args"])
                    sh = smp["shape"]
                    second = {"K1": "IMAD", "K2": "IMAD", "K5": "divstep"}.get(smp["name"])
                    log(f"scale[{cfg}]: {sh}{' (new)' if smp['new'] else ''}: {k} lanes equal "
                        f"python; {inst.by_shape[sh]} launches, kernel {inst.shape_ms(sh):.4f} "
                        f"ms a launch, bound {bms:.5f} ms ({bby})"
                        + (f", {second} bound {ims:.5f} ms" if second else ""))
                out[cfg] = launches
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    log(f"scale: the phase {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 7: multi-tenant signing
# --------------------------------------------------------------------------

MT_GROUPS = 8


def run_multitenant(dev, res16):
    """G = 8 key groups of the S = 16 keygen serving S = 128 sessions
    interleaved (session s on group s % 8, R = 16), tables configuration:
    the tables stay compressed at the 8 key sets behind a gmap.  First K2
    over the key's 24 flattened table groups (8 key sets x 3 parties), then
    one warm-up pass, both with every K1-K5 launch shape held against its
    plain version on its first call; then one timed pass, kernel counts
    set to 0 just before it and read just after.  Each pass must launch all
    five kernels and take the G = 8 batch verification with no per-session
    fallback; every signature of the warm-up pass must verify under its own
    group's y."""
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
    # one timed pass (a second ran until the scale phase took its time)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Instrument(held) as inst:
        dt, t_off, stats = one_pass(False)
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
    return launches


# --------------------------------------------------------------------------
# phase 8: identifiable aborts (blame)
# --------------------------------------------------------------------------

BLAME_PATTERNS = {5: [[], [0], [1], [0, 1]], 6: [[], [0], [1], [0, 1]],
                  "decommit": [[], [0], [1]], 7: [[], [0], [1], [0, 1]]}


def _spec(step, S) -> list:
    """Session b's corrupted signer slots: pattern b % len of its step."""
    pat = BLAME_PATTERNS[step]
    return [pat[b % len(pat)] for b in range(S)]


def run_blame(dev, key, held: set):
    """GG20 identifiable aborts on the slice's tables key (S = BLAME_S, signers
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
# phase 9: wide quorums
# --------------------------------------------------------------------------

# n: (t, keygen seed), each keygen(1, t, n) at PAILLIER_BITS
QUORUM_KEYGENS = {5: (2, 0x2505), 8: (4, 0x4808)}
# (n, signers, S) of the timed tables passes: the JAX package's wide quorums
# (tests/test_gg20_adv_quorum.py), S chosen for 6144 and 7680 MtA pairs,
# about the 8192 of the S = 4096 pass
QUORUM_PASSES = ((5, [0, 2, 3, 4], 512), (8, [0, 1, 2, 4, 6, 7], 256))
QUORUM_UNIFORM_S = 128
QUORUM_SEED = 0x0A11
# n = 5 blame at S = 2, the scenarios of tests/test_gg20_adv_quorum{5,6,7}.py
QUORUM_BLAME = {5: [[0], [0, 3]], 6: [[0], [0, 3]], 7: [[1, 3], []]}


def _hold_class(smp) -> tuple:
    """Sampled launches with equal keys share one plain call: the same kernel
    at the same widths, exponent words, tables and chunk split (K2), comb
    table (K4) or base count (K3)."""
    from tpu_mpc_torch.core import pallas_rns as pr

    name = smp["name"]
    if name == "K1":
        return name, smp["nbits"], tuple(smp["x"].shape[1:]), tuple(smp["e"].shape[1:]), smp["emit"]
    if name == "K2":
        return (name, smp["nbits"], tuple(smp["e"].shape[1:]), tuple(id(t) for t in smp["shared"]),
                tuple(smp["nwins"]), tuple(smp["woffs"]),
                pr.k2_split(smp["B"], sum(smp["nwins"])))
    if name == "K3":
        return name, tuple(smp["pts"].shape[1:]), tuple(smp["dg"].shape[1:])
    if name == "K4":
        return name, id(smp["shared"])
    return (name,)


def hold_plain(samples) -> tuple:
    """Holds every sampled launch against its kernel's plain version on the
    sample's lanes (the inputs gathered at the launch, shared ctx rows
    repeated a lane, and the launch's tables: `shared`), the samples of one
    _hold_class in one plain call; any difference fails.  -> (launch shapes,
    lanes, plain calls)."""
    import torch

    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.ec import pallas_ec as pe

    groups = {}
    for smp in samples:
        groups.setdefault(_hold_class(smp), []).append(smp)
    lanes = 0
    for key, smps in groups.items():
        name = key[0]
        cat = lambda f: torch.cat([smp[f] for smp in smps])
        rows = lambda: torch.cat([smp["rows"].expand(len(smp["lanes"]), -1) for smp in smps])
        if name == "K1":
            want = pr.exp_plain(cat("x"), cat("e"), rows(), key[1], key[4])
        elif name == "K2":
            want = pr.fixed_plain(cat("e"), cat("grow"), rows(), smps[0]["shared"],
                                  list(key[4]), list(key[5]), key[1], split=key[6])
        elif name == "K3":
            want = pe.ladder_plain(cat("pts"), cat("dg"), cat("neg"))
        elif name == "K4":
            want = pe.comb_plain(cat("dg"), smps[0]["shared"])
        else:
            want = pe.affine_plain(cat("pts"))
        got = cat("out")
        if not torch.equal(got, want):
            o = 0
            for smp in smps:
                n = len(smp["lanes"])
                err = _maxerr(got[o:o + n], want[o:o + n])
                require(err == 0, f"{smp['shape']}: kernel != plain on {n} lanes "
                        f"(max |diff| {err})")
                o += n
            require(False, f"{name}: kernel != plain")
        lanes += got.shape[0]
    return len(samples), lanes, len(groups)


def run_quorum(dev) -> dict:
    """GG20 with more than two signers at 2048-bit Paillier and N~.
    keygen(1, 2, 5) and keygen(1, 4, 8) under fixed seeds (tables
    configuration; res.ok, no bad actors, y = (sum u) G, the x shares of the
    pass's signers reconstruct sum u); then one timed tables pass a quorum
    of QUORUM_PASSES (n = 5 signers [0, 2, 3, 4] at S = 512; n = 8 signers
    [0, 1, 2, 4, 6, 7] at S = 256) and one uniform pass of the n = 5
    quorum at S = 128: every offline check holds, the batched checks run
    with no per-session fallback, every signature passes the pass's one
    ecdsa_verify_batch call and SIG_SAMPLE of them ecdsa_verify; then n = 5
    blame on the tables key at S = 2 (steps 5 and 6 on [[0], [0, 3]], step 7
    on [[1, 3], []] of a clean pass), every list equal to its spec.  The
    first launch at each shape of each run keeps up to SAMPLE_LANES lanes,
    which are held against the plain version after the phase (hold_plain).
    Kernel counts are set to 0 just before each run and read just after.
    Logs each pass's seconds, sig/s, kernel ms and launches by kernel and
    shape, each shape's bound, and peak card memory.  Returns the launches
    of each run."""
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import secp256k1 as dec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.host import paillier as hp
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.protocols.gg20 import blame
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.vss import feldman
    from tpu_mpc_torch.zk import batch_verify as bv

    card = card_line()
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in (ENC_ENV, BV_ENV)}
    os.environ.pop(BV_ENV, None)
    os.environ[ENC_ENV] = "1"
    out, keys, samples = {}, {}, []
    signers_of = {n: signers for n, signers, _ in QUORUM_PASSES}

    def shapes_line(label, inst):
        """Per launch shape of a run: launches, ms a launch and bound.  Then
        each sample lets go of its launch's arguments but for its tables
        (K2, K4), so that the held samples keep no pass's tensors alive."""
        rows = []
        for smp in inst.samples:
            sh = smp["shape"]
            a = smp.pop("args")
            smp["B"] = a[0].shape[0]
            smp["shared"] = a[3] if smp["name"] == "K2" else a[1] if smp["name"] == "K4" else None
            bms, bby, ims = launch_bound(smp["name"], a)
            second = {"K1": "IMAD", "K2": "IMAD", "K5": "divstep"}.get(smp["name"])
            rows.append(f"{sh}{' (new)' if smp['new'] else ''}: {inst.by_shape[sh]} x "
                        f"{inst.shape_ms(sh):.4f} ms, bound {bms:.5f} ms ({bby})"
                        + (f", {second} {ims:.5f}" if second else ""))
        log(f"{label}: launch shapes (launches x kernel ms a launch, bound): " + "; ".join(rows))

    try:
        for n, (t, seed) in QUORUM_KEYGENS.items():
            torch.cuda.synchronize()
            kernels.reset_launches()
            with _Timed(gg20, "gen_paillier_batch") as primes_t, \
                    Instrument(set(), sampled=set()) as inst:
                t0 = time.perf_counter()
                res = gg20.keygen(1, t, n, SessionRng(seed), PAILLIER_BITS, device=dev)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            require(res.ok.all() and not res.bad_actors.any(),
                    f"quorum keygen n={n}: a check failed: bad actors {res.bad_actors.tolist()}")
            key = res.key
            total = sum(int(v) for v in key.u[0]) % hec.N
            require(dec.points_to_host_list(key.y)[0] == hec.mul(total),
                    f"quorum keygen n={n}: y != (sum u) G")
            sg = signers_of[n]
            require(feldman.reconstruct(sg, [int(key.x[0, j]) for j in sg]) == total,
                    f"quorum keygen n={n}: the x shares of {sg} do not reconstruct sum u")
            missing = [k for k in ("K1", "K3", "K4", "K5") if launches[k] == 0]
            require(not missing, f"quorum keygen n={n}: kernels not launched: {missing}")
            log(f"quorum keygen(1, {t}, {n}) (seed {seed:#x}, {PAILLIER_BITS}-bit Paillier and "
                f"N~): res.ok, no bad actors, y = (sum u) G, the x shares of {sg} reconstruct "
                f"sum u; wall {dt:.2f} s, host prime search {primes_t.secs:.2f} s ({4 * n} "
                f"primes of {PAILLIER_BITS // 2} bits); " + _kernel_summary(inst, launches))
            shapes_line(f"quorum keygen n={n}", inst)
            samples += inst.samples
            keys[n] = key
            out[f"keygen_n{n}"] = launches

        def timed_pass(label, key, signers, cfg):
            S = key.S
            os.environ[ENC_ENV] = CONFIGS[cfg]
            bv.reset_stats()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launches()
            with Instrument(set(), sampled=set()) as inst, \
                    _Timed(hec, "ecdsa_verify_batch") as vb:
                t = time.perf_counter()
                off = gg20.offline_stage(key, signers, SessionRng(QUORUM_SEED))
                torch.cuda.synchronize()
                t_off = time.perf_counter() - t
                sig = gg20.sign_online(off, MSG)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
            launches = dict(kernels.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            stats = {"grouped": dict(bv.STATS["grouped"]),
                     "per_session": bv.STATS["per_session"]}
            bad = [k for k, v in off.debug_masks.items() if not bool(v.all())]
            require(off.ok.all() and not bad, f"{label}: offline checks failed: {bad}")
            require(sig.ok.all() and sig.sig_valid.all() and vb.calls == 1,
                    f"{label}: a signature failed, or {vb.calls} ecdsa_verify_batch calls")
            missing = [k for k in launches if launches[k] == 0 and (cfg == "tables" or k != "K2")]
            require(not missing, f"{label}: kernels not launched: {missing}")
            require(cfg == "tables" or launches["K2"] == 0, f"{label}: K2 was launched")
            require(stats["grouped"] and not stats["per_session"],
                    f"{label}: the batched checks did not run alone: {stats}")
            y = dec.points_to_host(key.y)
            picks = sample_lanes(S, SIG_SAMPLE)
            require(all(hec.ecdsa_verify(y[b], MSG % hec.N, int(sig.r[b]), int(sig.s[b]))
                        for b in picks), f"{label}: ecdsa_verify rejects a signature")
            tp = len(signers)
            busy = inst.busy()
            tot = sum(busy.get(k, 0.0) for k in launches)
            log(f"{label} S={S}, t={key.t}, n={key.n}, signers {signers} ({S * tp * (tp - 1)} "
                f"MtA pairs; {card}): pass {dt:.2f} s (offline {t_off:.2f} s, online "
                f"{dt - t_off:.2f} s), {S / dt:.2f} sig/s; every offline check holds; all {S} "
                f"signatures pass ecdsa_verify_batch ({vb.secs:.2f} s of the pass), "
                f"{len(picks)} also ecdsa_verify; batch verification {json.dumps(stats)}; "
                + _kernel_summary(inst, launches)
                + f" ({100 * tot / (dt * 1e3):.1f}% of the pass); peak card memory "
                f"{peak / 2 ** 30:.2f} GiB, {(peak - base) / 2 ** 30:.2f} GiB over the "
                f"{base / 2 ** 30:.2f} GiB allocated before the pass")
            shapes_line(label, inst)
            samples.extend(inst.samples)
            return launches

        for n, signers, S in QUORUM_PASSES:
            out[f"tables_n{n}"] = timed_pass(f"quorum[tables n={n}]",
                                             gg20.tile_key(keys[n], S), signers, "tables")
        os.environ[ENC_ENV] = "0"
        key5u = gg20.key_from_material(_material(keys[5]), device=dev)
        require(key5u.ek.enc_tab_g is None and key5u.dlog_stmt.tables_rns is None,
                "quorum[uniform]: the key has tables")
        out["uniform_n5"] = timed_pass("quorum[uniform n=5]",
                                       gg20.tile_key(key5u, QUORUM_UNIFORM_S), signers_of[5],
                                       "uniform")

        # n = 5 blame at S = 2 on the tables key
        os.environ[ENC_ENV] = "1"
        key = gg20.tile_key(keys[5], 2)
        signers = signers_of[5]
        rng = SessionRng(0xB1A5)
        secs = {}

        def timed(name, fn, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] = round(time.perf_counter() - t, 3)
            return r

        def gate(name, got, want):
            require(got == want, f"quorum blame: {name} gave {got}, the spec {want}")

        torch.cuda.synchronize()
        kernels.reset_launches()
        with Instrument(set(), sampled=set()) as inst:
            off = timed("offline_stage[clean]", gg20.offline_stage, key, signers, rng)
            require(off.ok.all(), "quorum blame: the clean offline stage failed")
            spec7 = QUORUM_BLAME[7]
            sig = timed("sign_online[7]", gg20.sign_online, off, MSG,
                        corrupt={"step": 7, "parties": spec7})
            require([bool(v) for v in sig.sig_valid] == [not p for p in spec7],
                    "quorum blame[7]: the corrupted session must fail and the honest verify")
            gate("phase7_blame", timed("phase7_blame", blame.phase7_blame, off, sig.s_i, MSG),
                 spec7)
            for step in (5, 6):
                spec = QUORUM_BLAME[step]
                off = timed(f"offline_stage[{step}]", gg20.offline_stage, key, signers, rng,
                            corrupt={"step": step, "parties": spec})
                require(not off.ok.any(), f"quorum blame[{step}]: off.ok holds in a session")
                if step == 5:
                    got = timed("phase5_blame", blame.phase5_blame, key, off)
                else:
                    with _Timed(hp, "open") as opens:
                        got = timed("phase6_blame", blame.phase6_blame, key, off, rng)
                gate(f"phase{step}_blame", got, spec)
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in launches if launches[k] == 0]
        require(not missing, f"quorum blame: kernels not launched: {missing}")
        out["blame_n5"] = launches
        samples += inst.samples
        log(f"quorum blame n=5: S=2, signers {signers}, tables; step 5 and 6 on "
            f"{QUORUM_BLAME[5]}, step 7 on {spec7}: every blame list equals its spec, off.ok "
            f"False in every corrupted session; seconds {json.dumps(secs)}; phase6_blame's "
            f"host Paillier opens ({opens.calls} at {PAILLIER_BITS} bits) {opens.secs:.2f} s; "
            + _kernel_summary(inst, launches))
        shapes_line("quorum blame n=5", inst)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    t = time.perf_counter()
    nshapes, nlanes, ncalls = hold_plain(samples)
    log(f"quorum: every launch shape of the phase ({nshapes}: its keygens, passes and blame) "
        f"held against its plain version on up to {SAMPLE_LANES} lanes each ({nlanes} lanes in "
        f"{ncalls} plain calls, {time.perf_counter() - t:.2f} s)")
    log(f"quorum: the phase {time.perf_counter() - t_phase:.1f} s")
    return out


# --------------------------------------------------------------------------
# phase 10: GG18
# --------------------------------------------------------------------------

GG18_KEYGEN = (16, 0x6618)          # S, SessionRng seed
GG18_SUBSETS = ([0, 1], [1, 2], [0, 2], [0, 1, 2])


def run_gg18(dev, key, held: set):
    """GG18 on the card.  keygen(16, 1, 3, SessionRng(0x6618), 2048): every
    check passes, y = (sum u) G and the x shares of every signer subset of
    GG18_SUBSETS reconstruct sum u, every launch shape held against its plain
    version.  Then sign at S = 128 on the slice's tiled tables key (GG18's
    sign reads S, t, x, ek, dk and y of it, which a GG20 key has): one
    warm-up pass per subset size ([0, 1] and [0, 1, 2], every launch shape
    held), then one timed pass per subset [0, 1], [1, 2], [0, 2], [0, 1, 2],
    kernel counts set to 0 just before each and read just after; each must
    launch all five kernels, every signature must verify with low s and
    sig.ok.  Returns the launches of the timed [0, 1] pass."""
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
        for sub in GG18_SUBSETS:
            require(feldman.reconstruct(sub, [int(kg.x[b, j]) for j in sub]) == total,
                    f"gg18 keygen: x shares of {sub} do not reconstruct sum u in key set {b}")
    missing = [k for k in ("K1", "K3", "K4", "K5") if kg_launches[k] == 0]
    require(not missing, f"gg18 keygen: kernels not launched: {missing}")
    busy = inst.busy()
    dev_s = sum(v for k, v in busy.items() if not k.startswith("K1 ")) / 1e3
    log(f"gg18 keygen S={S_kg} (seed {seed:#x}, t=1, n=3, {PAILLIER_BITS}-bit Paillier): res.ok "
        f"all true, y = (sum u) G and the x shares of every subset of {list(GG18_SUBSETS)} "
        f"reconstruct sum u; wall {dt:.2f} s (the plain holds included), host prime search "
        f"{primes_t.secs:.2f} s "
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

    for subset in ([0, 1], [0, 1, 2]):
        with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
            dt = one_pass(subset)
        log(f"gg18 sign: warm-up pass {subset} {dt:.2f} s, S={S}; held against plain: "
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


# --------------------------------------------------------------------------
# phases 11 and 12: the two-party protocols
# --------------------------------------------------------------------------

L17_S, L17_SEED = 64, 0x2017        # sessions, each with its own Paillier key and N~
# the two-party bench message (benches/run_benches.py:47)
MSG_2P = 0x31F7A65E315586AC198BD798B6629CE1B4C4E5AB37292BFA94B22C3B6A953E9B
CCLST_S, CCLST_SEED, CCLST_DISC_BITS = 1, 0xCC19, 1348


def run_lindell17(dev, held: set):
    """Lindell'17 two-party ECDSA on the card at S = 64 sessions, 2048-bit
    Paillier and N~, every session its own key (no tables: K2 is never
    launched), one rng chain from SessionRng(0x2017): keygen (every ok, y =
    (x1 x2 mod q) G on the host); sign of MSG_2P, a warm-up pass then a
    timed one (every signature verifies under the host oracle with low s,
    every ok); the Lindell -> GG18 MtA conversion (alpha + beta = x1 x2 mod
    q); refresh_private_key with random factors (the pubkey unchanged), then
    sign again; the interactive PDL under the keygen's Paillier keys, on
    fresh x < q/3 (every session accepts) and on x = q - 5 (every session's
    range proof rejects).  Every K1-K5 launch shape is held against its plain
    version on its first call.  Kernel counts are set to 0 just before the
    phase and read just after; K1, K3, K4, K5 must launch and K2 must not."""
    import numpy as np
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.mta.mta import paillier_encrypt_ints
    from tpu_mpc_torch.protocols.lindell17 import batch as l17
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import pdl

    S, N = L17_S, hec.N
    rng = SessionRng(L17_SEED)
    secs = {}

    def timed(name, fn, *a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        secs[name] = round(secs.get(name, 0.0) + time.perf_counter() - t, 3)
        return out

    def check_sign(name, sig):
        # sig_valid: every signature checked by the pure-python ECDSA verifier
        require(bool(np.asarray(sig.ok).all()) and bool(np.asarray(sig.sig_valid).all()),
                f"lindell17 {name}: a check or a signature failed")
        require(all(int(v) <= N // 2 for v in sig.s), f"lindell17 {name}: a high s")

    def pdl_round(tag, x):
        ek, dk = kg.p1.ek, kg.p1.dk
        r = rng.units_below(ek.n, (S,))
        c = paillier_encrypt_ints(ek, x, r)
        stmt = pdl.PDLStatementBatch(ciphertext=c, ek=ek, Q_pt=ec.mul_generator(
            ec.sc_from_ints(np.mod(x, N), dev)))
        wit = pdl.PDLWitnessBatch(x=x, r=r, dk=dk)
        v1, vs = timed(f"pdl[{tag}] verifier", pdl.verifier_message1, stmt, rng)
        p1, ps = timed(f"pdl[{tag}] prover", pdl.prover_message1, wit, stmt, v1, rng)
        v2, range_ok = timed(f"pdl[{tag}] verifier", pdl.verifier_message2, p1, stmt, vs)
        p2, prover_ok = timed(f"pdl[{tag}] prover", pdl.prover_message2, v1, v2, wit, ps)
        final = timed(f"pdl[{tag}] verifier", pdl.verifier_finalize, p1, p2, vs)
        return range_ok, prover_ok, final

    torch.cuda.synchronize()
    t_phase = time.perf_counter()
    kernels.reset_launches()
    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
        with _Timed(l17, "gen_paillier_batch") as primes_t:
            kg = timed("keygen", l17.keygen, S, rng, PAILLIER_BITS, device=dev)
        kg_dev_s = sum(v for k, v in inst.busy().items() if not k.startswith("K1 ")) / 1e3
        require(bool(np.asarray(kg.ok).all()), f"lindell17 keygen: ok {kg.ok.tolist()}")
        y = ec.points_to_host_list(kg.p1.pubkey)
        for b in range(S):
            require(y[b] == hec.mul(int(kg.p1.x1[b]) * int(kg.p2.x2[b]) % N),
                    f"lindell17 keygen: y != (x1 x2) G in session {b}")
        check_sign("sign[warm-up]", timed("sign[warm-up]", l17.sign, kg, MSG_2P, rng))
        holds = len(inst.new_holds)
        check_sign("sign", timed("sign", l17.sign, kg, MSG_2P, rng))
        require(len(inst.new_holds) == holds, "lindell17 sign: the timed pass launched a shape "
                f"the warm-up did not: {inst.new_holds[holds:]}")
        msg_b, beta = timed("mta", l17.party_two_to_mta_message_b, kg.p2, rng)
        alpha, ok = timed("mta", l17.party_one_to_mta_message_b, kg.p1, msg_b)
        require(bool(np.asarray(ok).all()), "lindell17 mta: a check failed")
        for b in range(S):
            require((int(alpha[b]) + int(beta[b])) % N
                    == int(kg.p1.x1[b]) * int(kg.p2.x2[b]) % N,
                    f"lindell17 mta: alpha + beta != x1 x2 in session {b}")
        with _Timed(l17, "gen_paillier_batch") as primes_r:
            kg2 = timed("refresh", l17.refresh_private_key, kg, rng.scalars((S,)), rng)
        require(bool(np.asarray(kg2.ok).all())
                and ec.points_to_host_list(kg2.p1.pubkey) == y,
                "lindell17 refresh: the pubkey changed")
        check_sign("sign[refreshed]", timed("sign[refreshed]", l17.sign, kg2, MSG_2P, rng))
        range_ok, prover_ok, final = pdl_round("honest", rng.below(N // 3, (S,)))
        require(bool((range_ok & prover_ok & final).all()),
                f"lindell17 pdl: an honest session rejected: range {range_ok.tolist()}, "
                f"prover {prover_ok.tolist()}, final {final.tolist()}")
        range_ok, prover_ok, final = pdl_round("x = q - 5", np.asarray([N - 5] * S, dtype=object))
        require(not bool(range_ok.any()),
                f"lindell17 pdl: x = q - 5 passed the range proof: {range_ok.tolist()}")
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    missing = [k for k in ("K1", "K3", "K4", "K5") if launches[k] == 0]
    require(not missing and launches["K2"] == 0,
            f"lindell17: K1, K3, K4, K5 must launch and K2 must not: {launches}")
    log(f"lindell17 keygen S={S} (seed {L17_SEED:#x}, {PAILLIER_BITS}-bit Paillier and N~): ok "
        f"all true, y = (x1 x2) G in every session; wall {secs['keygen']:.2f} s (the plain "
        f"holds included), host prime search {primes_t.secs:.2f} s ({4 * S} primes of "
        f"{PAILLIER_BITS // 2} bits), kernel device time {kg_dev_s:.3f} s, the rest (host "
        f"work and the plain holds) {secs['keygen'] - primes_t.secs - kg_dev_s:.2f} s")
    log(f"lindell17 sign S={S}: warm-up pass {secs['sign[warm-up]']:.2f} s (holds), timed pass "
        f"{secs['sign']:.2f} s, {S / secs['sign']:.2f} sig/s; every signature verifies with low "
        f"s, ok all true; after refresh {secs['sign[refreshed]']:.2f} s")
    log(f"lindell17 mta: alpha + beta = x1 x2 in every session, {secs['mta']:.2f} s; refresh "
        f"wall {secs['refresh']:.2f} s (host prime search {primes_r.secs:.2f} s, {2 * S} primes), "
        f"pubkey unchanged")
    log(f"lindell17 pdl: honest sessions all accept (prover {secs['pdl[honest] prover']:.2f} s, "
        f"verifier {secs['pdl[honest] verifier']:.2f} s, the first launch of each shape held "
        f"against plain); x = q - 5: every range proof rejects (prover "
        f"{secs['pdl[x = q - 5] prover']:.2f} s, verifier {secs['pdl[x = q - 5] verifier']:.2f} s)")
    log(f"lindell17: seconds {json.dumps(secs)}; the phase {time.perf_counter() - t_phase:.1f} s "
        f"with its checks and holds")
    log("lindell17: " + _kernel_summary(inst, launches))
    log(f"lindell17: launch shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; held "
        f"against plain in this phase: {', '.join(inst.new_holds)}")
    return launches


def run_cclst19():
    """CCLST'19 (HSM-CL over class groups), host-only as in the reference:
    keygen(1) at the production discriminant of 1348 bits under
    SessionRng(0xCC19), then sign of MSG_2P on the same rng.  Every session
    ok, the signature valid under the host oracle with low s; no kernel is
    launched (counts set to 0 just before the phase and read just after)."""
    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.host import class_group as cg
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.cclst19 import batch as cclst
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(CCLST_SEED)
    kernels.reset_launches()
    with _Timed(cg.CLGroup, "from_seed") as setup:
        t = time.perf_counter()
        sessions = cclst.keygen(CCLST_S, rng, disc_bits=CCLST_DISC_BITS)
        kg_s = time.perf_counter() - t
    t = time.perf_counter()
    sigs = cclst.sign(sessions, MSG_2P, rng)
    sign_s = time.perf_counter() - t
    require(all(s.ok for s in sessions), "cclst19 keygen: a check failed")
    for sess, sig in zip(sessions, sigs):
        require(sig.valid and sig.s <= hec.N // 2
                and hec.ecdsa_verify(sess.pubkey, MSG_2P % hec.N, sig.r, sig.s),
                "cclst19 sign: a signature is invalid or has a high s")
    launches = dict(kernels.LAUNCHES)
    require(not any(launches.values()), f"cclst19: the host-only path launched {launches}")
    log(f"cclst19 S={CCLST_S} (seed {CCLST_SEED:#x}, {CCLST_DISC_BITS}-bit discriminant): "
        f"keygen ok, signature valid with low s, no kernel launched; host seconds: keygen "
        f"{kg_s:.2f} (of which the CL group setup {setup.secs:.2f}), sign {sign_s:.2f}")


# --------------------------------------------------------------------------
# phase 13: the runtime (state machines, relays, CLI and GG18 clients)
# --------------------------------------------------------------------------

RUNTIME_GOLDEN = os.path.join("tests", "gpu", "fixtures", "runtime_768.json")
RUNTIME_BITS = 2048                  # the CLI's GG20 keygen, at production width
GG18_CLIENT_BITS = 1024             # cut from 2048 to keep the whole run under 600 s
RUNTIME_MSG = "tpu-mpc runtime smoke"
QUORUMS = ((1, 2), (2, 3))
CHILD_TIMEOUT = 400                  # seconds for one party process


def _recorder(log_list: list):
    def rec(msg):
        log_list.append(msg.to_json())
        return msg
    return rec


def run_runtime_replay(dev, repo, held: set) -> dict:
    """Step 1: the GG20 state machines in one process on the card, held to
    the JAX package's transcript (tests/gpu/fixtures/runtime_768.json, read
    as JSON): run_simulation over Gg20Keygen(i, 1, 3, SessionRng(100 + i),
    768), then Gg20OfflineStage for its s_l from SessionRng(201) and (202),
    and sign_manual of its message.  Every delivered message string and every
    output must equal the golden's; every K1-K5 launch shape is held against
    its plain version on its first call.  Counts are set to 0 just before
    and read just after: K1, K3, K4 and K5 must launch, K2 must not."""
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.runtime.gg20_keygen_sm import Gg20Keygen
    from tpu_mpc_torch.runtime.gg20_sign_sm import Gg20OfflineStage, partial_sig_local, sign_manual
    from tpu_mpc_torch.runtime.state_machine import run_simulation
    from tpu_mpc_torch.runtime.wire import decode_value, encode_value
    from tpu_mpc_torch.utils.rng import SessionRng

    with open(os.path.join(repo, RUNTIME_GOLDEN)) as f:
        gold = json.load(f)
    bits, m = gold["bits"], int(gold["m"])
    torch.cuda.synchronize()
    kernels.reset_launches()
    with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
        t = time.perf_counter()
        kg_msgs = []
        kg = [Gg20Keygen(i, gold["t"], gold["n"], SessionRng(seed), paillier_bits=bits,
                         device=dev) for i, seed in enumerate(gold["keygen_seeds"], 1)]
        outs = run_simulation(kg, tamper=_recorder(kg_msgs))
        kg_s = time.perf_counter() - t
        require(kg_msgs == gold["keygen_msgs"], "runtime replay: the keygen messages differ "
                f"from the golden's (first at {_first_diff(kg_msgs, gold['keygen_msgs'])})")
        require([encode_value(o) for o in outs] == gold["keygen_outputs"],
                "runtime replay: the keygen outputs differ from the golden's")
        t = time.perf_counter()
        off_msgs = []
        s_l = gold["s_l"]
        sms = [Gg20OfflineStage(li, s_l, outs[g], SessionRng(seed), device=dev)
               for li, (g, seed) in enumerate(zip(s_l, gold["offline_seeds"]), 1)]
        off = run_simulation(sms, tamper=_recorder(off_msgs))
        off_s = time.perf_counter() - t
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    require(off_msgs == gold["offline_msgs"], "runtime replay: the offline messages differ "
            f"from the golden's (first at {_first_diff(off_msgs, gold['offline_msgs'])})")
    require([encode_value(o) for o in off] == gold["offline_outputs"],
            "runtime replay: the offline outputs differ from the golden's")
    partials = [partial_sig_local(o, m) for o in off]
    sig = sign_manual(off[0], m, partials[1:])
    require([str(v) for v in partials] == gold["partials"] and sig == decode_value(gold["sig"])
            and sig["valid"], "runtime replay: the signature differs from the golden's")
    missing = [k for k in ("K1", "K3", "K4", "K5") if launches[k] == 0]
    require(not missing and launches["K2"] == 0,
            f"runtime replay: K1, K3, K4, K5 must launch and K2 must not: {launches}")
    log(f"runtime replay ({bits}-bit Paillier, t=1, n=3, s_l={s_l}): {len(kg_msgs)} keygen and "
        f"{len(off_msgs)} offline messages, every output and the signature equal to "
        f"{RUNTIME_GOLDEN}; keygen {kg_s:.2f} s, offline stage {off_s:.2f} s (the plain holds "
        f"included)")
    log("runtime replay: " + _kernel_summary(inst, launches))
    log(f"runtime replay: launch shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; held "
        f"against plain in this step: {', '.join(inst.new_holds)}")
    return launches


def _first_diff(a: list, b: list):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return min(len(a), len(b)) if len(a) != len(b) else None


class _Children:
    """The processes this phase starts; every one is stopped on the way out."""

    def __init__(self, repo, work):
        self.repo, self.work, self.procs = repo, work, []
        self.env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def start(self, tag, module, *args):
        out = open(os.path.join(self.work, tag + ".out"), "w+")
        err = open(os.path.join(self.work, tag + ".err"), "w+")
        p = subprocess.Popen([sys.executable, "-m", module, *map(str, args)], cwd=self.work,
                             env=self.env, stdout=out, stderr=err, text=True,
                             start_new_session=True)
        p.tag, p.out, p.err, p.t0 = tag, out, err, time.perf_counter()
        self.procs.append(p)
        return p

    def server(self, module, *args) -> tuple:
        """Start a relay on a free port; -> (process, its address)."""
        p = subprocess.Popen([sys.executable, "-m", module, "--port", "0", *args],
                             cwd=self.work, env=self.env, stdout=subprocess.PIPE, text=True,
                             start_new_session=True)
        self.procs.append(p)
        line = p.stdout.readline()
        require(" on 127.0.0.1:" in line, f"{module}: no listening line ({line!r})")
        return p, "http://127.0.0.1:" + line.split("127.0.0.1:")[1].split()[0]

    def wait(self, procs) -> list:
        """Wait for `procs`; each must exit 0 on the card, its launch counts
        above 0 for K1, K3, K4, K5 and 0 for K2.  -> [(stdout, the device
        line's dict, wall seconds)]."""
        res = []
        for p in procs:
            try:
                p.wait(timeout=max(1, CHILD_TIMEOUT - (time.perf_counter() - p.t0)))
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
            wall = time.perf_counter() - p.t0
            p.out.seek(0)
            p.err.seek(0)
            out, err = p.out.read(), p.err.read()
            require(p.returncode == 0,
                    f"runtime: {p.tag} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
            lines = [ln for ln in err.splitlines() if ln.startswith("device: ")]
            require(lines, f"runtime: {p.tag} printed no device line:\n{err[-2000:]}")
            info = json.loads(lines[-1][len("device: "):])
            la = info["launches"]
            require(info["device"].startswith("cuda") and la["K2"] == 0
                    and all(la[k] > 0 for k in ("K1", "K3", "K4", "K5")),
                    f"runtime: {p.tag} did not run its kernels on the card: {info}")
            res.append((out, info, wall))
        return res

    def stop(self):
        """Stop every process started here with its session (a party's
        prime-search workers included)."""
        for p in self.procs:
            for sig in (signal.SIGTERM, signal.SIGKILL):
                try:
                    os.killpg(p.pid, sig)
                except ProcessLookupError:
                    break
                try:
                    p.wait(timeout=10)
                    break
                except subprocess.TimeoutExpired:
                    continue
            for f in (getattr(p, "out", None), getattr(p, "err", None)):
                if f is not None:
                    f.close()


def _sig_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    require(lines, f"runtime: no signature line in {out[-500:]!r}")
    return json.loads(lines[-1])


def run_runtime_processes(repo, work) -> dict:
    """Steps 2 and 3: party processes on the card over the relays.  The
    GG20 relay (tpu_mpc_torch.runtime.relay_server) on a free port, three
    `cli keygen -t 1 -n 3 --paillier-bits 2048` processes at once, then
    `cli sign` for the quorums 1,2 and 2,3, each quorum's two signers in a
    fresh room: both must print the same (r, s) with "valid": true, and
    every signature must verify under the one y of the three key files (the
    host oracle); the two quorums sign at once, each in its own room.  Then
    the GG18 KV relay with {"parties": "3", "threshold": "1"}, three
    gg18_keygen_client and two gg18_sign_client processes at 1024 bits: y the
    same in every key store and the sum of y_i, every pair of x shares
    reconstructs sum u, both signers' (r, s) equal, valid under y, low s.
    Every process must exit 0, log the card as its device and have launched
    K1, K3, K4 and K5 (and not K2).  -> walls."""
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.runtime.cli import load_local_key
    from tpu_mpc_torch.vss import feldman

    walls = {}
    ch = _Children(repo, work)
    try:
        t = time.perf_counter()
        probe = subprocess.run(
            [sys.executable, "-c", "import time; t = time.perf_counter(); import torch; "
             "torch.zeros(1, device='cuda'); torch.cuda.synchronize(); "
             "print(time.perf_counter() - t)"],
            cwd=work, env=ch.env, capture_output=True, text=True, timeout=120)
        require(probe.returncode == 0, f"runtime: the start-up probe failed: {probe.stderr}")
        walls["process start-up"] = time.perf_counter() - t
        walls["import torch + CUDA context"] = float(probe.stdout.split()[-1])

        _, addr = ch.server("tpu_mpc_torch.runtime.relay_server")
        cli = "tpu_mpc_torch.runtime.cli"
        t = time.perf_counter()
        kgs = [ch.start(f"keygen{i}", cli, "keygen", "-a", addr, "-r", "kg", "-i", i, "-t", 1,
                        "-n", 3, "-o", f"local{i}.json", "--paillier-bits", RUNTIME_BITS)
               for i in (1, 2, 3)]
        res = ch.wait(kgs)
        walls["gg20 cli keygen"] = time.perf_counter() - t
        keys = [load_local_key(os.path.join(work, f"local{i}.json")) for i in (1, 2, 3)]
        y = keys[0]["y"]
        require(all(k["y"] == y for k in keys) and
                all(k["paillier_p"].bit_length() * 2 == RUNTIME_BITS for k in keys),
                "runtime: the three key files disagree on y or on the Paillier width")
        log(f"runtime cli keygen: 3 processes, t=1, n=3, {RUNTIME_BITS}-bit Paillier, one y; "
            f"wall {walls['gg20 cli keygen']:.2f} s; per process (wall s, launches): "
            + "; ".join(f"{p.tag} {w:.2f} {json.dumps(info['launches'])}"
                        for p, (_, info, w) in zip(kgs, res)))
        digest = int.from_bytes(hashlib.sha256(RUNTIME_MSG.encode()).digest(), "big")
        # both quorums at once, each in its own room (party 2 signs in both)
        t = time.perf_counter()
        sg = {q: [ch.start(f"sign{''.join(map(str, q))}-{i}", cli, "sign", "-a", addr, "-r",
                           "s" + "".join(map(str, q)), "-p", ",".join(map(str, q)), "-d",
                           RUNTIME_MSG, "-l", f"local{i}.json") for i in q] for q in QUORUMS}
        for quorum, procs in sg.items():
            res = ch.wait(procs)
            walls[f"gg20 cli sign {quorum}"] = max(w for _, _, w in res)
            sigs = [_sig_line(out) for out, _, _ in res]
            require(all(s == sigs[0] for s in sigs) and sigs[0]["valid"] is True,
                    f"runtime: quorum {quorum} signers disagree or are invalid: {sigs}")
            r, s_ = int(sigs[0]["r"], 16), int(sigs[0]["s"], 16)
            require(hec.ecdsa_verify(y, digest % hec.N, r, s_) and s_ <= hec.N // 2,
                    f"runtime: quorum {quorum}'s signature does not verify under y (low s)")
            log(f"runtime cli sign {quorum}: both signers print r={sigs[0]['r']} "
                f"s={sigs[0]['s']}, valid, verified under y with low s; wall "
                f"{walls[f'gg20 cli sign {quorum}']:.2f} s; per process (wall s, launches): "
                + "; ".join(f"{p.tag} {w:.2f} {json.dumps(info['launches'])}"
                            for p, (_, info, w) in zip(procs, res)))
        walls["gg20 cli sign, both quorums"] = time.perf_counter() - t

        params = os.path.join(work, "params.json")
        with open(params, "w") as f:
            json.dump({"parties": "3", "threshold": "1"}, f)
        _, kv = ch.server("tpu_mpc_torch.runtime.kv_server", "--params", params)
        t = time.perf_counter()
        kgs = [ch.start(f"gg18keygen{i}", "tpu_mpc_torch.runtime.gg18_keygen_client",
                        "--address", kv, "--params", params, "--output", f"gg18_{i}.json",
                        "--paillier-bits", GG18_CLIENT_BITS) for i in (1, 2, 3)]
        res = ch.wait(kgs)
        walls["gg18 keygen clients"] = time.perf_counter() - t
        stores = [load_local_key(os.path.join(work, f"gg18_{i}.json")) for i in (1, 2, 3)]
        by_num = {k["party_num"]: k for k in stores}
        require(sorted(by_num) == [1, 2, 3], "gg18 clients: party numbers are not 1, 2, 3")
        y18 = stores[0]["y"]
        acc = None
        for pt in stores[0]["y_vec"]:
            acc = pt if acc is None else hec.add(acc, pt)
        total = sum(k["u_i"] for k in stores) % hec.N
        require(all(k["y"] == y18 for k in stores) and acc == y18 and hec.mul(total) == y18,
                "gg18 clients: y differs between key stores or is not the sum of y_i")
        for a, b in ((1, 2), (2, 3), (1, 3)):
            require(feldman.reconstruct([a - 1, b - 1], [by_num[a]["x_i"], by_num[b]["x_i"]])
                    == total, f"gg18 clients: the x shares of {a}, {b} do not reconstruct")
        log(f"gg18 keygen clients: 3 processes, {GG18_CLIENT_BITS}-bit Paillier; one y = sum y_i "
            f"= (sum u) G, every pair of x shares reconstructs sum u; wall "
            f"{walls['gg18 keygen clients']:.2f} s; per process (launches): "
            + "; ".join(json.dumps(info["launches"]) for _, info, _ in res))
        t = time.perf_counter()
        sg = [ch.start(f"gg18sign{i}", "tpu_mpc_torch.runtime.gg18_sign_client", "--address",
                       kv, "--local-share", f"gg18_{i}.json", "--data-to-sign", RUNTIME_MSG)
              for i in (1, 2)]
        res = ch.wait(sg)
        walls["gg18 sign clients"] = time.perf_counter() - t
        sigs = [_sig_line(out) for out, _, _ in res]
        r, s_ = int(sigs[0]["r"], 16), int(sigs[0]["s"], 16)
        require(all(s == sigs[0] for s in sigs) and sigs[0]["valid"] is True
                and hec.ecdsa_verify(y18, digest % hec.N, r, s_) and s_ <= hec.N // 2,
                f"gg18 sign clients: the signers disagree or the signature is invalid: {sigs}")
        log(f"gg18 sign clients: 2 processes, both print r={sigs[0]['r']} s={sigs[0]['s']}, "
            f"valid under y with low s; wall {walls['gg18 sign clients']:.2f} s; per process "
            "(launches): " + "; ".join(json.dumps(info["launches"]) for _, info, _ in res))
    finally:
        ch.stop()
    log(f"runtime walls (s): {json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    return walls


# --------------------------------------------------------------------------
# phase 14: sessions-axis sharding
# --------------------------------------------------------------------------

SHARD_ENTRIES = 4                    # the mesh that repeats the one card
RANK_LANES = 16                      # lanes of the one-rank NCCL group's checks


def run_sharding(dev, keys, wants, slice_dt) -> dict:
    """GG20 tables passes of the slice's key at S = 128 under SessionRng
    (SLICE_SEED) under sessions_mesh() (every visible card), under a mesh
    that repeats this card SHARD_ENTRIES times, and, where the machine has
    two cards or more, a mesh over two real cards.  Under each mesh a
    warm-up pass holds every K1-K5 piece shape against its plain version on
    its first call, then a timed pass, counts set to 0 just before it and
    read just after, must launch all five kernels; every pass's (r, s,
    recid) must equal the slice's unsharded tables warm-up pass's
    (wants["tables"]), bit for bit.  Then one uniform pass under
    sessions_mesh(), which must launch every kernel but K2 and equal the
    slice's unsharded uniform warm-up pass (wants["uniform"]).  The timed
    passes are logged beside `slice_dt`, the slice's first unsharded timed
    tables pass.  Returns the timed pass's launches under the repeated
    mesh."""
    import torch

    from tpu_mpc_torch import kernels, sharding
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng

    os.environ[ENC_ENV] = "1"
    key, want = keys["tables"], wants["tables"]
    S = key.S

    def one_pass(label, key=key):
        t = time.perf_counter()
        off = gg20.offline_stage(key, [0, 1], SessionRng(SLICE_SEED))
        sig = gg20.sign_online(off, MSG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        require(off.ok.all() and sig.sig_valid.all() and sig.ok.all(),
                f"sharding[{label}]: a check or a signature failed")
        return _sig_ints(sig), dt

    meshes = [("sessions_mesh()", sharding.sessions_mesh()),
              (f"{SHARD_ENTRIES} x {dev}", sharding.sessions_mesh(devices=[dev] * SHARD_ENTRIES))]
    if torch.cuda.device_count() >= 2:
        meshes.append(("2 cards", sharding.sessions_mesh(devices=["cuda:0", "cuda:1"])))
    else:
        log(f"sharding: one card visible (torch.cuda.device_count() = "
            f"{torch.cuda.device_count()}): no mesh over two real cards")
    held, out = set(), None
    for label, mesh in meshes:
        with sharding.use_mesh(mesh):
            with Instrument(held, hold=("K1", "K2", "K3", "K4", "K5")) as inst:
                got, dt_w = one_pass(label)
            require(got == want, f"sharding[{label}]: the warm-up pass's (r, s, recid) differ "
                    "from the unsharded pass's")
            warm_holds = list(inst.new_holds)
            torch.cuda.synchronize()
            kernels.reset_launches()
            with Instrument(held) as inst:
                got, dt = one_pass(label)
            launches = dict(kernels.LAUNCHES)
        require(got == want, f"sharding[{label}]: (r, s, recid) differ from the unsharded pass's")
        missing = [k for k in launches if launches[k] == 0]
        require(not missing, f"sharding[{label}]: kernels not launched: {missing}")
        require(set(inst.by_shape) <= held, f"sharding[{label}]: piece shapes never held "
                f"against plain: {sorted(set(inst.by_shape) - held)}")
        log(f"sharding[{label}] {mesh}: (r, s, recid) of all {S} sessions equal the unsharded "
            f"pass's; warm-up {dt_w:.2f} s (holds included), timed pass {dt:.2f} s, "
            f"{S / dt:.2f} sig/s (the slice's unsharded timed pass: {slice_dt:.2f} s); "
            + _kernel_summary(inst, launches))
        log(f"sharding[{label}]: piece shapes {json.dumps(dict(sorted(inst.by_shape.items())))}; "
            f"held against plain in its warm-up: {', '.join(warm_holds)}")
        if label.startswith(f"{SHARD_ENTRIES} x"):
            out = launches
    # the uniform configuration (no tables, uniform randomizers) under a mesh
    os.environ[ENC_ENV] = CONFIGS["uniform"]
    mesh = sharding.sessions_mesh()
    torch.cuda.synchronize()
    kernels.reset_launches()
    try:
        with sharding.use_mesh(mesh), Instrument(held) as inst:
            got, dt = one_pass("uniform", keys["uniform"])
    finally:
        os.environ[ENC_ENV] = "1"
    launches = dict(kernels.LAUNCHES)
    require(got == wants["uniform"], "sharding[uniform]: (r, s, recid) differ from the "
            "unsharded uniform pass's")
    missing = [k for k in launches if k != "K2" and launches[k] == 0]
    require(not missing and launches["K2"] == 0,
            f"sharding[uniform]: kernels not launched {missing}, or K2 launched: {launches}")
    log(f"sharding[uniform] {mesh}: (r, s, recid) of all {S} sessions equal the unsharded "
        f"uniform pass's; pass {dt:.2f} s, {S / dt:.2f} sig/s; " + _kernel_summary(inst, launches))
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_sharding_ranks(dev):
    """A one-rank NCCL group in this process (TPU_MPC_TORCH_DISTRIBUTED=1,
    WORLD_SIZE=1, a free port): under sessions_mesh(), now a mesh over the
    ranks, a 2048-bit ModCtx.pow and mul_generator + to_affine over
    RANK_LANES lanes through the rank path (the input digest's all-gather,
    the piece, the output's all-gather) equal python pow and the host EC;
    then the group is destroyed."""
    import numpy as np
    import torch

    from tpu_mpc_torch import kernels, sharding
    from tpu_mpc_torch.core.limbs import batch_from_limbs
    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.core.rns import RnsParams
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    env = {"TPU_MPC_TORCH_DISTRIBUTED": "1", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port()), "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    rnd = random.Random(0x4A11)
    t = time.perf_counter()
    try:
        require(sharding.maybe_init_distributed(), "sharding ranks: no process group")
        backend = torch.distributed.get_backend()
        require(backend == "nccl", f"sharding ranks: backend {backend}, not nccl")
        mesh = sharding.sessions_mesh()
        require(mesh.size == 1 and mesh.group is not None and mesh.local == dev,
                f"sharding ranks: {mesh} is not a mesh over one rank on {dev}")
        mods = _odd_moduli(rnd, 2048, RANK_LANES, RnsParams(2048))
        base = [rnd.getrandbits(2048) % m for m in mods]
        expo = [rnd.getrandbits(2048) for _ in range(RANK_LANES)]
        ks = [rnd.randrange(1, hec.N) for _ in range(RANK_LANES)]
        obj = lambda v: np.asarray(v, dtype=object)
        torch.cuda.synchronize()
        kernels.reset_launches()
        with sharding.use_mesh(mesh):
            got = ModCtx.from_ints(obj(mods), 2048, dev).pow(obj(base), obj(expo), 2048)
            x, y, inf = ec.to_affine(ec.mul_generator(ec.sc_from_ints(obj(ks), dev)))
        launches = dict(kernels.LAUNCHES)
        require([int(g) for g in got] == [pow(b, e, m) for b, e, m in zip(base, expo, mods)],
                "sharding ranks: ModCtx.pow over the NCCL group != python pow")
        xs, ys = batch_from_limbs(x.cpu().numpy()), batch_from_limbs(y.cpu().numpy())
        require(not inf.any().item() and [(int(a), int(b)) for a, b in zip(xs, ys)]
                == [hec.mul(k) for k in ks], "sharding ranks: mul_generator != the host EC")
        require(launches["K1"] >= 1 and launches["K4"] >= 1 and launches["K5"] >= 1,
                f"sharding ranks: K1, K4 and K5 must launch: {launches}")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log(f"sharding ranks: a one-rank {backend} group in this process, {mesh}: 2048-bit "
        f"ModCtx.pow and mul_generator + to_affine over {RANK_LANES} lanes equal python pow "
        f"and the host EC; launches {json.dumps(launches)}; {time.perf_counter() - t:.2f} s "
        f"with the group's set-up; group destroyed")


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

    # each phase's own seconds, printed before the result lines
    phase_secs, t_lap = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        phase_secs[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

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
    lap("build")
    run_native()
    lap("native")

    rnd = random.Random(20261016)
    t0 = time.perf_counter()
    k1 = check_k1(dev, rnd)
    k2 = check_k2(dev, rnd)
    ec_res = check_ec(dev, rnd)
    log(f"check: every kernel equals its plain version in {time.perf_counter() - t0:.1f} s")
    lap("check")

    res16, material, kg_launches = run_keygen(dev, repo)
    lap("keygen")
    host_profile = "--host-profile" in sys.argv[1:]
    launches, keys128, key1s, slice_sigs, slice_dt = run_slice(dev, material, host_profile)
    key128, key1 = keys128["tables"], key1s["tables"]
    lap("slice")
    scale_launches = run_scale(dev, key1s, host_profile)
    lap("scale")
    mt_launches = run_multitenant(dev, res16)
    lap("multitenant")
    held = set()
    from tpu_mpc_torch.protocols.gg20 import batch as gg20

    blame_launches = run_blame(dev, gg20.tile_key(key1, BLAME_S), held)
    lap("blame")
    q_launches = run_quorum(dev)
    lap("quorum")
    gg18_launches = run_gg18(dev, key128, held)
    lap("gg18")
    l17_launches = run_lindell17(dev, held)
    lap("lindell17")
    run_cclst19()
    lap("cclst19")
    rt_launches = run_runtime_replay(dev, repo, held)
    work = os.path.join(repo, "build", "runtime_smoke", str(os.getpid()))
    os.makedirs(work, exist_ok=True)
    run_runtime_processes(repo, work)
    lap("runtime")
    t_shard = time.perf_counter()
    sh_launches = run_sharding(dev, keys128, slice_sigs, slice_dt)
    run_sharding_ranks(dev)
    log(f"sharding: the phase {time.perf_counter() - t_shard:.1f} s")
    lap("sharding")
    log(f"phases (s): {json.dumps(phase_secs)}, total {sum(phase_secs.values()):.1f}")

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
            "launches_keygen": kg_launches[name],
            "launches_scale_tables": scale_launches["tables"][name],
            "launches_scale_refexact": scale_launches["refexact"][name],
            "launches_multitenant": mt_launches[name],
            "launches_blame": blame_launches[name],
            **{f"launches_quorum_{k}": v[name] for k, v in q_launches.items()},
            "launches_gg18": gg18_launches[name],
            "launches_lindell17": l17_launches[name],
            "launches_runtime": rt_launches[name],
            "launches_sharding": sh_launches[name],
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

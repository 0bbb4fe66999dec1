#!/usr/bin/env python3
"""Chip smoke test of tpu_mpc_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root; needs one card)
    python3 chip_smoke.py --host-profile   (also prints a cProfile of one pass)

Phases (any failure exits non-zero and prints no result line):
  1. build   every CUDA kernel from tpu_mpc_torch/csrc/ (one nvcc per
             source, all started together) and print the build seconds;
  2. check   every kernel against its plain PyTorch version on the card,
             exactly (integers: tolerance 0), at the slice's shapes, with
             samples against python pow() and the host EC oracle, and time
             both (CUDA events);
  3. slice   GG20 2-of-3 signing at 2048-bit Paillier: the bench key
             (benches/bench_key_2048.json) tiled to S = 128 sessions, one
             warm-up and one timed pass of offline_stage + sign_online; every
             signature must verify under the pure-python ECDSA verifier and
             every kernel must have been launched in the timed pass.
Then it prints one JSON line {"kernels": [...]}, the card's name and power
limit, and last {"ok": true, "device": {...}}.  It imports nothing of jax or
of the reference package tpu_mpc.
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
MSG = 0x1C8AA4E93D8F4D7C9E21B5A7D301F2B8D4E6C0A9F3B5D7E9C1A3B5D7E9F10203
# H100 SXM peaks.  HBM: 3.35 TB/s (NVIDIA's data sheet).  The kernels'
# arithmetic is 32x32-bit integer multiply-adds (IMAD, one each, widening or
# not): 132 SMs x 64 INT32 lanes per clock x 1.98 GHz (the boost clock behind
# the data sheet's 67 TFLOP/s float32 = 132 x 128 x 2 x 1.98 GHz).  A
# widening IMAD counted as one instruction keeps the bound a lower bound.
PEAK_BYTES = 3.35e12
PEAK_IMAD = 132 * 64 * 1.98e9
# multiply-adds of one secp256k1 field operation on 8 x 32-bit limbs
# (reductions not counted): product, square, multiply by a small constant
FE_MUL, FE_SQ, FE_MULI = 64, 36, 8
RCB_ADD = 12 * FE_MUL + 2 * FE_MULI
RCB_DBL = 6 * FE_MUL + 2 * FE_SQ + FE_MULI
JAC_IO = 2 * FE_MUL + FE_SQ                 # jac_in and jac_out alike


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


def _bound(nbytes: float, imads: float):
    """Least time (ms) for `nbytes` moved once and `imads` multiply-adds.
    Bytes count each value at the width it needs: 16-bit limbs and residues
    2 B, digits and signs 1 B, exponent words and K1's constants 4 B, K1's
    column sums 8 B."""
    tb, to = nbytes / PEAK_BYTES * 1e3, imads / PEAK_IMAD * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _maxerr(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_k1(dev, rnd):
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
                ns = []
                while len(ns) < nmods:
                    n = rnd.getrandbits(bits) | 1 | (1 << (bits - 1))
                    if math.gcd(n, par.MA * par.MB) == 1:
                        ns.append(n)
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
                if bits == 2048 and per_lane and not reduce:
                    ms = _events_ms(lambda: pr.exp_call(x, e, rows, bits, emit), 3)
                    pms = _events_ms(lambda: pr.exp_plain(x, e, rows, bits, emit), 1)
                    ne2 = e.shape[1]
                    # Montgomery multiplies: x*R^2, 14 table entries, 8 windows
                    # of 4 squarings + 1 multiply per e-word, the decode's *1;
                    # each is two extension dots plus 7 channel products
                    mm = 1 + 14 + ne2 * 8 * 5 + 1
                    per_mm = par.K * (par.Kp + 1) + par.Kp * (par.K + 1) + 7 * par.CH
                    imads = lanes * (mm * per_mm + par.Lin * (par.K + par.Kp)
                                     + par.K * par.Lout)
                    nbytes = (2 * (x.numel() + rows.numel()) + 4 * e.numel()
                              + 4 * pr.dev_consts(par, dev)["flat32"].numel()
                              + 8 * lanes * par.Lout)
                    bms, bby = _bound(nbytes, imads)
                    entry = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                                 shape=f"{lanes} lanes, {bits}-bit moduli (one per lane), "
                                       f"{ebits}-bit exponents")
                    line += f"; kernel {ms:.3f} ms, plain {pms:.1f} ms, bound {bms:.4f} ms"
                if bits == 4096 and per_lane and not reduce:
                    ms = _events_ms(lambda: pr.exp_call(x, e, rows, bits, emit), 2)
                    line += f"; kernel {ms:.3f} ms"
                log(line)
    entry["max_abs_err"] = worst
    return entry


def _rand_points(dev, rnd, B):
    """B canonical Jacobian points with Z != 1 (plain comb on the card)."""
    import numpy as np
    import torch

    from tpu_mpc_torch.ec import pallas_ec as pe
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.host import ec as hec

    ks = np.asarray([rnd.randrange(1, hec.N) for _ in range(B)], dtype=object)
    out = pe.comb_plain(pe._comb_digits(ec.sc_from_ints(ks, dev)),
                        pe._comb8_for(hec.G, dev))
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
    imad_k3 = lambda ns: B * ((ns // 2) * (JAC_IO + 14 * RCB_ADD)
                              + 33 * (4 * RCB_DBL + ns * RCB_ADD + (ns // 2) * FE_MUL)
                              + JAC_IO)
    res = {}
    # K3, ns = 2 and 4, with an infinity base and k = 0
    pts, pk = _rand_points(dev, rnd, 2 * B)
    ks = [rnd.randrange(ec.Q_INT) for _ in range(2 * B)]
    ks[1] = 0
    pts[0, 0], pts[0, 1], pts[0, 2] = 0, 0, 0
    pts[0, 0, 0] = pts[0, 1, 0] = 1                     # lane 0: infinity base
    k = ec.sc_from_ints(np.asarray(ks, dtype=object), dev)
    worst = 0
    for ns in (2, 4):
        if ns == 2:
            DG, NEG = pe._glv_prep(k[:B])
            P = pts[:B, None]
        else:
            DGa, NEGa = pe._glv_prep(k[:B])
            DGb, NEGb = pe._glv_prep(k[B:])
            DG, NEG = torch.cat([DGa, DGb], 1), torch.cat([NEGa, NEGb], 1)
            P = torch.stack([pts[:B], pts[B:]], 1)
        out_k = pe.ladder_call(P, DG, NEG)
        out_p = pe.ladder_plain(P, DG, NEG)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0, f"K3 ns={ns}: kernel != plain (max |diff| {err})")
        got = ec.points_to_host_list(ec._from_rows(out_k[:8], (8,)))
        for i in range(8):
            a = None if i == 0 else hec.mul(int(pk[i]))
            want = hec.mul(ks[i], a) if a is not None else None
            if ns == 4:
                want = hec.add(want, hec.mul(ks[B + i], hec.mul(int(pk[B + i]))))
            require(got[i] == want, f"K3 ns={ns} lane {i} != host oracle")
        ms = _events_ms(lambda: pe.ladder_call(P, DG, NEG), 3)
        pms = _events_ms(lambda: pe.ladder_plain(P, DG, NEG), 1)
        bms, bby = _bound(2 * (P.numel() + B * 48) + DG.numel() + NEG.numel(),
                          imad_k3(ns))
        log(f"K3 ns={ns} lanes={B}: exact; kernel {ms:.3f} ms, plain {pms:.1f} ms, "
            f"bound {bms:.5f} ms")
        if ns == 2:
            res["K3"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                             shape=f"{B} lanes, ns=2 (scalar_mul)")
    res["K3"]["max_abs_err"] = worst
    # K4 for G and BASE_POINT2
    worst = 0
    for base, name in ((hec.G, "G"), (hec.BASE_POINT2, "BASE_POINT2")):
        kk = [rnd.randrange(ec.Q_INT) for _ in range(B)]
        kk[0], kk[1] = 0, 1
        dg = pe._comb_digits(ec.sc_from_ints(np.asarray(kk, dtype=object), dev))
        tab = pe._comb8_for(base, dev)
        out_k = pe.comb_call(dg, tab)
        out_p = pe.comb_plain(dg, tab)
        torch.cuda.synchronize()
        err = _maxerr(out_k, out_p)
        worst = max(worst, err)
        require(err == 0, f"K4 {name}: kernel != plain (max |diff| {err})")
        got = ec.points_to_host_list(ec._from_rows(out_k[:4], (4,)))
        require(got == [hec.mul(v, base) for v in kk[:4]], f"K4 {name} != host oracle")
        ms = _events_ms(lambda: pe.comb_call(dg, tab), 3)
        pms = _events_ms(lambda: pe.comb_plain(dg, tab), 1)
        # the table entries these digits touch, 64 B each (x, y)
        touched = int(torch.unique(dg + 256 * torch.arange(32, device=dev)).numel())
        bms, bby = _bound(dg.numel() + 2 * B * 48 + 64 * touched,
                          B * (32 * RCB_ADD + JAC_IO))
        log(f"K4 {name} lanes={B}: exact; kernel {ms:.3f} ms, plain {pms:.1f} ms, "
            f"bound {bms:.5f} ms")
        if name == "G":
            res["K4"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                             shape=f"{B} lanes, base G")
    res["K4"]["max_abs_err"] = worst
    # K5 with Z = 0 lanes
    P5 = pts[:B].clone()
    P5[3, 2] = 0
    out_k = pe.affine_call(P5)
    out_p = pe.affine_plain(P5)
    torch.cuda.synchronize()
    err = _maxerr(out_k, out_p)
    require(err == 0, f"K5: kernel != plain (max |diff| {err})")
    x, y, inf = pe.affine(ec.Point(P5[:, 0], P5[:, 1], P5[:, 2]))
    require(bool(inf[0]) and bool(inf[3]) and not bool(inf[2]),
            "K5 infinity flags wrong")
    as_int = lambda t: int.from_bytes(t.cpu().numpy().astype("<u2").tobytes(), "little")
    require((as_int(x[2]), as_int(y[2])) == hec.mul(int(pk[2])), "K5 != host oracle")
    ms = _events_ms(lambda: pe.affine_call(P5), 3)
    pms = _events_ms(lambda: pe.affine_plain(P5), 1)
    # 14 table products, 64 windows of 4 squarings + 1 product, Z^-2 (a
    # square) and the three products of the projection
    bms, bby = _bound(2 * B * (48 + 32), B * ((14 + 64 + 3) * FE_MUL + (256 + 1) * FE_SQ))
    log(f"K5 lanes={B}: exact; kernel {ms:.3f} ms, plain {pms:.1f} ms, bound {bms:.5f} ms")
    res["K5"] = dict(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby, max_abs_err=err,
                     shape=f"{B} lanes")
    return res


# --------------------------------------------------------------------------
# phase 3: the slice
# --------------------------------------------------------------------------

def run_slice(dev, repo, host_profile: bool = False):
    import torch

    from tpu_mpc_torch import kernels
    from tpu_mpc_torch.protocols.gg20 import batch as gg20
    from tpu_mpc_torch.utils.rng import SessionRng

    with open(os.path.join(repo, "benches", "bench_key_2048.json")) as f:
        d = json.load(f)
    t0 = time.perf_counter()
    key = gg20.tile_key(gg20.key_from_material(d, device=dev), S_SESSIONS)
    log(f"slice: bench key loaded and tiled to S={S_SESSIONS} in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = SessionRng(0xC41B)

    def one_pass():
        t = time.perf_counter()
        off = gg20.offline_stage(key, [0, 1], rng)
        torch.cuda.synchronize()
        t_off = time.perf_counter() - t
        sig = gg20.sign_online(off, MSG)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        require(off.ok.all(), f"offline stage failed: {off.debug_masks}")
        require(sig.sig_valid.all() and sig.ok.all(), "a signature failed to verify")
        return dt, t_off

    dt, t_off = one_pass()
    log(f"slice: warm-up pass {dt:.2f} s (offline {t_off:.2f} s), {S_SESSIONS} signatures verify")
    # device time of each kernel wrapper over the timed pass: CUDA events on
    # the stream around every call (no extra synchronisation)
    from tpu_mpc_torch.core import pallas_rns as pr
    from tpu_mpc_torch.ec import pallas_ec as pe

    spans = {"K1": [], "K3": [], "K4": [], "K5": []}
    patched = [(pr, "exp_call", "K1"), (pe, "ladder_call", "K3"),
               (pe, "comb_call", "K4"), (pe, "affine_call", "K5")]

    def timed(fn, name):
        def run(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans[name].append(ev)
            return out
        return run

    saved = [(m, f, getattr(m, f)) for m, f, _ in patched]
    for m, f, name in patched:
        setattr(m, f, timed(getattr(m, f), name))
    kernels.reset_launches()
    torch.cuda.synchronize()
    try:
        dt, t_off = one_pass()
    finally:
        for m, f, fn in saved:
            setattr(m, f, fn)
    launches = dict(kernels.LAUNCHES)
    busy = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    log("slice: kernel device time in the timed pass (ms) "
        + json.dumps({k: round(v, 3) for k, v in busy.items()})
        + f"; sum {sum(busy.values()):.1f} ms of {dt * 1e3:.1f} ms wall "
        f"({100 * sum(busy.values()) / (dt * 1e3):.1f}%)")
    log(f"slice: timed pass {dt:.2f} s (offline {t_off:.2f} s, online {dt - t_off:.2f} s), "
        f"{S_SESSIONS / dt:.2f} sig/s, all {S_SESSIONS} signatures verify")
    log(f"slice: kernel launches in the timed pass {json.dumps(launches)}")
    missing = [k for k, v in launches.items() if v == 0]
    require(not missing, f"kernels not launched on the main path: {missing}")
    if host_profile:
        import cProfile
        import io
        import pstats

        prof = cProfile.Profile()
        prof.enable()
        one_pass()
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("tottime").print_stats(30)
        log("slice: host profile of one more pass (cProfile, by own time)\n" + buf.getvalue())
    return launches, dt


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
    ec_res = check_ec(dev, rnd)
    log(f"check: every kernel equals its plain version in {time.perf_counter() - t0:.1f} s")

    launches, _ = run_slice(dev, repo, host_profile="--host-profile" in sys.argv[1:])

    src = {"K1": ("tpu_mpc_torch/csrc/rns_exp.cu",
                  "tpu_mpc/core/pallas_rns.py:371 (_exp_kernel)"),
           "K3": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:329 (_ladder_kernel)"),
           "K4": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:411 (_comb_kernel)"),
           "K5": ("tpu_mpc_torch/csrc/ec_kernels.cu",
                  "tpu_mpc/ec/pallas_ec.py:477 (_affine_kernel)")}
    rows = []
    for name, r in (("K1", k1), ("K3", ec_res["K3"]), ("K4", ec_res["K4"]),
                    ("K5", ec_res["K5"])):
        rows.append({
            "name": name, "route": "cuda", "source": src[name][0],
            "replaces": src[name][1], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
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

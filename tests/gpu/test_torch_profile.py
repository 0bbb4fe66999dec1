"""The port's launch log (core/modctx.py: PROFILE, PROFILE_LOG, prof_call,
profile_summary; TPU_MPC_TORCH_PROFILE) on the CPU.  The host functions run
live beside the reference's (tpu_mpc.core.modctx, with PROFILE set in both)
on the same numpy-seeded inputs and must log the same (kind, batch, bits,
ebits) rows; the modexp rows are held against rows written out from the
reference's code (its RNS path is not run: its CPU compile is slow)."""

import glob
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def logs(monkeypatch):
    """(reference modctx, port modctx), both logging into empty logs."""
    from tpu_mpc.core import modctx as rm
    from tpu_mpc_torch.core import modctx as tm

    for m in (rm, tm):
        monkeypatch.setattr(m, "PROFILE", True)
        monkeypatch.setattr(m, "PROFILE_LOG", [])
    return rm, tm


def _ints(rng, shape, bits):
    n = int(np.prod(shape))
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(rng.bytes(bits // 8), "big") | 1
    return out.reshape(shape)


def _host_calls(rng):
    """{name: (port call, reference call)} on one set of inputs."""
    from tpu_mpc.core import limbs as rl, modctx as rm
    from tpu_mpc.hashes import fiat_shamir as rf
    from tpu_mpc.zk import range_proofs as rr
    from tpu_mpc_torch.core import limbs as tl, modctx as tm
    from tpu_mpc_torch.hashes import fiat_shamir as tf

    mod40, a40, b40 = (_ints(rng, (40,), 256) for _ in range(3))
    mod5 = _ints(rng, (5,), 512)
    a5, b5, c5 = (_ints(rng, (5,), 512) for _ in range(3))
    vals, row = _ints(rng, (4, 10), 256), _ints(rng, (1, 10), 256)
    inv_a = _ints(rng, (6,), 128)
    inv_a[2] = 0                                     # not invertible: 0 out
    inv_m = _ints(rng, (6,), 256)
    cols = (_ints(rng, (3, 2), 256), _ints(rng, (2,), 64), 7)
    xs = _ints(rng, (2, 3), 512)
    return {
        "mulmod_B40": (lambda: tm.host_mulmod(a40, b40, mod40),
                       lambda: rm.host_mulmod(a40, b40, mod40)),
        "mulmod_B5": (lambda: tm.host_mulmod(a5, b5, c5, mod5),
                      lambda: rm.host_mulmod(a5, b5, c5, mod5)),
        "prod_axis0": (lambda: tm.host_prod_axis0(vals, row),
                       lambda: rm.host_prod_axis0(vals, row)),
        "invmod": (lambda: tm.host_invmod(inv_a, inv_m), lambda: rr._invmod(inv_a, inv_m)),
        "digest_rows": (lambda: tf.digest_rows(*cols, reduce_mod=mod40[0]),
                        lambda: rf.digest_rows(*cols, reduce_mod=mod40[0])),
        "to_limbs": (lambda: tl.batch_to_limbs(xs, 32), lambda: rl.batch_to_limbs(xs, 32)),
        "from_limbs": (lambda: tl.batch_from_limbs(tl.batch_to_limbs(xs, 33)),
                       lambda: rl.batch_from_limbs(rl.batch_to_limbs(xs, 33))),
    }


@pytest.mark.parametrize("name", ["mulmod_B40", "mulmod_B5", "prod_axis0", "invmod",
                                  "digest_rows", "to_limbs", "from_limbs"])
def test_host_rows_equal_reference(logs, name):
    rm, tm = logs
    port, ref = _host_calls(np.random.default_rng(0x9F0F))[name]
    rm.PROFILE_LOG.clear()
    tm.PROFILE_LOG.clear()
    got, want = port(), ref()
    assert np.asarray(got).astype(object).tolist() == np.asarray(want).astype(object).tolist()
    fields = lambda log: [row[:4] for row in log]
    assert fields(tm.PROFILE_LOG) == fields(rm.PROFILE_LOG) != []
    assert all(isinstance(row[4], float) and row[4] >= 0 for row in tm.PROFILE_LOG)


def test_modexp_rows_and_summary(logs):
    """A 512-bit ModCtx.pow (K1's plain version here) and a
    pow_fixed_prod_rns (K2's) log pow_rns and powfix_rns with the
    reference's ebits classes (tpu_mpc/core/modctx.py:ebits_class, 100 bits
    -> 128, 60 -> 64), forced to resolve under PROFILE even with
    sync=False; profile_summary ends in the TOTAL line and empties the log."""
    from tpu_mpc_torch.core.modctx import ModCtx

    _, tm = logs
    rng = np.random.default_rng(0x9F10)
    ns = _ints(rng, (3,), 512)
    mc = ModCtx.from_ints(ns, 512, device="cpu")
    base, h1, h2 = (_ints(rng, (3,), 256) for _ in range(3))
    e1 = _ints(rng, (3,), 64) >> 4                   # < 2^60
    e2 = _ints(rng, (3,), 128) >> 28                 # < 2^100
    tabs = mc.make_tables_rns(np.stack([h1, h2]), 128)
    tm.PROFILE_LOG.clear()
    got = mc.pow(base, e2, sync=False)
    fix = mc.pow_fixed_prod_rns(list(tabs), [e1, e2], [60, 100], sync=False)
    assert list(got) == [pow(int(b), int(e), int(n)) for b, e, n in zip(base, e2, ns)]
    assert list(fix) == [pow(int(a), int(x), int(n)) * pow(int(b), int(y), int(n)) % int(n)
                         for a, b, x, y, n in zip(h1, h2, e1, e2, ns)]
    dev_rows = [row[:4] for row in tm.PROFILE_LOG if not row[0].startswith("host:")]
    assert dev_rows == [("pow_rns", 3, 512, 128), ("powfix_rns", 3, 512, (64, 128))]
    assert {row[0] for row in tm.PROFILE_LOG} <= set(tm.PROFILE_KINDS)
    n_rows = len(tm.PROFILE_LOG)
    lines = tm.profile_summary().splitlines()
    assert lines[-1].startswith(f"TOTAL modexp launches: {n_rows}  ")
    assert tm.PROFILE_LOG == []
    k1 = next(line for line in lines if line.startswith("pow_rns"))
    assert "tc=" in k1 and "imad=" in k1


def test_summary_peaks_are_the_h100s(logs):
    """The achieved-against-peak columns divide the work model (rns_work,
    k1_montmuls, k2_montmuls, shared with chip_smoke.py) by the H100's
    tensor-core u8 and INT32 IMAD peaks."""
    from tpu_mpc_torch.core.rns import RnsParams

    _, tm = logs
    assert tm.PEAK_U8_MAC == 989.5e12 and tm.PEAK_IMAD == 132 * 64 * 1.98e9
    tm.PROFILE_LOG.extend([("pow_rns", 512, 2048, 2048, 0.5), ("host:digest", 10, 0, "-", 0.25),
                           ("powfix_rns", 256, 2048, (776, 3104), 0.125)])
    lines = tm.profile_summary(reset=False).splitlines()
    assert [line.split()[0] for line in lines] == ["pow_rns", "host:digest", "powfix_rns",
                                                   "TOTAL"]
    assert lines[-1] == "TOTAL modexp launches: 3  0.88s"
    assert len(tm.PROFILE_LOG) == 3
    par = RnsParams(2048)
    u8, imad, _ = tm.rns_work(par, tm.k1_montmuls(2048 // 32), 512, prologue=True)
    assert f"({100 * u8 / 0.5 / tm.PEAK_U8_MAC:4.1f}% H100)" in lines[0]
    assert f"({100 * imad / 0.5 / tm.PEAK_IMAD:4.1f}% H100)" in lines[0]
    u8, imad, _ = tm.rns_work(par, tm.k2_montmuls([194, 776]), 256, prologue=False)
    assert f"imad={imad / 0.125 / 1e12:5.2f}T/s" in lines[2]
    assert "tc=" not in lines[1]


def test_rows_from_ec_and_decrypt(logs):
    """The EC seam and the MtA decrypt log the reference's kinds, one row a
    call, with the call's lanes; host rows nest inside them."""
    from tpu_mpc_torch.ec import secp256k1 as ec
    from tpu_mpc_torch.hashes.fiat_shamir import point_hash_ints_many
    from tpu_mpc_torch.mta import mta
    from tpu_mpc_torch.paillier import paillier as tp

    _, tm = logs
    k = ec.sc_from_ints(np.asarray([3, 5], dtype=object), device="cpu")
    P = ec.mul_generator(k)
    pts = ec.points_to_host(P)
    hs = point_hash_ints_many(P, P)
    assert [row[:4] for row in tm.PROFILE_LOG if row[0].startswith("ec:")] == [
        ("ec:mulG", 2, 256, "-"), ("ec:affine", 2, 256, "-"), ("ec:hashpts", 4, 256, "-")]
    assert len(pts) == 2 and len(hs) == 2
    # Paillier over the Mersenne primes 2^127 - 1 and 2^107 - 1, two sessions
    p, q = (1 << 127) - 1, (1 << 107) - 1
    n = p * q
    dk = tp.BatchDecryptionKey.from_ints([p, p], [q, q], 256, device="cpu")
    m = np.asarray([12345, n - 7], dtype=object)
    c = np.asarray([(1 + int(v) * n) * pow(r, n, n * n) % (n * n) for v, r in zip(m, (3, 5))],
                   dtype=object)
    tm.PROFILE_LOG.clear()
    assert list(mta.paillier_decrypt_ints(dk, c, (2,), 256)) == list(m)
    rows = [row[:4] for row in tm.PROFILE_LOG if not row[0].startswith("host:")]
    assert rows == [("pow_rns", 4, 256, 128), ("decrypt", 2, 256, "-")]


def test_profile_off_logs_nothing(monkeypatch):
    from tpu_mpc_torch.core import limbs as tl, modctx as tm

    monkeypatch.setattr(tm, "PROFILE", False)
    monkeypatch.setattr(tm, "PROFILE_LOG", [])
    a = np.asarray([3, 4, 5], dtype=object)
    assert list(tm.host_mulmod(a, a, 7)) == [2, 2, 4]
    tl.batch_from_limbs(tl.batch_to_limbs(a, 2))
    assert tm.prof_call("ec:smul", 1, 256, lambda: 42) == 42
    assert tm.PROFILE_LOG == []


def test_kinds_are_reference_names():
    """Every kind the port logs is a string the reference logs."""
    from tpu_mpc_torch.core.modctx import PROFILE_KINDS

    src = "".join(open(p).read() for p in glob.glob(os.path.join(REPO, "tpu_mpc", "**", "*.py"),
                                                   recursive=True))
    assert [k for k in PROFILE_KINDS if f'"{k}"' not in src] == []

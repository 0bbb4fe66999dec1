"""The slice end to end on the CPU: the port's offline_stage + sign_online
gives the same (r, s, recid) as the reference package's run of the same
functions, for the same key, the same SessionRng seed and the same message,
and every signature verifies.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/gg20_slice_768.json (both configurations below); here
only the port runs, and every field must equal the file's (integers:
tolerance 0).  The reference's offline_stage takes minutes of JAX
compilation on the CPU, which tier-1's shared test workers cannot spare.

Key: session 0 of the committed tests/fixtures/gg20key_20_2_1_3_768.json,
tiled to S = 2 (one key set serving two sessions, the serving pattern), so
that the forced cross-session batch verification (TPU_MPC_BATCH_VERIFY=1 on
the reference side, TPU_MPC_TORCH_BATCH_VERIFY=1 on the port's) really
takes the pow_prod_axis0 / reduce_axis0 path at S = 2.  The verifier's
batching exponents come from os.urandom, not from SessionRng, so they do not
change (r, s).

Two configurations, one case each, so that a test scheduler can place them
on different workers: "uniform" (no fixed-base tables, uniform randomizers:
TPU_MPC_ENC_TABLES=0 / TPU_MPC_TORCH_ENC_TABLES=0) and "tables" (h1/h2 and
randomizer tables, the JAX package's default on an accelerator: both
switches "1")."""

import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
GOLD = os.path.join(HERE, "fixtures", "gg20_slice_768.json")
SEED = 0x5169
S = 2


def _key_dict():
    with open(FIXTURE) as f:
        d = json.load(f)
    d1 = {k: ([v[0]] * S if isinstance(v, list) else v) for k, v in d.items()}
    d1["S"] = S
    return d1


def _reference_key(d):
    spec = importlib.util.spec_from_file_location("keycache", os.path.join(HERE, "..", "keycache.py"))
    kc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kc)
    return kc._decode(d)


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


def _ints(v):
    return np.vectorize(int, otypes=[object])(np.asarray(v, dtype=object))


def _run_port(d, tables: bool):
    """One run of the port on the key, seed and message of the golden run.
    Records the lead sizes of the axis-0 folds and the fixed-base products
    it launched."""
    from tpu_mpc_torch.core import pallas_rns as tpr
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng as TRng

    m = int.from_bytes(hashlib.sha256(b"gg20 message").digest(), "big")
    reduced, fixed = [], []
    flag = "1" if tables else "0"
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("TPU_MPC_TORCH_BATCH_VERIFY", "1"), ("TPU_MPC_TORCH_ENC_TABLES", flag)):
            mp.setenv(k, v)
        fin = tpr._finish_reduce
        mp.setattr(tpr, "_finish_reduce",
                   lambda *a, **kw: reduced.append(a[4]) or fin(*a, **kw))
        fpd = tpr.fixed_prod_dispatch
        mp.setattr(tpr, "fixed_prod_dispatch",
                   lambda *a, **kw: fixed.append(a[5]) or fpd(*a, **kw))
        tkey = tg.key_from_material(d, device="cpu")
        toff = tg.offline_stage(tkey, [0, 1], TRng(SEED))
        tsig = tg.sign_online(toff, m)
    return toff, tsig, reduced, fixed, m, tkey


@pytest.mark.parametrize("tables", [False, True], ids=["uniform", "tables"])
def test_slice_signatures_equal_reference_and_verify(gold, tables):
    """The port's run, once per configuration, against the reference's run
    of the same configuration: every assertion about the slice reads from
    that single run."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec

    assert (gold["seed"], gold["S"], gold["signers"]) == (SEED, S, [0, 1])
    ref = gold["tables" if tables else "uniform"]
    toff, tsig, reduced, fixed, m, tkey = _run_port(_key_dict(), tables)
    assert m == int(gold["m"])
    # (r, s, recid) bit for bit
    assert [int(v) for v in tsig.r] == [int(v) for v in ref["r"]]
    assert [int(v) for v in tsig.s] == [int(v) for v in ref["s"]]
    assert [int(v) for v in tsig.recid] == [int(v) for v in ref["recid"]]
    # every signature verifies, every offline check passed
    assert tsig.sig_valid.all() and tsig.ok.all() and toff.ok.all() and all(ref["sig_valid"])
    for name in toff.debug_masks:
        assert np.asarray(toff.debug_masks[name]).all(), name
    y = tec.points_to_host(toff.y)
    for b in range(S):
        assert hec.ecdsa_verify(y[b], m % hec.N, int(tsig.r[b]), int(tsig.s[b]))
        assert int(tsig.s[b]) <= hec.N // 2
    # the offline transcript's secrets and ciphertexts equal the reference's
    for f in ("r_x", "k", "sigma_i", "delta_i", "msg_a_c", "alpha", "beta_g", "miu"):
        assert np.array_equal(np.asarray(getattr(toff, f), dtype=object), _ints(ref[f])), f
    # batch verification took the axis-0 product: alice_verify_fast and
    # pdl_slack_verify_fast, five products each, over the S sessions
    assert len(reduced) >= 10 and set(reduced) == {S}
    if not tables:
        assert not fixed and toff.k_randomness.shape == (S, 2)
        return
    # the fixed-base path carried every ring-Pedersen product and r^N: per
    # pass 4 N^2 products (r_a^N, alice's beta^N, Bob's r^N, PDL's beta^N)
    # and 8 N-width ones (alice z, w, s, its batched check; PDL z, u3, s2,
    # its batched check)
    nbits = tkey.paillier_bits
    assert sorted(fixed) == [nbits] * 8 + [2 * nbits] * 4
    # the randomizers stayed deferred launches; resolved, they equal the
    # reference's, and r_a encrypts k to msg_a_c
    r_a = toff.k_randomness.ints()
    assert np.array_equal(np.asarray(r_a, dtype=object), _ints(ref["k_randomness"]))
    assert np.array_equal(np.asarray(toff.beta_randomness.ints(), dtype=object),
                          _ints(ref["beta_randomness"]))
    n = tkey.ek.take([0, 1], 1).n
    for b in range(S):
        for i in range(2):
            nv = int(n[b, i])
            c = (1 + int(toff.k[b, i]) * nv) * pow(int(r_a[b, i]), nv, nv * nv) % (nv * nv)
            assert c == int(toff.msg_a_c[b, i])


def test_key_loader_takes_reference_objects():
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    d = _key_dict()
    a = tg.key_from_material(d, device="cpu")
    b = tg.key_from_material(_reference_key(d), device="cpu")
    assert (a.S, a.t, a.n, a.paillier_bits) == (b.S, b.t, b.n, b.paillier_bits)
    for f in ("p", "q", "u", "x"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert np.array_equal(a.dlog_stmt.ctx.n_ints, b.dlog_stmt.ctx.n_ints)
    assert tec.points_to_host_list(a.y_i) == tec.points_to_host_list(b.y_i)
    assert tec.points_to_host_list(a.vss.commitments) == \
        tec.points_to_host_list(b.vss.commitments)
    assert a.ek.nn_ctx.rns_ctx().rows.equal(b.ek.nn_ctx.rns_ctx().rows)

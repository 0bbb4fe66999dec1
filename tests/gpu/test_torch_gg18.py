"""GG18 of the port on the CPU, held exactly against the reference package's
outputs.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/gg18_768.json: gg18.keygen(2, 1, 3, SessionRng(0xAA),
768) (the seed of tests/test_gg18.py), then under the same rng gg18.sign of
sha256(b"hello") for the subsets [0, 1], [1, 2], [0, 2], and a zero-sum
refresh_private_key + update_private_key.  Here only the port runs, through
the same calls in the same order; every field must equal the file's
(integers: tolerance 0).  The port decrypts MtA ciphertexts through
decrypt_sk (K1), the reference's GG18 on its CIOS limb path: the same
integers, so the same signatures."""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "fixtures", "gg18_768.json")


def _ints(v):
    return np.vectorize(int, otypes=[object])(np.asarray(v, dtype=object)).tolist()


def _pts(v):
    if v is None:
        return None
    if isinstance(v, list) and len(v) == 2 and isinstance(v[0], str):
        return (int(v[0]), int(v[1]))
    return [_pts(e) for e in v]


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def kg(gold):
    """(keygen result, the rng past the keygen's draws)."""
    from tpu_mpc_torch.protocols.gg18 import batch as g18
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(gold["seed"])
    return g18.keygen(gold["S"], gold["t"], gold["n"], rng, gold["bits"], device="cpu"), rng


@pytest.fixture(scope="module")
def signed(gold, kg):
    """The three signatures, then the refresh and update, in the golden
    run's order on the same rng."""
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg18 import batch as g18
    from tpu_mpc_torch.vss import feldman

    res, rng = kg
    key, S, n = res.key, gold["S"], gold["n"]
    m = int(gold["m"])
    sigs = [g18.sign(key, e["subset"], m, rng) for e in gold["sign"]]
    f = np.asarray(rng.scalars((S, n)), dtype=object)
    f[:, n - 1] = np.vectorize(lambda tot: (-int(tot)) % hec.N, otypes=[object])(
        np.sum(f[:, : n - 1], axis=1))
    key2 = g18.refresh_private_key(key, f, rng)
    _, shares_f = feldman.share(key.t, n, f, rng, "cpu")
    factor_x = np.mod(np.sum(shares_f, axis=1), hec.N)
    key3 = g18.update_private_key(key2, np.zeros((S, n), dtype=object), factor_x)
    return sigs, f, key2, factor_x, key3


def test_keygen_equals_reference(gold, kg):
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.vss import feldman

    res, _ = kg
    key, want = res.key, gold["keygen"]
    assert [bool(v) for v in res.ok] == want["ok"] == [True] * gold["S"]
    assert not res.bad_actors.any()
    for f in ("p", "q", "u", "x"):
        assert _ints(getattr(key, f)) == _ints(want[f]), f
    assert tec.points_to_host_list(key.y_i) == _pts(want["y_i"])
    assert tec.points_to_host_list(key.y) == _pts(want["y"])
    assert tec.points_to_host_list(key.vss.commitments) == _pts(want["vss"])
    # y = (sum u) G, and every signer pair's x shares reconstruct sum u
    y = tec.points_to_host_list(key.y)
    for b in range(key.S):
        total = sum(int(v) for v in key.u[b]) % hec.N
        assert y[b] == hec.mul(total)
        for pair in ([0, 1], [1, 2], [0, 2]):
            assert feldman.reconstruct(pair, [int(key.x[b, j]) for j in pair]) == total


def test_signatures_equal_reference(gold, kg, signed):
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec

    res, _ = kg
    sigs = signed[0]
    m = int(gold["m"])
    y = tec.points_to_host_list(res.key.y)
    for sig, want in zip(sigs, gold["sign"]):
        assert _ints(sig.r) == _ints(want["r"]) and _ints(sig.s) == _ints(want["s"])
        assert [int(v) for v in sig.recid] == want["recid"]
        assert [bool(v) for v in sig.ok] == want["ok"] == [True] * gold["S"]
        assert [bool(v) for v in sig.sig_valid] == want["sig_valid"]
        for b in range(gold["S"]):
            assert int(sig.s[b]) <= hec.N // 2
            assert hec.ecdsa_verify(y[b], m % hec.N, int(sig.r[b]), int(sig.s[b]))


def test_refresh_and_update_equal_reference(gold, kg, signed):
    from tpu_mpc_torch.ec import secp256k1 as tec

    res, _ = kg
    _, f, key2, factor_x, key3 = signed
    assert _ints(f) == _ints(gold["refresh"]["factor"])
    for k in ("p", "q", "u"):
        assert _ints(getattr(key2, k)) == _ints(gold["refresh"][k]), k
    assert tec.points_to_host_list(key2.y) == _pts(gold["refresh"]["y"])
    assert _ints(factor_x) == _ints(gold["update"]["factor_x"])
    assert _ints(key3.u) == _ints(gold["update"]["u"]) and _ints(key3.x) == _ints(gold["update"]["x"])
    # a zero-sum refresh leaves y unchanged; the Paillier keys are new
    assert tec.points_to_host_list(key3.y) == tec.points_to_host_list(res.key.y) \
        == _pts(gold["update"]["y"])
    assert (np.asarray(key2.ek.n) != np.asarray(res.key.ek.n)).all()


def test_gg18_key_segments_equal_reference(kg):
    from tpu_mpc.host import backup as rb
    from tpu_mpc.utils.rng import SessionRng as RRng
    from tpu_mpc_torch.host import backup as tb
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg18 import batch as g18
    from tpu_mpc_torch.utils.rng import SessionRng

    key = kg[0].key
    y_sk = 0xBAC4
    pub_y = hec.mul(y_sk)
    tw, te = g18.to_encrypted_segments(key, 16, 16, pub_y, SessionRng(35))
    rw, re_ = rb.backup_batch(key.u, 16, 16, pub_y, RRng(35))
    assert [(w.x_vec, w.r_vec) for w in tw] == [(w.x_vec, w.r_vec) for w in rw]
    assert [(e.D, e.E) for e in te] == [(e.D, e.E) for e in re_]
    assert tb.recover_batch(te, y_sk, 16).tolist() == [int(v) for v in key.u.reshape(-1)]

"""GG20 and GG18 signing with more than two signers, and GG20's identifiable
aborts at n = 5 and n = 2, on the CPU, held exactly against the reference
package's outputs.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/gg20_quorum_768.json (768-bit Paillier, the cross-session
batch verification forced on both sides): the wide quorums of
tests/test_gg20_adv_quorum.py (n = 5, t = 2, signers [0, 2, 3, 4]; n = 8,
t = 4, signers [0, 1, 2, 4, 6, 7]), their blame matrices
(tests/test_gg20_adv_quorum{5,6,7}.py), the n = 2 matrix of
tests/test_gg20_adversarial.py, and the full quorum [0, 1, 2] of the n = 3
key for GG20 (tests/test_gg20.py) and GG18.  Here only the port runs,
through the same calls in the same order, and every field must equal the
file's (integers: tolerance 0); every blame list must also equal the
corruption spec it injected.  One offline pass carries every scenario of a
step (the sessions axis is the scenario axis), and the step-7 scenarios run
on the honest pass's offline state.  The n = 8 case is marked slow, as the
reference's is."""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, "..", ".."))
GOLD = os.path.join(HERE, "fixtures", "gg20_quorum_768.json")
DEV = "cpu"
ENV = {"TPU_MPC_TORCH_BATCH_VERIFY": "1"}


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


def _key(rel: str, S: int, tables: bool):
    """Session 0 of a key file in tests/keycache.py's format, loaded by the
    port and tiled to S sessions."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    with open(os.path.join(REPO, rel)) as f:
        d = json.load(f)
    d = {k: ([v[0]] if isinstance(v, list) else v) for k, v in d.items()}
    d["S"] = 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1" if tables else "0")
        key = tg.tile_key(tg.key_from_material(d, device=DEV), S)
    assert (key.ek.enc_tab_g is not None) == tables
    return key


def _ints(v) -> list:
    return [int(x) for x in np.asarray(v, dtype=object).reshape(-1)]


def _offline(key, section, run, signers):
    """The port's offline_stage of a golden run, its state held against the
    run's."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(run["seed"])
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1" if section["tables"] else "0")
        off = tg.offline_stage(key, signers, rng, corrupt=run["corrupt"])
    assert [bool(v) for v in off.ok] == run["ok"]
    assert np.asarray(off.bad_actors, dtype=bool).tolist() == run["bad_actors"]
    for f in ("r_x", "delta_i", "sigma_i"):
        assert _ints(getattr(off, f)) == _ints(run[f]), f
    return off, rng


def _sign_equal(sig, want):
    assert _ints(sig.r) == _ints(want["r"])
    assert _ints(sig.s) == _ints(want["s"])
    assert _ints(sig.recid) == _ints(want["recid"])
    assert [bool(v) for v in np.asarray(sig.ok)] == want["ok"]
    assert [bool(v) for v in np.asarray(sig.sig_valid)] == want["sig_valid"]


# ---- the layouts at wide quorums, without a protocol run --------------------

@pytest.mark.parametrize("tp", [2, 3, 4, 6])
def test_pair_layout_at_wide_quorums(tp):
    """The off-diagonal packing [S, alice, tp-1]: every ordered pair once,
    iinv the inverse of peers, and _unpack_dense putting each pair at
    [alice, bob] with the diagonal filled."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    peers, iinv = tg._peer_idx(tp)
    pairs = {(i, int(peers[i, kk])) for i in range(tp) for kk in range(tp - 1)}
    assert pairs == {(i, j) for i in range(tp) for j in range(tp) if i != j}
    for j in range(tp):
        for kk in range(tp - 1):
            assert peers[iinv[j, kk], kk] == j
    packed = np.asarray([[[10 * i + int(peers[i, kk]) for kk in range(tp - 1)]
                          for i in range(tp)]], dtype=object)
    dense = tg._unpack_dense(packed, peers, -1)
    assert dense.tolist() == [[[-1 if i == j else 10 * i + j for j in range(tp)]
                               for i in range(tp)]]


def test_corrupt_slots_with_two_parties_in_a_session():
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    assert list(tg._corrupt_slots([[0], [0, 3]], 2)) == [(0, 0), (1, 0), (1, 3)]
    assert list(tg._corrupt_slots([[1, 3], []], 2)) == [(0, 1), (0, 3)]
    assert list(tg._corrupt_slots([1, 3], 2)) == [(slice(None), 1), (slice(None), 3)]


@pytest.mark.parametrize("n", [3, 5, 8])
def test_table_group_rows_over_n_parties(n):
    """The flattened table-group row of a call into group-compressed tables
    of G key sets x n parties: g * n + party, for the [S, n] batch and for
    a stacked [2, S, n] call (the gamma / w paths)."""
    from tpu_mpc_torch.zk import range_proofs as rp

    G, S = 2, 6
    gmap = np.arange(S) % G
    rows = rp._table_group_rows(gmap, (G, n), (S, n), (S, n))
    assert rows.tolist() == [[int(gmap[s]) * n + i for i in range(n)] for s in range(S)]
    stacked = rp._table_group_rows(gmap, (G, n), (S, n), (2, S, n))
    assert stacked.shape == (2, S, n) and (stacked[0] == rows).all() and (stacked[1] == rows).all()
    T = np.zeros((4, 16, G, n, 3))
    assert rp._gmap_rows(None, T, (S, n), (S, n)) is None
    assert (rp._gmap_rows(gmap, T, (S, n), (S, n)) == rows).all()


@pytest.mark.parametrize("quorum", [[0, 2, 3, 4], [0, 1, 2, 4, 6, 7], [1, 3, 4, 5, 6]],
                         ids=["n5", "n8", "n8_t4_min"])
def test_lagrange_coefficients_equal_reference(quorum):
    """Lagrange coefficients at 0 over non-contiguous quorums equal the
    reference's, and reconstruct a degree-(len - 1) secret from its shares."""
    from tpu_mpc.vss import feldman as jf
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.vss import feldman as tf

    lam = [tf.lagrange_coeff(i, quorum) for i in quorum]
    assert lam == [jf.lagrange_coeff(i, quorum) for i in quorum]
    rnd = np.random.default_rng(len(quorum))
    coef = [int(rnd.integers(1, 2 ** 62)) for _ in range(len(quorum))]
    share = lambda i: sum(c * (i + 1) ** k for k, c in enumerate(coef)) % hec.N
    assert sum(int(l) * share(i) for l, i in zip(lam, quorum)) % hec.N == coef[0]
    assert tf.reconstruct(quorum, [share(i) for i in quorum]) == coef[0]


def test_tile_key_of_an_n8_key_shares_its_tables():
    """tile_key of the n = 8 key: every per-party field [S, 8], the tables
    shared with the 1-session key, not copied."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    with open(os.path.join(HERE, "fixtures", "gg20key_53_1_4_8_768.json")) as f:
        d = json.load(f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
        key1 = tg.key_from_material(d, device=DEV)
    key = tg.tile_key(key1, 3)
    assert (key.S, key.t, key.n) == (3, 4, 8)
    for a in (key.p, key.q, key.u, key.x, key.ek.n, key.dlog_stmt.h1):
        assert np.shape(a) == (3, 8)
    assert tuple(key.y_i.X.shape[:2]) == (3, 8) and tuple(key.y.X.shape[:1]) == (3,)
    assert key.vss.commitments.X.shape[:3] == (3, 8, 5)
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(key.dlog_stmt.tables_rns, key1.dlog_stmt.tables_rns))
    assert key.ek.enc_tab_g.data_ptr() == key1.ek.enc_tab_g.data_ptr()
    assert (key.x[2] == key1.x[0]).all()


# ---- n = 5, t = 2, signers [0, 2, 3, 4] -------------------------------------

@pytest.fixture(scope="module")
def key_n5(gold):
    sec = gold["n5"]
    return _key(sec["key"], sec["S"], sec["tables"])


@pytest.fixture(scope="module")
def n5_honest(gold, key_n5):
    """The honest pass: its offline state and signatures, and the fixed-base
    products it launched, by group count."""
    from tpu_mpc_torch.core import pallas_rns as tpr
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.zk import batch_verify as bv

    sec = gold["n5"]
    groups = []
    fc = tpr.fixed_call
    bv.reset_stats()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpr, "fixed_call",
                   lambda *a: groups.append(a[3][0].shape[2]) or fc(*a))
        off, _ = _offline(key_n5, sec, sec["honest"], sec["signers"])
    stats = {"grouped": dict(bv.STATS["grouped"]), "per_session": bv.STATS["per_session"]}
    return off, tg.sign_online(off, int(sec["m"])), groups, stats


def test_n5_t2_signers4_signature_equals_reference(gold, n5_honest):
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec

    off, sig, groups, stats = n5_honest
    run = gold["n5"]["honest"]
    _sign_equal(sig, run)
    assert off.ok.all() and sig.sig_valid.all()
    for name, mask in off.debug_masks.items():
        assert np.asarray(mask).all(), name
    # the pair layout [S, 4, 3], dense [S, 4, 4]
    assert off.beta_g.shape == (2, 4, 4) and off.R_bar.X.shape[:2] == (2, 4)
    m = int(gold["n5"]["m"])
    y = tec.points_to_host(off.y)
    assert all(hec.ecdsa_verify(y[b], m % hec.N, int(sig.r[b]), int(sig.s[b]))
               for b in range(2))
    # K2's plain version ran over the signers' randomizer tables (4 groups)
    # and the 12 ordered pairs' h1/h2 tables
    assert set(groups) == {4, 12}
    # the cross-session checks ran batched over the 4 x 3 pairs, with no
    # per-session fallback
    assert stats["grouped"] and not stats["per_session"]


def test_n5_step7_blame_equals_reference(gold, n5_honest):
    """Step 7 on the honest pass's offline state: signers 1 and 3 double s_i
    in session 0, session 1 is honest."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.protocols.gg20 import blame

    off = n5_honest[0]
    st7 = gold["n5"]["honest"]["step7"]
    m = int(st7["m"])
    sig = tg.sign_online(off, m, corrupt={"step": 7, "parties": st7["parties"]})
    assert _ints(sig.s_i) == _ints(st7["s_i"])
    assert [bool(v) for v in sig.sig_valid] == st7["sig_valid"] == [False, True]
    assert blame.phase7_blame(off, sig.s_i, m) == st7["phase7"] == st7["parties"]


@pytest.fixture(scope="module", params=[5, 6], ids=["step5", "step6"])
def n5_blame(request, gold, key_n5):
    """One offline pass of a corruption step over both scenarios, then its
    blame."""
    from tpu_mpc_torch.protocols.gg20 import blame

    sec, step = gold["n5"], request.param
    run = sec[f"step{step}"]
    off, rng = _offline(key_n5, sec, run, sec["signers"])
    got = blame.phase5_blame(key_n5, off) if step == 5 else blame.phase6_blame(key_n5, off, rng)
    return run, got


@pytest.mark.parametrize("b", [0, 1], ids=["party1", "party14"])
def test_n5_t2_blame_equals_reference(n5_blame, b):
    run, got = n5_blame
    assert run["corrupt"]["parties"] == [[0], [0, 3]]
    assert not any(run["ok"])
    assert got[b] == run["blame"][b] == run["corrupt"]["parties"][b]


# ---- n = 2, t = 1 -------------------------------------------------------------

@pytest.fixture(scope="module", params=[5, 6], ids=["step5", "step6"])
def n2_blame(request, gold):
    from tpu_mpc_torch.protocols.gg20 import blame

    sec, step = gold["n2"], request.param
    run = sec[f"step{step}"]
    key = _key(sec["key"], len(run["corrupt"]["parties"]), sec["tables"])
    off, rng = _offline(key, sec, run, sec["signers"])
    got = blame.phase5_blame(key, off) if step == 5 else blame.phase6_blame(key, off, rng)
    return run, got


@pytest.mark.parametrize("b", [0, 1, 2], ids=["party1", "party2", "party12"])
def test_n2_t1_blame_equals_reference(n2_blame, b):
    run, got = n2_blame
    assert run["corrupt"]["parties"] == [[0], [1], [0, 1]]
    assert not any(run["ok"])
    assert got[b] == run["blame"][b] == run["corrupt"]["parties"][b]


def test_n2_t1_step7_blame_equals_reference(gold):
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.protocols.gg20 import blame

    sec = gold["n2"]
    run = sec["step7"]
    off, _ = _offline(_key(sec["key"], 1, sec["tables"]), sec, run, sec["signers"])
    assert off.ok.all()
    st7 = run["step7"]
    m = int(st7["m"])
    sig = tg.sign_online(off, m, corrupt={"step": 7, "parties": st7["parties"]})
    assert _ints(sig.s_i) == _ints(st7["s_i"])
    assert not sig.sig_valid.any() and not any(st7["sig_valid"])
    assert blame.phase7_blame(off, sig.s_i, m) == st7["phase7"] == [[1]]


def test_n2_small_paillier_keygen_rejected_equals_reference(gold):
    """Party 1 presents a Paillier modulus of half the width with honest
    proofs for it: only the bit-length policy flags it, as in the
    reference."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    want = gold["n2"]["small_paillier"]
    res = tg.keygen(1, 1, 2, SessionRng(want["seed"]), paillier_bits=gold["bits"],
                    corrupt={"small_paillier": want["parties"]}, device=DEV)
    assert [bool(v) for v in res.ok] == want["ok"] == [False]
    assert np.asarray(res.bad_actors, dtype=bool).tolist() == want["bad_actors"] \
        == [[False, True]]


# ---- the full quorum of the n = 3 key: GG20 and GG18 --------------------------

@pytest.fixture(scope="module")
def key_full(gold):
    sec = gold["full"]
    return _key(sec["key"], sec["S"], sec["tables"])


@pytest.mark.parametrize("protocol", ["gg20", "gg18"])
def test_full_quorum_signature_equals_reference(gold, key_full, protocol):
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg18 import batch as g18
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    sec = gold["full"]
    run = sec[protocol]
    if protocol == "gg20":
        off, _ = _offline(key_full, sec, run, sec["signers"])
        sig = tg.sign_online(off, int(sec["m"]))
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
            sig = g18.sign(key_full, sec["signers"], int(sec["gg18_m"]), SessionRng(run["seed"]))
    _sign_equal(sig, run)
    assert sig.sig_valid.all() and all(int(v) <= hec.N // 2 for v in sig.s)


# ---- n = 8, t = 4, signers [0, 1, 2, 4, 6, 7] ------------------------------------

def test_n8_keygen_equals_reference_key(gold):
    """The port's keygen(1, 4, 8, SessionRng(0x53), 768) reproduces the
    reference's key file field for field."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    seed, S, t, n, bits = gold["n8"]["keygen"]
    with open(os.path.join(REPO, gold["n8"]["key"])) as f:
        d = json.load(f)
    assert d["seed"] == seed
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
        res = tg.keygen(S, t, n, SessionRng(seed), paillier_bits=bits, device=DEV)
    assert res.ok.all() and not res.bad_actors.any()
    key = res.key
    for f, got in (("p", key.p), ("q", key.q), ("nt", key.dlog_stmt.ctx.n_ints),
                   ("h1", key.dlog_stmt.h1), ("h2", key.dlog_stmt.h2), ("u", key.u),
                   ("x", key.x)):
        assert _ints(got) == _ints(d[f]), f
    assert tec.points_to_host_list(key.y_i) == tg._tuplify(d["y_i"])
    assert tec.points_to_host_list(key.vss.commitments) == tg._tuplify(d["vss"])


@pytest.mark.slow
def test_n8_t4_signers6_signature_equals_reference(gold):
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    sec = gold["n8"]
    off, _ = _offline(_key(sec["key"], sec["S"], sec["tables"]), sec, sec["run"], sec["signers"])
    assert off.ok.all()
    _sign_equal(tg.sign_online(off, int(sec["m"])), sec["run"])

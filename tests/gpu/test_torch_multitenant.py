"""Multi-tenant serving of the port on the CPU: G key groups interleaved
over S sessions (session s on group s % G), with the fixed-base tables
compressed at G groups behind a gmap and one batched verification product
per group.

Keys: the two key sets of the committed tests/fixtures/gg20key_20_2_1_3_768.json
(G = 2), repeated to S = 4 sessions (R = 2), in the tables configuration.
No case runs the reference's offline_stage: the reference falls back to
uniform units off the TPU when its tables are compressed, so its
signatures on the CPU are not the port's; each signature is held to verify
under its own group's y instead."""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
G, R = 2, 2
S = G * R
MSG = 0x6D756C74692D74656E616E74


def _key_dict():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def keys():
    """(the G-set key with its tables, the key repeated to S sessions)."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
        keyG = tg.key_from_material(_key_dict(), device="cpu")
    assert keyG.dlog_stmt.tables_rns is not None and keyG.ek.enc_tab_g is not None
    return keyG, tg.repeat_key(keyG, S)


def test_repeat_interleaved_equals_reference_layout(keys):
    """gmap, n_groups and the repeated per-session ints equal the
    reference's repeat_interleaved on the same ints."""
    from tpu_mpc.zk.range_proofs import DlogStatementBatch as JStmt
    from tpu_mpc.zk.range_proofs import PaillierCtxBatch as JEk

    keyG, key = keys
    st, ek = key.dlog_stmt, key.ek
    jst = JStmt.from_ints(keyG.dlog_stmt.ctx.n_ints, keyG.dlog_stmt.h1, keyG.dlog_stmt.h2,
                          keyG.paillier_bits).repeat_interleaved(R)
    jek = JEk.from_ints(keyG.ek.n, keyG.paillier_bits).attach_sk(keyG.p, keyG.q) \
        .repeat_interleaved(R)
    assert st.gmap.tolist() == jst.gmap.tolist() == [0, 1, 0, 1]
    assert ek.gmap.tolist() == jek.gmap.tolist()
    assert st.n_groups == jst.n_groups == ek.n_groups == jek.n_groups == G
    for a, b in ((st.ctx.n_ints, jst.ctx.n_ints), (st.h1, jst.h1), (st.h2, jst.h2),
                 (ek.n, jek.n), (ek.nn, jek.nn), (ek.sk_e, jek.sk_e), (ek.sk_p, jek.sk_p),
                 (ek.sk_hq, jek.sk_hq), (ek.sk_ctx.n_ints, jek.sk_ctx.n_ints)):
        assert np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))
    # the tables stay at G groups; a sessions-axis take slices gmap, not them
    assert st.tables_rns[0].shape[2] == G and ek.enc_tab_h.shape[2] == G
    sub = st.take(np.asarray([3, 0, 1]), 0)
    assert sub.gmap.tolist() == [1, 0, 1] and sub.tables_rns[0].shape[2] == G
    assert ek.take(np.asarray([2, 3]), 0).gmap.tolist() == [0, 1]
    peers = ek.take([0, 1], 1).expand(2)
    assert peers.gmap.tolist() == [0, 1, 0, 1] and peers.enc_tab_g.shape[2:4] == (G, 2)
    assert st.swapped().gmap is st.gmap and st.expand(2).gmap is st.gmap


def test_gmap_routed_products_equal_pow(keys):
    """pow_h1h2, sample_unit_with_power and pow_enc_base through gmap give,
    for every session, python pow over that session's own group, also in
    the [S, alice, peer] pair layout of the signing path."""
    from tpu_mpc_torch.core import pallas_rns as tpr
    from tpu_mpc_torch.utils.rng import SessionRng

    keyG, key = keys
    rng = SessionRng(0x6A)
    gmaps = []
    with pytest.MonkeyPatch.context() as mp:
        fpd = tpr.fixed_prod_dispatch
        mp.setattr(tpr, "fixed_prod_dispatch",
                   lambda *a, **kw: gmaps.append(kw.get("gmap")) or fpd(*a, **kw))
        stmt = key.dlog_stmt.take([0, 1], 1).take(np.asarray([[1], [0]]), 1)  # [S, 2, 1]
        e1, e2 = rng.bits(700, (S, 2, 1)), rng.bits(1500, (S, 2, 1))
        got = stmt.pow_h1h2(e1, e2, (776, 1552))
        ek = key.ek
        u, un, t = ek.sample_unit_with_power((S, 3), rng, sync=True, want_t=True)
        ee = rng.bits(1000, (S, 3))
        gb = ek.pow_enc_base(ee, 1024, sync=True)
    assert len(gmaps) == 4 and all(g is not None for g in gmaps)
    peer = [[1], [0]]
    for s in range(S):
        g = s % G
        for a in range(2):
            j = peer[a][0]
            nt = int(keyG.dlog_stmt.ctx.n_ints[g, j])
            want = pow(int(keyG.dlog_stmt.h1[g, j]), int(e1[s, a, 0]), nt) \
                * pow(int(keyG.dlog_stmt.h2[g, j]), int(e2[s, a, 0]), nt) % nt
            assert int(got[s, a, 0]) == want
        for i in range(3):
            n = int(keyG.ek.n[g, i])
            gbase = int(keyG.ek.enc_g[g, i])
            assert int(u[s, i]) == pow(gbase, int(t[s, i]), n)
            assert int(un[s, i]) == pow(int(u[s, i]), n, n * n)
            assert int(gb[s, i]) == pow(gbase, int(ee[s, i]), n)


def test_grouping_finds_g_and_rejects_a_changed_modulus(keys):
    """_grouping returns G = 2 for the interleaved layout and None once one
    session's modulus differs, as the reference's does on the same ints."""
    from tpu_mpc.zk import batch_verify as jbv
    from tpu_mpc_torch.zk import batch_verify as tbv

    _, key = keys
    st, ek = key.dlog_stmt, key.ek
    shape = (S, 3)
    arrays = [st.ctx.n_ints, st.h1, st.h2, ek.n]
    assert tbv._grouping(shape, G, *arrays) == jbv._grouping(shape, G, *arrays) == G
    assert tbv._grouping(shape, 1, *arrays) is None
    bad = np.array(ek.n, dtype=object)
    bad[2, 1] = int(bad[2, 1]) + 2
    arrays[3] = bad
    assert tbv._grouping(shape, G, *arrays) is None
    assert jbv._grouping(shape, G, *arrays) is None


def test_multitenant_signing_verifies_per_group(keys):
    """S = 4 sessions over G = 2 key groups sign end to end in the tables
    configuration; every signature verifies under its own group's y (and
    not under the other's); every fixed-base product went through gmap and
    both batch verifications took the G = 2 reduction, with no per-session
    fallback."""
    from tpu_mpc_torch.core import pallas_rns as tpr
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import batch_verify as tbv

    keyG, key = keys
    gmaps = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1")
        mp.setenv("TPU_MPC_TORCH_BATCH_VERIFY", "1")
        fpd = tpr.fixed_prod_dispatch
        mp.setattr(tpr, "fixed_prod_dispatch",
                   lambda *a, **kw: gmaps.append(kw.get("gmap")) or fpd(*a, **kw))
        tbv.reset_stats()
        off = tg.offline_stage(key, [0, 1], SessionRng(0x7E))
        sig = tg.sign_online(off, MSG)
        stats = {"grouped": dict(tbv.STATS["grouped"]), "per_session": tbv.STATS["per_session"]}
    assert off.ok.all() and sig.ok.all() and sig.sig_valid.all()
    for name, m in off.debug_masks.items():
        assert np.asarray(m).all(), name
    y = tec.points_to_host_list(keyG.y)
    assert y[0] != y[1]
    for s in range(S):
        r, sv = int(sig.r[s]), int(sig.s[s])
        assert hec.ecdsa_verify(y[s % G], MSG % hec.N, r, sv)
        assert not hec.ecdsa_verify(y[(s + 1) % G], MSG % hec.N, r, sv)
    assert len(gmaps) == 12 and all(g is not None for g in gmaps)
    assert stats == {"grouped": {G: 2}, "per_session": 0}

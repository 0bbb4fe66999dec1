"""The reference-exact configuration on the CPU at S = 8: the port's
per-proof verification path against the reference's.

bench.py follows its default pass with a reference-exact companion pass:
every range proof, PDL and MtA proof verified on its own
(TPU_MPC_BATCH_VERIFY=0) and uniform randomizers (TPU_MPC_ENC_TABLES=0).
S = 8 is the smallest S at which the default would batch
(zk/batch_verify.py:_enabled), so this is the per-proof path where the
default would not take it.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/gg20_ref_exact_768.json: on gg20_slice_768.json's key
(session 0 of tests/fixtures/gg20key_20_2_1_3_768.json, here tiled to
S = 8) and seed, a clean run and a run with sigma_i doubled for signer 1 of
session 5 alone (the step seam, offline_stage's corrupt={"step": 6, ...}).
Here the port runs the corrupted case once, under
TPU_MPC_TORCH_BATCH_VERIFY=0 and TPU_MPC_TORCH_ENC_TABLES=0, and every field
must equal the reference's corrupted run (integers: tolerance 0).  The
corruption changes nothing drawn from SessionRng, so the seven honest
sessions must also equal the reference's clean run, and session 5 must be
the one session that its checks name.  One run serves both, since a pass of
the plain versions on the CPU takes most of this file's time."""

import hashlib
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
GOLD = os.path.join(HERE, "fixtures", "gg20_ref_exact_768.json")
S = 8
NAMED = 5                          # the session whose signer 1 is corrupted
FIELDS = ("r_x", "k", "sigma_i", "delta_i", "msg_a_c", "alpha", "beta_g", "miu")


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


def _ints(v):
    return np.vectorize(int, otypes=[object])(np.asarray(v, dtype=object))


@pytest.fixture(scope="module")
def port_run(gold):
    """The port's corrupted run, with the verifier's path counts."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk import batch_verify as bv

    with open(FIXTURE) as f:
        d = json.load(f)
    d = {k: ([v[0]] * S if isinstance(v, list) else v) for k, v in d.items()}
    d["S"] = S
    m = int.from_bytes(hashlib.sha256(b"gg20 message").digest(), "big")
    corrupt = gold["runs"]["step6"]["corrupt"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_BATCH_VERIFY", "0")
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
        key = tg.key_from_material(d, device="cpu")
        bv.reset_stats()
        off = tg.offline_stage(key, gold["signers"], SessionRng(gold["seed"]), corrupt=corrupt)
        sig = tg.sign_online(off, m)
        stats = {"grouped": dict(bv.STATS["grouped"]), "per_session": bv.STATS["per_session"]}
    return key, off, sig, stats, m


def test_golden_is_the_reference_exact_configuration(gold):
    """The golden's runs: S = 8 on the slice's seed and signers, session 5
    corrupted alone, named by the reference and nowhere else."""
    assert (gold["S"], gold["signers"], gold["seed"], gold["bits"]) == (S, [0, 1], 0x5169, 768)
    spec = gold["runs"]["step6"]["corrupt"]
    assert spec["step"] == 6 and [b for b, ps in enumerate(spec["parties"]) if ps] == [NAMED]
    clean, bad = gold["runs"]["clean"], gold["runs"]["step6"]
    assert all(clean["ok"]) and all(clean["sig_valid"]) and all(clean["sign_ok"])
    assert [b for b in range(S) if not bad["ok"][b]] == [NAMED]
    assert [b for b in range(S) if not bad["sig_valid"][b]] == [NAMED]


def test_per_proof_path_equals_reference(gold, port_run):
    """Every field of the port's run equals the reference's corrupted run,
    no batched check ran, and the honest sessions equal the clean run."""
    key, off, sig, stats, m = port_run
    ref, clean = gold["runs"]["step6"], gold["runs"]["clean"]
    assert m == int(gold["m"])
    # per-proof verification only: no batched equation, the per-session
    # verifier for the range proofs and for the PDL proofs
    assert stats["grouped"] == {} and stats["per_session"] >= 2, stats
    assert key.ek.enc_tab_h is None and key.dlog_stmt.tables_rns is None
    assert [int(v) for v in sig.r] == [int(v) for v in ref["r"]]
    assert [int(v) for v in sig.s] == [int(v) for v in ref["s"]]
    assert [int(v) for v in sig.recid] == [int(v) for v in ref["recid"]]
    assert [bool(v) for v in sig.sig_valid] == ref["sig_valid"]
    assert [bool(v) for v in sig.ok] == ref["sign_ok"]
    assert [bool(v) for v in off.ok] == ref["ok"]
    assert np.asarray(off.bad_actors, dtype=bool).tolist() == ref["bad_actors"]
    assert set(off.debug_masks) == set(ref["debug_masks"])
    for name, mask in off.debug_masks.items():
        assert np.asarray(mask, dtype=bool).tolist() == ref["debug_masks"][name], name
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(off, f), dtype=object), _ints(ref[f])), f
    # the seven honest sessions are the clean run's, bit for bit
    honest = [b for b in range(S) if b != NAMED]
    for f in ("r", "s", "recid"):
        got = [int(v) for v in getattr(sig, f)]
        assert [got[b] for b in honest] == [int(clean[f][b]) for b in honest], f
    for f in ("k", "sigma_i", "delta_i", "alpha", "miu"):
        got = np.asarray(getattr(off, f), dtype=object)[honest]
        assert np.array_equal(got, _ints(clean[f])[honest]), f
    assert all(off.ok[b] and sig.sig_valid[b] for b in honest)

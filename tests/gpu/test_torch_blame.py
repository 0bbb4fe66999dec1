"""GG20 identifiable aborts of the port on the CPU, held exactly against the
reference package's outputs.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/gg20_blame_768.json: session 0 of the committed 768-bit
key tests/fixtures/gg20key_20_2_1_3_768.json tiled to S = 4, signers
[0, 1], tables configuration, one SessionRng seed per run.  Here only the
port runs, through the same calls in the same order, and every field and
every blame list must equal the file's (integers: tolerance 0).  Each run's
blame lists must also equal the corruption spec it injected."""

import dataclasses
import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "fixtures", "gg20_blame_768.json")
KEY = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
DEV = "cpu"
PATTERNS4 = [[], [0], [1], [0, 1]]
PATTERNS3 = [[], [0], [1]]


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


def _key(S: int, tables: bool):
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    with open(KEY) as f:
        d = json.load(f)
    d = {k: ([v[0]] * S if isinstance(v, list) else v) for k, v in d.items()}
    d["S"] = S
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "1" if tables else "0")
        key = tg.key_from_material(d, device=DEV)
    assert (key.ek.enc_tab_g is not None) == tables
    return key


@pytest.fixture(scope="module")
def key(gold):
    return _key(gold["key"]["S"], tables=True)


def _ints(v):
    return [[int(x) for x in row] for row in v]


def _pts(v):
    if v is None:
        return None
    if isinstance(v, list) and len(v) == 2 and isinstance(v[0], str):
        return (int(v[0]), int(v[1]))
    return [_pts(e) for e in v]


def _offline(key, run):
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(run["seed"])
    off = tg.offline_stage(key, [0, 1], rng, corrupt=run["corrupt"])
    assert [bool(v) for v in off.ok] == run["ok"]
    assert np.asarray(off.bad_actors, dtype=bool).tolist() == run["bad_actors"]
    for f in ("r_x", "delta_i", "sigma_i"):
        got = np.asarray(getattr(off, f), dtype=object)
        want = np.asarray(run[f], dtype=object)
        assert [int(v) for v in got.reshape(-1)] == [int(v) for v in want.reshape(-1)], f
    return off, rng


def _spec(S, patterns):
    return [patterns[b % len(patterns)] for b in range(S)]


def test_corrupt_slots_and_double_mod_q():
    from tpu_mpc_torch.protocols.gg20 import batch as tg

    Q = tg.Q
    assert list(tg._corrupt_slots([1, 2], 3)) == [(slice(None), 1), (slice(None), 2)]
    assert list(tg._corrupt_slots([[], [0], [0, 1]], 3)) == [(1, 0), (2, 0), (2, 1)]
    assert list(tg._corrupt_slots([], 3)) == []
    a = np.asarray([[Q - 1, 5], [7, Q - 3]], dtype=object)
    tg._double_mod_q(a, 1, 1)                   # one cell: a bare python int
    tg._double_mod_q(a, slice(None), 0)         # a column: an object array
    assert a.tolist() == [[Q - 2, 5], [14, Q - 6]]


def test_step5_blame_equals_reference(gold, key):
    from tpu_mpc_torch.protocols.gg20 import blame

    run = gold["runs"]["step5"]
    assert run["corrupt"]["parties"] == _spec(key.S, PATTERNS4)
    off, _ = _offline(key, run)
    got = blame.phase5_blame(key, off)
    assert got == run["phase5"] == run["corrupt"]["parties"]
    # the randomizers stayed deferred launches until the replay resolved them
    assert hasattr(off.k_randomness, "ints") and hasattr(off.beta_randomness, "ints")


def test_step6_blame_and_local_proofs_equal_reference(gold, key):
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.core.limbs import batch_from_limbs
    from tpu_mpc_torch.protocols.gg20 import blame

    run = gold["runs"]["step6"]
    off, rng = _offline(key, run)
    proofs = blame.phase6_local_proofs(off, rng)
    want = run["phase6_local_proofs"]
    assert tec.points_to_host_list(proofs.a1) == _pts(want["a1"])
    assert tec.points_to_host_list(proofs.a2) == _pts(want["a2"])
    z = np.asarray(batch_from_limbs(proofs.z), dtype=object)
    assert _ints(z.tolist()) == _ints(want["z"])
    assert blame.phase6_blame(key, off, rng, ecddh_proofs=proofs) == run["phase6"] \
        == run["corrupt"]["parties"]


def test_decommit_blame_equals_reference(gold, key):
    """The reference's decommit seam takes a flat list: party 1 in every
    session."""
    from tpu_mpc_torch.protocols.gg20 import blame

    run = gold["runs"]["decommit"]
    off, _ = _offline(key, run)
    assert blame.phase5_blame(key, off) == run["phase5"] == [run["corrupt"]["parties"]] * key.S


def test_clean_forged_proof_and_step7_equal_reference(gold, key):
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.protocols.gg20 import blame

    run = gold["runs"]["clean"]
    S = key.S
    off, rng = _offline(key, run)
    assert off.ok.all()
    assert blame.phase5_blame(key, off) == run["phase5"] == [[]] * S
    forged = dataclasses.replace(off)
    forged.sigma_i = off.sigma_i.copy()
    for b in range(S):
        if b % 4 == 1:
            forged.sigma_i[b, 0] = int(off.sigma_i[b, 0]) * 2 % hec.N
    proofs = blame.phase6_local_proofs(forged, rng)
    assert blame.phase6_blame(key, off, rng, ecddh_proofs=proofs) == run["forged_phase6"] \
        == [[0] if b % 4 == 1 else [] for b in range(S)]
    st7 = run["step7"]
    m = int(st7["m"])
    sig = tg.sign_online(off, m, corrupt=st7["corrupt"])
    assert _ints(sig.s_i.tolist()) == _ints(st7["s_i"])
    assert [bool(v) for v in sig.sig_valid] == st7["sig_valid"] == \
        [not p for p in st7["corrupt"]["parties"]]
    assert blame.phase7_blame(off, sig.s_i, m) == st7["phase7"] == st7["corrupt"]["parties"]


def test_decommit_per_session_matrix_blames_its_spec(key):
    """Per-session decommit specs, which the reference's seam does not take:
    session b on pattern b % 3; ok fails exactly where a party lied, and
    phase-5 blame names exactly the liars."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.protocols.gg20 import blame
    from tpu_mpc_torch.utils.rng import SessionRng

    spec = _spec(key.S, PATTERNS3)
    off = tg.offline_stage(key, [0, 1], SessionRng(0xD3C),
                           corrupt={"step": "decommit", "parties": spec})
    assert [bool(v) for v in off.ok] == [not p for p in spec]
    assert blame.phase5_blame(key, off) == spec


def test_step5_uniform_blames_its_spec():
    """The uniform configuration: the randomizers are ints, not deferred
    launches, and phase-5 blame reads them as they are."""
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.protocols.gg20 import blame
    from tpu_mpc_torch.utils.rng import SessionRng

    key = _key(4, tables=False)
    spec = _spec(key.S, PATTERNS4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
        off = tg.offline_stage(key, [0, 1], SessionRng(0x5F),
                               corrupt={"step": 5, "parties": spec})
    assert isinstance(off.k_randomness, np.ndarray) and isinstance(off.beta_randomness, np.ndarray)
    assert [bool(v) for v in off.ok] == [not p for p in spec]
    assert blame.phase5_blame(key, off) == spec

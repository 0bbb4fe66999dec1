"""The port's RangeProofNi and interactive PDL (zk/range_proof_ni.py,
zk/pdl.py) on the CPU, held exactly against the reference package's
outputs.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/pdl_576.json: the runs of tests/test_pdl.py (BITS = 576,
S = 2, host keypairs from each seed's rng): the range proof on x < q/3
(seed 5) and on x = q - 5 (seed 6, the soundness case), the zk_pdl flow
(seed 7) and the flow with Q = (x + 1) G (seed 8).  Here only the port runs,
through the same calls on the same draws; every proof field, message and
verdict must equal the file's (integers: tolerance 0)."""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "fixtures", "pdl_576.json")
PROOF_FIELDS = ("c1", "c2", "e", "w1", "r1", "w2", "r2", "z", "r_masked")


def _strs(a):
    return np.vectorize(lambda v: str(int(v)), otypes=[object])(
        np.asarray(a, dtype=object)).tolist()


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


def _setup(gold, name):
    """The run's rng past the key draws, the keys, x, r and c = Enc(x; r)."""
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.host import paillier as hp
    from tpu_mpc_torch.mta.mta import paillier_encrypt_ints
    from tpu_mpc_torch.paillier import paillier as dp
    from tpu_mpc_torch.utils.rng import SessionRng
    from tpu_mpc_torch.zk.range_proofs import PaillierCtxBatch

    bits, S, want = gold["bits"], gold["S"], gold[name]
    rng = SessionRng(gold["seeds"][name])
    keys = [hp.keypair(bits, rng=rng._r) for _ in range(S)]
    assert [str(k[1].p) for k in keys] == want["p"] and [str(k[1].q) for k in keys] == want["q"]
    ns = np.asarray([k[0].n for k in keys], dtype=object)
    ek = PaillierCtxBatch.from_ints(ns, bits, "cpu")
    dk = dp.BatchDecryptionKey.from_ints([k[1].p for k in keys], [k[1].q for k in keys], bits,
                                         "cpu")
    x = (np.asarray([hec.N - 5] * S, dtype=object) if name == "soundness"
         else rng.below(hec.N // 3, (S,)))
    r = rng.units_below(ns, (S,))
    c = paillier_encrypt_ints(ek, x, r)
    assert (_strs(x), _strs(r), _strs(c)) == (want["x"], want["r_enc"], want["c"])
    return rng, ek, dk, x, r, c


def _assert_proof(proof, want):
    for f in PROOF_FIELDS:
        assert _strs(getattr(proof, f)) == want[f], f"range proof field {f} differs"


@pytest.mark.parametrize("name", ["roundtrip", "soundness"])
def test_range_proof_ni_equals_reference(gold, name):
    """prove/verify; on x = q - 5 every session's proof is rejected."""
    from tpu_mpc_torch.zk import range_proof_ni

    rng, ek, _, x, r, c = _setup(gold, name)
    proof = range_proof_ni.prove(ek, c, x, r, rng)
    _assert_proof(proof, gold[name]["proof"])
    ok = [bool(v) for v in range_proof_ni.verify(proof, ek, c)]
    assert ok == gold[name]["verify"] == [name == "roundtrip"] * gold["S"]


@pytest.mark.parametrize("name", ["flow", "wrong_witness"])
def test_zk_pdl_equals_reference(gold, name):
    """Every message and state of the two rounds; the honest flow accepts,
    Q = (x + 1) G is rejected at the verifier's final check."""
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.zk import pdl

    rng, ek, dk, x, r, c = _setup(gold, name)
    want = gold[name]
    xq = x + 1 if name == "wrong_witness" else x
    stmt = pdl.PDLStatementBatch(ciphertext=c, ek=ek, Q_pt=tec.mul_generator(
        tec.sc_from_ints(np.mod(xq, hec.N), "cpu")))
    wit = pdl.PDLWitnessBatch(x=x, r=r, dk=dk)
    v1, vs = pdl.verifier_message1(stmt, rng)
    assert {"c_tag": _strs(v1.c_tag), "c_tag_tag": _strs(v1.c_tag_tag)} == want["v1"]
    assert ({"a": _strs(vs.a), "b": _strs(vs.b), "blindness": _strs(vs.blindness),
             "q_tag": tec.points_to_host_list(vs.q_tag)}
            == {**want["v_state"], "q_tag": _pts(want["v_state"]["q_tag"])})
    p1, ps = pdl.prover_message1(wit, stmt, v1, rng)
    assert _strs(p1.c_hat) == want["p1"]["c_hat"]
    _assert_proof(p1.range_proof, want["p1"]["range_proof"])
    assert ({"alpha": _strs(ps.alpha), "q_hat": tec.points_to_host_list(ps.q_hat),
             "blindness": _strs(ps.blindness)}
            == {**want["p_state"], "q_hat": _pts(want["p_state"]["q_hat"])})
    v2, range_ok = pdl.verifier_message2(p1, stmt, vs)
    p2, prover_ok = pdl.prover_message2(v1, v2, wit, ps)
    final = pdl.verifier_finalize(p1, p2, vs)
    assert [bool(v) for v in range_ok] == want["range_ok"] == [True] * gold["S"]
    assert [bool(v) for v in prover_ok] == want["prover_ok"] == [True] * gold["S"]
    assert [bool(v) for v in final] == want["final"] == [name == "flow"] * gold["S"]

"""Lindell'17 of the port on the CPU, held exactly against the reference
package's outputs.

The reference ran once, in tests/gpu/make_torch_goldens.py, and wrote
tests/gpu/fixtures/lindell17_1024.json: one rng chain from SessionRng(0x17)
(the seed of tests/test_lindell17.py) at 1024-bit Paillier, S = 2: keygen,
sign of sha256(b"lindell msg"), the Lindell -> GG18 MtA conversion, then
refresh_private_key with rng.scalars((2,)) and sign of 424242.  Here only
the port runs: once through the same calls in the same order, and once per
step from the golden key (keygen_result_from_material) with the golden
run's rng state before that step.  Every field must equal the file's
(integers: tolerance 0).  The reference verifies signatures with OpenSSL,
the port with the pure-python oracle: the same verdicts."""

import json
import os

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "fixtures", "lindell17_1024.json")


def _pts(v):
    if v is None:
        return None
    if isinstance(v, list) and len(v) == 2 and isinstance(v[0], str):
        return (int(v[0]), int(v[1]))
    return [_pts(e) for e in v]


def _strs(a):
    return [str(int(v)) for v in np.asarray(a, dtype=object).reshape(-1)]


def _rng_at(state):
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(0)
    v, st, gauss = state
    rng._r.setstate((v, tuple(st), gauss))
    return rng


def _state(rng):
    v, st, gauss = rng._r.getstate()
    return [v, list(st), gauss]


@pytest.fixture(scope="module")
def gold():
    with open(GOLD) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def kg(gold):
    """(the port's keygen, its rng past the keygen's draws)."""
    from tpu_mpc_torch.protocols.lindell17 import batch as l17
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(gold["seed"])
    return l17.keygen(gold["S"], rng, gold["bits"], device="cpu"), rng


@pytest.fixture(scope="module")
def chain(gold, kg):
    """sign, the MtA conversion, refresh and sign, in the golden run's order
    on the keygen's rng; the rng state before each step."""
    from tpu_mpc_torch.protocols.lindell17 import batch as l17

    res, rng = kg
    out = {"rng_before_sign": _state(rng)}
    out["sign"] = l17.sign(res, int(gold["m"]), rng)
    out["rng_before_mta"] = _state(rng)
    msg_b, beta = l17.party_two_to_mta_message_b(res.p2, rng)
    out["mta"] = l17.party_one_to_mta_message_b(res.p1, msg_b) + (beta,)
    out["rng_before_refresh"] = _state(rng)
    factor = rng.scalars((gold["S"],))
    out["factor"] = factor
    out["refresh"] = l17.refresh_private_key(res, factor, rng)
    out["refresh_sign"] = l17.sign(out["refresh"], int(gold["refresh"]["m"]), rng)
    return out


def _key_fields(kg) -> dict:
    from tpu_mpc_torch.ec import secp256k1 as tec

    p1, p2 = kg.p1, kg.p2
    return {"x1": _strs(p1.x1), "x2": _strs(p2.x2), "p": _strs(p1.p), "q": _strs(p1.q),
            "Q1": tec.points_to_host_list(p1.Q1), "Q2": tec.points_to_host_list(p2.Q2),
            "c_key": _strs(p1.c_key), "c_key_randomness": _strs(p1.c_key_randomness),
            "pubkey": tec.points_to_host_list(p1.pubkey),
            "pubkey2": tec.points_to_host_list(p2.pubkey), "ok": [bool(v) for v in kg.ok]}


def _assert_key(kg, want):
    got = _key_fields(kg)
    for f, v in got.items():
        w = _pts(want[f]) if f.startswith(("Q", "pubkey")) else want[f]
        assert v == w, f"{f} differs from the reference"


def _assert_sig(sig, want):
    assert _strs(sig.r) == want["r"] and _strs(sig.s) == want["s"]
    assert [int(v) for v in sig.recid] == want["recid"]
    assert [bool(v) for v in sig.ok] == want["ok"] == [True] * len(want["ok"])
    assert [bool(v) for v in sig.sig_valid] == want["sig_valid"]


def _assert_mta(mta, want):
    alpha, ok, beta = mta
    assert _strs(alpha) == want["alpha"] and _strs(beta) == want["beta"]
    assert [bool(v) for v in ok] == want["ok"] == [True] * len(want["ok"])


def test_keygen_equals_reference(gold, kg, chain):
    from tpu_mpc_torch.ec import secp256k1 as tec
    from tpu_mpc_torch.host import ec as hec

    res, _ = kg
    _assert_key(res, gold["keygen"])
    # y = x1 x2 G, and the keygen drew from the rng exactly as the reference
    for b, y in enumerate(tec.points_to_host_list(res.p1.pubkey)):
        assert y == hec.mul(int(res.p1.x1[b]) * int(res.p2.x2[b]) % hec.N)
    assert chain["rng_before_sign"] == gold["rng_before_sign"]


def test_sign_equals_reference(gold, chain):
    from tpu_mpc_torch.host import ec as hec

    _assert_sig(chain["sign"], gold["sign"])
    assert all(int(v) <= hec.N // 2 for v in chain["sign"].s)
    assert chain["rng_before_mta"] == gold["rng_before_mta"]


def test_mta_conversion_equals_reference(gold, kg, chain):
    from tpu_mpc_torch.host import ec as hec

    _assert_mta(chain["mta"], gold["mta"])
    res, _ = kg
    alpha, _, beta = chain["mta"]
    for s in range(gold["S"]):
        assert ((int(alpha[s]) + int(beta[s])) % hec.N
                == int(res.p1.x1[s]) * int(res.p2.x2[s]) % hec.N)
    assert chain["rng_before_refresh"] == gold["rng_before_refresh"]


def test_refresh_equals_reference(gold, chain):
    want = gold["refresh"]
    assert _strs(chain["factor"]) == want["factor"]
    _assert_key(chain["refresh"], want["key"])
    _assert_sig(chain["refresh_sign"], want["sign"])


@pytest.fixture(scope="module")
def from_material(gold):
    from tpu_mpc_torch.protocols.lindell17 import batch as l17

    d = dict(gold["keygen"])
    d["pubkey"] = _pts(d["pubkey"])
    return l17.keygen_result_from_material(d, device="cpu")


@pytest.mark.parametrize("step", ["sign", "mta", "refresh"])
def test_step_from_reference_key(gold, from_material, step):
    """Each step from the reference's key alone, at the golden run's rng
    state before it."""
    from tpu_mpc_torch.protocols.lindell17 import batch as l17

    kg = from_material
    _assert_key(kg, gold["keygen"])
    rng = _rng_at(gold[f"rng_before_{step}"])
    if step == "sign":
        _assert_sig(l17.sign(kg, int(gold["m"]), rng), gold["sign"])
    elif step == "mta":
        msg_b, beta = l17.party_two_to_mta_message_b(kg.p2, rng)
        _assert_mta(l17.party_one_to_mta_message_b(kg.p1, msg_b) + (beta,), gold["mta"])
    else:
        kg2 = l17.refresh_private_key(kg, rng.scalars((gold["S"],)), rng)
        _assert_key(kg2, gold["refresh"]["key"])
        _assert_sig(l17.sign(kg2, int(gold["refresh"]["m"]), rng), gold["refresh"]["sign"])

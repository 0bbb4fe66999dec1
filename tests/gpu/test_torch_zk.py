"""Hashing goldens and proof round trips of the port on the CPU: the
reference's pinned digests (tests/test_fixtures.py) must come out of the
port byte for byte, and every prover's proof must pass its verifier while a
tampered one fails."""

import hashlib
import json
import os

import numpy as np
import pytest

from tpu_mpc_torch.ec import secp256k1 as ec
from tpu_mpc_torch.hashes.fiat_shamir import digest_rows, point_hash_ints
from tpu_mpc_torch.host import ec as hec
from tpu_mpc_torch.host.serde import bigint_to_bytes
from tpu_mpc_torch.mta.mta import paillier_encrypt_ints
from tpu_mpc_torch.utils.rng import SessionRng
from tpu_mpc_torch.zk import range_proofs as rp
from tpu_mpc_torch.zk import sigma

DEV = "cpu"
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "fixtures",
                       "gg20key_20_2_1_3_768.json")
P_FIX = 0xE49FBB0E90F6BFF4CFEB4E54B9B737BC33DA9D188FE0F14F15F7C4C3A5F261E1AA2EF37343E7E1F7BE9C1A379FBAF44B5E31D68A1CEC93777EA0B1ADB18E64A3
Q_FIX = 0xD2E5B9A3C1D075DF5C46873C5B1EFF3E2B8C557F27A8A5B38F9D3B8A8FEB3F61F00F5C09C2E8D37B08F2B6DEA2D1DEB1A1BA4C6F0B7C5E9A3D2C1B0A9F8E7D55
A = lambda *v: np.asarray(v, dtype=object)


def test_curve_constants_pinned():
    assert hec.compress(hec.G).hex() == \
        "0279be667ef9dcbbac55a06295ce870b07029bfcdb2dce28d959f2815b16f81798"
    assert hec.compress(hec.BASE_POINT2).hex() == \
        "0208d13221e3a7326a34dd45214ba80116dd142e4b5ff3ce66a8dc7bfa0378b795"
    assert bigint_to_bytes(0) == b"" and bigint_to_bytes(0x0100) == b"\x01\x00"


def test_paillier_ciphertext_and_digest_pinned():
    n = P_FIX * Q_FIX
    ek = rp.PaillierCtxBatch.from_ints(A(n), bits=1024, device=DEV)
    m = 0x1122334455667788990011223344556677889900
    r = 0x0FEDCBA987654321 ** 7 % n
    c = paillier_encrypt_ints(ek, A(m), A(r))
    assert int(c[0]) == ((1 + m * n) * pow(r, n, n * n)) % (n * n)
    assert hashlib.sha256(bigint_to_bytes(int(c[0]))).hexdigest() == \
        "69108ba6b94b702866d6339dda7b6b070aad04c404d35995a8731f4424eeb514"
    e = digest_rows(A(n), A(n + 1), c)
    assert hex(int(e[0])) == "0xbe5563b439f0e7951414f73e83b6b94fbb8a0bd0718c55b33c4fecb72f410e4"


def test_point_hash_encoding_matches_host_compress():
    ks = A(1, 2, 0xDEADBEEF)
    got = point_hash_ints(ec.mul_generator(ec.sc_from_ints(ks, DEV)))
    for i, k in enumerate(ks):
        assert int(got[i]) == int.from_bytes(hec.compress(hec.mul(int(k))), "big")


@pytest.fixture(scope="module")
def keys():
    with open(FIXTURE) as f:
        d = json.load(f)
    ints = lambda k: np.vectorize(int, otypes=[object])(np.asarray(d[k], dtype=object))
    p, q = ints("p")[0, :2], ints("q")[0, :2]                      # two parties
    ek = rp.PaillierCtxBatch.from_ints(p * q, 768, DEV).attach_sk(p, q)
    stmt = rp.DlogStatementBatch.from_ints(ints("nt")[0, :2], ints("h1")[0, :2],
                                           ints("h2")[0, :2], 768, DEV)
    return ek, stmt


def test_alice_proof_round_trip(keys):
    ek, stmt = keys
    rng = SessionRng(7)
    a = rng.scalars((2,))
    r = rng.below(ek.n, (2,))
    c = paillier_encrypt_ints(ek, a, r)
    assert (ek.decrypt_sk(c) == a).all()         # the owner's CRT decryption
    peer = stmt.take([1, 0], 0)                 # each alice proves to the other party
    proof = rp.alice_prove(a, c, ek, peer, r, rng)
    assert rp.alice_verify(proof, c, ek, peer).all()
    proof.s1 = proof.s1 + A(1, 0)
    assert rp.alice_verify(proof, c, ek, peer).tolist() == [False, True]


def test_bob_proof_round_trip_with_check(keys):
    ek, stmt = keys
    rng = SessionRng(8)
    b = rng.scalars((2,))
    beta_prim = rng.below(ek.n, (2,))
    a_enc = paillier_encrypt_ints(ek, rng.scalars((2,)), rng.below(ek.n, (2,)))
    r = rng.below(ek.n, (2,))
    mta_enc = (np.vectorize(lambda c, bb, n: pow(int(c), int(bb), int(n) ** 2),
                            otypes=[object])(a_enc, b, ek.n)
               * paillier_encrypt_ints(ek, beta_prim, r)) % ek.nn
    X = [hec.mul(int(v)) for v in b]
    X_pts = (A(*(x for x, _ in X)), A(*(y for _, y in X)))
    proof = rp.bob_prove(b, beta_prim, a_enc, mta_enc, r, ek, stmt, rng, check=True,
                         X_pts=X_pts)
    assert rp.bob_verify(proof, a_enc, mta_enc, ek, stmt, X_pts=X_pts).all()
    proof.t1 = proof.t1 + A(0, 1)
    assert rp.bob_verify(proof, a_enc, mta_enc, ek, stmt, X_pts=X_pts).tolist() == [True, False]


def test_sigma_proofs_round_trip():
    rng = SessionRng(9)
    x = ec.sc_from_ints(rng.scalars((3,)), DEV)
    dl = sigma.dlog_prove(x, rng)
    assert sigma.dlog_verify(dl).all()
    m, r = ec.sc_from_ints(rng.scalars((3,)), DEV), ec.sc_from_ints(rng.scalars((3,)), DEV)
    ped = sigma.pedersen_prove(m, r, rng)
    assert sigma.pedersen_verify(ped).all()
    G, H = ec.generator((3,), DEV), ec.base_point2((3,), DEV)
    Y = ec.mul_generator(ec.sc_from_ints(rng.scalars((3,)), DEV))
    D = ec.point_add(ec.scalar_mul(m, H), ec.scalar_mul(r, Y))
    E = ec.scalar_mul(r, G)
    heg = sigma.homo_elgamal_prove(m, r, G, H, Y, D, E, rng)
    assert sigma.homo_elgamal_verify(heg, G, H, Y, D, E).all()
    assert not sigma.homo_elgamal_verify(heg, G, H, Y, E, D).any()

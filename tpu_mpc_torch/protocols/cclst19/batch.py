"""CCLST 2019 two-party ECDSA, the class-group / HSM-CL variant (port of
tpu_mpc/protocols/cclst19/batch.py).

ZenGo-X/multi-party-ecdsa's two_party_ecdsa/cclst_2019 (party_one.rs,
party_two.rs): the Lindell'17 shape with Paillier replaced by HSM-CL
encryption: exact Z_q plaintext space, so no range proofs and no rho*q
masking are needed (party_two.rs:328-356).

Host-only, as in the reference: the class-group arithmetic
(host/class_group.py) and the EC work (the host oracle host/ec.py, per
session) are pure python, sessions are a python loop, nothing runs on the
card and no entry point takes a device.  This protocol is the
capability-completeness path, not the throughput path; a device version
would be a feature the JAX package lacks.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...host import class_group as cg
from ...host import ec as hec
from ...host.serde import Digest
from ...utils.rng import SessionRng

Q = hec.N
SECURITY_BITS = 256


def _commit(value_int: int, blind: int) -> int:
    return Digest().chain_bigint(value_int, blind).result_bigint()


def _pt_int(pt) -> int:
    return int.from_bytes(hec.compress(pt), "big")


@dataclasses.dataclass
class CclstSession:
    group: cg.CLGroup
    x1: int
    x2: int
    Q1: tuple
    Q2: tuple
    sk: int                 # P1's HSM-CL secret
    pk: cg.Form
    c_key: cg.CLCiphertext  # Enc(x1)
    pubkey: tuple
    ok: bool


def keygen(S: int, rng: SessionRng, disc_bits: int = 1348, seed: bytes = b"tpu-mpc-cclst") -> list[CclstSession]:
    """2P keygen with commit/decommit + CL verifiable encryption of x1
    (party_one.rs:250-277, party_two.rs:227-251).  One shared CL group
    (public setup from seed, like CLGroup::new_from_setup)."""
    group = cg.CLGroup.from_seed(seed, disc_bits)
    out = []
    for _ in range(S):
        # P1 commits to Q1 + dlog nonce (identical dance to Lindell'17)
        x1 = int(rng.scalars(()))
        Q1 = hec.mul(x1)
        # Schnorr PoK of x1 (host): z = r + e x1
        r1 = int(rng.scalars(()))
        R1 = hec.mul(r1)
        e1 = Digest().chain_point(R1, hec.G, Q1).result_bigint() % Q
        z1 = (r1 + e1 * x1) % Q
        blind_pk = int(rng.bits(SECURITY_BITS, ()))
        blind_pok = int(rng.bits(SECURITY_BITS, ()))
        com_pk = _commit(_pt_int(Q1), blind_pk)
        com_pok = _commit(_pt_int(R1), blind_pok)

        # P2
        x2 = int(rng.scalars(()))
        Q2 = hec.mul(x2)
        r2 = int(rng.scalars(()))
        R2c = hec.mul(r2)
        e2 = Digest().chain_point(R2c, hec.G, Q2).result_bigint() % Q
        z2 = (r2 + e2 * x2) % Q

        # P1 verifies P2's proof; decommit; P2 verifies commitments + proof
        ok = hec.mul(z2) == hec.add(R2c, hec.mul(e2, Q2))
        ok &= _commit(_pt_int(Q1), blind_pk) == com_pk
        ok &= _commit(_pt_int(R1), blind_pok) == com_pok
        ok &= hec.mul(z1) == hec.add(R1, hec.mul(e1, Q1))

        # P1: HSM-CL keypair + verifiable encryption of x1
        sk, pk = group.keygen(rng)
        c_key, rho = group.encrypt(pk, x1, rng)
        proof = cg.cldl_prove(group, pk, c_key, Q1, x1, rho, rng)
        # P2: verify setup + CLDL proof (party_two.rs:227-251)
        ok &= cg.cldl_verify(group, pk, c_key, Q1, proof)

        pubkey = hec.mul(x1, Q2)
        ok &= pubkey == hec.mul(x2, Q1)
        out.append(CclstSession(group, x1, x2, Q1, Q2, sk, pk, c_key, pubkey, bool(ok)))
    return out


@dataclasses.dataclass
class CclstSignature:
    r: int
    s: int
    valid: bool


def sign(sessions: list[CclstSession], m_int: int, rng: SessionRng) -> list[CclstSignature]:
    """Eph ECDDH keygen + CL homomorphic partial sig + completion
    (party_two.rs:328-356, party_one.rs:359-391)."""
    out = []
    m = m_int % Q
    for sess in sessions:
        g = sess.group
        # ephemeral: P2 commits, P1 publishes, ECDDH both ways (host Chaum-Pedersen)
        k2 = int(rng.scalars(()))
        R2 = hec.mul(k2)
        k1 = int(rng.scalars(()))
        R1 = hec.mul(k1)
        # ECDDH proofs on (G, bp2)
        ok = True
        for kx, Rx in ((k1, R1), (k2, R2)):
            s_n = int(rng.scalars(()))
            a1 = hec.mul(s_n)
            a2 = hec.mul(s_n, hec.BASE_POINT2)
            cpt = hec.mul(kx, hec.BASE_POINT2)
            e = Digest().chain_point(hec.G, Rx, hec.BASE_POINT2, cpt, a1, a2).result_bigint() % Q
            z = (s_n + e * kx) % Q
            ok &= hec.mul(z) == hec.add(a1, hec.mul(e, Rx))
            ok &= hec.mul(z, hec.BASE_POINT2) == hec.add(a2, hec.mul(e, cpt))

        # P2 partial signature (party_two.rs:328-356)
        r_pt = hec.mul(k2, R1)
        rx = r_pt[0] % Q
        k2_inv = pow(k2, -1, Q)
        c1, _ = g.encrypt(sess.pk, k2_inv * m % Q, rng)
        v = k2_inv * sess.x2 % Q * rx % Q
        c2 = g.eval_scal(sess.c_key, v)
        c3 = g.eval_sum(c1, c2)

        # P1 completes (party_one.rs:359-391)
        s_tag = g.decrypt(sess.sk, c3)
        k1_inv = pow(k1, -1, Q)
        s_tt = s_tag * k1_inv % Q
        s_final = min(s_tt, Q - s_tt)
        rx1 = hec.mul(k1, R2)[0] % Q
        valid = ok and rx1 == rx and hec.ecdsa_verify(sess.pubkey, m, rx1, s_final)
        out.append(CclstSignature(r=rx1, s=s_final, valid=bool(valid)))
    return out

"""Lindell 2017 two-party ECDSA, session-batched (port of
tpu_mpc/protocols/lindell17/batch.py).

ZenGo-X/multi-party-ecdsa's two_party_ecdsa/lindell_2017 (party_one.rs,
party_two.rs): multiplicative key sharing y = x1 x2 G, Paillier-encrypted
x1, one-round online signing where P2 computes the encrypted partial
signature homomorphically and P1 decrypts.

Batched: S concurrent 2-party sessions, each with its own Paillier key and
ring-Pedersen setup (no fixed-base tables: K2 is never launched); both
parties' round functions are array ops over the session axis (the MPC
boundary is a host-side data move).  On the card: Paillier modexps, the
correct-key, composite-dlog and PDL-with-slack proofs and the CRT
decryption run through K1; points through K3 (GLV ladder), K4 (fixed-base
comb) and K5 (to_affine).  Signatures are checked by the batched ECDSA
verifier (host/ec.py:ecdsa_verify_batch), which gives the answers of the
reference's OpenSSL verifier.
Every entry point takes `device` (default "cuda") or runs on the device of
the key it is given.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.limbs import batch_from_limbs
from ...core.modctx import ModCtx, host_invmod, host_mulmod
from ...device import resolve_device, to_numpy
from ...ec import secp256k1 as dec
from ...hashes.fiat_shamir import commit_rows, digest_rows, point_hash_ints
from ...host import ec as hec
from ...mta import mta
from ...paillier import paillier as dp
from ...utils.ct import ct_eq_int_batch
from ...utils.rng import SessionRng
from ...zk import sigma
from ...zk.paillier_zk import (
    CompositeDLogStatementBatch,
    composite_dlog_prove,
    composite_dlog_verify,
    correct_key_prove,
    correct_key_verify,
)
from ...zk.pdl_slack import PDLwSlackStatementBatch, pdl_slack_prove, pdl_slack_verify
from ...zk.range_proofs import DlogStatementBatch, PaillierCtxBatch
from ..gg18.batch import _finish_signatures, _sc, gen_paillier_batch
from ..gg20.batch import _ints, _tuplify

Q = hec.N
SECURITY_BITS = 256


def generate_h1_h2_n_tilde_lindell(S: int, bits: int, rng: SessionRng, device=None):
    """party_one.rs:594-607: h1 < phi, xhi < 2^256, h2 = (h1^-1)^xhi mod N~
    (one K1 launch of S lanes)."""
    pt, qt = gen_paillier_batch(S, 1, bits, rng)
    pt, qt = pt[:, 0], qt[:, 0]
    n_tilde = pt * qt
    phi = (pt - 1) * (qt - 1)
    h1 = rng.below(phi, (S,))
    xhi = rng.bits(256, (S,))
    h1_inv = host_invmod(h1, n_tilde)
    ctx = ModCtx.from_ints(n_tilde, bits, device)
    h2 = ctx.pow(h1_inv, xhi, ebits_hint=256)
    return ctx, h1, h2, xhi


@dataclasses.dataclass
class Party1KeyBatch:
    x1: np.ndarray                 # [S] (secret)
    Q1: dec.Point
    ek: PaillierCtxBatch           # [S]
    dk: dp.BatchDecryptionKey
    p: np.ndarray
    q: np.ndarray
    c_key: np.ndarray              # Enc(x1)
    c_key_randomness: np.ndarray
    pubkey: dec.Point              # x1 x2 G


@dataclasses.dataclass
class Party2KeyBatch:
    x2: np.ndarray                 # [S] (secret)
    Q2: dec.Point
    ek: PaillierCtxBatch           # P1's public key
    c_key: np.ndarray
    pubkey: dec.Point


@dataclasses.dataclass
class KeygenResult2P:
    p1: Party1KeyBatch
    p2: Party2KeyBatch
    ok: np.ndarray                 # [S]


def _paillier(p_fac, q_fac, bits: int, dev):
    """P1's Paillier key: the public ek (no sk attached: P2 holds the same
    object) and the decryption key."""
    ek = PaillierCtxBatch.from_ints(p_fac * q_fac, bits, dev)
    return ek, dp.BatchDecryptionKey.from_ints(p_fac, q_fac, bits, dev)


def keygen(S: int, rng: SessionRng, paillier_bits: int = 2048, device=None) -> KeygenResult2P:
    """Lindell'17 keygen: commit/decommit of Q1 + dlog proofs + Paillier
    correct-key and PDLwSlack proofs (party_one.rs:137-400,
    party_two.rs:140-312), S sessions on `device` (default "cuda"); draws
    from rng in the reference's order."""
    dev = resolve_device(device)
    sc = lambda v: _sc(v, dev)
    # P1 round 1: commitments to Q1 and the dlog proof nonce commitment
    x1 = rng.scalars((S,))
    Q1 = dec.mul_generator(sc(x1))
    p1_dlog = sigma.dlog_prove(sc(x1), rng)
    pk_blind = rng.bits(SECURITY_BITS, (S,))
    pok_blind = rng.bits(SECURITY_BITS, (S,))
    pk_com = commit_rows(point_hash_ints(Q1), pk_blind)
    pok_com = commit_rows(point_hash_ints(p1_dlog.commitment), pok_blind)

    # P2 round 1: Q2 + dlog proof (party_two.rs:140-157)
    x2 = rng.scalars((S,))
    Q2 = dec.mul_generator(sc(x2))
    p2_dlog = sigma.dlog_prove(sc(x2), rng)

    # P1 verifies P2's proof, decommits (party_one.rs:221-229)
    p2_ok = sigma.dlog_verify(p2_dlog)

    # P2 verifies commitments + P1's proof (party_two.rs:179-223)
    pk_com_ok = commit_rows(point_hash_ints(Q1), pk_blind) == pk_com
    pok_com_ok = commit_rows(point_hash_ints(p1_dlog.commitment), pok_blind) == pok_com
    p1_ok = sigma.dlog_verify(p1_dlog)

    # P1: Paillier keypair + encrypted share (party_one.rs:318-337)
    p_fac, q_fac = gen_paillier_batch(S, 1, paillier_bits, rng)
    p_fac, q_fac = p_fac[:, 0], q_fac[:, 0]
    ek, dk = _paillier(p_fac, q_fac, paillier_bits, dev)
    ns = ek.n
    c_rand = rng.below(ns, (S,))
    c_key = mta.paillier_encrypt_ints(ek, x1, c_rand)
    ck_proof = correct_key_prove(ek.n_ctx, (p_fac - 1) * (q_fac - 1))

    # P1: PDL proof (party_one.rs:366-400)
    nt_ctx, h1, h2, xhi = generate_h1_h2_n_tilde_lindell(S, paillier_bits, rng, dev)
    cd_stmt = CompositeDLogStatementBatch(ctx=nt_ctx, g=h1, ni=h2)
    cd_proof = composite_dlog_prove(cd_stmt, xhi, rng)
    pdl_stmt = PDLwSlackStatementBatch(
        ciphertext=c_key, ek=ek, Q_pt=Q1, G_pt=dec.generator((S,), dev),
        dlog=DlogStatementBatch(ctx=nt_ctx, h1=h1, h2=h2),
    )
    pdl_proof = pdl_slack_prove(x1, c_rand, pdl_stmt, rng)

    # P2: verify correct key (incl. bit-length, party_two.rs:302-312) + PDL
    ck_ok = correct_key_verify(ck_proof, ek.n_ctx)
    bitlen_ok = np.asarray([int(v).bit_length() >= paillier_bits - 1 for v in ns], dtype=bool)
    pdl_ok = composite_dlog_verify(cd_proof, cd_stmt) & pdl_slack_verify(pdl_proof, pdl_stmt)

    pubkey1 = dec.scalar_mul(sc(x1), Q2)     # P1's view
    pubkey2 = dec.scalar_mul(sc(x2), Q1)     # P2's view (equal)
    same = to_numpy(dec.point_eq(pubkey1, pubkey2))

    ok = p2_ok & pk_com_ok & pok_com_ok & p1_ok & ck_ok & bitlen_ok & pdl_ok & same
    return KeygenResult2P(
        p1=Party1KeyBatch(x1=x1, Q1=Q1, ek=ek, dk=dk, p=p_fac, q=q_fac, c_key=c_key,
                          c_key_randomness=c_rand, pubkey=pubkey1),
        p2=Party2KeyBatch(x2=x2, Q2=Q2, ek=ek, c_key=c_key, pubkey=pubkey2),
        ok=np.asarray(ok),
    )


def keygen_result_from_material(d: dict, device=None) -> KeygenResult2P:
    """The port's KeygenResult2P from a reference key's material: a dict of
    x1, x2, p, q, c_key, c_key_randomness ([S] ints or decimal strings),
    pubkey ([S] affine [x, y]), bits (the Paillier width) and optionally ok
    ([S] bools, default all true), on `device` (default "cuda").  Q1 and Q2
    are recomputed as x1 G and x2 G (K4)."""
    dev = resolve_device(device)
    x1, x2, p, q = (_ints(d[k]) for k in ("x1", "x2", "p", "q"))
    c_key, c_rand = _ints(d["c_key"]), _ints(d["c_key_randomness"])
    ek, dk = _paillier(p, q, int(d["bits"]), dev)
    pub = dec.points_from_host(_tuplify(d["pubkey"]), dev)
    return KeygenResult2P(
        p1=Party1KeyBatch(x1=x1, Q1=dec.mul_generator(_sc(x1, dev)), ek=ek, dk=dk, p=p, q=q,
                          c_key=c_key, c_key_randomness=c_rand, pubkey=pub),
        p2=Party2KeyBatch(x2=x2, Q2=dec.mul_generator(_sc(x2, dev)), ek=ek, c_key=c_key,
                          pubkey=pub),
        ok=np.asarray(d.get("ok", [True] * len(x1)), dtype=bool),
    )


@dataclasses.dataclass
class Sign2PResult:
    r: np.ndarray
    s: np.ndarray
    recid: np.ndarray
    ok: np.ndarray
    sig_valid: np.ndarray


def sign(kg: KeygenResult2P, m_int, rng: SessionRng) -> Sign2PResult:
    """Ephemeral keygen (commit + ECDDH both sides) + homomorphic partial
    signature (party_two.rs:390-424) + completion (party_one.rs:485-564),
    on the key's device."""
    S = kg.p1.x1.shape[0]
    dev = kg.p1.ek.n_ctx.device
    sc = lambda v: _sc(v, dev)
    G, BP2 = dec.generator((S,), dev), dec.base_point2((S,), dev)
    m_arr = np.mod(np.broadcast_to(np.asarray(m_int, dtype=object), (S,)), Q)

    # P2 eph commit round (party_two.rs:314-372)
    k2 = rng.scalars((S,))
    R2 = dec.mul_generator(sc(k2))
    c2_pt = dec.scalar_mul(sc(k2), BP2)
    p2_eph_proof = sigma.ecddh_prove(sc(k2), G, BP2, rng)
    pk_blind = rng.bits(SECURITY_BITS, (S,))
    pok_blind = rng.bits(SECURITY_BITS, (S,))
    pk_com = commit_rows(point_hash_ints(R2), pk_blind)
    a1a2_hash = digest_rows(point_hash_ints(p2_eph_proof.a1), point_hash_ints(p2_eph_proof.a2))
    pok_com = commit_rows(a1a2_hash, pok_blind)

    # P1 eph round (party_one.rs:403-434)
    k1 = rng.scalars((S,))
    R1 = dec.mul_generator(sc(k1))
    c1_pt = dec.scalar_mul(sc(k1), BP2)
    p1_eph_proof = sigma.ecddh_prove(sc(k1), G, BP2, rng)

    # P2 verifies P1's ECDDH proof and decommits (party_two.rs:374-388)
    p1_eph_ok = sigma.ecddh_verify(p1_eph_proof, G, R1, BP2, c1_pt)
    # P1 verifies commitments + P2's proof (party_one.rs:436-483)
    com_ok = (commit_rows(point_hash_ints(R2), pk_blind) == pk_com) & (
        commit_rows(a1a2_hash, pok_blind) == pok_com)
    p2_eph_ok = sigma.ecddh_verify(p2_eph_proof, G, R2, BP2, c2_pt)

    # P2 partial signature (party_two.rs:390-424)
    R_p2 = dec.scalar_mul(sc(k2), R1)
    rx = batch_from_limbs(dec.x_coord_mod_q(R_p2))
    rho = rng.below(Q * Q, (S,))
    k2_inv = host_invmod(k2, Q)
    partial = rho * Q + np.mod(k2_inv * m_arr, Q)
    r_c1 = rng.below(kg.p2.ek.n, (S,))
    c1 = mta.paillier_encrypt_ints(kg.p2.ek, partial, r_c1)
    v = np.mod(k2_inv * np.mod(rx * kg.p2.x2, Q), Q)
    c2 = kg.p2.ek.nn_ctx.pow(kg.p2.c_key, v, ebits_hint=256)
    c3 = host_mulmod(c2, c1, kg.p2.ek.nn)

    # P1 completes (party_one.rs:485-564)
    s_tag = mta.paillier_decrypt_ints(kg.p1.dk, c3, (S,), kg.p1.ek.n_ctx.bits)
    s_tt = np.mod(np.mod(s_tag, Q) * host_invmod(k1, Q), Q)
    R_p1 = dec.scalar_mul(sc(k1), R2)
    rx1 = batch_from_limbs(dec.x_coord_mod_q(R_p1))
    s_final, recid, sig_valid = _finish_signatures(R_p1, s_tt, rx1, kg.p1.pubkey, m_arr)
    # r agreement checked constant-time (subtle::ConstantTimeEq analog,
    # party_one.rs:585): rx involves P2's view of the secret nonce product
    ok = p1_eph_ok & com_ok & p2_eph_ok & ct_eq_int_batch(rx, rx1) & sig_valid
    return Sign2PResult(r=rx1, s=s_final, recid=recid, ok=np.asarray(ok), sig_valid=sig_valid)


def party_two_to_mta_message_b(p2: Party2KeyBatch, rng: SessionRng):
    """Lindell -> GG18 master-key conversion, P2 side
    (party_two.rs:259-271 to_mta_message_b): respond as MtA Bob with
    b = x2 to P1's encrypted share c_key = Enc_ek1(x1), no range proofs
    (MessageB::b(&x2, ek, MessageA { c: c_key }, &[])).

    -> (MessageBBatch, beta [S]) with x1*x2 = alpha + beta mod q."""
    msg, beta, _randomness, _beta_tag, _ = mta.message_b(p2.x2, p2.ek, p2.c_key, None, None,
                                                         rng)
    return msg, beta


def party_one_to_mta_message_b(p1: Party1KeyBatch, msg_b):
    """Lindell -> GG18 master-key conversion, P1 side
    (party_one.rs:309-315 to_mta_message_b): finish as MtA Alice with
    a = x1: decrypt alpha under the Lindell Paillier sk (K1, CRT) and run the
    dlog-proof + EC-identity checks of verify_proofs_get_alpha.

    -> (alpha [S] mod q, ok [S]); (alpha, beta) are then additive GG18-style
    shares of the master secret x1*x2."""
    S = p1.x1.shape[0]
    alpha, _alpha_raw, ok = mta.verify_proofs_get_alpha(p1.dk, msg_b, p1.x1, (S,))
    return alpha, ok


def refresh_private_key(kg: KeygenResult2P, factor_ints, rng: SessionRng) -> KeygenResult2P:
    """Key rotation: x1 *= factor, x2 *= factor^{-1}, following
    party_one.rs:246-296 / party_two.rs:241-246 (a fresh Paillier key
    re-encrypts the new x1); ok: the pubkey is unchanged."""
    S = kg.p1.x1.shape[0]
    dev = kg.p1.ek.n_ctx.device
    sc = lambda v: _sc(v, dev)
    factor = np.mod(np.asarray(factor_ints, dtype=object), Q)
    x1_new = np.mod(kg.p1.x1 * factor, Q)
    x2_new = np.mod(kg.p2.x2 * host_invmod(factor, Q), Q)
    bits = kg.p1.ek.n_ctx.bits
    p_fac, q_fac = gen_paillier_batch(S, 1, bits, rng)
    p_fac, q_fac = p_fac[:, 0], q_fac[:, 0]
    ek, dk = _paillier(p_fac, q_fac, bits, dev)
    c_rand = rng.below(ek.n, (S,))
    c_key = mta.paillier_encrypt_ints(ek, x1_new, c_rand)
    Q1 = dec.mul_generator(sc(x1_new))
    Q2 = dec.mul_generator(sc(x2_new))
    pub = dec.scalar_mul(sc(x1_new), Q2)
    same = to_numpy(dec.point_eq(pub, kg.p1.pubkey))  # pubkey invariant
    return KeygenResult2P(
        p1=Party1KeyBatch(x1=x1_new, Q1=Q1, ek=ek, dk=dk, p=p_fac, q=q_fac, c_key=c_key,
                          c_key_randomness=c_rand, pubkey=pub),
        p2=Party2KeyBatch(x2=x2_new, Q2=Q2, ek=ek, c_key=c_key, pubkey=pub),
        ok=same,
    )

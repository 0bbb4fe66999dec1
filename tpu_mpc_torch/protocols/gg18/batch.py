"""GG18 {t,n}-threshold ECDSA, session-batched (port of
tpu_mpc/protocols/gg18/batch.py).

4-round keygen and 5-phase signing with the 5A-5D commit/decommit
consistency checks of ZenGo-X/multi-party-ecdsa's gg_2018/party_i.rs, over
SoA arrays [S(essions), n(parties), ...]: messages between parties are index
moves on those arrays.  MtA runs without range proofs, as the upstream test
path does (gg_2018/test.rs passes no dlog statements); GG20 adds them.

Every check yields a per-slot boolean mask; KeygenResult.ok / SignResult.ok
fold them per session.  keygen draws from SessionRng in the reference's
order (u, the Paillier primes, blind, the Feldman coefficients, the dlog
nonces), so a pinned seed gives the reference's keys value for value.
Also the helpers the GG20 path imports: _sc, _dk_take, _off_diag_sum,
gen_paillier_batch and the signature finish (_finish_signatures).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.limbs import batch_from_limbs
from ...device import resolve_device, to_numpy
from ...ec import secp256k1 as dec
from ...hashes.fiat_shamir import commit_rows, digest_rows, point_hash_ints
from ...host import ec as hec, primes
from ...mta import mta
from ...paillier import paillier as dp
from ...utils.rng import SessionRng
from ...vss import feldman
from ...zk import sigma
from ...zk.paillier_zk import correct_key_prove, correct_key_verify
from ...zk.range_proofs import PaillierCtxBatch

Q = hec.N
SECURITY = 256  # blinding bits, gg_2018/party_i.rs:42


def _sc(x, device):
    return dec.sc_from_ints(np.asarray(x, dtype=object), device)


def _dk_take(dk: dp.BatchDecryptionKey, indices, axis: int) -> dp.BatchDecryptionKey:
    return dk.map(lambda a: np.take(a, indices, axis=axis))


def _off_diag_sum(m: np.ndarray, axis: int) -> np.ndarray:
    """Sum over `axis` of a [..., t, t] pair matrix, excluding the diagonal."""
    eye = np.eye(m.shape[-1], dtype=bool)
    return np.sum(np.where(eye, 0, m), axis=axis)


def gen_paillier_batch(S: int, n: int, bits: int, rng: SessionRng, safe: bool = False):
    """Paillier prime factors (p, q), each [S, n], for every (session, party)
    slot: 2*S*n primes of bits/2 bits, one seed per prime drawn from rng in
    the reference's order (p and q alternate), searched across host
    processes (host/primes.py).  safe=True draws safe primes p = 2p' + 1."""
    gen = primes.gen_safe_primes_parallel if safe else primes.gen_primes_parallel
    flat = gen(bits // 2, 2 * S * n, rng._r)
    ps = np.asarray(flat[0::2], dtype=object).reshape(S, n)
    qs = np.asarray(flat[1::2], dtype=object).reshape(S, n)
    return ps, qs


@dataclasses.dataclass
class LocalKeyBatch:
    """The long-lived keygen output (LocalKey / PartyPrivate)."""

    S: int
    t: int
    n: int
    paillier_bits: int
    p: np.ndarray             # [S, n] Paillier prime factors (secret)
    q: np.ndarray
    ek: PaillierCtxBatch      # [S, n]
    dk: dp.BatchDecryptionKey  # [S, n]
    u: np.ndarray             # [S, n] additive key shares (secret)
    x: np.ndarray             # [S, n] VSS-aggregated shares (secret)
    y: dec.Point              # [S]   shared public key
    y_i: dec.Point            # [S, n] per-party public commitments u_i G
    vss: feldman.VssSchemeBatch  # per-dealer commitments [S, n, t+1]

    @property
    def device(self):
        return self.ek.n_ctx.device


@dataclasses.dataclass
class KeygenResult:
    key: LocalKeyBatch
    ok: np.ndarray            # [S] all checks passed
    bad_actors: np.ndarray    # [S, n] per-party failure flags


def _paillier_ctx(p_fac, q_fac, bits: int, dev):
    ek = PaillierCtxBatch.from_ints(p_fac * q_fac, bits, dev).attach_sk(p_fac, q_fac)
    return ek, dp.BatchDecryptionKey.from_ints(p_fac, q_fac, bits)


def keygen(S: int, t: int, n: int, rng: SessionRng, paillier_bits: int = 2048,
           safe_primes: bool = False, device=None) -> KeygenResult:
    """4-round GG18 keygen over a batch of S sessions (party_i.rs:148-311),
    on `device` (default "cuda").  safe_primes=True is
    Keys::create_safe_prime (party_i.rs:163-175).  No fixed-base tables are
    built (the reference's GG18 keygen builds none)."""
    dev = resolve_device(device)
    sc = lambda v: _sc(v, dev)
    # round 0: per-party secrets
    u = rng.scalars((S, n))
    y_i = dec.mul_generator(sc(u))
    p_fac, q_fac = gen_paillier_batch(S, n, paillier_bits, rng, safe=safe_primes)
    ek, dk = _paillier_ctx(p_fac, q_fac, paillier_bits, dev)

    # round 1: broadcast com(y_i) + Paillier correct-key proof
    blind = rng.bits(SECURITY, (S, n))
    y_ints = point_hash_ints(y_i)
    com = commit_rows(y_ints, blind)
    ck_proof = correct_key_prove(ek.n_ctx, (p_fac - 1) * (q_fac - 1))

    # round 2: decommit + verify; VSS share
    com_ok = commit_rows(y_ints, blind) == com
    ck_ok = correct_key_verify(ck_proof, ek.n_ctx)
    vss, shares = feldman.share(t, n, u, rng, dev)   # shares [S, n_dealer, n_recv]

    # round 3: validate shares, build x_i, dlog proofs
    vss_ok = np.ones((S, n), dtype=bool)
    for j in range(n):
        vss_ok &= feldman.validate_share(vss, shares[:, :, j], j)
    c0_ok = to_numpy(dec.point_eq(feldman.point_index(vss.commitments, 0), y_i))
    x = np.mod(np.sum(shares, axis=1), Q)            # x_j = sum_i share_{i->j}
    y = dec.point_sum(y_i, axis=1)
    dlog_proofs = sigma.dlog_prove(sc(x), rng)

    # round 4: verify dlog proofs
    dlog_ok = sigma.dlog_verify(dlog_proofs)

    bad = ~(com_ok & ck_ok & vss_ok & c0_ok & dlog_ok)
    key = LocalKeyBatch(S=S, t=t, n=n, paillier_bits=paillier_bits, p=p_fac, q=q_fac,
                        ek=ek, dk=dk, u=u, x=x, y=y, y_i=y_i, vss=vss)
    return KeygenResult(key=key, ok=~bad.any(axis=1), bad_actors=bad)


@dataclasses.dataclass
class SignResult:
    r: np.ndarray             # [S] ints
    s: np.ndarray             # [S] ints
    recid: np.ndarray         # [S] 0..3
    ok: np.ndarray            # [S] protocol checks all passed
    sig_valid: np.ndarray     # [S] independent ECDSA verification


def _finish_signatures(R: dec.Point, s_sum, r_x, y: dec.Point, m_arr):
    """Low-s normalisation (the recovery id flips with s), then every
    signature checked by host/ec.py:ecdsa_verify_batch, which gives the
    answers of the reference's OpenSSL verifier (a key off the curve fails).
    -> (s, recid, sig_valid), each [S]."""
    S = s_sum.shape[0]
    _, ry_l, _ = dec.to_affine(R)
    ry = np.asarray(batch_from_limbs(ry_l), dtype=object)
    recid = np.empty(S, dtype=object)
    s_final = np.empty(S, dtype=object)
    for b in range(S):
        sv = int(s_sum[b])
        rec = (int(ry[b]) % Q) & 1
        if sv > Q - sv:
            sv = Q - sv
            rec ^= 1
        s_final[b] = sv
        recid[b] = rec
    y_host = dec.points_to_host(y)
    sig_valid = np.asarray(hec.ecdsa_verify_batch(y_host, np.mod(m_arr, Q), r_x, s_final))
    return s_final, recid, sig_valid


def sign(key, s_parties: list[int], m_int, rng: SessionRng) -> SignResult:
    """GG18 signing among the signer subset s_parties (0-based), batched
    (phases of party_i.rs:384-711); MtA without range proofs, uniform
    randomizers for message A (rng.below(n)).  Reads S, t, x, ek, dk and y
    of the key, so a GG20 LocalKeyBatch20 signs too; when its ek carries
    randomizer tables, message B samples its randomizers through them (K2),
    as the reference's does."""
    from ..gg20.batch import _peer_idx

    S = key.S
    tp = len(s_parties)
    if tp < key.t + 1:
        raise ValueError(f"gg18.sign: {tp} signers, need at least t + 1 = {key.t + 1}")
    dev = key.ek.n_ctx.device
    sc = lambda v: _sc(v, dev)
    m_arr = np.asarray(np.broadcast_to(np.asarray(m_int, dtype=object), (S,)), dtype=object)

    # SignKeys::create: w_i = lambda_i x_i (party_i.rs:384-406)
    lam = np.asarray([feldman.lagrange_coeff(i, s_parties) for i in s_parties], dtype=object)
    w = np.mod(key.x[:, s_parties] * lam[None, :], Q)            # [S, tp]
    k = rng.scalars((S, tp))
    gamma = rng.scalars((S, tp))
    g_gamma = dec.mul_generator(sc(gamma))

    # phase 1: commit to g_gamma_i (party_i.rs:408-424)
    blind1 = rng.bits(SECURITY, (S, tp))
    gg_ints = point_hash_ints(g_gamma)
    com1 = commit_rows(gg_ints, blind1)

    # MtA pairs in the off-diagonal packed layout [S, alice, tp-1]
    peers, iinv = _peer_idx(tp)
    kidx = np.broadcast_to(np.arange(tp - 1), (tp, tp - 1))
    pshape = (S, tp, tp - 1)
    ek_s = key.ek.take(s_parties, 1)                  # [S, tp]
    ek_pairs = ek_s.expand(2)                         # [S, tp, 1]
    r_a = rng.below(np.broadcast_to(ek_s.n, (S, tp)), (S, tp))
    msg_a = mta.message_a(k, ek_s, r_a, None, rng)
    c_a_pairs = np.broadcast_to(msg_a.c[:, :, None], pshape)
    msg_b_gamma, beta_g, _, _, _ = mta.message_b(gamma[:, peers], ek_pairs, c_a_pairs,
                                                 None, None, rng)
    msg_b_w, beta_w, _, _, _ = mta.message_b(w[:, peers], ek_pairs, c_a_pairs, None, None, rng)

    # alice decrypts alpha (gamma path) and mu (w path)
    dk_s = mta.expand_tree_axis(_dk_take(key.dk, s_parties, 1), 2)
    a_pairs = np.broadcast_to(k[:, :, None], pshape)
    alpha, _, ok_a = mta.verify_proofs_get_alpha(dk_s, msg_b_gamma, a_pairs, pshape,
                                                 ek_sk=ek_pairs)
    mu, _, ok_m = mta.verify_proofs_get_alpha(dk_s, msg_b_w, a_pairs, pshape, ek_sk=ek_pairs)
    mta_ok = (ok_a & ok_m).all(axis=(1, 2))

    # phase 2: delta_i, sigma_i (party_i.rs:426-444)
    delta_i = np.mod(np.mod(k * gamma, Q) + np.sum(alpha, axis=2)
                     + np.sum(beta_g[:, iinv, kidx], axis=2), Q)
    sigma_i = np.mod(np.mod(k * w, Q) + np.sum(mu, axis=2)
                     + np.sum(beta_w[:, iinv, kidx], axis=2), Q)

    # phase 3: delta = sum, invert (party_i.rs:446-452)
    delta = np.mod(np.sum(delta_i, axis=1), Q)
    delta_inv = np.asarray([pow(int(d), -1, Q) for d in delta], dtype=object)

    # phase 4: decommit g_gamma, check b_proofs, R (party_i.rs:454-483)
    com_ok = (commit_rows(gg_ints, blind1) == com1).all(axis=1)
    gg_peers = dec.point_take(g_gamma, peers, 1)     # bob j's gamma must be the decommitted one
    pk_ok = to_numpy(dec.point_eq(msg_b_gamma.b_proof.pk, gg_peers)).all(axis=(1, 2))
    R = dec.scalar_mul(sc(delta_inv), dec.point_sum(g_gamma, axis=1))
    r_x = np.asarray(batch_from_limbs(dec.x_coord_mod_q(R)), dtype=object)

    # phase 5 local signature: s_i = m k_i + r sigma_i (party_i.rs:487-511)
    s_i = np.mod(np.mod(m_arr, Q)[:, None] * k + r_x[:, None] * sigma_i, Q)

    # phase 5A: V_i, A_i, B_i + commitment (party_i.rs:513-559)
    l_i = rng.scalars((S, tp))
    rho_i = rng.scalars((S, tp))
    R_pairs = dec.point_expand(R, 1)
    G = dec.generator((S, tp), dev)
    V_i = dec.point_add(dec.scalar_mul(sc(s_i), R_pairs), dec.mul_generator(sc(l_i)))
    A_i = dec.mul_generator(sc(rho_i))
    B_i = dec.mul_generator(sc(np.mod(l_i * rho_i, Q)))
    blind5a = rng.bits(SECURITY, (S, tp))
    input_hash5a = digest_rows(point_hash_ints(V_i), point_hash_ints(A_i), point_hash_ints(B_i))
    com5a = commit_rows(input_hash5a, blind5a)
    # HomoElGamal: G = A_i, H = R, Y = g, D = V_i, E = B_i; witness x = s_i, r = l_i
    heg = sigma.homo_elgamal_prove(sc(s_i), sc(l_i), A_i, R_pairs, G, V_i, B_i, rng)
    dlog_rho = sigma.dlog_prove(sc(rho_i), rng)

    # phase 5B/5C: verify, then U_i and T_i (party_i.rs:561-636)
    com5a_ok = (commit_rows(input_hash5a, blind5a) == com5a).all(axis=1)
    heg_ok = sigma.homo_elgamal_verify(heg, A_i, R_pairs, G, V_i, B_i).all(axis=1)
    rho_ok = sigma.dlog_verify(dlog_rho).all(axis=1)
    # v = sum V - m G - r y (the sum includes the party's own V_i)
    m_g = dec.mul_generator(sc(np.mod(m_arr, Q)))
    r_y = dec.scalar_mul(sc(r_x), key.y)
    v = dec.point_add(dec.point_sum(V_i, axis=1), dec.point_neg(dec.point_add(m_g, r_y)))
    u_i = dec.scalar_mul(sc(rho_i), dec.point_expand(v, 1))
    # a excludes the party's own A_i (party_i.rs:595,599): t_i = l_i (sum_j A_j - A_i)
    a_minus_own = dec.point_add(dec.point_expand(dec.point_sum(A_i, axis=1), 1),
                                dec.point_neg(A_i))
    t_i = dec.scalar_mul(sc(l_i), a_minus_own)
    blind5c = rng.bits(SECURITY, (S, tp))
    input_hash5c = digest_rows(point_hash_ints(u_i), point_hash_ints(t_i))
    com5c = commit_rows(input_hash5c, blind5c)

    # phase 5D: sum check (party_i.rs:638-673)
    com5c_ok = (commit_rows(input_hash5c, blind5c) == com5c).all(axis=1)
    t_plus_b = dec.point_sum(dec.point_add(t_i, B_i), axis=1)
    sum_ok = to_numpy(dec.point_eq(t_plus_b, dec.point_sum(u_i, axis=1)))

    # the signature (party_i.rs:674-711)
    s_final, recid, sig_valid = _finish_signatures(R, np.mod(np.sum(s_i, axis=1), Q), r_x,
                                                   key.y, m_arr)
    ok = mta_ok & com_ok & pk_ok & com5a_ok & heg_ok & rho_ok & com5c_ok & sum_ok
    return SignResult(r=r_x, s=s_final, recid=recid, ok=np.asarray(ok), sig_valid=sig_valid)


def refresh_private_key(key: LocalKeyBatch, factor_ints, rng: SessionRng) -> LocalKeyBatch:
    """Key rotation (party_i.rs:326-358): u_i += factor and a fresh Paillier
    keypair per slot.  factor_ints [S, n]: a refresh ceremony supplies
    zero-sum factors so that y is unchanged; like the reference, this
    applies whatever it is given."""
    S, n, bits, dev = key.S, key.n, key.paillier_bits, key.device
    u_new = np.mod(key.u + np.mod(np.asarray(factor_ints, dtype=object), Q), Q)
    y_i_new = dec.mul_generator(_sc(u_new, dev))
    p_fac, q_fac = gen_paillier_batch(S, n, bits, rng)
    ek, dk = _paillier_ctx(p_fac, q_fac, bits, dev)
    return dataclasses.replace(key, u=u_new, y_i=y_i_new, y=dec.point_sum(y_i_new, axis=1),
                               p=p_fac, q=q_fac, ek=ek, dk=dk)


def update_private_key(key: LocalKeyBatch, factor_u, factor_x) -> LocalKeyBatch:
    """PartyPrivate::update_private_key (party_i.rs:371-381): additive
    update of u_i and x_i; the Paillier keys are untouched."""
    u_new = np.mod(key.u + np.asarray(factor_u, dtype=object), Q)
    x_new = np.mod(key.x + np.asarray(factor_x, dtype=object), Q)
    y_i_new = dec.mul_generator(_sc(u_new, key.device))
    return dataclasses.replace(key, u=u_new, x=x_new, y_i=y_i_new,
                               y=dec.point_sum(y_i_new, axis=1))


def to_encrypted_segments(key, segment_size: int, num_segments: int, pub_y, rng: SessionRng):
    """Verifiable backup of every u_i share (party_i.rs:360-369) ->
    (witnesses, encrypted segment lists), flattened [S * n] row-major
    (host/backup.py)."""
    from ...host import backup

    return backup.backup_batch(key.u, segment_size, num_segments, pub_y, rng)

"""GG20 identifiable aborts: batched blame (port of
tpu_mpc/protocols/gg20/blame.py).

On a phase-5, 6 or 7 failure the parties reveal the listed local state,
every MtA ciphertext is replayed deterministically, and the mismatching
slots become the bad-actor set (ZenGo-X/multi-party-ecdsa's
gg_2020/blame.rs): here a boolean [S, tp] matrix, returned as per-session
sorted index lists.  The dense [S, alice, bob] matrices of OfflineState are
globally indexed, so "party i's beta against j" is beta[:, j, i].

Device work: the replayed encryptions and c_A^gamma mod N^2 through K1 (in
the tables configuration resolve() first launches the deferred randomizer
values, K2), the EC replays through K3/K4 and the comparisons through K5.
Phase 6's Paillier `open` of the MtAwc ciphertexts runs on the host in pure
python (host/paillier.py), as the reference's does.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.modctx import resolve
from ...device import to_numpy
from ...ec import secp256k1 as dec
from ...host import ec as hec, paillier as hp
from ...mta import mta
from ...utils.rng import SessionRng
from ...vss import feldman
from ...zk import sigma
from ...zk.range_proofs import _mulmod
from ..gg18.batch import _off_diag_sum, _sc
from .batch import LocalKeyBatch20, OfflineState

Q = hec.N


def _bad_lists(bad: np.ndarray) -> list[list[int]]:
    """[S, tp] bool -> per-session sorted bad-actor index lists."""
    return [sorted(int(j) for j in np.nonzero(row)[0]) for row in bad]


def _replay_msg_a(ek_s, off: OfflineState) -> np.ndarray:
    """[S, tp] bool: alice i's revealed k_i and randomness re-encrypt to a
    ciphertext other than her message A."""
    return mta.paillier_encrypt_ints(ek_s, np.mod(off.k, Q), resolve(off.k_randomness)) \
        != off.msg_a_c


def phase5_blame(key: LocalKeyBatch20, off: OfflineState) -> list[list[int]]:
    """Replay of the gamma-path MtA (blame.rs:116-224) from the revealed
    LocalStatePhase5 fields: k, k_randomness, gamma, beta_randomness,
    beta_tag."""
    S = key.S
    tp = len(off.s_parties)
    dev = key.device
    eye = np.eye(tp, dtype=bool)[None]
    ek_s = key.ek.take(off.s_parties, 1)

    # 1. decommit re-check (blame.rs:126-141): the revealed gamma_i must
    # reproduce the decommitted g_gamma_i
    bad = np.zeros((S, tp), dtype=bool)
    if off.g_gamma_decommit is not None:
        g_gamma_rec = dec.mul_generator(_sc(np.mod(off.gamma, Q), dev))
        bad |= ~to_numpy(dec.point_eq(g_gamma_rec, off.g_gamma_decommit))

    # 2. message A re-encrypted with the revealed randomness
    bad |= _replay_msg_a(ek_s, off)

    # 3. the message-B matrix: c_B[i, j] = c_A[i]^gamma_j Enc_i(beta'_ij)
    c_a_pairs = np.broadcast_to(off.msg_a_c[:, :, None], (S, tp, tp))
    ek_pairs = ek_s.expand(2)
    c_beta_tag = mta.paillier_encrypt_ints(ek_pairs, off.beta_tag, resolve(off.beta_randomness))
    b_ca = ek_pairs.nn_ctx.pow(c_a_pairs, np.mod(off.gamma[:, None, :], Q), 256)
    c_b_replay = _mulmod(b_ca, c_beta_tag, np.broadcast_to(ek_pairs.nn, (S, tp, tp)))
    # a mismatch in (alice i, bob j) blames bob j (blame.rs:155-157)
    bad |= np.where(eye, False, c_b_replay != off.msg_b_gamma_c).any(axis=1)

    # 4. delta_i rebuilt from the revealed values: alpha_ij = k_i gamma_j - beta_ij
    beta = np.mod(-np.mod(off.beta_tag, Q), Q)
    alpha = np.mod(np.mod(off.k[:, :, None] * off.gamma[:, None, :], Q) - beta, Q)
    kg = np.mod(off.k * off.gamma, Q)
    delta_rec = np.mod(kg + _off_diag_sum(alpha, 2) + _off_diag_sum(beta, 1), Q)
    bad |= delta_rec != np.mod(off.delta_i, Q)
    return _bad_lists(bad)


def phase6_local_proofs(off: OfflineState, rng: SessionRng) -> sigma.ECDDHProof:
    """The ECDDH proof each accused party makes from its local state for
    the statement (G, R; sigma_i G, S_i): the per-party inputs of the
    judge's phase6_blame (GlobalStatePhase6, blame.rs:258-271)."""
    S = off.k.shape[0]
    tp = len(off.s_parties)
    dev = off.R.X.device
    return sigma.ecddh_prove(_sc(off.sigma_i, dev), dec.generator((S, tp), dev),
                             dec.point_expand(off.R, 1), rng)


def phase6_blame(key: LocalKeyBatch20, off: OfflineState, rng: SessionRng,
                 ecddh_proofs: sigma.ECDDHProof | None = None) -> list[list[int]]:
    """Replay of the w-path MtAwc and the ECDDH consistency
    (blame.rs:322-421).  ecddh_proofs: the accused parties' revealed proofs
    (phase6_local_proofs), inputs here: a forged one fails and blames its
    maker (blame.rs:396-414).  Omitted, honest local proofs are made from
    rng."""
    S = key.S
    tp = len(off.s_parties)
    dev = key.device
    eye = np.eye(tp, dtype=bool)[None]
    ek_s = key.ek.take(off.s_parties, 1)
    ek_pairs = ek_s.expand(2)
    bad = np.zeros((S, tp), dtype=bool)

    # the mu randomness by Paillier::open on the host (blame.rs:252-256)
    p_s = key.p[:, off.s_parties]
    q_s = key.q[:, off.s_parties]
    miu_rand = np.empty((S, tp, tp), dtype=object)
    for s in range(S):
        for i in range(tp):
            dk = hp.DecryptionKey(int(p_s[s, i]), int(q_s[s, i]))
            for j in range(tp):
                miu_rand[s, i, j] = 1 if i == j else hp.open(dk, int(off.m_b_w_c[s, i, j]))[1]

    # 1. mu (raw, before reduction mod q) re-encrypted with that randomness
    c_replay = mta.paillier_encrypt_ints(ek_pairs, off.miu, miu_rand)
    bad |= np.where(eye, False, c_replay != off.m_b_w_c).any(axis=2)

    # 2. message A re-encrypted
    bad |= _replay_msg_a(ek_s, off)

    # 3. g_sigma_i rebuilt, and the ECDDH proofs checked against it
    lam = np.asarray([feldman.lagrange_coeff(i, off.s_parties) for i in off.s_parties],
                     dtype=object)
    w = np.mod(key.x[:, off.s_parties] * lam[None, :], Q)
    g_w = dec.mul_generator(_sc(w, dev))
    # g_ni[i, j] = k_i g_w_j - mu_ij G (blame.rs:358-373)
    k_pairs = _sc(np.mod(np.broadcast_to(off.k[:, :, None], (S, tp, tp)), Q), dev)
    g_w_k = dec.scalar_mul(k_pairs, dec.point_expand(g_w, 1))          # [S, i, j]
    g_miu = dec.mul_generator(_sc(np.mod(off.miu, Q), dev))
    g_ni = dec.point_add(g_w_k, dec.point_neg(g_miu))
    # g_sigma_i = k_i g_w_i + sum_j mu_ij G + sum_j g_ni[j, i] (blame.rs:377-394)
    g_wi_ki = dec.scalar_mul(_sc(np.mod(off.k, Q), dev), g_w)
    miu_sum = np.mod(np.sum(np.where(eye, 0, np.mod(off.miu, Q)), axis=2), Q)
    g_sigma = dec.point_add(g_wi_ki, dec.mul_generator(_sc(miu_sum, dev)))
    # the diagonal of g_ni masked to infinity before the sum over alice j
    inf = dec.point_infinity((S, tp, tp), dev)
    diag = torch.eye(tp, dtype=torch.bool, device=dev)[None, :, :, None]
    g_ni_masked = dec.Point(*(torch.where(diag, a, b) for a, b in zip(inf, g_ni)))
    g_sigma = dec.point_add(g_sigma, dec.point_sum(g_ni_masked, axis=1))

    # ECDDH statement (g1 = G, g2 = R, h1 = g_sigma_i, h2 = S_i)
    if ecddh_proofs is None:
        ecddh_proofs = phase6_local_proofs(off, rng)
    ok = sigma.ecddh_verify(ecddh_proofs, dec.generator((S, tp), dev), g_sigma,
                            dec.point_expand(off.R, 1), off.S_i)
    bad |= ~ok
    return _bad_lists(bad)


def phase7_blame(off: OfflineState, s_i: np.ndarray, m_int) -> list[list[int]]:
    """s_i R == m R_bar_i + r S_i per party (blame.rs:433-455)."""
    S, tp = s_i.shape[0], s_i.shape[1]
    dev = off.R.X.device
    sc = lambda v: _sc(v, dev)
    m_arr = np.mod(np.broadcast_to(np.asarray(m_int, dtype=object), (S, tp)), Q)
    lhs = dec.scalar_mul(sc(np.mod(s_i, Q)), dec.point_expand(off.R, 1))
    rhs = dec.point_add(
        dec.scalar_mul(sc(m_arr), off.R_bar),
        dec.scalar_mul(sc(np.mod(np.broadcast_to(off.r_x[:, None], (S, tp)), Q)), off.S_i),
    )
    return _bad_lists(~to_numpy(dec.point_eq(lhs, rhs)))

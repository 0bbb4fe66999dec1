"""Batched MtA / MtAwc share conversion (port of tpu_mpc/mta/mta.py).

Alice encrypts a under her Paillier key (message_a, + range proofs against
each peer's ring-Pedersen setup); Bob homomorphically computes E(ab + beta') and proves
knowledge of b and beta'; alpha + beta = ab mod q.  Ciphertext math is
ModCtx modexps (kernel K1; Bob's randomizer r^N from the randomizer tables,
kernel K2, in the tables configuration); decryption is
PaillierCtxBatch.decrypt_sk.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.modctx import resolve
from ..device import to_numpy
from ..ec import secp256k1 as dec
from ..host import ec as hec
from ..paillier import paillier as dp
from ..zk import sigma
from ..zk.range_proofs import (
    AliceProofBatch,
    DlogStatementBatch,
    PaillierCtxBatch,
    _mulmod,
    alice_prove,
)

Q = hec.N


def paillier_encrypt_ints(ek: PaillierCtxBatch, m, r, rn=None) -> np.ndarray:
    """(1 + m n) r^n mod n^2 on object ints (device modexp; the key
    owner's CRT half-width path when the sk is attached).  rn: r^n already
    computed (randomizer-table sampling, sample_unit_with_power); r is then
    not read (it may be a DeferredLaunch, whose np.shape is ())."""
    m = np.asarray(m, dtype=object)
    shape = np.broadcast_shapes(m.shape, np.shape(r), ek.n_ctx.batch_shape)
    n = np.broadcast_to(ek.n, shape)
    if rn is not None:
        rn = resolve(rn)
    elif ek.sk_ctx is not None:
        rn = ek.pow_n_sk(r)
    else:
        rn = ek.nn_ctx.pow(r, n, ek.n_ctx.bits)
    return _mulmod(np.broadcast_to(m, shape) * n + 1, rn, np.broadcast_to(ek.nn, shape))


def expand_tree_axis(dk: dp.BatchDecryptionKey, axis: int) -> dp.BatchDecryptionKey:
    """Insert a batch axis into every leaf (so leading dims right-align)."""
    return dk.map(lambda a: np.expand_dims(a, axis))


@dataclasses.dataclass
class MessageABatch:
    """c = Enc_ek(a) and, when statements are given, one range proof per
    peer statement (mta/mod.rs:34-38)."""

    c: np.ndarray
    range_proofs: AliceProofBatch | None


def message_a(a_ints, ek: PaillierCtxBatch, randomness, stmts: DlogStatementBatch | None,
              rng) -> MessageABatch:
    """Alice's message: a [...] ints < q, randomness [...] < n.  With stmts
    of a trailing peer axis (e.g. [S, n_peers]) a and randomness broadcast
    against it and one proof per peer is made.  (GG18 calls it without
    statements; GG20's offline_stage encrypts inline, with the
    randomizer-table path.)"""
    c = paillier_encrypt_ints(ek, a_ints, randomness)
    proofs = None
    if stmts is not None:
        proofs = alice_prove(a_ints, c, ek, stmts, randomness, rng)
    return MessageABatch(c=c, range_proofs=proofs)


@dataclasses.dataclass
class MessageBBatch:
    """Bob's response: c = E(ab + beta') and PoKs of b and beta'."""

    c: np.ndarray
    b_proof: sigma.DLogProof
    beta_tag_proof: sigma.DLogProof


def message_b(b_ints, ek: PaillierCtxBatch, msg_a_c, alice_proofs: AliceProofBatch | None,
              own_stmt: DlogStatementBatch | None, rng):
    """-> (MessageBBatch, beta ints, randomness, beta_tag, alice_ok or None).
    own_stmt: Bob's own (h1, h2, N_tilde) used to verify Alice's proof."""
    b_arr = np.asarray(b_ints, dtype=object)
    shape = np.broadcast_shapes(b_arr.shape, ek.n_ctx.batch_shape, np.shape(msg_a_c))
    n = np.broadcast_to(ek.n, shape)
    dev = ek.n_ctx.device

    alice_ok = None
    if alice_proofs is not None and own_stmt is not None:
        from ..zk.batch_verify import alice_verify_fast

        alice_ok = alice_verify_fast(alice_proofs, msg_a_c, ek, own_stmt)

    beta_tag = np.asarray(rng.below(n, shape), dtype=object)
    nn = np.broadcast_to(ek.nn, shape)
    if ek.enc_tab_g is not None:
        # Bob encrypts under Alice's key: the randomizer tables replace the
        # full-width r^N.  No Bob range proof reveals r here, only a blame
        # replay does, so its launch stays deferred (DeferredLaunch)
        randomness, rn_l = ek.sample_unit_with_power(shape, rng, sync=False,
                                                     defer_value=True)
    else:
        randomness = np.asarray(rng.below(n, shape), dtype=object)
        rn_l = ek.nn_ctx.pow(randomness, n, ek.n_ctx.bits, sync=False)
    b_ca_l = ek.nn_ctx.pow(msg_a_c, b_arr, 256, sync=False)
    beta = np.vectorize(lambda v: (-int(v)) % Q, otypes=[object])(beta_tag)

    b_proof = sigma.dlog_prove(dec.sc_from_ints(np.mod(np.broadcast_to(b_arr, shape), Q), dev),
                               rng)
    beta_tag_proof = sigma.dlog_prove(dec.sc_from_ints(np.mod(beta_tag, Q), dev), rng)

    c_beta_tag = _mulmod(np.broadcast_to(beta_tag, shape) * n + 1, resolve(rn_l), nn)
    c_b = _mulmod(resolve(b_ca_l), c_beta_tag, nn)
    msg = MessageBBatch(c=c_b, b_proof=b_proof, beta_tag_proof=beta_tag_proof)
    return msg, beta, randomness, beta_tag, alice_ok


def msg_b_index(m: MessageBBatch, i: int) -> MessageBBatch:
    """Slice a stacked-[2, ...] MessageBBatch (the gamma/w pair of the GG20
    responder step) back into one path's view."""
    sl = lambda p: sigma.DLogProof(
        pk=dec.point_index_axis(p.pk, i, 0),
        commitment=dec.point_index_axis(p.commitment, i, 0),
        z=p.z[i],
    )
    return MessageBBatch(c=m.c[i], b_proof=sl(m.b_proof), beta_tag_proof=sl(m.beta_tag_proof))


def verify_proofs_get_alpha(dk: dp.BatchDecryptionKey, msg_b: MessageBBatch, a_ints,
                            batch_shape, ek_sk: PaillierCtxBatch):
    """Alice decrypts alpha (decrypt_sk) and checks Bob's dlog proofs and the
    EC identity b*a*G + beta'G == alpha G.  -> (alpha mod q, alpha_raw, ok).
    Every caller decrypts through ek_sk (K1): the reference's GG18 passes no
    ek_sk and decrypts on its CIOS limb path instead, to the same integers;
    dk is kept for the reference's signature and not read."""
    alpha_raw = np.broadcast_to(np.asarray(ek_sk.decrypt_sk(msg_b.c), dtype=object),
                                batch_shape)
    alpha = np.mod(alpha_raw, Q)
    dev = ek_sk.n_ctx.device
    ok = sigma.dlog_verify(msg_b.b_proof) & sigma.dlog_verify(msg_b.beta_tag_proof)
    g_alpha = dec.mul_generator(dec.sc_from_ints(alpha, dev))
    a_sc = dec.sc_from_ints(
        np.mod(np.broadcast_to(np.asarray(a_ints, dtype=object), batch_shape), Q), dev)
    ba_btag = dec.point_add(dec.scalar_mul(a_sc, msg_b.b_proof.pk), msg_b.beta_tag_proof.pk)
    ok = ok & to_numpy(dec.point_eq(ba_btag, g_alpha))
    return alpha, alpha_raw, ok

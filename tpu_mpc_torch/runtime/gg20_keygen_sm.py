"""GG20 keygen state machine — per-party, message-driven (port of
tpu_mpc/runtime/gg20_keygen_sm.py).

The deployment-path counterpart of protocols/gg20/batch.py:  each party runs
its own `Gg20Keygen` instance (reference: gg_2020/state_machine/keygen.rs),
exchanging JSON messages through the relay or the in-process simulator.
Internally each round calls the same batched gadgets with singleton (or
per-peer) batch shapes, so both paths share one crypto implementation: on
the card the modexps are K1 launches, the commitments K4, the proof and
share checks K3, and every device point read back K5.

`device` (default "cuda") is where those gadgets run; every ModCtx, device
point and scalar of the machine is made there.

Output: a LocalKey dict (state_machine/keygen/rounds.rs:310-329) holding
paillier_dk, pk_vec, shared_keys (y, x_i), vss vector, ek/h1h2 vectors.
"""

from __future__ import annotations

import numpy as np

from ..core.limbs import batch_from_limbs
from ..core.modctx import ModCtx
from ..device import resolve_device
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import commit_rows, point_hash_ints
from ..host import ec as hec
from ..protocols.gg18.batch import _sc, gen_paillier_batch
from ..protocols.gg20.batch import generate_h1_h2_n_tilde_batch
from ..utils.rng import SessionRng
from ..vss import feldman
from ..zk import sigma
from ..zk.paillier_zk import (
    CompositeDLogProofBatch,
    CompositeDLogStatementBatch,
    CorrectKeyProofBatch,
    composite_dlog_prove,
    composite_dlog_verify,
    correct_key_prove,
    correct_key_verify,
)
from .state_machine import ProtocolError, StateMachine

Q = hec.N


def _obj(x):
    return np.asarray(x, dtype=object)


def _pt_host(P):
    return dec.points_to_host(P)


class Gg20Keygen(StateMachine):
    # rounds: 1 bc (com+proofs), 2 bc (decommit), 3 p2p (VSS share), 4 bc (dlog)
    ROUND_KINDS = {1: "bc", 2: "bc", 3: "p2p", 4: "bc"}
    """i: 1-based party index; t, n: threshold params (Keygen::new,
    state_machine/keygen.rs:56-82)."""

    def __init__(self, i: int, t: int, n: int, rng: SessionRng | None = None,
                 paillier_bits: int = 2048, device=None):
        super().__init__(i, n, num_rounds=4)
        self.t = t
        self.bits = paillier_bits
        self.rng = rng or SessionRng()
        self.dev = resolve_device(device)

    # round 0: Keys::create + phase1 broadcast (keygen/rounds.rs:26-62)
    def _r0(self):
        rng, dev = self.rng, self.dev
        self.u = int(rng.scalars(()))
        self.y_pt = hec.mul(self.u)
        p_f, q_f = gen_paillier_batch(1, 1, self.bits, rng)
        self.p_fac, self.q_fac = int(p_f[0, 0]), int(q_f[0, 0])
        self.n_paillier = self.p_fac * self.q_fac
        nt_ctx, h1, h2, xhi, xhi_inv, _ = generate_h1_h2_n_tilde_batch(
            1, 1, self.bits, rng, dev)
        self.n_tilde = int(nt_ctx.n_ints[0, 0])
        self.h1, self.h2 = int(h1[0, 0]), int(h2[0, 0])
        self.blind = int(rng.bits(256, ()))
        y_int = int(point_hash_ints(dec.points_from_host(self.y_pt, dev)))
        self.com = int(commit_rows(_obj(y_int), _obj(self.blind)))

        ek_ctx = ModCtx.from_ints(self.n_paillier, self.bits, dev)
        phi = (self.p_fac - 1) * (self.q_fac - 1)
        ck = correct_key_prove(ek_ctx, _obj(phi))
        stmt1 = CompositeDLogStatementBatch(
            ctx=ModCtx.from_ints(self.n_tilde, self.bits, dev), g=_obj(self.h1),
            ni=_obj(self.h2))
        stmt2 = CompositeDLogStatementBatch(ctx=stmt1.ctx, g=_obj(self.h2), ni=_obj(self.h1))
        cd1 = composite_dlog_prove(stmt1, _obj(int(xhi[0, 0])), rng)
        cd2 = composite_dlog_prove(stmt2, _obj(int(xhi_inv[0, 0])), rng)
        self._broadcast(1, {
            "ek_n": self.n_paillier,
            "com": self.com,
            "dlog_statement": {"N": self.n_tilde, "g": self.h1, "ni": self.h2},
            "correct_key_proof": [int(s) for s in np.asarray(ck.sigma, dtype=object).reshape(-1)],
            "cd1": {"u": int(cd1.u), "y": int(cd1.y)},
            "cd2": {"u": int(cd2.u), "y": int(cd2.y)},
        })

    # round 1: all bcm1 in -> broadcast decommit (rounds.rs:64-104)
    def _r1(self, bodies):
        self.bcm1 = bodies
        self._broadcast(2, {"blind": self.blind, "y_i": self.y_pt})

    # round 2: verify; VSS share (rounds.rs:106-176)
    def _r2(self, bodies):
        dev = self.dev
        self.decom = bodies
        bad = []
        peers = sorted(self.bcm1)
        ek_ns = [self.bcm1[j]["ek_n"] for j in peers]
        n_tildes = [self.bcm1[j]["dlog_statement"]["N"] for j in peers]
        h1s = [self.bcm1[j]["dlog_statement"]["g"] for j in peers]
        h2s = [self.bcm1[j]["dlog_statement"]["ni"] for j in peers]
        # hash commitments + bit lengths
        min_b = self.bits - 1
        for j in peers:
            y_int = int(point_hash_ints(dec.points_from_host(self.decom[j]["y_i"], dev)))
            com_ok = int(commit_rows(_obj(y_int), _obj(self.decom[j]["blind"]))) == \
                self.bcm1[j]["com"]
            len_ok = (min_b <= self.bcm1[j]["ek_n"].bit_length() <= self.bits) and (
                min_b <= self.bcm1[j]["dlog_statement"]["N"].bit_length() <= self.bits
            )
            if not (com_ok and len_ok):
                bad.append(j)
        # batched proof verification over the peer axis
        ek_ctx = ModCtx.from_ints(_obj(ek_ns), self.bits, dev)
        ck = CorrectKeyProofBatch(
            sigma=_obj([self.bcm1[j]["correct_key_proof"] for j in peers])
        )
        ck_ok = correct_key_verify(ck, ek_ctx)
        nt_ctx = ModCtx.from_ints(_obj(n_tildes), self.bits, dev)
        stmt1 = CompositeDLogStatementBatch(ctx=nt_ctx, g=_obj(h1s), ni=_obj(h2s))
        stmt2 = CompositeDLogStatementBatch(ctx=nt_ctx, g=_obj(h2s), ni=_obj(h1s))
        cd1 = CompositeDLogProofBatch(
            u=_obj([self.bcm1[j]["cd1"]["u"] for j in peers]),
            y=_obj([self.bcm1[j]["cd1"]["y"] for j in peers]),
        )
        cd2 = CompositeDLogProofBatch(
            u=_obj([self.bcm1[j]["cd2"]["u"] for j in peers]),
            y=_obj([self.bcm1[j]["cd2"]["y"] for j in peers]),
        )
        cd_ok = composite_dlog_verify(cd1, stmt1) & composite_dlog_verify(cd2, stmt2)
        for idx, j in enumerate(peers):
            if not (ck_ok[idx] and cd_ok[idx]):
                bad.append(j)
        if bad:
            raise ProtocolError("invalid key", sorted(set(bad)))

        scheme, shares = feldman.share(self.t, self.party_n, _obj(self.u), self.rng, dev)
        self.own_vss = scheme
        self.own_shares = shares  # [n]
        comm_pts = _pt_host(scheme.commitments)  # [t+1] points
        for j in range(1, self.party_n + 1):
            if j == self.party_i:
                continue
            self._p2p(3, j, {
                "vss_commitments": list(comm_pts),
                "share": int(shares[j - 1]),
            })

    # round 3: validate shares, x_i, dlog proof (rounds.rs:178-248)
    def _r3(self, bodies):
        dev = self.dev
        bad = []
        n = self.party_n
        comm_by_party: dict[int, list] = {}
        share_by_party: dict[int, int] = {}
        for j, b in bodies.items():
            comm_by_party[j] = b["vss_commitments"]
            share_by_party[j] = b["share"]
        comm_by_party[self.party_i] = _pt_host(self.own_vss.commitments)
        share_by_party[self.party_i] = int(self.own_shares[self.party_i - 1])
        # batched validation over the dealer axis
        all_comms = [list(comm_by_party[j]) for j in range(1, n + 1)]
        scheme = feldman.VssSchemeBatch(
            t=self.t, n=n, commitments=dec.points_from_host(all_comms, dev)
        )
        shares = _obj([share_by_party[j] for j in range(1, n + 1)])
        ok = feldman.validate_share(scheme, shares, self.party_i - 1)
        y_by_party = {j: self.decom[j]["y_i"] for j in self.decom}
        y_by_party[self.party_i] = self.y_pt
        for j in range(1, n + 1):
            c0_ok = comm_by_party[j][0] == y_by_party[j]
            if not (ok[j - 1] and c0_ok):
                bad.append(j)
        if bad:
            raise ProtocolError("invalid vss", sorted(set(bad)))
        self.x_i = sum(share_by_party[j] for j in range(1, n + 1)) % Q
        acc = None
        for j in range(1, n + 1):
            acc = y_by_party[j] if acc is None else hec.add(acc, y_by_party[j])
        self.y_sum = acc
        self.vss_all = scheme
        proof = sigma.dlog_prove(_sc(_obj(self.x_i), dev), self.rng)
        self._broadcast(4, {
            "pk": _pt_host(proof.pk),
            "commitment": _pt_host(proof.commitment),
            "z": _limb_int(proof.z),
        })

    # round 4: verify dlog proofs against VSS sums (rounds.rs:250-307)
    def _r4(self, bodies):
        dev = self.dev
        bad = []
        n = self.party_n
        order = sorted(bodies)
        pks = [bodies[j]["pk"] for j in order]
        if order:
            proof = sigma.DLogProof(
                pk=dec.points_from_host(pks, dev),
                commitment=dec.points_from_host([bodies[j]["commitment"] for j in order], dev),
                z=_sc(_obj([bodies[j]["z"] for j in order]), dev),
            )
            ok = sigma.dlog_verify(proof)
        else:
            ok = []
        # xi commitments (public per-party key shares) for every party
        pk_vec = []
        for j in range(1, n + 1):
            cj = feldman.commitment_eval(self.vss_all, j - 1)  # [n_dealer]
            acc = None
            for pt in _pt_host(cj):
                acc = pt if acc is None else hec.add(acc, pt)
            pk_vec.append(acc)
        for idx, j in enumerate(order):
            if not (ok[idx] and pk_vec[j - 1] == pks[idx]):
                bad.append(j)
        if bad:
            raise ProtocolError("bad dlog proof", sorted(set(bad)))
        self.output = {
            "i": self.party_i,
            "t": self.t,
            "n": self.party_n,
            "x_i": self.x_i,
            "y": self.y_sum,
            "pk_vec": pk_vec,
            "paillier_p": self.p_fac,
            "paillier_q": self.q_fac,
            "ek_n_vec": self._ek_vec(),
            "dlog_statements": self._stmt_vec(),
        }

    def _ek_vec(self):
        return [self.n_paillier if j == self.party_i else self.bcm1[j]["ek_n"]
                for j in range(1, self.party_n + 1)]

    def _stmt_vec(self):
        return [{"N": self.n_tilde, "g": self.h1, "ni": self.h2} if j == self.party_i
                else dict(self.bcm1[j]["dlog_statement"])
                for j in range(1, self.party_n + 1)]

    def _proceed(self, completed_round, bodies):
        if completed_round == 0:
            self._r0()
        else:
            [self._r1, self._r2, self._r3, self._r4][completed_round - 1](bodies)


def _limb_int(limbs) -> int:
    return int(batch_from_limbs(limbs))

"""GG20 signing state machines — per-party OfflineStage (6 rounds) and
one-round online SignManual (port of tpu_mpc/runtime/gg20_sign_sm.py;
reference: gg_2020/state_machine/sign.rs).

Message schedule (sign/rounds.rs):
  M1 bcast  com(g_gamma) + MessageA (k ciphertext + per-peer Alice proofs)
  M2 p2p    MessageB(gamma), MessageB(w) [MtAwc]
  M3 bcast  delta_i, T_i + Pedersen proof
  M4 bcast  decommit of g_gamma
  M5 bcast  R_bar_i + per-peer PDLwSlack proofs
  M6 bcast  S_i + HomoElGamal consistency proof
  online    s_i broadcast (SignManual, sign.rs:625-646)

Local party indices are 1..t' within the signer subset; `s_l` holds the
0-based global indices for Lagrange reconstruction.  `device` (default
"cuda") is where the offline stage's gadgets run: its key contexts,
statements, points and scalars are all made there.
"""

from __future__ import annotations

import numpy as np

from ..core.limbs import batch_from_limbs
from ..device import resolve_device
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import commit_rows
from ..host import ec as hec
from ..mta import mta
from ..paillier import paillier as dp
from ..protocols.gg18.batch import _sc
from ..utils.rng import SessionRng
from ..vss import feldman
from ..zk import sigma
from ..zk.pdl_slack import (
    PDLwSlackProofBatch,
    PDLwSlackStatementBatch,
    pdl_slack_prove,
    pdl_slack_verify,
)
from ..zk.range_proofs import (
    AliceProofBatch,
    DlogStatementBatch,
    PaillierCtxBatch,
    alice_prove,
    alice_verify,
)
from .state_machine import ProtocolError, StateMachine

Q = hec.N
ALICE_FIELDS = ("z", "e", "s", "s1", "s2", "u", "w")


def _obj(x):
    return np.asarray(x, dtype=object)


def _flat(a):
    return np.asarray(a, dtype=object).reshape(-1)


def _first(a) -> int:
    return int(_flat(a)[0])


def _pt(P):
    """singleton device point -> host tuple"""
    return dec.points_to_host(P)


def _int(limbs):
    return int(batch_from_limbs(limbs))


def _dlog_to_wire(p: sigma.DLogProof):
    return {"pk": _pt(p.pk), "commitment": _pt(p.commitment), "z": _int(p.z)}


def _dlog_from_wire(d, device=None):
    """A wire DLog proof -> a 1-lane DLogProof on `device`."""
    return sigma.DLogProof(
        pk=dec.points_from_host([d["pk"]], device),
        commitment=dec.points_from_host([d["commitment"]], device),
        z=_sc(_obj([d["z"]]), device),
    )


def _stmt_batch(sts: list, bits: int, device) -> DlogStatementBatch:
    """Stack dlog statement dicts into one [len(sts)] batch."""
    return DlogStatementBatch.from_ints(
        _obj([st["N"] for st in sts]), _obj([st["g"] for st in sts]),
        _obj([st["ni"] for st in sts]), bits, device)


class Gg20OfflineStage(StateMachine):
    # OfflineStageProgress cells (fmt.rs:40-45): R1 bc, R2 p2p (2x MessageB
    # per peer), R3-R6 bc
    ROUND_KINDS = {1: "bc", 2: "p2p", 3: "bc", 4: "bc", 5: "bc", 6: "bc"}

    def __init__(self, local_i: int, s_l: list[int], local_key: dict,
                 rng: SessionRng | None = None, device=None):
        tp = len(s_l)
        super().__init__(local_i, tp, num_rounds=6)
        self.s_l = s_l
        self.key = local_key
        self.rng = rng or SessionRng()
        self.tp = tp
        self.bits = local_key["paillier_p"].bit_length() * 2
        self.dev = resolve_device(device)

    # ---- helpers -----------------------------------------------------------
    def _peer_order(self):
        return [j for j in range(1, self.tp + 1) if j != self.party_i]

    def _stmt_of(self, local_j: int) -> dict:
        return self.key["dlog_statements"][self.s_l[local_j - 1]]

    def _ek_of(self, local_j: int) -> int:
        return self.key["ek_n_vec"][self.s_l[local_j - 1]]

    def _my_stmt(self) -> DlogStatementBatch:
        st = self._stmt_of(self.party_i)
        return DlogStatementBatch.from_ints(_obj(st["N"]), _obj(st["g"]), _obj(st["ni"]),
                                            self.bits, self.dev)

    # ---- round 0: SignKeys + com + MessageA (rounds.rs:67-109) -------------
    def _r0(self):
        rng, dev = self.rng, self.dev
        i0 = self.s_l[self.party_i - 1]
        lam = feldman.lagrange_coeff(i0, self.s_l)
        self.w = lam * self.key["x_i"] % Q
        self.g_w_vec = [
            None if self.key.get("pk_vec") is None else
            hec.mul(feldman.lagrange_coeff(self.s_l[j - 1], self.s_l),
                    self.key["pk_vec"][self.s_l[j - 1]])
            for j in range(1, self.tp + 1)
        ]
        self.k = int(rng.scalars(()))
        self.gamma = int(rng.scalars(()))
        self.g_gamma = hec.mul(self.gamma)
        self.blind = int(rng.bits(256, ()))
        com = int(commit_rows(
            _obj(int.from_bytes(hec.compress(self.g_gamma), "big")), _obj(self.blind)
        ))
        # MessageA: encrypt k under own ek, prove range to each peer's stmt
        my_ek = PaillierCtxBatch.from_ints(_obj(self._ek_of(self.party_i)), self.bits, dev)
        self.my_ek = my_ek
        self.k_rand = int(rng.below(_obj(my_ek.n[()]), ()))
        c_a = _first(mta.paillier_encrypt_ints(my_ek, _obj(self.k), _obj(self.k_rand)))
        self.c_a = c_a
        proofs = {}
        # all per-peer proofs in ONE launch: the peer statements stack into
        # a [tp-1] batch (each peer still gets its own fresh proof nonces)
        peers = self._peer_order()
        if peers:
            stmt = _stmt_batch([self._stmt_of(j) for j in peers], self.bits, dev)
            pr = alice_prove(_obj(self.k), _obj(c_a), my_ek, stmt, _obj(self.k_rand), rng)
            for idx, j in enumerate(peers):
                proofs[str(j)] = {k: int(_flat(getattr(pr, k))[idx]) for k in ALICE_FIELDS}
        self._broadcast(1, {"com": com, "c_a": c_a, "alice_proofs": proofs})
        self.com = com

    # ---- round 1: MessageB per peer (rounds.rs:121-218) --------------------
    def _r1(self, bodies):
        rng, dev = self.rng, self.dev
        self.m1 = bodies
        self.beta = {}
        self.ni = {}
        my_stmt = self._my_stmt()
        for j in self._peer_order():
            b = bodies[j]
            ek_j = PaillierCtxBatch.from_ints(_obj(self._ek_of(j)), self.bits, dev)
            pr = b["alice_proofs"][str(self.party_i)]
            proof = AliceProofBatch(**{k: _obj(pr[k]) for k in ALICE_FIELDS})
            if not bool(_flat(alice_verify(proof, _obj(b["c_a"]), ek_j, my_stmt))[0]):
                raise ProtocolError("invalid Alice range proof", [j])
            out = {}
            for name, secret in (("gamma", self.gamma), ("w", self.w)):
                msg, beta, _, _, _ = mta.message_b(
                    _obj(secret), ek_j, _obj(b["c_a"]), None, None, rng
                )
                (self.beta if name == "gamma" else self.ni)[j] = _first(beta)
                out["mb_" + name] = {
                    "c": _first(msg.c),
                    "b_proof": _dlog_to_wire(msg.b_proof),
                    "beta_tag_proof": _dlog_to_wire(msg.beta_tag_proof),
                }
            self._p2p(2, j, out)

    # ---- round 2: alphas, delta/sigma/T (rounds.rs:233-326) ----------------
    def _r2(self, bodies):
        rng, dev = self.rng, self.dev
        self.m2 = bodies
        dk = dp.BatchDecryptionKey.from_ints(
            _obj(self.key["paillier_p"]), _obj(self.key["paillier_q"]), self.bits, dev
        )
        alpha_sum, miu_sum = 0, 0
        self.mb_gamma_proofs = {}
        for j in self._peer_order():
            b = bodies[j]
            for name in ("gamma", "w"):
                mb = b["mb_" + name]
                msg = mta.MessageBBatch(
                    c=_obj(mb["c"]),
                    b_proof=_dlog_from_wire(mb["b_proof"], device=dev),
                    beta_tag_proof=_dlog_from_wire(mb["beta_tag_proof"], device=dev),
                )
                alpha, _, ok = mta.verify_proofs_get_alpha(dk, msg, _obj(self.k), ())
                if not bool(np.asarray(ok).reshape(-1)[0]):
                    raise ProtocolError(f"invalid MessageB ({name})", [j])
                if name == "gamma":
                    self.mb_gamma_proofs[j] = mb["b_proof"]
                    alpha_sum += _first(alpha)
                else:
                    # MtAwc: check bob's value against g_w_j
                    if self.g_w_vec[j - 1] is not None:
                        if mb["b_proof"]["pk"] != self.g_w_vec[j - 1]:
                            raise ProtocolError("MtAwc g_w mismatch", [j])
                    miu_sum += _first(alpha)
        self.delta_i = (self.k * self.gamma + alpha_sum + sum(self.beta.values())) % Q
        self.sigma_i = (self.k * self.w + miu_sum + sum(self.ni.values())) % Q
        self.l = int(rng.scalars(()))
        ped = sigma.pedersen_prove(_sc(_obj(self.sigma_i), dev), _sc(_obj(self.l), dev), rng)
        self.T_pt = _pt(ped.T)
        self._broadcast(3, {
            "delta_i": self.delta_i,
            "T": self.T_pt,
            "ped": {"T": self.T_pt, "A": _pt(ped.A), "z1": _int(ped.z1), "z2": _int(ped.z2)},
        })

    # ---- round 3: pedersen verify + delta; decommit gamma (rounds.rs:346-411)
    def _r3(self, bodies):
        dev = self.dev
        self.m3 = bodies
        for j in self._peer_order():
            p = bodies[j]["ped"]
            proof = sigma.PedersenProof(
                T=dec.points_from_host(p["T"], dev),
                A=dec.points_from_host(p["A"], dev),
                z1=_sc(_obj(p["z1"]), dev),
                z2=_sc(_obj(p["z2"]), dev),
            )
            if not bool(np.asarray(sigma.pedersen_verify(proof)).reshape(-1)[0]):
                raise ProtocolError("invalid Pedersen proof", [j])
        delta = self.delta_i + sum(bodies[j]["delta_i"] for j in self._peer_order())
        self.delta_inv = pow(delta % Q, -1, Q)
        self._broadcast(4, {"blind": self.blind, "g_gamma": self.g_gamma})

    # ---- round 4: check decommits, R, R_bar + PDL (rounds.rs:430-507) ------
    def _r4(self, bodies):
        dev = self.dev
        bad = []
        g_gamma_sum = self.g_gamma
        for j in self._peer_order():
            b = bodies[j]
            com_ok = int(commit_rows(
                _obj(int.from_bytes(hec.compress(b["g_gamma"]), "big")), _obj(b["blind"])
            )) == self.m1[j]["com"]
            pk_ok = self.mb_gamma_proofs[j]["pk"] == b["g_gamma"]
            if not (com_ok and pk_ok):
                bad.append(j)
            g_gamma_sum = hec.add(g_gamma_sum, b["g_gamma"])
        if bad:
            raise ProtocolError("bad gamma_i decommit", sorted(bad))
        self.R = hec.mul(self.delta_inv, g_gamma_sum)
        self.r_x = self.R[0] % Q
        self.R_bar = hec.mul(self.k, self.R)
        proofs = {}
        peers = self._peer_order()
        if peers:
            # one launch for all peers: stack the peer dlog statements
            stmt = PDLwSlackStatementBatch(
                ciphertext=_obj(self.c_a),
                ek=self.my_ek,
                Q_pt=dec.points_from_host([self.R_bar] * len(peers), dev),
                G_pt=dec.points_from_host([self.R] * len(peers), dev),
                dlog=_stmt_batch([self._stmt_of(j) for j in peers], self.bits, dev),
            )
            pr = pdl_slack_prove(_obj(self.k), _obj(self.k_rand), stmt, self.rng)
            for idx, j in enumerate(peers):
                proofs[str(j)] = {
                    "z": int(_flat(pr.z)[idx]),
                    "u1": (int(_flat(pr.u1_x)[idx]), int(_flat(pr.u1_y)[idx])),
                    "u2": int(_flat(pr.u2)[idx]), "u3": int(_flat(pr.u3)[idx]),
                    "s1": int(_flat(pr.s1)[idx]), "s2": int(_flat(pr.s2)[idx]),
                    "s3": int(_flat(pr.s3)[idx]),
                }
        self._broadcast(5, {"R_bar": self.R_bar, "pdl": proofs})

    # ---- round 5: verify PDL, R_bar sum, S_i (rounds.rs:524-601) -----------
    def _r5(self, bodies):
        dev = self.dev
        self.m5 = bodies
        my_stmt = self._my_stmt()
        rbar_sum = self.R_bar
        for j in self._peer_order():
            b = bodies[j]
            pr = b["pdl"][str(self.party_i)]
            stmt = PDLwSlackStatementBatch(
                ciphertext=_obj(self.m1[j]["c_a"]),
                ek=PaillierCtxBatch.from_ints(_obj(self._ek_of(j)), self.bits, dev),
                Q_pt=dec.points_from_host(b["R_bar"], dev),
                G_pt=dec.points_from_host(self.R, dev),
                dlog=my_stmt,
            )
            proof = PDLwSlackProofBatch(
                z=_obj(pr["z"]), u1_x=_obj(pr["u1"][0]), u1_y=_obj(pr["u1"][1]),
                u2=_obj(pr["u2"]), u3=_obj(pr["u3"]),
                s1=_obj(pr["s1"]), s2=_obj(pr["s2"]), s3=_obj(pr["s3"]),
            )
            if not bool(np.asarray(pdl_slack_verify(proof, stmt)).reshape(-1)[0]):
                raise ProtocolError("Bad PDLwSlack proof", [j])
            rbar_sum = hec.add(rbar_sum, b["R_bar"])
        if rbar_sum != hec.G:
            raise ProtocolError("phase5 R_dash sum", list(range(1, self.tp + 1)))
        S_pt = hec.mul(self.sigma_i, self.R)
        self.S_pt = S_pt
        heg = sigma.homo_elgamal_prove(
            _sc(_obj(self.l), dev), _sc(_obj(self.sigma_i), dev),
            dec.points_from_host(self.R, dev), dec.base_point2((), dev), dec.generator((), dev),
            dec.points_from_host(self.T_pt, dev), dec.points_from_host(S_pt, dev), self.rng,
        )
        self._broadcast(6, {
            "S": S_pt,
            "heg": {"T1": _pt(heg.T1), "T2": _pt(heg.T2),
                    "z1": _int(heg.z1), "z2": _int(heg.z2)},
        })

    # ---- round 6: verify HEG + S sum (rounds.rs:611-645) -------------------
    def _r6(self, bodies):
        dev = self.dev
        s_sum = self.S_pt
        for j in self._peer_order():
            b = bodies[j]
            h = b["heg"]
            proof = sigma.HomoElGamalProof(
                T1=dec.points_from_host(h["T1"], dev), T2=dec.points_from_host(h["T2"], dev),
                z1=_sc(_obj(h["z1"]), dev), z2=_sc(_obj(h["z2"]), dev),
            )
            ok = sigma.homo_elgamal_verify(
                proof,
                dec.points_from_host(self.R, dev), dec.base_point2((), dev),
                dec.generator((), dev),
                dec.points_from_host(self.m3[j]["T"], dev), dec.points_from_host(b["S"], dev),
            )
            if not bool(np.asarray(ok).reshape(-1)[0]):
                raise ProtocolError("phase6", [j])
            s_sum = hec.add(s_sum, b["S"])
        if s_sum != self.key["y"]:
            raise ProtocolError("phase6 S sum", list(range(1, self.tp + 1)))
        self.output = {
            "R": self.R,
            "r": self.r_x,
            "k": self.k,
            "sigma_i": self.sigma_i,
            "y": self.key["y"],
            "i": self.party_i,
        }

    def _proceed(self, completed_round, bodies):
        [self._r0, self._r1, self._r2, self._r3, self._r4, self._r5, self._r6][
            completed_round
        ](*(() if completed_round == 0 else (bodies,)))


def sign_manual(offline_output: dict, m_int: int, partial_sigs: list[int]) -> dict:
    """SignManual::complete (sign.rs:625-646): combine partial sigs."""
    q = Q
    s = sum(partial_sigs, partial_sig_local(offline_output, m_int)) % q
    r = offline_output["r"]
    ry = offline_output["R"][1] % q
    recid = ry & 1
    if s > q - s:
        s = q - s
        recid ^= 1
    valid = hec.ecdsa_verify(offline_output["y"], m_int % q, r, s)
    return {"r": r, "s": s, "recid": recid, "valid": valid}


def partial_sig_local(offline_output: dict, m_int: int) -> int:
    """SignManual::new -> phase7_local_sig (party_i.rs:850-871)."""
    return (m_int % Q * offline_output["k"] + offline_output["r"] * offline_output["sigma_i"]) % Q


def scrub_offline(offline_output: dict) -> None:
    """Zeroize the one-time offline secrets (k_i, sigma_i) after the online
    round completes — the zeroize-on-drop analog of the reference's
    CompletedOfflineStage (sign.rs:647-655; zeroize usage
    range_proofs.rs:26-27).  Call only after a successful signature: an
    aborted session needs the state for blame."""
    from ..utils.ct import scrub_array

    for key in ("k", "sigma_i"):
        if key in offline_output:
            scrub_array(offline_output.get(key))
            offline_output[key] = 0

"""GG18 sign client — hand-rolled rounds 0-9 over the polled KV relay
(port of tpu_mpc/runtime/gg18_sign_client.py).

Behavioral equivalent of the reference's examples/gg18_sign_client.rs:29-505:
  round0  signer-id collection (each client broadcasts its keygen index)
  round1  com(g_gamma_i) + MessageA(k_i)          [MtA without range proofs,
          the reference test path: dlog_statements = &[]]
  round2  P2P 2x MessageB per peer (gamma and w); decrypt alpha/mu; MtAwc
          check against W_j from the VSS commitments (update_commitments_to_xi)
  round3  delta_i broadcast -> delta^{-1}
  round4  decommit gamma -> R, r
  round5-8  GG18 phases 5A-5D commit/decommit consistency dance
          (gg_2018/party_i.rs:513-673)
  round9  s_i broadcast -> (r, s) + low-s normalization + self-verify
The device gadgets run on `device` (default "cuda").
"""

from __future__ import annotations

import hashlib
import json

import numpy as np

from ..device import resolve_device
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import commit_rows, digest_rows, point_hash_ints
from ..host import ec as hec
from ..mta import mta
from ..paillier import paillier as dp
from ..protocols.gg18.batch import _sc
from ..utils.rng import SessionRng
from ..vss import feldman
from ..zk import sigma
from ..zk.range_proofs import PaillierCtxBatch
from .gg18_common import KvClient, broadcast, poll_for_broadcasts, poll_for_p2p, sendp2p
from .gg20_keygen_sm import _limb_int
from .gg20_sign_sm import _dlog_from_wire, _dlog_to_wire

Q = hec.N


def _obj(x):
    return np.asarray(x, dtype=object)


def _pt_hash(host_pt, device) -> int:
    return int(point_hash_ints(dec.points_from_host(host_pt, device)))


def sign_run(address: str, key: dict, m_int: int,
             rng: SessionRng | None = None, delay: float = 0.05, device=None) -> dict:
    rng = rng or SessionRng()
    dev = resolve_device(device)
    pt_hash = lambda pt: _pt_hash(pt, dev)
    from_host = lambda pts: dec.points_from_host(pts, dev)
    sc = lambda x: _sc(_obj(x), dev)
    client = KvClient(address)
    n, t = key["n"], key["t"]
    tp = t + 1
    bits = key["paillier_p"].bit_length() * 2
    party_num, uuid = client.signup_sign()

    # round 0: signer id collection (gg18_sign_client.rs:70-97)
    broadcast(client, party_num, "round0", {"party_id": key["party_num"]}, uuid)
    bm0 = poll_for_broadcasts(client, party_num, tp, "round0", uuid, delay)
    signers = {party_num: key["party_num"], **{j: b["party_id"] for j, b in bm0.items()}}
    s_l = [signers[j] - 1 for j in range(1, tp + 1)]  # 0-based keygen indices
    peers = [j for j in range(1, tp + 1) if j != party_num]

    # SignKeys::create (party_i.rs:384-406)
    own0 = key["party_num"] - 1
    w = feldman.lagrange_coeff(own0, s_l) * key["x_i"] % Q
    # W_j from VSS commitments: update_commitments_to_xi (party_i.rs:339-357)
    all_scheme = feldman.VssSchemeBatch(
        t=t, n=n, commitments=from_host(key["vss_vec"])
    )
    g_w = {}
    for j in range(1, tp + 1):
        g0 = signers[j] - 1
        cj = dec.points_to_host(feldman.commitment_eval(all_scheme, g0))
        xi = None
        for pt in cj:
            xi = pt if xi is None else hec.add(xi, pt)
        g_w[j] = hec.mul(feldman.lagrange_coeff(g0, s_l), xi)

    k = int(rng.scalars(()))
    gamma = int(rng.scalars(()))
    g_gamma = hec.mul(gamma)

    # round 1: com(g_gamma) + MessageA (gg18_sign_client.rs:110-148)
    blind1 = int(rng.bits(256, ()))
    com1 = int(commit_rows(_obj(pt_hash(g_gamma)), _obj(blind1)))
    my_ek = PaillierCtxBatch.from_ints(_obj(key["ek_n_vec"][own0]), bits, dev)
    k_rand = int(rng.below(_obj(my_ek.n[()]), ()))
    c_a = int(np.asarray(mta.paillier_encrypt_ints(my_ek, _obj(k), _obj(k_rand))).reshape(-1)[0])
    broadcast(client, party_num, "round1", {"com": com1, "c_a": c_a}, uuid)
    bm1 = poll_for_broadcasts(client, party_num, tp, "round1", uuid, delay)

    # round 2: MessageB(gamma), MessageB(w) per peer (gg18_sign_client.rs:151-216)
    beta, ni = {}, {}
    for j in peers:
        ek_j = PaillierCtxBatch.from_ints(_obj(key["ek_n_vec"][signers[j] - 1]), bits, dev)
        out = {}
        for name, secret in (("gamma", gamma), ("w", w)):
            msg, b_share, _, _, _ = mta.message_b(
                _obj(secret), ek_j, _obj(bm1[j]["c_a"]), None, None, rng
            )
            (beta if name == "gamma" else ni)[j] = int(np.asarray(b_share).reshape(-1)[0])
            out["mb_" + name] = {
                "c": int(np.asarray(msg.c).reshape(-1)[0]),
                "b_proof": _dlog_to_wire(msg.b_proof),
                "beta_tag_proof": _dlog_to_wire(msg.beta_tag_proof),
            }
        sendp2p(client, party_num, j, "round2", out, uuid)
    pm2 = poll_for_p2p(client, party_num, tp, "round2", uuid, delay)

    dk = dp.BatchDecryptionKey.from_ints(
        _obj(key["paillier_p"]), _obj(key["paillier_q"]), bits, dev
    )
    alpha_sum, miu_sum = 0, 0
    mb_gamma_pk = {}
    for j in peers:
        for name in ("gamma", "w"):
            mb = pm2[j]["mb_" + name]
            msg = mta.MessageBBatch(
                c=_obj(mb["c"]),
                b_proof=_dlog_from_wire(mb["b_proof"], device=dev),
                beta_tag_proof=_dlog_from_wire(mb["beta_tag_proof"], device=dev),
            )
            alpha, _, ok = mta.verify_proofs_get_alpha(dk, msg, _obj(k), ())
            if not bool(np.asarray(ok).reshape(-1)[0]):
                raise RuntimeError(f"invalid MessageB ({name}) from sign party {j}")
            if name == "gamma":
                mb_gamma_pk[j] = mb["b_proof"]["pk"]
                alpha_sum += int(np.asarray(alpha).reshape(-1)[0])
            else:
                # MtAwc: Bob's w must match the public W_j (party_i.rs:204-209)
                if mb["b_proof"]["pk"] != g_w[j]:
                    raise RuntimeError(f"MtAwc W mismatch from sign party {j}")
                miu_sum += int(np.asarray(alpha).reshape(-1)[0])
    delta_i = (k * gamma + alpha_sum + sum(beta.values())) % Q
    sigma_i = (k * w + miu_sum + sum(ni.values())) % Q

    # round 3: delta broadcast (gg18_sign_client.rs:246-272)
    broadcast(client, party_num, "round3", {"delta_i": delta_i}, uuid)
    bm3 = poll_for_broadcasts(client, party_num, tp, "round3", uuid, delay)
    delta_inv = pow((delta_i + sum(bm3[j]["delta_i"] for j in peers)) % Q, -1, Q)

    # round 4: decommit gamma -> R (gg18_sign_client.rs:276-309)
    broadcast(client, party_num, "round4", {"blind": blind1, "g_gamma": g_gamma}, uuid)
    bm4 = poll_for_broadcasts(client, party_num, tp, "round4", uuid, delay)
    g_gamma_sum = g_gamma
    for j in peers:
        b = bm4[j]
        if int(commit_rows(_obj(pt_hash(b["g_gamma"])), _obj(b["blind"]))) != bm1[j]["com"]:
            raise RuntimeError(f"bad gamma decommit from sign party {j}")
        if mb_gamma_pk[j] != b["g_gamma"]:
            raise RuntimeError(f"MessageB gamma pk mismatch from sign party {j}")
        g_gamma_sum = hec.add(g_gamma_sum, b["g_gamma"])
    R = hec.mul(delta_inv, g_gamma_sum)
    r_x = R[0] % Q

    # phase 5 local sig (party_i.rs:487-511)
    m = m_int % Q
    s_i = (m * k + r_x * sigma_i) % Q

    # round 5 (5A com): V, A, B + HEG + dlog(rho) (party_i.rs:513-559)
    l_i = int(rng.scalars(()))
    rho = int(rng.scalars(()))
    V = hec.add(hec.mul(s_i, R), hec.mul(l_i))
    A = hec.mul(rho)
    B = hec.mul(l_i * rho % Q)
    blind5a = int(rng.bits(256, ()))
    ih5a = int(digest_rows(_obj(pt_hash(V)), _obj(pt_hash(A)), _obj(pt_hash(B))))
    com5a = int(commit_rows(_obj(ih5a), _obj(blind5a)))
    broadcast(client, party_num, "round5", {"com": com5a}, uuid)
    bm5 = poll_for_broadcasts(client, party_num, tp, "round5", uuid, delay)

    # round 6 (5B decom): decommit + proofs
    heg = sigma.homo_elgamal_prove(
        sc(s_i), sc(l_i),
        from_host(A), from_host(R), dec.generator((), dev),
        from_host(V), from_host(B), rng,
    )
    dlog_rho = sigma.dlog_prove(sc(rho), rng)
    broadcast(client, party_num, "round6", {
        "V": V, "A": A, "B": B, "blind": blind5a,
        "heg": {"T1": dec.points_to_host(heg.T1), "T2": dec.points_to_host(heg.T2),
                "z1": _limb_int(heg.z1), "z2": _limb_int(heg.z2)},
        "dlog_rho": _dlog_to_wire(dlog_rho),
    }, uuid)
    bm6 = poll_for_broadcasts(client, party_num, tp, "round6", uuid, delay)
    v_sum, a_sum = V, A
    for j in peers:
        b = bm6[j]
        ih = int(digest_rows(_obj(pt_hash(b["V"])), _obj(pt_hash(b["A"])), _obj(pt_hash(b["B"]))))
        if int(commit_rows(_obj(ih), _obj(b["blind"]))) != bm5[j]["com"]:
            raise RuntimeError(f"bad 5A decommit from sign party {j}")
        h = b["heg"]
        proof = sigma.HomoElGamalProof(
            T1=from_host(h["T1"]), T2=from_host(h["T2"]),
            z1=sc(h["z1"]), z2=sc(h["z2"]),
        )
        heg_ok = sigma.homo_elgamal_verify(
            proof,
            from_host(b["A"]), from_host(R), dec.generator((), dev),
            from_host(b["V"]), from_host(b["B"]),
        )
        rho_ok = sigma.dlog_verify(_dlog_from_wire(b["dlog_rho"], device=dev))
        if not (bool(np.asarray(heg_ok).reshape(-1)[0])
                and bool(np.asarray(rho_ok).reshape(-1)[0])
                and b["dlog_rho"]["pk"] == b["A"]):
            raise RuntimeError(f"bad phase5 proofs from sign party {j}")
        v_sum = hec.add(v_sum, b["V"])
        a_sum = hec.add(a_sum, b["A"])

    # 5C: u_i = rho * (V_sum - mG - r y); t_i = l * (A_sum - A_own)
    # (party_i.rs:561-636: v includes own V, a excludes own A)
    v = hec.add(v_sum, hec.neg(hec.add(hec.mul(m), hec.mul(r_x, key["y"]))))
    u_pt = hec.mul(rho, v)
    a_minus_own = hec.add(a_sum, hec.neg(A))
    t_pt = hec.mul(l_i, a_minus_own)
    blind5c = int(rng.bits(256, ()))
    ih5c = int(digest_rows(_obj(pt_hash(u_pt)), _obj(pt_hash(t_pt))))
    com5c = int(commit_rows(_obj(ih5c), _obj(blind5c)))
    broadcast(client, party_num, "round7", {"com": com5c}, uuid)
    bm7 = poll_for_broadcasts(client, party_num, tp, "round7", uuid, delay)

    # round 8 (5D decom): sum check (party_i.rs:638-673)
    broadcast(client, party_num, "round8",
              {"u": u_pt, "t": t_pt, "blind": blind5c}, uuid)
    bm8 = poll_for_broadcasts(client, party_num, tp, "round8", uuid, delay)
    tb_sum = hec.add(t_pt, B)
    u_sum = u_pt
    for j in peers:
        b = bm8[j]
        ih = int(digest_rows(_obj(pt_hash(b["u"])), _obj(pt_hash(b["t"]))))
        if int(commit_rows(_obj(ih), _obj(b["blind"]))) != bm7[j]["com"]:
            raise RuntimeError(f"bad 5C decommit from sign party {j}")
        tb_sum = hec.add(tb_sum, hec.add(b["t"], bm6[j]["B"]))
        u_sum = hec.add(u_sum, b["u"])
    if tb_sum != u_sum:
        raise RuntimeError("phase5 sum check failed (Phase5BadSum)")

    # round 9: s_i broadcast -> signature (party_i.rs:674-711)
    broadcast(client, party_num, "round9", {"s_i": s_i}, uuid)
    bm9 = poll_for_broadcasts(client, party_num, tp, "round9", uuid, delay)
    s = (s_i + sum(bm9[j]["s_i"] for j in peers)) % Q
    recid = (R[1] % Q) & 1
    if s > Q - s:
        s = Q - s
        recid ^= 1
    valid = hec.ecdsa_verify(key["y"], m, r_x, s)
    if not valid:
        raise RuntimeError("invalid signature (InvalidSig)")
    return {"r": r_x, "s": s, "recid": recid, "valid": valid}


def main(argv=None) -> None:
    import argparse
    import sys

    from .cli import load_local_key, report_device

    ap = argparse.ArgumentParser(description="tpu-mpc gg18 sign client")
    ap.add_argument("--address", default="http://127.0.0.1:8001")
    ap.add_argument("--local-share", required=True, help="keys store from keygen")
    ap.add_argument("--data-to-sign", required=True)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"tpu-mpc: {e}")
    key = load_local_key(args.local_share)
    digest = int.from_bytes(hashlib.sha256(args.data_to_sign.encode()).digest(), "big")
    sig = sign_run(args.address, key, digest, device=device)
    print(json.dumps({"r": format(sig["r"], "x"), "s": format(sig["s"], "x"),
                      "recid": sig["recid"], "valid": sig["valid"]}), flush=True)
    report_device(device)


if __name__ == "__main__":
    main()

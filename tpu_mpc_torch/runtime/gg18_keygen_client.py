"""GG18 keygen client — hand-rolled rounds 1-5 over the polled KV relay
(port of tpu_mpc/runtime/gg18_keygen_client.py).

Behavioral equivalent of the reference's examples/gg18_keygen_client.rs:56-263:
  round1  broadcast com(y_i) + Paillier ek + NiCorrectKeyProof
  round2  broadcast decommit (blind, y_i); verify coms + proofs; derive
          pairwise ECDH AES keys  (gg18_keygen_client.rs:114-123)
  round3  P2P AES-GCM-encrypted Feldman VSS shares
  round4  broadcast VSS commitment vectors; validate shares; x_i = sum
  round5  broadcast DLogProof(x_i); verify all
Output: a keys-store dict (the reference serializes the tuple to keys.store,
gg18_keygen_client.rs:254-263).

Crypto runs on the same batched device gadgets as protocols/gg18/batch.py,
with the peer axis as the batch dimension, on `device` (default "cuda").
"""

from __future__ import annotations

import json

import numpy as np

from ..core.modctx import ModCtx
from ..device import resolve_device
from ..ec import secp256k1 as dec
from ..hashes.fiat_shamir import commit_rows, point_hash_ints
from ..host import ec as hec
from ..protocols.gg18.batch import _sc, gen_paillier_batch
from ..utils.rng import SessionRng
from ..vss import feldman
from ..zk import sigma
from ..zk.paillier_zk import CorrectKeyProofBatch, correct_key_prove, correct_key_verify
from .gg18_common import (
    KvClient,
    aes_decrypt,
    aes_encrypt,
    broadcast,
    ecdh_aes_key,
    poll_for_broadcasts,
    poll_for_p2p,
    sendp2p,
)
from .gg20_keygen_sm import _limb_int

Q = hec.N


def _obj(x):
    return np.asarray(x, dtype=object)


def keygen_run(address: str, parties: int, threshold: int,
               rng: SessionRng | None = None, paillier_bits: int = 2048,
               delay: float = 0.05, device=None) -> dict:
    rng = rng or SessionRng()
    dev = resolve_device(device)
    n, t = parties, threshold
    client = KvClient(address)
    party_num, uuid = client.signup_keygen()

    # Keys::create (gg_2018/party_i.rs:148-160)
    u = int(rng.scalars(()))
    y_pt = hec.mul(u)
    p_f, q_f = gen_paillier_batch(1, 1, paillier_bits, rng)
    p_fac, q_fac = int(p_f[0, 0]), int(q_f[0, 0])
    ek_n = p_fac * q_fac

    # round 1: com + ek + correct-key proof (gg18_keygen_client.rs:56-97)
    blind = int(rng.bits(256, ()))
    y_int = int(point_hash_ints(dec.points_from_host(y_pt, dev)))
    com = int(commit_rows(_obj(y_int), _obj(blind)))
    ek_ctx = ModCtx.from_ints(ek_n, paillier_bits, dev)
    ck = correct_key_prove(ek_ctx, _obj((p_fac - 1) * (q_fac - 1)))
    broadcast(client, party_num, "round1", {
        "com": com, "ek_n": ek_n,
        "correct_key_proof": [int(s) for s in ck.sigma.reshape(-1)],
    }, uuid)
    bm1 = poll_for_broadcasts(client, party_num, n, "round1", uuid, delay)

    # round 2: decommit (gg18_keygen_client.rs:99-133)
    broadcast(client, party_num, "round2", {"blind": blind, "y_i": y_pt}, uuid)
    decom = poll_for_broadcasts(client, party_num, n, "round2", uuid, delay)

    peers = sorted(bm1)
    bad = []
    for j in peers:
        yj = int(point_hash_ints(dec.points_from_host(decom[j]["y_i"], dev)))
        if int(commit_rows(_obj(yj), _obj(decom[j]["blind"]))) != bm1[j]["com"]:
            bad.append(j)
    ck_batch = CorrectKeyProofBatch(sigma=_obj([bm1[j]["correct_key_proof"] for j in peers]))
    ck_ok = correct_key_verify(
        ck_batch, ModCtx.from_ints(_obj([bm1[j]["ek_n"] for j in peers]), paillier_bits, dev)
    )
    bad += [j for idx, j in enumerate(peers) if not ck_ok[idx]]
    if bad:
        raise RuntimeError(f"invalid key proof from parties {sorted(set(bad))}")

    aes_keys = {j: ecdh_aes_key(u, decom[j]["y_i"]) for j in peers}

    # round 3: AES-GCM-encrypted VSS shares, P2P (gg18_keygen_client.rs:135-175)
    scheme, shares = feldman.share(t, n, _obj(u), rng, dev)
    for j in peers:
        env = aes_encrypt(aes_keys[j], int(shares[j - 1]).to_bytes(32, "big"))
        sendp2p(client, party_num, j, "round3", env, uuid)
    enc_shares = poll_for_p2p(client, party_num, n, "round3", uuid, delay)
    share_by_party = {party_num: int(shares[party_num - 1])}
    for j in peers:
        share_by_party[j] = int.from_bytes(aes_decrypt(aes_keys[j], enc_shares[j]), "big")

    # round 4: VSS commitment vectors (gg18_keygen_client.rs:177-219)
    own_comms = dec.points_to_host(scheme.commitments)
    broadcast(client, party_num, "round4", {"vss_commitments": list(own_comms)}, uuid)
    bm4 = poll_for_broadcasts(client, party_num, n, "round4", uuid, delay)
    comm_by_party = {j: bm4[j]["vss_commitments"] for j in peers}
    comm_by_party[party_num] = list(own_comms)
    y_by_party = {j: decom[j]["y_i"] for j in peers}
    y_by_party[party_num] = y_pt

    all_scheme = feldman.VssSchemeBatch(
        t=t, n=n,
        commitments=dec.points_from_host([comm_by_party[j] for j in range(1, n + 1)], dev),
    )
    ok = feldman.validate_share(
        all_scheme, _obj([share_by_party[j] for j in range(1, n + 1)]), party_num - 1
    )
    bad = [j for j in range(1, n + 1)
           if not (ok[j - 1] and comm_by_party[j][0] == y_by_party[j])]
    if bad:
        raise RuntimeError(f"invalid vss from parties {bad}")
    x_i = sum(share_by_party.values()) % Q
    y_sum = None
    for j in range(1, n + 1):
        y_sum = y_by_party[j] if y_sum is None else hec.add(y_sum, y_by_party[j])

    # round 5: dlog proofs of x_i (gg18_keygen_client.rs:221-252)
    proof = sigma.dlog_prove(_sc(_obj(x_i), dev), rng)
    broadcast(client, party_num, "round5", {
        "pk": dec.points_to_host(proof.pk),
        "commitment": dec.points_to_host(proof.commitment),
        "z": _limb_int(proof.z),
    }, uuid)
    bm5 = poll_for_broadcasts(client, party_num, n, "round5", uuid, delay)
    order = sorted(bm5)
    batch = sigma.DLogProof(
        pk=dec.points_from_host([bm5[j]["pk"] for j in order], dev),
        commitment=dec.points_from_host([bm5[j]["commitment"] for j in order], dev),
        z=_sc(_obj([bm5[j]["z"] for j in order]), dev),
    )
    dl_ok = sigma.dlog_verify(batch)
    bad = [j for idx, j in enumerate(order) if not dl_ok[idx]]
    if bad:
        raise RuntimeError(f"bad dlog proof from parties {bad}")

    return {
        "party_num": party_num,
        "t": t, "n": n,
        "u_i": u, "x_i": x_i,
        "paillier_p": p_fac, "paillier_q": q_fac,
        "y": y_sum,
        "y_vec": [y_by_party[j] for j in range(1, n + 1)],
        "vss_vec": [comm_by_party[j] for j in range(1, n + 1)],
        "ek_n_vec": [ek_n if j == party_num else bm1[j]["ek_n"] for j in range(1, n + 1)],
    }


def main(argv=None) -> None:
    import argparse
    import sys

    from .cli import report_device, save_local_key

    ap = argparse.ArgumentParser(description="tpu-mpc gg18 keygen client")
    ap.add_argument("--address", default="http://127.0.0.1:8001")
    ap.add_argument("--params", default="params.json")
    ap.add_argument("--output", required=True, help="keys store output path")
    ap.add_argument("--paillier-bits", type=int, default=2048)
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"tpu-mpc: {e}")
    with open(args.params) as f:
        p = json.load(f)
    key = keygen_run(args.address, int(p["parties"]), int(p["threshold"]),
                     paillier_bits=args.paillier_bits, device=device)
    save_local_key(args.output, key)
    print(f"party {key['party_num']}: keys saved to {args.output}", flush=True)
    report_device(device)


if __name__ == "__main__":
    main()

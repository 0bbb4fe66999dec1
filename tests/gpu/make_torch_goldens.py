#!/usr/bin/env python3
"""Write the reference package's GG20 slice and blame, GG18, Lindell'17,
PDL and runtime outputs, and its kernels' outputs on the kernel tests'
inputs, as golden files for the port's CPU tests
(tests/gpu/test_torch_gg20.py, test_torch_blame.py, test_torch_gg18.py,
test_torch_lindell17.py, test_torch_pdl.py, test_torch_runtime.py,
test_torch_ec.py, test_torch_rns.py, test_torch_fixed.py,
test_torch_quorum.py).

    JAX_PLATFORMS=cpu TPU_MPC_PALLAS=0 python tests/gpu/make_torch_goldens.py [name ...]

(from the repository root; names: gg20_blame_768, gg18_768, lindell17_1024,
pdl_576, gg20_slice_768, gg20_ref_exact_768, runtime_768, gg20_quorum_768,
kernels_ec, kernels_rns, kernels_fixed, default all; on an 8-core CPU
machine 299 s wall for the first two, 100 s for lindell17_1024, 29 s for
pdl_576, 139 s for gg20_slice_768 and 2883 s for gg20_quorum_768, most of
it JAX compilation and the reference's keygen).
pytest does not collect this file.  The tests run only the port against
what it writes, so that no tier-1 test pays for the reference's
offline_stage, sign or keygen.  The Lindell'17 and PDL files are written
with the randomizer tables off (TPU_MPC_ENC_TABLES=0; their keys have no
tables either way).

tests/gpu/fixtures/gg20_slice_768.json: session 0 of
tests/fixtures/gg20key_20_2_1_3_768.json tiled to S = 2, signers [0, 1],
offline_stage from SessionRng(0x5169) and sign_online of
m = sha256(b"gg20 message"), with the cross-session batch verification
forced (TPU_MPC_BATCH_VERIFY=1), in two configurations: "uniform"
(TPU_MPC_ENC_TABLES=0) and "tables" (TPU_MPC_ENC_TABLES=1), the randomizer
tables built on the key in both.  Per configuration: r, s, recid,
sig_valid and the offline transcript's r_x, k, sigma_i, delta_i, msg_a_c,
alpha, beta_g, miu; in "tables" also the resolved k and beta randomizers.

tests/gpu/fixtures/gg20_ref_exact_768.json (tests/gpu/test_torch_ref_exact.py):
the reference-exact configuration, per-proof verification and uniform
randomizers (TPU_MPC_BATCH_VERIFY=0, TPU_MPC_ENC_TABLES=0), on the key and
seed of gg20_slice_768 tiled to S = 8; two runs, "clean" and "step6" (sigma_i
doubled for signer 1 of session 5 alone).  Per run: ok, bad_actors, the
debug masks, the fields of gg20_slice_768, r, s, recid, sig_valid and the
signing ok flags.

tests/gpu/fixtures/gg20_blame_768.json: session 0 of
tests/fixtures/gg20key_20_2_1_3_768.json tiled to S = 4, signers [0, 1], in
the tables configuration (TPU_MPC_ENC_TABLES=1 and the randomizer tables
built on the key, as tests/gpu/test_torch_gg20.py does).  Runs, each from its
own SessionRng seed:
  step5     offline_stage with delta_i doubled, session b on pattern b % 4
            of [[], [0], [1], [0, 1]]; then phase5_blame;
  step6     the same matrix on sigma_i; then phase6_local_proofs and
            phase6_blame with those proofs;
  decommit  a fake g_gamma committed and decommitted by party 1 in every
            session (the reference's decommit seam takes a flat party list:
            tpu_mpc/protocols/gg20/batch.py:318-322 indexes fake[:, pi]);
            then phase5_blame;
  clean     no corruption; phase5_blame; phase6_blame on the proofs of a
            forged state (sigma_0 doubled in the sessions with b % 4 == 1);
            sign_online with s_i doubled on the b % 4 matrix; phase7_blame.
Per run: ok, bad_actors, r_x, delta_i, sigma_i and the blame lists.

tests/gpu/fixtures/gg18_768.json: gg18.keygen(2, 1, 3, SessionRng(0xAA), 768)
(the seed of tests/test_gg18.py): p, q, u, x, y_i, vss, ok; then under the
same rng gg18.sign of m = sha256(b"hello") for the subsets [0, 1], [1, 2],
[0, 2] (r, s, recid, ok, sig_valid), and a zero-sum refresh_private_key
followed by update_private_key with the Feldman re-dealt x factors (the new
p, q, u, x and y).

tests/gpu/fixtures/lindell17_1024.json: one rng chain from SessionRng(0x17)
(the seed of tests/test_lindell17.py:18), 1024-bit Paillier, S = 2:
lindell17.keygen(2, rng, 1024) (x1, x2, p, q, Q1, Q2, c_key,
c_key_randomness, pubkey, ok); sign of m = sha256(b"lindell msg") (r, s,
recid, ok, sig_valid); the MtA conversion party_two_to_mta_message_b /
party_one_to_mta_message_b (alpha, beta, ok); refresh_private_key with
factors rng.scalars((2,)) (the new key's fields) and sign of 424242.  The
state of rng's random.Random before each step after keygen
(rng_before_*, getstate() as lists), so that a test can run a step from
the golden key alone.

tests/gpu/fixtures/pdl_576.json: the runs of tests/test_pdl.py (BITS =
576, S = 2, keys host/paillier.keypair(576) drawn from each seed's rng):
range_proof_ni prove/verify on x < q/3 (seed 5) and on x = q - 5 (seed 6,
the soundness case: verify rejects), the zk_pdl flow (seed 7: every
message and state field, range_ok, prover_ok, the verifier's verdict) and
the flow with Q = (x + 1) G (seed 8: the verdict rejects).

tests/gpu/fixtures/runtime_768.json: the runtime's in-process replay (the
seeds of tests/test_runtime.py): run_simulation over Gg20Keygen(i, 1, 3,
SessionRng(100 + i), 768) for i = 1, 2, 3, then Gg20OfflineStage for s_l =
[0, 2] from SessionRng(201) and SessionRng(202), partial_sig_local and
sign_manual of m = sha256(b"sm message"); every delivered Msg.to_json()
string in delivery order, every output (wire-encoded), the partial
signatures, the signature, and party 1's LocalKey file as
runtime.cli.save_local_key writes it.

tests/gpu/fixtures/gg20_quorum_768.json (tests/gpu/test_torch_quorum.py): the
wide quorums and the n = 5 / n = 2 blame matrices (gg20_quorum below), and
tests/gpu/fixtures/gg20key_53_1_4_8_768.json, the n = 8 key they sign
with, written once by the reference's keygen.

tests/gpu/fixtures/kernels_ec.json, kernels_rns.json, kernels_fixed.json:
the reference's kernels on the seeded inputs of the kernel tests that held
the port against them live (see kernels_ec, kernels_rns and kernels_fixed
below); each records its inputs beside the outputs, and the tests check
that their own inputs still equal them.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, "..", ".."))
OUT = os.path.join(HERE, "fixtures")
KEY_FIXTURE = os.path.join(REPO, "tests", "fixtures", "gg20key_20_2_1_3_768.json")

S_BLAME = 4
SIGNERS = [0, 1]
PATTERNS4 = [[], [0], [1], [0, 1]]
SEEDS = {"step5": 0xB105, "step6": 0xB106, "decommit": 0xB1DC, "clean": 0xB1C1}
S_SLICE = 2
SLICE_SEED = 0x5169
SLICE_FIELDS = ("r_x", "k", "sigma_i", "delta_i", "msg_a_c", "alpha", "beta_g", "miu")
S_REF_EXACT = 8
REF_EXACT_CORRUPT = {"step": 6, "parties": [[1] if b == 5 else [] for b in range(S_REF_EXACT)]}
DECOMMIT_PARTIES = [1]
M_BLAME = int.from_bytes(hashlib.sha256(b"gg20 blame").digest(), "big")

GG18_SEED, GG18_S, GG18_BITS = 0xAA, 2, 768
GG18_SUBSETS = ([0, 1], [1, 2], [0, 2])
M_GG18 = int.from_bytes(hashlib.sha256(b"hello").digest(), "big")

L17_SEED, L17_S, L17_BITS = 0x17, 2, 1024
M_L17 = int.from_bytes(hashlib.sha256(b"lindell msg").digest(), "big")
M_L17_REFRESH = 424242
PDL_BITS, PDL_S = 576, 2
PDL_SEEDS = {"roundtrip": 5, "soundness": 6, "flow": 7, "wrong_witness": 8}


def matrix4(S: int) -> list:
    return [PATTERNS4[b % 4] for b in range(S)]


def strs(a):
    import numpy as np

    return np.vectorize(lambda v: str(int(v)), otypes=[object])(
        np.asarray(a, dtype=object)).tolist()


def host_pts(P):
    from tpu_mpc.ec import secp256k1 as dec

    def s(v):
        if v is None:
            return None
        if isinstance(v, tuple):
            return [str(v[0]), str(v[1])]
        return [s(e) for e in v]

    return s(dec.points_to_host_list(P))


def _keycache():
    spec = importlib.util.spec_from_file_location(
        "keycache", os.path.join(REPO, "tests", "keycache.py"))
    kc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kc)
    return kc


def _state(off) -> dict:
    import numpy as np

    return {"ok": [bool(v) for v in np.asarray(off.ok)],
            "bad_actors": np.asarray(off.bad_actors, dtype=bool).tolist(),
            "r_x": strs(off.r_x), "delta_i": strs(off.delta_i), "sigma_i": strs(off.sigma_i)}


def gg20_blame() -> dict:
    import numpy as np

    from tpu_mpc.host import ec as hec
    from tpu_mpc.protocols.gg20 import batch as gg20
    from tpu_mpc.protocols.gg20 import blame
    from tpu_mpc.utils.rng import SessionRng

    with open(KEY_FIXTURE) as f:
        d = json.load(f)
    d = {k: ([v[0]] * S_BLAME if isinstance(v, list) else v) for k, v in d.items()}
    d["S"] = S_BLAME
    key = _keycache()._decode(d)
    key.ek.ensure_enc_tables()
    mat = matrix4(S_BLAME)
    runs = {}

    def run(name, corrupt):
        t = time.perf_counter()
        rng = SessionRng(SEEDS[name])
        off = gg20.offline_stage(key, SIGNERS, rng, corrupt=corrupt)
        out = {"seed": SEEDS[name], "corrupt": corrupt, **_state(off)}
        print(f"  {name}: offline_stage {time.perf_counter() - t:.1f} s", flush=True)
        return off, rng, out

    off, rng, out = run("step5", {"step": 5, "parties": mat})
    out["phase5"] = blame.phase5_blame(key, off)
    runs["step5"] = out

    off, rng, out = run("step6", {"step": 6, "parties": mat})
    proofs = blame.phase6_local_proofs(off, rng)
    out["phase6_local_proofs"] = {"a1": host_pts(proofs.a1), "a2": host_pts(proofs.a2),
                                  "z": strs(_limbs_ints(proofs.z))}
    out["phase6"] = blame.phase6_blame(key, off, rng, ecddh_proofs=proofs)
    runs["step6"] = out

    off, rng, out = run("decommit", {"step": "decommit", "parties": DECOMMIT_PARTIES})
    out["phase5"] = blame.phase5_blame(key, off)
    runs["decommit"] = out

    off, rng, out = run("clean", None)
    out["phase5"] = blame.phase5_blame(key, off)
    forged = dataclasses.replace(off)
    forged.sigma_i = off.sigma_i.copy()
    for b in range(S_BLAME):
        if b % 4 == 1:
            forged.sigma_i[b, 0] = int(off.sigma_i[b, 0]) * 2 % hec.N
    proofs = blame.phase6_local_proofs(forged, rng)
    out["forged_phase6"] = blame.phase6_blame(key, off, rng, ecddh_proofs=proofs)
    sig = gg20.sign_online(off, M_BLAME, corrupt={"step": 7, "parties": mat})
    out["step7"] = {"m": str(M_BLAME), "corrupt": {"step": 7, "parties": mat},
                    "s_i": strs(sig.s_i), "sig_valid": [bool(v) for v in sig.sig_valid],
                    "phase7": blame.phase7_blame(off, sig.s_i, M_BLAME)}
    runs["clean"] = out
    return {"key": {"fixture": "tests/fixtures/gg20key_20_2_1_3_768.json", "session": 0,
                    "S": S_BLAME, "tables": True},
            "signers": SIGNERS, "runs": runs}


def gg20_slice() -> dict:
    import numpy as np
    from tpu_mpc.protocols.gg20 import batch as jg
    from tpu_mpc.utils.rng import SessionRng

    with open(KEY_FIXTURE) as f:
        d = json.load(f)
    key = {k: ([v[0]] * S_SLICE if isinstance(v, list) else v) for k, v in d.items()}
    key["S"] = S_SLICE
    m = int.from_bytes(hashlib.sha256(b"gg20 message").digest(), "big")
    out = {"seed": SLICE_SEED, "S": S_SLICE, "signers": SIGNERS, "m": str(m)}
    batch_verify = os.environ.get("TPU_MPC_BATCH_VERIFY")
    os.environ["TPU_MPC_BATCH_VERIFY"] = "1"
    try:
        for name, flag in (("uniform", "0"), ("tables", "1")):
            os.environ["TPU_MPC_ENC_TABLES"] = flag
            t = time.perf_counter()
            jkey = _keycache()._decode(key)
            # the reference's keygen builds the randomizer tables
            # (batch.py:191); its offline_stage builds only the h1/h2 ones
            jkey.ek.ensure_enc_tables()
            off = jg.offline_stage(jkey, SIGNERS, SessionRng(SLICE_SEED))
            sig = jg.sign_online(off, m)
            run = {f: strs(getattr(off, f)) for f in SLICE_FIELDS}
            run.update(r=strs(sig.r), s=strs(sig.s), recid=strs(sig.recid),
                       sig_valid=[bool(v) for v in np.asarray(sig.sig_valid)])
            if flag == "1":
                run["k_randomness"] = strs(off.k_randomness.ints())
                run["beta_randomness"] = strs(off.beta_randomness.ints())
            out[name] = run
            print(f"  gg20 slice {name} {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        if batch_verify is None:
            os.environ.pop("TPU_MPC_BATCH_VERIFY")
        else:
            os.environ["TPU_MPC_BATCH_VERIFY"] = batch_verify
    return out


def gg20_ref_exact() -> dict:
    """The reference-exact configuration at S = 8: per-proof verification
    (TPU_MPC_BATCH_VERIFY=0) and uniform randomizers (TPU_MPC_ENC_TABLES=0),
    on gg20_slice's key and seed, tiled to S = 8, the smallest S at which
    the default would batch.  Two runs from SessionRng(SLICE_SEED): "clean",
    and "step6" with sigma_i doubled for signer 1 of session 5 alone (the
    step seam's per-session form), which the reference names through the
    session's checks."""
    import numpy as np
    from tpu_mpc.protocols.gg20 import batch as jg
    from tpu_mpc.utils.rng import SessionRng

    with open(KEY_FIXTURE) as f:
        d = json.load(f)
    key = {k: ([v[0]] * S_REF_EXACT if isinstance(v, list) else v) for k, v in d.items()}
    key["S"] = S_REF_EXACT
    m = int.from_bytes(hashlib.sha256(b"gg20 message").digest(), "big")
    out = {"seed": SLICE_SEED, "S": S_REF_EXACT, "signers": SIGNERS, "m": str(m),
           "bits": 768, "runs": {}}
    saved = {k: os.environ.get(k) for k in ("TPU_MPC_BATCH_VERIFY", "TPU_MPC_ENC_TABLES")}
    os.environ.update(TPU_MPC_BATCH_VERIFY="0", TPU_MPC_ENC_TABLES="0")
    try:
        jkey = _keycache()._decode(key)
        for name, corrupt in (("clean", None), ("step6", REF_EXACT_CORRUPT)):
            t = time.perf_counter()
            off = jg.offline_stage(jkey, SIGNERS, SessionRng(SLICE_SEED), corrupt=corrupt)
            sig = jg.sign_online(off, m)
            run = {"corrupt": corrupt, **_state(off),
                   "debug_masks": {k: np.asarray(v, dtype=bool).tolist()
                                   for k, v in off.debug_masks.items()}}
            run.update({f: strs(getattr(off, f)) for f in SLICE_FIELDS})
            run.update(r=strs(sig.r), s=strs(sig.s), recid=strs(sig.recid),
                       sig_valid=[bool(v) for v in np.asarray(sig.sig_valid)],
                       sign_ok=[bool(v) for v in np.asarray(sig.ok)])
            out["runs"][name] = run
            print(f"  gg20 ref-exact {name} {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def _limbs_ints(z):
    import numpy as np

    from tpu_mpc.core.limbs import batch_from_limbs

    return batch_from_limbs(np.asarray(z))


def gg18() -> dict:
    import numpy as np

    from tpu_mpc.ec import secp256k1 as dec
    from tpu_mpc.host import ec as hec
    from tpu_mpc.protocols.gg18 import batch as gg18m
    from tpu_mpc.utils.rng import SessionRng
    from tpu_mpc.vss import feldman

    rng = SessionRng(GG18_SEED)
    t = time.perf_counter()
    res = gg18m.keygen(GG18_S, 1, 3, rng, paillier_bits=GG18_BITS)
    key = res.key
    print(f"  gg18 keygen {time.perf_counter() - t:.1f} s", flush=True)
    out = {"seed": GG18_SEED, "S": GG18_S, "t": 1, "n": 3, "bits": GG18_BITS,
           "keygen": {"ok": [bool(v) for v in res.ok], "p": strs(key.p), "q": strs(key.q),
                      "u": strs(key.u), "x": strs(key.x), "y_i": host_pts(key.y_i),
                      "y": host_pts(key.y), "vss": host_pts(key.vss.commitments)},
           "m": str(M_GG18), "sign": []}
    for subset in GG18_SUBSETS:
        t = time.perf_counter()
        sig = gg18m.sign(key, subset, M_GG18, rng)
        print(f"  gg18 sign {subset} {time.perf_counter() - t:.1f} s", flush=True)
        out["sign"].append({"subset": subset, "r": strs(sig.r), "s": strs(sig.s),
                            "recid": [int(v) for v in sig.recid],
                            "ok": [bool(v) for v in sig.ok],
                            "sig_valid": [bool(v) for v in sig.sig_valid]})
    n = key.n
    f = np.asarray(rng.scalars((GG18_S, n)), dtype=object)
    f[:, n - 1] = np.vectorize(lambda tot: (-int(tot)) % hec.N, otypes=[object])(
        np.sum(f[:, : n - 1], axis=1))
    key2 = gg18m.refresh_private_key(key, f, rng)
    _, shares_f = feldman.share(key.t, n, f, rng)
    factor_x = np.mod(np.sum(shares_f, axis=1), hec.N)
    key3 = gg18m.update_private_key(key2, np.zeros((GG18_S, n), dtype=object), factor_x)
    out["refresh"] = {"factor": strs(f), "p": strs(key2.p), "q": strs(key2.q),
                      "u": strs(key2.u), "y": host_pts(key2.y)}
    out["update"] = {"factor_x": strs(factor_x), "u": strs(key3.u), "x": strs(key3.x),
                     "y": host_pts(key3.y)}
    assert dec.points_to_host_list(key3.y) == dec.points_to_host_list(key.y)
    return out


def _rng_state(rng) -> list:
    v, st, gauss = rng._r.getstate()
    return [v, list(st), gauss]


def _l17_key(kg) -> dict:
    from tpu_mpc.ec import secp256k1 as dec

    p1, p2 = kg.p1, kg.p2
    return {"x1": strs(p1.x1), "x2": strs(p2.x2), "p": strs(p1.p), "q": strs(p1.q),
            "Q1": host_pts(p1.Q1), "Q2": host_pts(p2.Q2), "c_key": strs(p1.c_key),
            "c_key_randomness": strs(p1.c_key_randomness), "pubkey": host_pts(p1.pubkey),
            "pubkey2": host_pts(p2.pubkey), "ok": [bool(v) for v in kg.ok],
            "bits": int(p1.ek.n_ctx.bits)}


def _sig(sig) -> dict:
    import numpy as np

    return {"r": strs(sig.r), "s": strs(sig.s), "recid": [int(v) for v in sig.recid],
            "ok": [bool(v) for v in np.asarray(sig.ok)],
            "sig_valid": [bool(v) for v in np.asarray(sig.sig_valid)]}


def lindell17() -> dict:
    from tpu_mpc.protocols.lindell17 import batch as l17
    from tpu_mpc.utils.rng import SessionRng

    rng = SessionRng(L17_SEED)
    t = time.perf_counter()
    kg = l17.keygen(L17_S, rng, paillier_bits=L17_BITS)
    print(f"  lindell17 keygen {time.perf_counter() - t:.1f} s", flush=True)
    out = {"seed": L17_SEED, "S": L17_S, "bits": L17_BITS, "keygen": _l17_key(kg),
           "m": str(M_L17), "rng_before_sign": _rng_state(rng)}
    out["sign"] = _sig(l17.sign(kg, M_L17, rng))
    out["rng_before_mta"] = _rng_state(rng)
    msg_b, beta = l17.party_two_to_mta_message_b(kg.p2, rng)
    alpha, ok = l17.party_one_to_mta_message_b(kg.p1, msg_b)
    out["mta"] = {"alpha": strs(alpha), "beta": strs(beta), "ok": [bool(v) for v in ok]}
    out["rng_before_refresh"] = _rng_state(rng)
    factor = rng.scalars((L17_S,))
    kg2 = l17.refresh_private_key(kg, factor, rng)
    out["refresh"] = {"factor": strs(factor), "key": _l17_key(kg2),
                      "m": str(M_L17_REFRESH), "sign": _sig(l17.sign(kg2, M_L17_REFRESH, rng))}
    print(f"  lindell17 total {time.perf_counter() - t:.1f} s", flush=True)
    return out


def _proof(rp) -> dict:
    return {f: strs(getattr(rp, f)) for f in
            ("c1", "c2", "e", "w1", "r1", "w2", "r2", "z", "r_masked")}


def pdl576() -> dict:
    import numpy as np

    from tpu_mpc.ec import secp256k1 as dec
    from tpu_mpc.host import ec as hec
    from tpu_mpc.host import paillier as hp
    from tpu_mpc.mta.mta import paillier_encrypt_ints
    from tpu_mpc.paillier import paillier as dp
    from tpu_mpc.utils.rng import SessionRng
    from tpu_mpc.zk import pdl, range_proof_ni
    from tpu_mpc.zk.range_proofs import PaillierCtxBatch

    Q = hec.N
    out = {"bits": PDL_BITS, "S": PDL_S, "seeds": PDL_SEEDS}
    for name, seed in PDL_SEEDS.items():
        t = time.perf_counter()
        rng = SessionRng(seed)
        keys = [hp.keypair(PDL_BITS, rng=rng._r) for _ in range(PDL_S)]
        ns = np.asarray([k[0].n for k in keys], dtype=object)
        ek = PaillierCtxBatch.from_ints(ns, bits=PDL_BITS)
        dk = dp.BatchDecryptionKey.from_ints([k[1].p for k in keys], [k[1].q for k in keys],
                                             bits=PDL_BITS)
        x = (np.asarray([Q - 5] * PDL_S, dtype=object) if name == "soundness"
             else rng.below(Q // 3, (PDL_S,)))
        r_enc = rng.units_below(ns, (PDL_S,))
        c = paillier_encrypt_ints(ek, x, r_enc)
        run = {"p": [str(k[1].p) for k in keys], "q": [str(k[1].q) for k in keys],
               "x": strs(x), "r_enc": strs(r_enc), "c": strs(c)}
        if name in ("roundtrip", "soundness"):
            proof = range_proof_ni.prove(ek, c, x, r_enc, rng)
            run["proof"] = _proof(proof)
            run["verify"] = [bool(v) for v in range_proof_ni.verify(proof, ek, c)]
        else:
            xq = x + 1 if name == "wrong_witness" else x
            stmt = pdl.PDLStatementBatch(
                ciphertext=c, ek=ek, Q_pt=dec.mul_generator(dec.sc_from_ints(np.mod(xq, Q))))
            wit = pdl.PDLWitnessBatch(x=x, r=r_enc, dk=dk)
            v1, vs = pdl.verifier_message1(stmt, rng)
            p1, ps = pdl.prover_message1(wit, stmt, v1, rng)
            v2, range_ok = pdl.verifier_message2(p1, stmt, vs)
            p2, prover_ok = pdl.prover_message2(v1, v2, wit, ps)
            run.update({
                "v1": {"c_tag": strs(v1.c_tag), "c_tag_tag": strs(v1.c_tag_tag)},
                "v_state": {"a": strs(vs.a), "b": strs(vs.b), "blindness": strs(vs.blindness),
                            "q_tag": host_pts(vs.q_tag)},
                "p1": {"c_hat": strs(p1.c_hat), "range_proof": _proof(p1.range_proof)},
                "p_state": {"alpha": strs(ps.alpha), "q_hat": host_pts(ps.q_hat),
                            "blindness": strs(ps.blindness)},
                "range_ok": [bool(v) for v in range_ok],
                "prover_ok": [bool(v) for v in prover_ok],
                "final": [bool(v) for v in pdl.verifier_finalize(p1, p2, vs)]})
        out[name] = run
        print(f"  pdl {name} {time.perf_counter() - t:.1f} s", flush=True)
    return out


RUNTIME_BITS = 768
RUNTIME_S_L = [0, 2]
M_RUNTIME = int.from_bytes(hashlib.sha256(b"sm message").digest(), "big")


def _recorder(log: list):
    """run_simulation's tamper hook that records every delivered message."""
    def rec(msg):
        log.append(msg.to_json())
        return msg
    return rec


def runtime768() -> dict:
    import tempfile

    from tpu_mpc.runtime import cli
    from tpu_mpc.runtime.gg20_keygen_sm import Gg20Keygen
    from tpu_mpc.runtime.gg20_sign_sm import Gg20OfflineStage, partial_sig_local, sign_manual
    from tpu_mpc.runtime.state_machine import run_simulation
    from tpu_mpc.runtime.wire import encode_value
    from tpu_mpc.utils.rng import SessionRng

    t = time.perf_counter()
    kg_msgs, off_msgs = [], []
    kg = [Gg20Keygen(i, 1, 3, SessionRng(100 + i), paillier_bits=RUNTIME_BITS)
          for i in (1, 2, 3)]
    outs = run_simulation(kg, tamper=_recorder(kg_msgs))
    print(f"  runtime keygen {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    sms = [Gg20OfflineStage(1, RUNTIME_S_L, outs[0], SessionRng(201)),
           Gg20OfflineStage(2, RUNTIME_S_L, outs[2], SessionRng(202))]
    off = run_simulation(sms, tamper=_recorder(off_msgs))
    print(f"  runtime offline {time.perf_counter() - t:.1f} s", flush=True)
    partials = [partial_sig_local(o, M_RUNTIME) for o in off]
    sigs = [sign_manual(off[0], M_RUNTIME, [partials[1]]),
            sign_manual(off[1], M_RUNTIME, [partials[0]])]
    assert sigs[0] == sigs[1] and sigs[0]["valid"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "local1.json")
        cli.save_local_key(path, outs[0])
        with open(path) as f:
            key_file = f.read()
    return {"bits": RUNTIME_BITS, "t": 1, "n": 3, "keygen_seeds": [101, 102, 103],
            "s_l": RUNTIME_S_L, "offline_seeds": [201, 202], "m": str(M_RUNTIME),
            "keygen_msgs": kg_msgs, "keygen_outputs": [encode_value(o) for o in outs],
            "offline_msgs": off_msgs, "offline_outputs": [encode_value(o) for o in off],
            "partials": [str(v) for v in partials], "sig": encode_value(sigs[0]),
            "local_key_1": key_file}


# ---- wide quorums and the n = 5 / n = 2 blame matrices ---------------------

KEY_N2 = os.path.join(REPO, "tests", "fixtures", "gg20key_51_1_1_2_768.json")
KEY_N5 = os.path.join(REPO, "tests", "fixtures", "gg20key_52_1_2_5_768.json")
KEY_N8 = os.path.join(OUT, "gg20key_53_1_4_8_768.json")
N8_KEYGEN = (0x53, 1, 4, 8, 768)          # seed, S, t, n, bits (tests/test_gg20_adv_quorum.py)
N5_SIGNERS, N8_SIGNERS = [0, 2, 3, 4], [0, 1, 2, 4, 6, 7]
N5_SCENARIOS, N5_STEP7 = [[0], [0, 3]], [[1, 3], []]
N2_SCENARIOS, N2_STEP7 = [[0], [1], [0, 1]], [[1]]
QUORUM_SEEDS = {"n5_honest": 0x5151, "n5_step5": 0x5205, "n5_step6": 0x5206,
                "n2_step5": 0x5105, "n2_step6": 0x5106, "n2_step7": 0x5107,
                "small_paillier": 0x54, "full": 0x3F01, "gg18_full": 0xBB, "n8": 0x8181}
M_N5, M_N8, M_STEP7 = 0x5151, 0x8181, 0xDEAD_BEEF    # the JAX package's tests' messages
M_FULL, M_GG18_FULL = 987654321, 12345678901234567890


def _fixture_key(path: str, S: int, tables: bool):
    """Session 0 of a key file in tests/keycache.py's format, tiled to S
    sessions; the randomizer tables built in the tables configuration."""
    with open(path) as f:
        d = json.load(f)
    d = {k: ([v[0]] * S if isinstance(v, list) else v) for k, v in d.items()}
    d["S"] = S
    key = _keycache()._decode(d)
    if tables:
        key.ek.ensure_enc_tables()
    return key


def _n8_key():
    """keygen(1, 4, 8, SessionRng(0x53), 768) of the JAX package, written
    once to tests/gpu/fixtures/ in tests/keycache.py's format."""
    from tpu_mpc.protocols.gg20 import batch as gg20
    from tpu_mpc.utils.rng import SessionRng

    seed, S, t, n, bits = N8_KEYGEN
    if not os.path.exists(KEY_N8):
        t0 = time.perf_counter()
        res = gg20.keygen(S, t, n, SessionRng(seed), paillier_bits=bits)
        assert res.ok.all(), f"n = 8 keygen failed: {res.bad_actors}"
        obj = _keycache()._encode(res.key)
        obj["seed"] = seed
        with open(KEY_N8, "w") as f:
            json.dump(obj, f)
        print(f"  n8 keygen {time.perf_counter() - t0:.1f} s", flush=True)


def gg20_quorum() -> dict:
    """The JAX package's wide quorums and blame matrices at 768 bits, with the
    cross-session batch verification forced (TPU_MPC_BATCH_VERIFY=1):

      n5      tests/fixtures/gg20key_52_1_2_5_768.json tiled to S = 2,
              signers [0, 2, 3, 4], tables: an honest offline_stage and
              sign_online(0x5151), then on the same offline state
              sign_online(0xDEADBEEF) with s_i doubled on [[1, 3], []] and
              phase7_blame; offline_stage with step 5 and step 6 on
              [[0], [0, 3]], phase5_blame / phase6_blame
              (tests/test_gg20_adv_quorum{,5,6,7}.py);
      n2      tests/fixtures/gg20key_51_1_1_2_768.json, signers [0, 1],
              uniform: steps 5 and 6 on [[0], [1], [0, 1]] (S = 3), a clean
              S = 1 pass with step 7 on [[1]], and keygen(1, 1, 2,
              SessionRng(0x54), 768) with party 1's Paillier key at half
              width (tests/test_gg20_adversarial.py);
      full    session 0 of tests/fixtures/gg20key_20_2_1_3_768.json tiled to
              S = 2, tables:
              GG20 [0, 1, 2] (tests/test_gg20.py:54) and GG18 sign [0, 1, 2]
              on the same key (GG18's sign reads S, t, x, ek, dk and y);
      n8      keygen(1, 4, 8, SessionRng(0x53), 768) (written once to
              tests/gpu/fixtures/gg20key_53_1_4_8_768.json) tiled to S = 2,
              signers [0, 1, 2, 4, 6, 7], tables, sign_online(0x8181).
    """
    import numpy as np

    from tpu_mpc.protocols.gg18 import batch as gg18m
    from tpu_mpc.protocols.gg20 import batch as gg20
    from tpu_mpc.protocols.gg20 import blame
    from tpu_mpc.utils.rng import SessionRng

    saved = {k: os.environ.get(k) for k in ("TPU_MPC_BATCH_VERIFY", "TPU_MPC_ENC_TABLES")}
    os.environ["TPU_MPC_BATCH_VERIFY"] = "1"
    out = {"bits": 768, "seeds": QUORUM_SEEDS}

    def offline(name, key, signers, corrupt=None):
        t = time.perf_counter()
        rng = SessionRng(QUORUM_SEEDS[name])
        off = gg20.offline_stage(key, signers, rng, corrupt=corrupt)
        print(f"  {name}: offline_stage {time.perf_counter() - t:.1f} s", flush=True)
        return off, rng, {"seed": QUORUM_SEEDS[name], "corrupt": corrupt, **_state(off)}

    def step7(off, parties):
        sig = gg20.sign_online(off, M_STEP7, corrupt={"step": 7, "parties": parties})
        return {"m": str(M_STEP7), "parties": parties, "s_i": strs(sig.s_i),
                "sig_valid": [bool(v) for v in sig.sig_valid],
                "phase7": blame.phase7_blame(off, sig.s_i, M_STEP7)}

    try:
        # n = 5, t = 2, four signers
        os.environ["TPU_MPC_ENC_TABLES"] = "1"
        key = _fixture_key(KEY_N5, 2, tables=True)
        n5 = {"key": "tests/fixtures/gg20key_52_1_2_5_768.json", "S": 2, "tables": True,
              "signers": N5_SIGNERS, "m": str(M_N5)}
        off, rng, run = offline("n5_honest", key, N5_SIGNERS)
        run.update(_sig(gg20.sign_online(off, M_N5)))
        run["step7"] = step7(off, N5_STEP7)
        n5["honest"] = run
        for step in (5, 6):
            name = f"n5_step{step}"
            off, rng, run = offline(name, key, N5_SIGNERS,
                                    {"step": step, "parties": N5_SCENARIOS})
            run["blame"] = (blame.phase5_blame(key, off) if step == 5
                            else blame.phase6_blame(key, off, rng))
            n5[f"step{step}"] = run
        out["n5"] = n5

        # n = 2, t = 1
        os.environ["TPU_MPC_ENC_TABLES"] = "0"
        n2 = {"key": "tests/fixtures/gg20key_51_1_1_2_768.json", "tables": False,
              "signers": [0, 1]}
        key = _fixture_key(KEY_N2, len(N2_SCENARIOS), tables=False)
        for step in (5, 6):
            name = f"n2_step{step}"
            off, rng, run = offline(name, key, [0, 1], {"step": step, "parties": N2_SCENARIOS})
            run["blame"] = (blame.phase5_blame(key, off) if step == 5
                            else blame.phase6_blame(key, off, rng))
            n2[f"step{step}"] = run
        key = _fixture_key(KEY_N2, 1, tables=False)
        off, rng, run = offline("n2_step7", key, [0, 1])
        run["step7"] = step7(off, N2_STEP7)
        n2["step7"] = run
        t = time.perf_counter()
        res = gg20.keygen(1, 1, 2, SessionRng(QUORUM_SEEDS["small_paillier"]), paillier_bits=768,
                          corrupt={"small_paillier": [1]})
        n2["small_paillier"] = {"seed": QUORUM_SEEDS["small_paillier"], "parties": [1],
                                "ok": [bool(v) for v in np.asarray(res.ok)],
                                "bad_actors": np.asarray(res.bad_actors, dtype=bool).tolist()}
        print(f"  small_paillier keygen {time.perf_counter() - t:.1f} s", flush=True)
        out["n2"] = n2

        # the full quorum of the n = 3 key, GG20 and GG18
        os.environ["TPU_MPC_ENC_TABLES"] = "1"
        key = _fixture_key(KEY_FIXTURE, 2, tables=True)
        full = {"key": "tests/fixtures/gg20key_20_2_1_3_768.json", "S": 2, "tables": True,
                "signers": [0, 1, 2], "m": str(M_FULL), "gg18_m": str(M_GG18_FULL)}
        off, rng, run = offline("full", key, [0, 1, 2])
        run.update(_sig(gg20.sign_online(off, M_FULL)))
        full["gg20"] = run
        t = time.perf_counter()
        sig = gg18m.sign(key, [0, 1, 2], M_GG18_FULL, SessionRng(QUORUM_SEEDS["gg18_full"]))
        full["gg18"] = {"seed": QUORUM_SEEDS["gg18_full"], **_sig(sig)}
        print(f"  gg18 [0, 1, 2] {time.perf_counter() - t:.1f} s", flush=True)
        out["full"] = full

        # n = 8, t = 4, six signers
        _n8_key()
        key = _fixture_key(KEY_N8, 2, tables=True)
        off, rng, run = offline("n8", key, N8_SIGNERS)
        run.update(_sig(gg20.sign_online(off, M_N8)))
        out["n8"] = {"key": "tests/gpu/fixtures/gg20key_53_1_4_8_768.json",
                     "keygen": list(N8_KEYGEN), "S": 2, "tables": True,
                     "signers": N8_SIGNERS, "m": str(M_N8), "run": run}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


# ---- the kernel tests' reference outputs ----------------------------------

def _test_module(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pts_json(pts):
    return [None if p is None else [str(p[0]), str(p[1])] for p in pts]


def kernels_ec() -> dict:
    """tests/gpu/test_torch_ec.py: the reference's XLA path on the inputs of
    test_against_reference_xla_path, and its K3 Pallas kernel in interpret
    mode on those of test_k3_plain_equals_reference_pallas_interpret."""
    import numpy as np

    from tpu_mpc.ec import pallas_ec as jpe
    from tpu_mpc.ec import secp256k1 as jec
    from tpu_mpc.host import ec as hec

    te = _test_module("test_torch_ec")
    sc = lambda ks: jec.sc_from_ints(np.asarray(ks, dtype=object))
    host = jec.points_to_host_list
    os.environ["TPU_MPC_PALLAS"] = "0"
    ks, kb = te._scalars(10, edge=(0,)), te._scalars(11)
    pts = te._points(12, edge=(None,))
    P, G = jec.points_from_host(pts), jec.points_from_host([hec.G] * te.B)
    xla = {"ks": [str(k) for k in ks], "kb": [str(k) for k in kb], "pts": _pts_json(pts),
           "scalar_mul": _pts_json(host(jec.scalar_mul(sc(ks), P))),
           "mul_generator": _pts_json(host(jec.mul_generator(sc(ks)))),
           "dual_mul": _pts_json(host(jec.dual_mul(sc(ks), P, sc(kb), G))),
           "glv_split": [np.asarray(t).astype(np.int64).tolist()
                         for t in jec._glv_split(sc(ks))]}
    os.environ["TPU_MPC_PALLAS"] = "1"
    ks = te._scalars(13, edge=(0, 1, hec.N - 1))
    pts = te._points(14, edge=(None,))
    want = te._jac_rows(jpe.glv_mul(sc(ks), jec.points_from_host(pts)))
    os.environ["TPU_MPC_PALLAS"] = "0"
    return {"xla": xla, "k3_interpret": {"ks": [str(k) for k in ks], "pts": _pts_json(pts),
                                         "jac": want.tolist()}}


def kernels_rns() -> dict:
    """tests/gpu/test_torch_rns.py: the reference's XLA RNS path (reduce_axis0
    off and on) on the inputs of test_k1_plain_matches_reference_xla, and
    its Pallas dispatch in interpret mode on those of
    test_k1_plain_matches_reference_pallas_interpret."""
    import numpy as np

    from tpu_mpc.core import rns as jrns

    tr = _test_module("test_torch_rns")
    out = {"xla": {}}
    os.environ["TPU_MPC_PALLAS"] = "0"
    for reduce_axis0 in (False, True):
        rng = np.random.default_rng(21)
        bits, S = 768, 4
        ns = tr._moduli(rng, bits, 1)
        b = np.asarray([[tr._rand(rng, bits) % int(ns[0])] for _ in range(S)], dtype=object)
        e = np.asarray([[tr._rand(rng, 64)] for _ in range(S)], dtype=object)
        want = jrns.rns_exp_dispatch(jrns.RnsCtx.from_ints(ns, bits), ns, b, e, 64,
                                     reduce_axis0=reduce_axis0).ints()
        out["xla"][str(reduce_axis0)] = {"ns": strs(ns), "b": strs(b), "e": strs(e),
                                         "shape": list(np.shape(want)), "want": strs(want)}
    os.environ["TPU_MPC_PALLAS"] = "1"
    rng = np.random.default_rng(31)
    ns = tr._moduli(rng, 256, 3)
    b = np.asarray([tr._rand(rng, 256) >> 1 for _ in range(3)], dtype=object)
    e = np.asarray([tr._rand(rng, 16) | 1 for _ in range(3)], dtype=object)
    want = jrns.rns_exp_dispatch(jrns.RnsCtx.from_ints(ns, 256), ns, b, e, 16).ints()
    os.environ["TPU_MPC_PALLAS"] = "0"
    out["interpret"] = {"ns": strs(ns), "b": strs(b), "e": strs(e), "want": strs(want)}
    return out


def table_digest(a) -> str:
    """sha256 of an integer array's int64 little-endian bytes."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(np.asarray(a).astype("<i8")).tobytes()).hexdigest()


def kernels_fixed() -> dict:
    """tests/gpu/test_torch_fixed.py::test_fixed_base_equals_reference, per
    width: the reference's table build (as a digest of its residues: the
    768-bit tables hold 77k values), its XLA fixed-product path for G = 3
    and G = 1, and at 256 bits its Pallas dispatch with a gmap in interpret
    mode; each on the test's seeded inputs."""
    import numpy as np

    from tpu_mpc.core import rns as jrns

    tf = _test_module("test_torch_fixed")
    out = {}
    for bits in (256, 768):
        os.environ["TPU_MPC_PALLAS"] = "0"
        rng = np.random.default_rng(bits + 1)
        ns3 = tf._moduli(rng, bits, 3).reshape(1, 3)
        bases3 = np.asarray([[[tf._rand(rng, bits + 8) for _ in range(3)]] for _ in range(2)],
                            dtype=object)
        jt3 = jrns.rns_make_tables(jrns.RnsCtx.from_ints(ns3, bits), ns3, bases3, 64, bits)
        refs = [np.concatenate([np.asarray(tA), np.asarray(tB), np.asarray(tr)[..., None]], -1)
                for tA, tB, tr in jt3]
        run = {"ns3": strs(ns3), "bases3": strs(bases3),
               "tables": [{"shape": list(r.shape), "sha256": table_digest(r)} for r in refs],
               "groups": []}
        S = 2
        for G in (3, 1):
            ns = ns3[:, :G]
            jt = [tuple(c[:, :, :, :G] for c in t) for t in jt3]
            e1 = np.asarray([[tf._rand(rng, 16) for _ in range(G)] for _ in range(S)],
                            dtype=object)
            e2 = np.asarray([[tf._rand(rng, 64) for _ in range(G)] for _ in range(S)],
                            dtype=object)
            e1[0, 0] = 0
            want = jrns.rns_fixed_prod_dispatch(jrns.RnsCtx.from_ints(ns, bits), ns, jt,
                                                [e1, e2], [16, 64], bits).ints()
            run["groups"].append({"G": G, "e1": strs(e1), "e2": strs(e2), "want": strs(want)})
        if bits == 256:
            os.environ["TPU_MPC_PALLAS"] = "1"
            nsG = ns3[0]
            gmap = np.asarray([0, 2, 1, 2])
            n_s = np.asarray([int(nsG[i]) for i in gmap], dtype=object)
            e = np.asarray([5, 200, 77, 255], dtype=object)
            want = jrns.rns_fixed_prod_dispatch(jrns.RnsCtx.from_ints(n_s, bits), n_s, jt3[:1],
                                                [e], [8], bits, gmap=gmap).ints()
            run["gmap"] = {"gmap": gmap.tolist(), "e": strs(e), "want": strs(want)}
            os.environ["TPU_MPC_PALLAS"] = "0"
        out[str(bits)] = run
    return out


GOLDENS = {"gg20_blame_768": (gg20_blame, "1"), "gg18_768": (gg18, "1"),
           "lindell17_1024": (lindell17, "0"), "pdl_576": (pdl576, "0"),
           "gg20_slice_768": (gg20_slice, "0"), "gg20_ref_exact_768": (gg20_ref_exact, "0"),
           "runtime_768": (runtime768, "0"), "gg20_quorum_768": (gg20_quorum, "1"),
           "kernels_ec": (kernels_ec, "0"), "kernels_rns": (kernels_rns, "0"),
           "kernels_fixed": (kernels_fixed, "0")}



def main() -> int:
    names = sys.argv[1:] or list(GOLDENS)
    unknown = [n for n in names if n not in GOLDENS]
    if unknown:
        print(f"unknown golden(s) {unknown}; choose from {list(GOLDENS)}", file=sys.stderr)
        return 2
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["TPU_MPC_PALLAS"] = "0"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    # drop jax's compiled programs before the process passes the kernel's
    # mapped-area limit (the wide quorums compile more than it holds)
    spec = importlib.util.spec_from_file_location("gpu_conftest", os.path.join(HERE, "conftest.py"))
    conftest = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(conftest)
    conftest.JitMapGuard().install()
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    for name in names:
        fn, enc_tables = GOLDENS[name]
        # read per call by the reference's randomizer sampling
        os.environ["TPU_MPC_ENC_TABLES"] = enc_tables
        t = time.perf_counter()
        obj = fn()
        with open(os.path.join(OUT, name + ".json"), "w") as f:
            if name.startswith("kernels_"):
                json.dump(obj, f, separators=(",", ":"))
            else:
                json.dump(obj, f, indent=1)
            f.write("\n")
        print(f"{name}.json: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

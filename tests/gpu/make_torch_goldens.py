#!/usr/bin/env python3
"""Write the reference package's GG20 blame and GG18 outputs as golden files
for the port's CPU tests (tests/gpu/test_torch_blame.py, test_torch_gg18.py).

    JAX_PLATFORMS=cpu TPU_MPC_PALLAS=0 python tests/gpu/make_torch_goldens.py

(from the repository root; 299 s wall on an 8-core CPU machine, most of it
JAX compilation).  pytest does not collect this file.  The tests run
only the port against what it writes, so that no tier-1 test pays for the
reference's offline_stage, sign or keygen.

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
DECOMMIT_PARTIES = [1]
M_BLAME = int.from_bytes(hashlib.sha256(b"gg20 blame").digest(), "big")

GG18_SEED, GG18_S, GG18_BITS = 0xAA, 2, 768
GG18_SUBSETS = ([0, 1], [1, 2], [0, 2])
M_GG18 = int.from_bytes(hashlib.sha256(b"hello").digest(), "big")


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


def main() -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["TPU_MPC_PALLAS"] = "0"
    os.environ["TPU_MPC_ENC_TABLES"] = "1"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    for name, fn in (("gg20_blame_768.json", gg20_blame), ("gg18_768.json", gg18)):
        t = time.perf_counter()
        obj = fn()
        with open(os.path.join(OUT, name), "w") as f:
            json.dump(obj, f, indent=1)
            f.write("\n")
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

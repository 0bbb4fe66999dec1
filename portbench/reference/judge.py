"""The comparison that decides `correct`.

It judges what the timed passes returned, session by session, against the
reference's own verdicts (secp256k1.py), under the guarantees that the
configurations state:

    key_wrong    the program's public key is not (sum of u_i) G, worked out
                 again from the key material
    missing      sessions of the window's passes with no signature returned
    sig_bad      signatures (r, s, recid) that do not verify under that key
                 for the session's message hash
    high_s       signatures with s above N / 2 (the low-s form)
    r_repeats    sessions whose r another session of the run already had
                 (a nonce used twice)
    mask_wrong   sessions whose sig_valid or ok is not the reference's
                 verdict: valid, low s and r not repeated

Each is a count whose limit is 0: an exact comparison.
"""

from __future__ import annotations

from . import secp256k1 as ec

LIMITS = {"key_wrong": 0, "missing": 0, "sig_bad": 0, "high_s": 0, "r_repeats": 0,
          "mask_wrong": 0}


def public_key(material: dict):
    """(sum of the additive shares u_i) G of a one-key-set material."""
    return ec.g_comb().mul(sum(int(v) for v in material["u"][0]) % ec.N)


def secret_key(material: dict) -> int:
    return sum(int(v) for v in material["u"][0]) % ec.N


def judge(material: dict, program_y, passes: list, S: int) -> dict:
    """passes: one dict a pass, each with the hashes it was given ("m") and
    what the program returned for them ("r", "s", "recid", "ok",
    "sig_valid"), lists of ints and bools.  -> {check: count}."""
    y = public_key(material)
    ver = ec.Verifier(y)
    out = dict.fromkeys(LIMITS, 0)
    out["key_wrong"] = int(program_y is None or tuple(map(int, program_y)) != y)
    seen = set()
    for p in passes:
        got = min(len(p[k]) for k in ("r", "s", "recid", "ok", "sig_valid"))
        out["missing"] += S - min(got, S)
        for b in range(min(got, S)):
            r, s, rec = int(p["r"][b]), int(p["s"][b]), int(p["recid"][b])
            valid = ver.check(int(p["m"][b]), r, s, rec)
            low = s <= ec.HALF_N
            fresh = r not in seen
            seen.add(r)
            out["sig_bad"] += not valid
            out["high_s"] += not low
            out["r_repeats"] += not fresh
            verdict = valid and low and fresh
            out["mask_wrong"] += (bool(p["sig_valid"][b]) != verdict
                                  or bool(p["ok"][b]) != verdict)
    return out


def passed(checks: dict) -> bool:
    return all(checks[k] <= lim for k, lim in LIMITS.items())

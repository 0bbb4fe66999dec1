"""The program under test for the GG20 configurations: tpu_mpc_torch's
batched GG20 signing, through its normal entry points.

Set-up loads the configuration's key set with key_from_material (which
builds the h1/h2 and randomizer tables on the device in the tables mode)
and tiles it to the traffic's S sessions with tile_key.  A pass is
offline_stage(key, signers, rng) then sign_online(off, m): S sessions, each
with its own message hash; rng is one SessionRng(seed) that runs on from
pass to pass.
"""

from __future__ import annotations

import numpy as np


class Program:
    # the signature gate, called once a pass from sign_online
    # (protocols/gg18/batch.py:_finish_signatures)
    GATE = ("tpu_mpc_torch.host.ec", "ecdsa_verify_batch")

    def __init__(self, config: dict, material: dict, sessions: int, device, seed: int):
        from tpu_mpc_torch.ec import secp256k1 as dec
        from tpu_mpc_torch.protocols.gg20 import batch
        from tpu_mpc_torch.utils.rng import SessionRng

        self.batch, self.dec, self.SessionRng = batch, dec, SessionRng
        self.signers = list(config["signers"])
        self.key1 = batch.key_from_material(material, device)
        self.key = batch.tile_key(self.key1, sessions)
        self.rng = SessionRng(seed)

    def public_key(self):
        """The program's public key of the key set, as host (x, y) ints."""
        return self.dec.points_to_host(self.key1.y).reshape(-1)[0]

    def warm(self, seed: int, m: list) -> None:
        """One pass at the window's sessions, with an rng of its own."""
        off = self.batch.offline_stage(self.key, self.signers, self.SessionRng(seed))
        self.batch.sign_online(off, np.asarray(m, dtype=object))

    def sign_pass(self, m: list, stage) -> dict:
        with stage("offline"):
            off = self.batch.offline_stage(self.key, self.signers, self.rng)
        with stage("online"):
            res = self.batch.sign_online(off, np.asarray(m, dtype=object))
        return {"r": [int(v) for v in res.r], "s": [int(v) for v in res.s],
                "recid": [int(v) for v in res.recid],
                "ok": [bool(v) for v in res.ok], "sig_valid": [bool(v) for v in res.sig_valid]}

    def close(self) -> None:
        self.key = self.key1 = None

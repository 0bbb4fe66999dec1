"""The port's pure-python Paillier and share backup against the reference's
own pure-python modules, live (milliseconds: no golden file needed), bit
for bit: tpu_mpc_torch/host/paillier.py against tpu_mpc/host/paillier.py,
tpu_mpc_torch/host/backup.py against tpu_mpc/host/backup.py, and the GG20
key's to_encrypted_segments against the reference's backup_batch."""

import json
import os
import random

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
KEY = os.path.join(HERE, "..", "fixtures", "gg20key_20_2_1_3_768.json")
# the moduli of tests/gpu/test_torch_zk.py (odd, not prime: they test the
# integer functions; the round trips below use a seeded prime keypair)
P_FIX = 0xE49FBB0E90F6BFF4CFEB4E54B9B737BC33DA9D188FE0F14F15F7C4C3A5F261E1AA2EF37343E7E1F7BE9C1A379FBAF44B5E31D68A1CEC93777EA0B1ADB18E64A3
Q_FIX = 0xD2E5B9A3C1D075DF5C46873C5B1EFF3E2B8C557F27A8A5B38F9D3B8A8FEB3F61F00F5C09C2E8D37B08F2B6DEA2D1DEB1A1BA4C6F0B7C5E9A3D2C1B0A9F8E7D55
SEG, NSEG = 16, 16


def test_host_paillier_equals_reference():
    from tpu_mpc.host import paillier as rp
    from tpu_mpc_torch.host import paillier as tp

    rnd = random.Random(0x9A1)
    tek, tdk = tp.EncryptionKey(P_FIX * Q_FIX), tp.DecryptionKey(P_FIX, Q_FIX)
    rek, rdk = rp.EncryptionKey(P_FIX * Q_FIX), rp.DecryptionKey(P_FIX, Q_FIX)
    assert (tek.nn, tdk.n, tdk.lam) == (rek.nn, rdk.n, rdk.lam)
    for _ in range(4):
        m, r, k = rnd.randrange(tek.n), rnd.randrange(1, tek.n), rnd.getrandbits(256)
        c = tp.encrypt(tek, m, r)
        assert c == rp.encrypt(rek, m, r)
        assert tp.decrypt(tdk, c) == rp.decrypt(rdk, c)
        assert tp.open(tdk, c) == rp.open(rdk, c)
        assert tp.add(tek, c, c + 1) == rp.add(rek, c, c + 1)
        assert tp.add_plain(tek, c, m) == rp.add_plain(rek, c, m)
        assert tp.mul_plain(tek, c, k) == rp.mul_plain(rek, c, k)
    # a seeded keypair (the port's prime draw equals the reference's), and
    # the round trips on it: decrypt and open recover (m, r)
    ek, dk = tp.keypair(512, random.Random(7))
    rek, rdk = rp.keypair(512, random.Random(7))
    assert (ek, (dk.p, dk.q)) == (tp.EncryptionKey(rek.n), (rdk.p, rdk.q))
    assert tp.sample_randomness(ek, random.Random(3)) == rp.sample_randomness(rek, random.Random(3))
    for _ in range(4):
        m, r = rnd.randrange(ek.n), rnd.randrange(1, ek.n)
        c = tp.encrypt(ek, m, r)
        assert tp.decrypt(dk, c) == m and tp.open(dk, c) == (m, r)
        assert tp.decrypt(dk, tp.add(ek, c, tp.encrypt(ek, 5, r))) == (m + 5) % ek.n


def test_encrypted_segments_equal_reference():
    from tpu_mpc.host import backup as rb
    from tpu_mpc.utils.rng import SessionRng as RRng
    from tpu_mpc_torch.host import backup as tb
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.utils.rng import SessionRng

    trng, rrng = SessionRng(32), RRng(32)
    y_sk = int(trng.scalars(()))
    assert y_sk == int(rrng.scalars(()))
    pub_y = hec.mul(y_sk)
    secrets = np.asarray([[int(trng.scalars(())) for _ in range(2)] for _ in range(2)],
                         dtype=object)
    assert secrets.tolist() == [[int(rrng.scalars(())) for _ in range(2)] for _ in range(2)]
    assert tb.segment_secret(int(secrets[0, 0]), SEG, NSEG) == \
        rb.segment_secret(int(secrets[0, 0]), SEG, NSEG)
    tw, te = tb.backup_batch(secrets, SEG, NSEG, pub_y, trng)
    rw, re_ = rb.backup_batch(secrets, SEG, NSEG, pub_y, rrng)
    assert len(tw) == len(rw) == 4
    for a, b, c, d in zip(tw, rw, te, re_):
        assert (a.x_vec, a.r_vec) == (b.x_vec, b.r_vec)
        assert (c.D, c.E) == (d.D, d.E)
    with pytest.raises(ValueError):
        tb.to_encrypted_segments(1, 8, 31, pub_y, trng)


def test_recovery_with_the_right_key_and_a_wrong_one():
    from tpu_mpc_torch.host import backup as tb
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.utils.rng import SessionRng

    rng = SessionRng(33)
    y_sk = int(rng.scalars(()))
    secrets = [int(rng.scalars(())) for _ in range(2)] + [5]
    _, encs = tb.backup_batch(secrets, SEG, NSEG, hec.mul(y_sk), rng)
    assert tb.recover_batch(encs, y_sk, SEG).tolist() == secrets
    assert all(tb.assemble_segments(tb.segment_secret(s, SEG, NSEG), SEG) == s for s in secrets)
    wrong = tb.decrypt_segments(encs[0], y_sk + 1, SEG)
    assert wrong != secrets[0]


def test_gg20_key_segments_equal_reference():
    from tpu_mpc.host import backup as rb
    from tpu_mpc.utils.rng import SessionRng as RRng
    from tpu_mpc_torch.host import backup as tb
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.gg20 import batch as tg
    from tpu_mpc_torch.utils.rng import SessionRng

    with open(KEY) as f:
        d = json.load(f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_MPC_TORCH_ENC_TABLES", "0")
        key = tg.key_from_material(d, device="cpu")
    y_sk = 0x5EC0DE
    pub_y = hec.mul(y_sk)
    tw, te = tg.to_encrypted_segments(key, SEG, NSEG, pub_y, SessionRng(34))
    rw, re_ = rb.backup_batch(key.u, SEG, NSEG, pub_y, RRng(34))
    assert [(w.x_vec, w.r_vec) for w in tw] == [(w.x_vec, w.r_vec) for w in rw]
    assert [(e.D, e.E) for e in te] == [(e.D, e.E) for e in re_]
    assert tb.recover_batch(te, y_sk, SEG).tolist() == [int(v) for v in key.u.reshape(-1)]

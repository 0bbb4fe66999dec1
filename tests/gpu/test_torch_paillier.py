"""The port's Paillier API (paillier/paillier.py: encrypt, decrypt,
ciphertext_add, ciphertext_add_plain, ciphertext_mul_plain) and
mta.paillier_decrypt_ints on the CPU, held exactly (integers: tolerance 0)
against the reference package's, run live on the same ints at 512 bits:
the reference on its CIOS limb path, the port through ModCtx (K1's plain
version here).  Keys from the host keypair of a seeded random.Random."""

import random

import numpy as np
import pytest

BITS = 512
S = 3


@pytest.fixture(scope="module")
def setup():
    """(keys' n, p, q; m, r, k draws; the port's ek, dk)."""
    from tpu_mpc_torch.host import paillier as hp
    from tpu_mpc_torch.paillier import paillier as tp

    rnd = random.Random(0x9A11)
    keys = [hp.keypair(BITS, rng=rnd) for _ in range(S)]
    obj = lambda v: np.asarray(v, dtype=object)
    ns, ps, qs = (obj([getattr(k[i], a) for k in keys]) for i, a in ((0, "n"), (1, "p"), (1, "q")))
    m = obj([rnd.randrange(int(n)) for n in ns])
    r = obj([rnd.randrange(1, int(n)) for n in ns])
    k = obj([rnd.getrandbits(256) for _ in ns])
    ek = tp.BatchEncryptionKey.from_ints(ns, BITS, "cpu")
    dk = tp.BatchDecryptionKey.from_ints(ps, qs, BITS, "cpu")
    return dict(ns=ns, ps=ps, qs=qs, m=m, r=r, k=k, ek=ek, dk=dk)


def _ref(d):
    """The reference's keys and a limb codec."""
    import jax.numpy as jnp

    from tpu_mpc.core.limbs import batch_from_limbs, batch_to_limbs, nlimbs
    from tpu_mpc.paillier import paillier as rp

    ek = rp.BatchEncryptionKey.from_ints(d["ns"], BITS)
    dk = rp.BatchDecryptionKey.from_ints(d["ps"], d["qs"], BITS)
    to = lambda v, bits: jnp.asarray(batch_to_limbs(np.asarray(v, dtype=object), nlimbs(bits)))
    back = lambda a: list(batch_from_limbs(np.asarray(a)))
    return rp, ek, dk, to, back


def test_encrypt_decrypt_equal_reference(setup):
    from tpu_mpc_torch.paillier import paillier as tp

    d = setup
    rp, ek, dk, to, back = _ref(d)
    c_ref = back(rp.encrypt(ek, to(d["m"], BITS), to(d["r"], BITS)))
    c = tp.encrypt(d["ek"], d["m"], d["r"])
    assert list(c) == c_ref
    m_ref = back(rp.decrypt(dk, to(c_ref, 2 * BITS)))
    assert list(tp.decrypt(d["dk"], c)) == m_ref == list(d["m"])
    # the key owner's CRT path for r^n gives the same ciphertexts
    ek_sk = tp.BatchEncryptionKey.from_ints(d["ns"], BITS, "cpu").attach_sk(d["ps"], d["qs"])
    assert list(tp.encrypt(ek_sk, d["m"], d["r"])) == c_ref


def test_ciphertext_ops_equal_reference(setup):
    from tpu_mpc_torch.paillier import paillier as tp

    d = setup
    rp, ek, dk, to, back = _ref(d)
    c = tp.encrypt(d["ek"], d["m"], d["r"])
    c2 = tp.encrypt(d["ek"], d["k"], d["r"])
    cl, c2l = to(c, 2 * BITS), to(c2, 2 * BITS)
    assert list(tp.ciphertext_add(d["ek"], c, c2)) == back(rp.ciphertext_add(ek, cl, c2l))
    assert (list(tp.ciphertext_add_plain(d["ek"], c, d["k"]))
            == back(rp.ciphertext_add_plain(ek, cl, to(d["k"], BITS))))
    got = tp.ciphertext_mul_plain(d["ek"], c, d["k"], ebits=256)
    assert list(got) == back(rp.ciphertext_mul_plain(ek, cl, to(d["k"], 256), ebits=256))
    # homomorphic: Dec(c^k (+) k) = m k + k mod n
    want = [(int(mv) * int(kv) + int(kv)) % int(n) for mv, kv, n in zip(d["m"], d["k"], d["ns"])]
    assert list(tp.decrypt(d["dk"], tp.ciphertext_add_plain(d["ek"], got, d["k"]))) == want


def test_mta_paillier_decrypt_ints_equal_reference(setup):
    """A [2, S] batch of ciphertexts under the [S] keys (the dk broadcast)."""
    from tpu_mpc.mta import mta as rmta
    from tpu_mpc_torch.mta import mta as tmta
    from tpu_mpc_torch.paillier import paillier as tp

    d = setup
    rp, ek, dk, to, back = _ref(d)
    m2 = np.stack([d["m"], d["k"]])
    c = np.stack([tp.encrypt(d["ek"], m2[i], d["r"]) for i in range(2)])
    want = rmta.paillier_decrypt_ints(dk, c, (2, S), bits=BITS)
    got = tmta.paillier_decrypt_ints(d["dk"], c, (2, S), bits=BITS)
    assert got.shape == want.shape == (2, S)
    assert got.tolist() == want.tolist() == m2.tolist()

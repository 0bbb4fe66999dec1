"""The port's class group (host/class_group.py) and CCLST'19
(protocols/cclst19/batch.py) held exactly against the reference package's,
run live: both are pure python on both sides (the reference's modules
import no jax), so every form, ciphertext, proof and signature must be
equal on the same draws.  The draws of tests/test_cclst.py: disc -71 for
the group laws, the 600-bit test discriminant, SessionRng(0xCC) and (0xCD);
the protocol at S = 1."""

import pytest

DISC_BITS = 600
SEED = b"t"


def _f(form):
    return (form.a, form.b, form.c)


def _ct(ct):
    return (_f(ct.c1), _f(ct.c2))


@pytest.fixture(scope="module")
def groups():
    from tpu_mpc.host import class_group as rcg
    from tpu_mpc_torch.host import class_group as tcg

    return rcg.CLGroup.from_seed(SEED, DISC_BITS), tcg.CLGroup.from_seed(SEED, DISC_BITS)


def test_class_group_laws_equal_reference():
    from tpu_mpc.host import class_group as rcg
    from tpu_mpc_torch.host import class_group as tcg

    f, i = tcg.prime_form(-71, 3), tcg.identity(-71)
    assert tcg.compose(i, f) == tcg.reduce_form(f)
    assert tcg.pow_form(f, 7) == i                     # h(-71) = 7
    assert tcg.compose(f, tcg.inverse(f)) == i
    assert tcg.compose(tcg.compose(f, f), f) == tcg.compose(f, tcg.compose(f, f))
    rf = rcg.prime_form(-71, 3)
    assert _f(f) == _f(rf)
    for e in range(-8, 9):
        assert _f(tcg.pow_form(f, e)) == _f(rcg.pow_form(rf, e))
    assert _f(tcg.square(f)) == _f(rcg.square(rf))
    for a in (2, 3, 5, 7, 11):
        for n in (3, 5, 15, 71, 1021):
            assert tcg._kronecker(a, n) == rcg._kronecker(a, n)
    for a, p in ((2, 17), (3, 13), (10, 1009)):
        assert tcg._sqrt_mod(a, p) == rcg._sqrt_mod(a, p)


def test_hsmcl_equal_reference(groups):
    """Group setup, keygen, encrypt/decrypt, eval_sum/eval_scal and the CLDL
    proof (and its rejection of a bad response) on the same draws."""
    from tpu_mpc.host import class_group as rcg
    from tpu_mpc.utils.rng import SessionRng as RRng
    from tpu_mpc_torch.host import class_group as tcg
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.utils.rng import SessionRng

    rg, g = groups
    assert (g.dk, g.dq, _f(g.gq), g.stilde, g.q) == (rg.dk, rg.dq, _f(rg.gq), rg.stilde, rg.q)
    rng, rrng = SessionRng(0xCC), RRng(0xCC)
    sk, pk = g.keygen(rng)
    rsk, rpk = rg.keygen(rrng)
    assert (sk, _f(pk)) == (rsk, _f(rpk))
    m = 0x123456789ABCDEF
    ct, rho = g.encrypt(pk, m, rng)
    rct, rrho = rg.encrypt(rpk, m, rrng)
    assert (_ct(ct), rho) == (_ct(rct), rrho)
    assert g.decrypt(sk, ct) == m
    ct2, _ = g.encrypt(pk, 55, rng)
    rct2, _ = rg.encrypt(rpk, 55, rrng)
    assert _ct(g.eval_sum(ct, ct2)) == _ct(rg.eval_sum(rct, rct2))
    assert g.decrypt(sk, g.eval_sum(ct, ct2)) == (m + 55) % g.q
    assert _ct(g.eval_scal(ct, 3)) == _ct(rg.eval_scal(rct, 3))
    assert g.decrypt(sk, g.eval_scal(ct, 3)) == (m * 3) % g.q
    X = hec.mul(m)
    proof = tcg.cldl_prove(g, pk, ct, X, m, rho, rng)
    rproof = rcg.cldl_prove(rg, rpk, rct, X, m, rrho, rrng)
    assert ((_f(proof.t1), _f(proof.t2), proof.T, proof.u_r, proof.u_m)
            == (_f(rproof.t1), _f(rproof.t2), rproof.T, rproof.u_r, rproof.u_m))
    assert tcg.cldl_verify(g, pk, ct, X, proof)
    bad = tcg.CLDLProof(proof.t1, proof.t2, proof.T, proof.u_r + 1, proof.u_m)
    assert not tcg.cldl_verify(g, pk, ct, X, bad)


def test_cclst_keygen_and_sign_equal_reference():
    """keygen(1) and sign at the 600-bit discriminant: every session field,
    form, ciphertext, r and s equal; the port's signature valid, low s."""
    from tpu_mpc.protocols.cclst19 import batch as rcc
    from tpu_mpc.utils.rng import SessionRng as RRng
    from tpu_mpc_torch.host import ec as hec
    from tpu_mpc_torch.protocols.cclst19 import batch as tcc
    from tpu_mpc_torch.utils.rng import SessionRng

    rng, rrng = SessionRng(0xCD), RRng(0xCD)
    ss = tcc.keygen(1, rng, disc_bits=DISC_BITS)
    rss = rcc.keygen(1, rrng, disc_bits=DISC_BITS)
    for s, r in zip(ss, rss):
        assert s.ok and r.ok
        assert ((s.x1, s.x2, s.Q1, s.Q2, s.sk, _f(s.pk), _ct(s.c_key), s.pubkey)
                == (r.x1, r.x2, r.Q1, r.Q2, r.sk, _f(r.pk), _ct(r.c_key), r.pubkey))
        assert s.pubkey == hec.mul(s.x1 * s.x2 % hec.N)
    sigs = tcc.sign(ss, 0xFEEDFACE, rng)
    rsigs = rcc.sign(rss, 0xFEEDFACE, rrng)
    assert [(g.r, g.s, g.valid) for g in sigs] == [(g.r, g.s, g.valid) for g in rsigs]
    assert all(g.valid and g.s <= hec.N // 2 for g in sigs)

"""Each committed key set is a valid t-of-n GG20 key set: the shares x of
any t + 1 parties interpolate to the secret sum(u), whose point is the sum
of the committed y_i; each x_j matches the Feldman commitments; p, q and
the safe primes of N~ pass Miller-Rabin."""

import itertools
import json
import os
import random

import pytest

from portbench.keys import make_keys
from portbench.reference import secp256k1 as ec

KEYS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "keys")


def lagrange_at_zero(ids, shares):
    s = 0
    for i, xi in zip(ids, shares):
        num = den = 1
        for j in ids:
            if j != i:
                num = num * j % ec.N
                den = den * (j - i) % ec.N
        s = (s + xi * num * pow(den, -1, ec.N)) % ec.N
    return s


def check_key_set(d):
    t, n, bits = d["t"], d["n"], d["bits"]
    u, x = d["u"][0], d["x"][0]
    y_i = [tuple(p) for p in d["y_i"][0]]
    vss = [[tuple(p) for p in row] for row in d["vss"][0]]
    assert len(u) == len(x) == len(y_i) == len(vss) == n and all(len(r) == t + 1 for r in vss)
    secret = sum(u) % ec.N
    y = None
    for yi in y_i:
        y = ec.add(y, yi)
    assert ec.g_comb().mul(secret) == y
    for i in range(n):
        assert ec.g_comb().mul(u[i]) == y_i[i] == vss[i][0]
    for ids in itertools.combinations(range(1, n + 1), t + 1):
        assert lagrange_at_zero(ids, [x[i - 1] for i in ids]) == secret
    # fewer than t + 1 shares do not give the secret
    assert lagrange_at_zero(range(1, t + 1), x[:t]) != secret
    for j in range(n):
        want = None
        for row in vss:
            for k, C in enumerate(row):
                want = ec.add(want, ec.mul(pow(j + 1, k, ec.N), C))
        assert ec.g_comb().mul(x[j]) == want
    rnd = random.Random(1)
    for i in range(n):
        p, q, P, Q = d["p"][0][i], d["q"][0][i], d["nt_p"][0][i], d["nt_q"][0][i]
        for v in (p, q, P, Q, (P - 1) // 2, (Q - 1) // 2):
            assert make_keys.is_probable_prime(v, rnd, rounds=24)
        assert (p * q).bit_length() == bits == (P * Q).bit_length() == d["nt"][0][i].bit_length()
        assert d["nt"][0][i] == P * Q and p != q and P != Q
        h1, h2, m = d["h1"][0][i], d["h2"][0][i], P * Q
        assert 1 < h1 < m and 1 < h2 < m and h1 != h2


@pytest.mark.parametrize("name", sorted(make_keys.KEY_SETS))
def test_committed_key_set_is_valid(name):
    with open(os.path.join(KEYS, f"{name}.json")) as fh:
        d = json.load(fh)
    t, n, seed = make_keys.KEY_SETS[name]
    assert (d["t"], d["n"], d["seed"], d["bits"]) == (t, n, seed, 2048)
    check_key_set(d)


def test_the_generator_is_seeded(tiny_material):
    assert make_keys.make_material(1, 3, 768, 0x7E57) == tiny_material
    check_key_set(tiny_material)
    assert not make_keys.is_probable_prime(561, random.Random(2))         # Carmichael
    assert not make_keys.is_probable_prime(tiny_material["nt"][0][0], random.Random(2))

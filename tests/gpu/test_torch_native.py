"""The port's native host layer (tpu_mpc_torch/native/) on the CPU: its own
copies of the reference's C++ helpers (primegen.cpp, hostmul.cpp over GMP),
built with g++ into build/tpu_mpc_torch/, against their plain python
versions and against the reference's helpers (tpu_mpc.native, tpu_mpc.core.
modctx) on the same inputs; the unseeded prime route; and the loader, which
raises instead of falling back when a compiler or library is missing.
OpenSSL's verifier is tests/gpu/test_torch_verify.py's, the native
layer's imports tests/gpu/test_torch_imports.py's."""

import os
import random
import re

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("bits,seeds", [(256, (1, 2, 3, 0x2017)), (512, (1, 12345))])
def test_seeded_primes_equal_plain_and_reference(bits, seeds):
    from tpu_mpc.native import primegen as ref
    from tpu_mpc_torch import native
    from tpu_mpc_torch.host import primes

    for seed in seeds:
        p = native.primegen.gen_prime(bits, seed)
        assert p == primes._helper_gen_prime(bits, seed) == ref.gen_prime(bits, seed)
        assert p.bit_length() == bits and primes.is_probable_prime(p)
    rng_a, rng_b = random.Random(bits), random.Random(bits)
    assert primes.gen_prime(bits, rng_a) == ref.gen_prime(bits, rng_b.getrandbits(64))


def test_seeded_safe_primes_equal_plain_and_reference():
    from tpu_mpc.native import primegen as ref
    from tpu_mpc_torch import native
    from tpu_mpc_torch.host import primes

    for seed in (1, 2, 7):
        p = native.primegen.gen_safe_prime(256, seed)
        assert p == primes._helper_gen_safe_prime(256, seed) == ref.gen_safe_prime(256, seed)
        assert native.primegen.is_safe_prime((p - 1) // 2, seed)
    rng_a, rng_b = random.Random(11), random.Random(11)
    assert primes.gen_safe_prime(256, rng_a) == ref.gen_safe_prime(256, rng_b.getrandbits(64))


def test_unseeded_primes_take_os_candidates_and_native_tests(monkeypatch):
    """No rng: every candidate and every witness seed comes from secrets,
    the python splitmix64 is never built, the helper's tests run, and the
    primes pass."""
    import secrets

    from tpu_mpc_torch import native
    from tpu_mpc_torch.host import primes

    def refuse(*a, **kw):
        raise AssertionError("an unseeded prime draw reached the 64-bit splitmix64 state")

    calls = {"os": 0, "is_prime": 0, "is_safe_prime": 0}
    real_bits = secrets.randbits

    def os_bits(k):
        calls["os"] += 1
        return real_bits(k)

    def spy(name):
        real = getattr(native.primegen, name)

        def run(*a):
            calls[name] += 1
            return real(*a)
        return staticmethod(run)

    monkeypatch.setattr(primes, "_SplitMix64", refuse)
    monkeypatch.setattr(secrets, "randbits", os_bits)
    for name in ("is_prime", "is_safe_prime"):
        monkeypatch.setattr(native.primegen, name, spy(name))
    got = [primes.gen_prime(256), primes.gen_prime(512, random.SystemRandom())]
    safe = primes.gen_safe_prime(256)
    assert [p.bit_length() for p in got] == [256, 512] and safe.bit_length() == 256
    assert all(primes.is_probable_prime(p) for p in got + [safe, (safe - 1) // 2])
    assert calls["is_prime"] >= 2 and calls["is_safe_prime"] >= 1
    # one draw of candidate bits and one of witness seed per test
    assert calls["os"] == 2 * (calls["is_prime"] + calls["is_safe_prime"])


def _ints(rng, shape, bits):
    n = int(np.prod(shape))
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = int.from_bytes(rng.bytes(bits // 8), "big")
    return out.reshape(shape)


@pytest.fixture
def gmp_calls(monkeypatch):
    """Counts the port's calls into the GMP helper."""
    from tpu_mpc_torch import native

    calls = []
    for name in ("mulmod_batch", "prodmod_axis0"):
        real = getattr(native.hostmul, name)

        def run(*a, _real=real, _name=name):
            calls.append(_name)
            return _real(*a)
        monkeypatch.setattr(native.hostmul, name, staticmethod(run))
    return calls


def _loop(monkeypatch, fn):
    """fn() with the GMP route closed: the python loop's values."""
    from tpu_mpc_torch.core import modctx as tm

    with monkeypatch.context() as m:
        m.setattr(tm, "NATIVE_MIN_LANES", 1 << 62)
        return fn()


def _cases():
    rng = np.random.default_rng(0x6A9)
    out = {}
    for bits in (2048, 4096):
        mod = _ints(rng, (64,), bits) | 1
        a, b, c = (_ints(rng, (64,), bits - 1) for _ in range(3))
        out[f"B64_{bits}"] = ((a, b, mod), True)
        out[f"B64_{bits}_k3"] = ((a, b, c, mod), True)
    a = _ints(rng, (4, 16), 2048)
    row = _ints(rng, (1, 16), 2048) | 1
    out["broadcast"] = ((a, _ints(rng, (16,), 1024), row), True)    # [4, 16] x [16] mod [1, 16]
    out["scalar_mod"] = ((a, 2 ** 521 - 1), True)
    neg = _ints(rng, (64,), 2048)
    neg[5] = -neg[5]
    out["negative"] = ((neg, a.reshape(-1), _ints(rng, (64,), 2048) | 1), False)
    out["B31"] = ((_ints(rng, (31,), 2048), _ints(rng, (31,), 2048), _ints(rng, (31,), 2048) | 1),
                  False)
    return out


@pytest.mark.parametrize("name", list(_cases()))
def test_host_mulmod_native_equals_loop_and_reference(name, monkeypatch, gmp_calls):
    from tpu_mpc.core import modctx as rm
    from tpu_mpc_torch.core import modctx as tm

    args, on_gmp = _cases()[name]
    got = tm.host_mulmod(*args)
    assert gmp_calls == (["mulmod_batch"] if on_gmp else [])
    want = _loop(monkeypatch, lambda: tm.host_mulmod(*args))
    assert got.shape == want.shape == np.asarray(rm.host_mulmod(*args)).shape
    assert got.tolist() == want.tolist() == np.asarray(rm.host_mulmod(*args)).tolist()


@pytest.mark.parametrize("S,J,bits", [(4, 16, 4096), (64, 1, 2048), (31, 1, 2048), (2, 8, 2048)])
def test_host_prod_axis0_native_equals_loop_and_reference(S, J, bits, monkeypatch, gmp_calls):
    from tpu_mpc.core import modctx as rm
    from tpu_mpc_torch.core import modctx as tm

    rng = np.random.default_rng(S * J)
    vals, row = _ints(rng, (S, J), bits), _ints(rng, (1, J), bits) | 1
    got = tm.host_prod_axis0(vals, row)
    assert gmp_calls == (["prodmod_axis0"] if S * J >= 32 else [])
    want = _loop(monkeypatch, lambda: tm.host_prod_axis0(vals, row))
    assert got.shape == want.shape == (1, J)
    assert got.tolist() == want.tolist() == np.asarray(rm.host_prod_axis0(vals, row)).tolist()


def test_zero_modulus_raises_as_the_loop_does(monkeypatch, gmp_calls):
    from tpu_mpc_torch.core import modctx as tm

    rng = np.random.default_rng(0)
    a, mod = _ints(rng, (64,), 2048), _ints(rng, (64,), 2048) | 1
    mod[9] = 0
    for fn in (lambda: tm.host_mulmod(a, a, mod),
               lambda: tm.host_prod_axis0(a.reshape(2, 32), mod[:32].reshape(1, 32))):
        with pytest.raises(ZeroDivisionError):
            fn()
        with pytest.raises(ZeroDivisionError):
            _loop(monkeypatch, fn)
    assert gmp_calls == []


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The native loader with nothing loaded and an empty build directory."""
    from tpu_mpc_torch import native

    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    return native


def test_missing_compiler_raises(fresh_loader, monkeypatch):
    native = fresh_loader
    monkeypatch.setattr(native, "GXX", "no-such-g++")
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.primegen.gen_prime(256, 1)
    assert not os.path.exists(native.BUILD_DIR) or not os.listdir(native.BUILD_DIR)


def test_missing_libraries_raise(fresh_loader, monkeypatch, tmp_path):
    import ctypes.util

    native = fresh_loader
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    missing = str(tmp_path / "libgmp.so.10")
    monkeypatch.setattr(native, "GMP_PATH", missing)
    with pytest.raises(RuntimeError, match=re.escape(missing)):
        native.hostmul.mulmod_batch([b"\x01" * 8], b"\x07" * 8, 1, 8)
    maps = tmp_path / "maps"
    maps.write_text("00400000-00452000 r-xp 00000000 08:02 173521 /usr/bin/python3\n")
    monkeypatch.setattr(native, "PROC_MAPS", str(maps))
    with pytest.raises(RuntimeError, match="libcrypto not found"):
        native.openssl.verifier()


def test_failed_build_raises_with_the_command(fresh_loader, monkeypatch, tmp_path):
    native = fresh_loader
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "HERE", str(tmp_path))
    monkeypatch.setattr(native, "SOURCES", {"primegen": "bad.cpp"})
    with pytest.raises(RuntimeError, match="bad.cpp"):
        native.lib("primegen")


def test_plain_versions_stay_off_the_main_path():
    """The python verifier and the python prime draws are called only by
    the tests and chip_smoke.py: no module of the port names them outside
    the module that defines them."""
    pkg = os.path.join(REPO, "tpu_mpc_torch")
    defs = {"ecdsa_verify_batch_plain": "host/ec.py", "_helper_gen_prime": "host/primes.py",
            "_helper_gen_safe_prime": "host/primes.py"}
    for root, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(root, f)
            rel = os.path.relpath(path, pkg)
            with open(path) as fh:
                text = fh.read()
            for name, home in defs.items():
                assert name not in text or rel == home, (name, rel)

"""The session's JitMapGuard (tests/gpu/conftest.py): installed for every
test, it checks the process's mapped areas where jax is about to compile a
program, drops the compiled programs above its share of the kernel's
limit and leaves them alone under it; a drop in the middle of nested
compilations leaves every result right."""

import importlib.util
import os

import numpy as np

_CONFTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "conftest.py")


def _conftest():
    spec = importlib.util.spec_from_file_location("gpu_conftest_probe", _CONFTEST)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _compile_many(n, start=0):
    """n distinct programs, one compilation each; their results."""
    import jax
    import jax.numpy as jnp

    out = []
    for i in range(start, start + n):
        x = jnp.arange(i + 3, dtype=jnp.int32)
        out.append(int(jax.jit(lambda x, i=i: jnp.sum(jnp.cumsum(x) * (i + 2)))(x)))
    return out


def _expected(n, start=0):
    return [int(np.sum(np.cumsum(np.arange(i + 3)) * (i + 2))) for i in range(start, start + n)]


def test_guard_is_installed_for_the_session(request):
    from jax._src.interpreters import pxla

    guard = request.config.pluginmanager.get_plugin("jit-map-guard")
    assert type(guard).__name__ == "JitMapGuard"
    assert 0.5 < guard.share < 1
    assert guard._real is not None and pxla._cached_compilation is not guard._real


def test_guard_drops_compiled_programs_only_above_its_share(request, monkeypatch):
    mod = _conftest()
    assert mod._map_limit() > 0
    # the session's guard must not drop while this test counts areas
    monkeypatch.setattr(request.config.pluginmanager.get_plugin("jit-map-guard"), "share", 2.0)
    before = mod._mapped_areas()
    _compile_many(60)
    grown = mod._mapped_areas()
    assert grown >= before + 60                    # each program maps areas
    keep = mod.JitMapGuard(share=1.0)
    keep.check()
    assert keep.drops == 0 and mod._mapped_areas() >= grown - 10   # under: kept
    drop = mod.JitMapGuard(share=0.0)
    drop.check()
    assert drop.drops == 1 and mod._mapped_areas() <= grown - 60   # over: unmapped


def test_drops_before_every_compilation_keep_results_right():
    """share 0: the guard drops every compiled program before each
    compilation, inside jit calls, nested jits and eager ops alike."""
    import jax
    import jax.numpy as jnp
    from jax._src.interpreters import pxla

    mod = _conftest()
    session = pxla._cached_compilation
    guard = mod.JitMapGuard(share=0.0)
    guard.install()
    try:
        assert _compile_many(8, start=100) == _expected(8, start=100)

        @jax.jit
        def outer(x):
            return jax.jit(lambda y: y * 3)(x) + jnp.flip(x)

        x = jnp.arange(17, dtype=jnp.int32)
        for n in (17, 9, 17):
            got = np.asarray(outer(x[:n]))
            assert np.array_equal(got, np.arange(n) * 3 + np.arange(n)[::-1])
        assert int(jnp.asarray(np.int32(5)) + jnp.int32(6)) == 11
    finally:
        guard.uninstall()
    assert guard.drops >= 8
    assert pxla._cached_compilation is session

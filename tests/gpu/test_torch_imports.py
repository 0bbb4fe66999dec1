"""The port stands alone: importing tpu_mpc_torch (every module, the runtime's
CLIs included) pulls in neither jax, nor any tpu_mpc module, nor the
cryptography package; its native host layer (tpu_mpc_torch/native/) imports
the standard library only and loads none of tpu_mpc/native/'s libraries;
and the default device is the card (no silent CPU)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PROBE = r"""
import sys, pkgutil, importlib
import tpu_mpc_torch
for m in pkgutil.walk_packages(tpu_mpc_torch.__path__, "tpu_mpc_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "tpu_mpc", "cryptography"))
print("BAD", bad)
"""


def test_port_imports_no_jax_no_reference():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_chip_smoke_imports_no_jax_no_reference():
    probe = ("import sys, runpy; sys.argv = ['chip_smoke.py', '--help'];\n"
             "import importlib.util as u\n"
             "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
             "m = u.module_from_spec(spec); spec.loader.exec_module(m)\n"
             "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
             "or k == 'tpu_mpc' or k.startswith('tpu_mpc.')]\n"
             "print('BAD', sorted(bad))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_native_layer_imports_nothing_but_the_standard_library():
    """native/__init__.py and host/primes.py (what a spawned prime worker
    imports) pull in no torch, numpy, jax or tpu_mpc module; after the
    helpers run, no library of tpu_mpc/native/ is mapped."""
    probe = ("import sys, random\n"
             "from tpu_mpc_torch import native\n"
             "from tpu_mpc_torch.host import primes\n"
             "primes.gen_primes_parallel(256, 2, random.Random(1), workers=1)\n"
             "native.hostmul.mulmod_batch([b'\\x03' * 8], b'\\x07' * 8, 1, 8)\n"
             "native.openssl.verifier().close()\n"
             "bad = sorted(k for k in sys.modules\n"
             "             if k.split('.')[0] in ('torch', 'numpy', 'jax', 'tpu_mpc'))\n"
             "maps = open('/proc/self/maps').read()\n"
             "print('BAD', bad, 'REF_SO', 'tpu_mpc/native/' in maps,\n"
             "      'PORT_SO', 'tpu_mpc_torch/libprimegen-' in maps)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD [] REF_SO False PORT_SO True" in out.stdout, out.stdout


def test_kernel_ab_imports_no_jax_no_reference():
    """kernel_ab.py (the card's A/B timing of K1 and K2) stands alone too,
    and refuses to run without a card."""
    probe = ("import sys, importlib.util as u\n"
             "spec = u.spec_from_file_location('kernel_ab', 'kernel_ab.py')\n"
             "m = u.module_from_spec(spec); spec.loader.exec_module(m)\n"
             "import torch\n"
             "rc = m.main() if not torch.cuda.is_available() else 1\n"
             "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.') "
             "or k == 'tpu_mpc' or k.startswith('tpu_mpc.')]\n"
             "print('BAD', sorted(bad), 'RC', rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", probe, "."], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD [] RC 1" in out.stdout, out.stdout

def test_default_device_is_cuda_and_raises_without_it():
    import torch

    from tpu_mpc_torch.core.modctx import ModCtx
    from tpu_mpc_torch.device import resolve_device
    from tpu_mpc_torch.ec import secp256k1 as ec

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        ModCtx.from_ints([23], 256)
    with pytest.raises(RuntimeError, match="CUDA"):
        ec.generator((2,))
    assert resolve_device("cpu").type == "cpu"


def test_cli_without_a_card_fails_instead_of_running_on_the_cpu(tmp_path):
    """`cli keygen` without --device asks for the card: with none it exits
    non-zero with resolve_device's message before it touches the relay."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "tpu_mpc_torch.runtime.cli", "keygen",
                          "-a", "http://127.0.0.1:9", "-i", "1", "-t", "1", "-n", "3",
                          "-o", str(tmp_path / "local1.json"), "--paillier-bits", "768"],
                         env=env, cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr, out.stderr
    assert "Traceback" not in out.stderr and not (tmp_path / "local1.json").exists()


def test_kernel_build_targets_hopper():
    from tpu_mpc_torch import kernels

    for name, (src, _) in kernels.SOURCES.items():
        assert os.path.exists(os.path.join(kernels.CSRC, src))
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert kernels.BUILD_DIR == os.path.join(REPO, "build", "tpu_mpc_torch")
    assert set(kernels.LAUNCHES) == {"K1", "K2", "K3", "K4", "K5"}
    # K1 and K2 share the Montgomery multiply's header: editing it rebuilds both
    assert "rns_field.cuh" in kernels.SOURCES["rns"][1]
    assert "rns_field.cuh" in kernels.SOURCES["rns_fixed"][1]


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A tensor on any device but the CPU goes to the kernel or raises: a
    non-CUDA device (meta here) must raise, never fall back."""
    import torch

    from tpu_mpc_torch.core import pallas_rns
    from tpu_mpc_torch.ec import pallas_ec

    m = lambda *shape: torch.zeros(shape, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="K1"):
        pallas_rns.exp_call(m(4, 16), m(4, 8), m(1, 3 * 37), 256)
    with pytest.raises(ValueError, match="K2"):
        pallas_rns.fixed_call(m(4, 2), m(4), m(1, 3 * 38),
                              [torch.zeros((4, 16, 1, 38), dtype=torch.int32, device="meta")],
                              [4], [0], 256)
    with pytest.raises(ValueError, match="K3"):
        pallas_ec.ladder_call(m(4, 1, 3, 16), m(4, 2, 33), m(4, 2))
    with pytest.raises(ValueError, match="K4"):
        pallas_ec.comb_call(m(4, 32), m(32, 256, 2, 16))
    with pytest.raises(ValueError, match="K5"):
        pallas_ec.affine_call(m(4, 3, 16))

"""The port's native host helpers, loaded with ctypes (port of
tpu_mpc/native/__init__.py, plus the OpenSSL verifier of
tpu_mpc/host/ec.py):

  primegen  primegen.cpp: host/primes.py's seeded prime draws, and the
            Miller-Rabin tests of its unseeded search;
  hostmul   hostmul.cpp over GMP (libgmp.so.10): core/modctx.py's batched
            modular products;
  openssl   OpenSSL's libcrypto: host/ec.py's secp256k1 ECDSA verification.

Each C++ source compiles with g++ into a library of its own,

    g++ -O2 -shared -fPIC -o build/tpu_mpc_torch/lib<name>-<hash>.so
        tpu_mpc_torch/native/<name>.cpp [<path of libgmp.so.10> -lpthread]

at first use, from the source in the checkout; nothing is built or loaded
when this module is imported.  The file name carries a hash of the source,
and the compiler writes a temporary file that os.replace puts in place, so
processes that build at once (test workers, prime workers) do no harm.

There is no fallback: a missing compiler, libgmp or libcrypto, a failed
build, or an error code from a helper raises, naming what it sought.

Standard library only, as kernels.py, whose build directory it shares:
host/primes.py's spawned prime workers import these two modules and
nothing else of the package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib
import os
import shutil
import subprocess
import threading

from ..kernels import BUILD_DIR  # the CUDA kernels' build directory

HERE = os.path.dirname(os.path.abspath(__file__))
GXX = "g++"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
# where libgmp.so.10 lies when ctypes.util.find_library("gmp") finds none
GMP_PATH = "/usr/lib/x86_64-linux-gnu/libgmp.so.10"
PROC_MAPS = "/proc/self/maps"
NID_SECP256K1 = 714

SOURCES = {"primegen": "primegen.cpp", "hostmul": "hostmul.cpp"}

_M64 = (1 << 64) - 1
_VP, _CP, _I, _L, _U64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
                          ctypes.c_uint64)

# library -> {function: (argtypes, restype)}; every pointer comes back as
# c_void_p, since the default int restype would cut it to 32 bits
_SIGNATURES = {
    "primegen": {
        "tpu_mpc_gen_prime": ([_I, _U64, _CP], _I),
        "tpu_mpc_gen_safe_prime": ([_I, _U64, _CP], _I),
        "tpu_mpc_is_prime": ([_CP, _I, _U64], _I),
        "tpu_mpc_is_safe_prime": ([_CP, _I, _U64], _I),
    },
    "hostmul": {
        "tpu_mpc_mulmod_batch": ([_CP, _I, _CP, _CP, _L, _L], _I),
        "tpu_mpc_prodmod_axis0": ([_CP, _L, _CP, _CP, _L, _L], _I),
    },
    "crypto": {
        "EC_GROUP_new_by_curve_name": ([_I], _VP),
        "EC_GROUP_free": ([_VP], None),
        "EC_POINT_new": ([_VP], _VP),
        "EC_POINT_free": ([_VP], None),
        "EC_POINT_set_affine_coordinates": ([_VP, _VP, _VP, _VP, _VP], _I),
        "EC_KEY_new": ([], _VP),
        "EC_KEY_set_group": ([_VP, _VP], _I),
        "EC_KEY_set_public_key": ([_VP, _VP], _I),
        "EC_KEY_check_key": ([_VP], _I),
        "EC_KEY_free": ([_VP], None),
        "BN_bin2bn": ([_CP, _I, _VP], _VP),
        "BN_free": ([_VP], None),
        "ECDSA_SIG_new": ([], _VP),
        "ECDSA_SIG_set0": ([_VP, _VP, _VP], _I),
        "ECDSA_SIG_free": ([_VP], None),
        "ECDSA_do_verify": ([_CP, _I, _VP, _VP], _I),
        "ERR_clear_error": ([], None),
    },
}

_lock = threading.Lock()
_LIBS: dict = {}


def gxx() -> str:
    """The path of the C++ compiler GXX."""
    path = shutil.which(GXX)
    if path is None:
        raise RuntimeError(f"native: the C++ compiler {GXX!r} is not on PATH")
    return path


def _mapped(name: str) -> str | None:
    """The path of a file mapped into this process whose name starts with
    `name` (PROC_MAPS), or None."""
    try:
        with open(PROC_MAPS) as f:
            for line in f:
                fields = line.split(maxsplit=5)
                if len(fields) == 6 and os.path.basename(fields[5].strip()).startswith(name):
                    return fields[5].strip()
    except OSError:
        return None
    return None


def gmp_path() -> str:
    """The path of libgmp: ctypes.util.find_library("gmp"), else GMP_PATH."""
    name = ctypes.util.find_library("gmp")
    if name:
        ctypes.CDLL(name)
        path = _mapped(os.path.basename(name))
        if path:
            return path
    if os.path.exists(GMP_PATH):
        return GMP_PATH
    raise RuntimeError(f"native: libgmp not found (ctypes.util.find_library('gmp') gave "
                       f"{name!r}, and {GMP_PATH} does not exist)")


def libcrypto_path() -> str:
    """The path of OpenSSL's libcrypto: ctypes.util.find_library("crypto"),
    else the libcrypto that `import _ssl` maps into this process."""
    name = ctypes.util.find_library("crypto")
    if name:
        ctypes.CDLL(name)
        return _mapped(os.path.basename(name)) or name
    try:
        import _ssl  # noqa: F401  (maps the libcrypto python's ssl module links)
    except ImportError:
        pass
    path = _mapped("libcrypto")
    if path is None:
        raise RuntimeError(f"native: libcrypto not found (ctypes.util.find_library('crypto') "
                           f"gave None, and no libcrypto is mapped in {PROC_MAPS} after "
                           f"import _ssl)")
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(HERE, SOURCES[name]), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build(name: str) -> str:
    """Compile SOURCES[name] unless it is built; returns the library's path."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    link = [gmp_path(), "-lpthread"] if name == "hostmul" else []
    cmd = [gxx(), *GXX_FLAGS, "-o", tmp, os.path.join(HERE, SOURCES[name]), *link]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native: `{' '.join(cmd)}` failed:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def lib(name: str):
    """The loaded library `name` ("primegen", "hostmul", or "crypto"),
    built first where it is one of SOURCES."""
    hit = _LIBS.get(name)
    if hit is not None:
        return hit
    with _lock:
        hit = _LIBS.get(name)
        if hit is None:
            hit = ctypes.CDLL(libcrypto_path() if name == "crypto" else build(name))
            for fn, (args, res) in _SIGNATURES[name].items():
                f = getattr(hit, fn)
                f.argtypes, f.restype = args, res
            _LIBS[name] = hit
    return hit


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native: {what} returned {rc}")


def _words(n: int, extra_bits: int = 0) -> int:
    """Bytes of whole 64-bit words holding n with `extra_bits` spare."""
    return max(1, (n.bit_length() + extra_bits + 63) // 64) * 8


class primegen:
    """The prime helper (primegen.cpp); widths 64 | bits, 128 <= bits <= 4096."""

    @staticmethod
    def gen_prime(bits: int, seed: int) -> int:
        buf = ctypes.create_string_buffer(bits // 8)
        _check(lib("primegen").tpu_mpc_gen_prime(bits, seed & _M64, buf),
               f"tpu_mpc_gen_prime({bits})")
        return int.from_bytes(buf.raw, "little")

    @staticmethod
    def gen_safe_prime(bits: int, seed: int) -> int:
        buf = ctypes.create_string_buffer(bits // 8)
        _check(lib("primegen").tpu_mpc_gen_safe_prime(bits, seed & _M64, buf),
               f"tpu_mpc_gen_safe_prime({bits})")
        return int.from_bytes(buf.raw, "little")

    @staticmethod
    def is_prime(n: int, seed: int) -> bool:
        """Trial division by the odd primes below 1000, then 28 Miller-Rabin
        rounds with witnesses from `seed`."""
        W = _words(n)
        rc = lib("primegen").tpu_mpc_is_prime(n.to_bytes(W, "little"), W, seed & _M64)
        if rc not in (0, 1):
            raise RuntimeError(f"native: tpu_mpc_is_prime returned {rc}")
        return rc == 1

    @staticmethod
    def is_safe_prime(q: int, seed: int) -> bool:
        """q and 2q + 1 through the safe-prime draw's double sieve and its
        Miller-Rabin rounds 2 (q), 2 (p), 26 (q), 26 (p), witnesses from
        `seed`; q odd, of at least 65 bits."""
        W = _words(q, 1)
        rc = lib("primegen").tpu_mpc_is_safe_prime(q.to_bytes(W, "little"), W, seed & _M64)
        if rc not in (0, 1):
            raise RuntimeError(f"native: tpu_mpc_is_safe_prime returned {rc}")
        return rc == 1


class hostmul:
    """GMP's batched modular products (hostmul.cpp).  Values are W-byte
    little-endian, W a multiple of 8; a modulus must not be 0."""

    @staticmethod
    def mulmod_batch(op_bufs: list, mod_buf: bytes, B: int, W: int) -> bytes:
        """out[b] = prod_i op_bufs[i][b] mod mod[b], as B values of W bytes."""
        out = ctypes.create_string_buffer(B * W)
        _check(lib("hostmul").tpu_mpc_mulmod_batch(b"".join(op_bufs), len(op_bufs), mod_buf,
                                                   out, B, W), "tpu_mpc_mulmod_batch")
        return out.raw

    @staticmethod
    def prodmod_axis0(vals_buf: bytes, S: int, mod_buf: bytes, J: int, W: int) -> bytes:
        """out[j] = prod_s vals[s, j] mod mod[j] over an [S, J] array, as J
        values of W bytes."""
        out = ctypes.create_string_buffer(J * W)
        _check(lib("hostmul").tpu_mpc_prodmod_axis0(vals_buf, S, mod_buf, out, J, W),
               "tpu_mpc_prodmod_axis0")
        return out.raw


def _bn(c, v: int):
    b = v.to_bytes(max(1, (v.bit_length() + 7) // 8), "big")
    bn = c.BN_bin2bn(b, len(b), None)
    if not bn:
        raise MemoryError("native: BN_bin2bn failed")
    return bn


class Secp256k1Verifier:
    """libcrypto's ECDSA verification on secp256k1: one EC_GROUP, and the
    EC_KEYs made from it, which close() frees (a context manager)."""

    def __init__(self):
        self._c = lib("crypto")
        self._group = self._c.EC_GROUP_new_by_curve_name(NID_SECP256K1)
        if not self._group:
            raise RuntimeError("native: EC_GROUP_new_by_curve_name(NID_secp256k1) failed")
        self._keys: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        for k in self._keys:
            self._c.EC_KEY_free(k)
        self._keys = []
        if self._group:
            self._c.EC_GROUP_free(self._group)
            self._group = None

    def key(self, x: int, y: int):
        """An EC_KEY for the point (x, y), or None where OpenSSL refuses it
        (a point off the curve once x and y are reduced mod p).  A negative
        coordinate is refused before OpenSSL sees it."""
        if x < 0 or y < 0:
            return None
        c, g = self._c, self._group
        pt = c.EC_POINT_new(g)
        if not pt:
            raise MemoryError("native: EC_POINT_new failed")
        try:
            bx, by = _bn(c, x), _bn(c, y)
            ok = c.EC_POINT_set_affine_coordinates(g, pt, bx, by, None) == 1
            c.BN_free(bx)
            c.BN_free(by)
            if not ok:
                c.ERR_clear_error()
                return None
            k = c.EC_KEY_new()
            if not k:
                raise MemoryError("native: EC_KEY_new failed")
            self._keys.append(k)
            if (c.EC_KEY_set_group(k, g) != 1 or c.EC_KEY_set_public_key(k, pt) != 1
                    or c.EC_KEY_check_key(k) != 1):
                c.ERR_clear_error()
                return None
            return k
        finally:
            c.EC_POINT_free(pt)

    def verify(self, key, digest: bytes, r: int, s: int) -> bool:
        """ECDSA_do_verify of (r, s) on `digest` under `key` == 1; a negative
        r or s is False before OpenSSL sees it."""
        if r < 0 or s < 0:
            return False
        c = self._c
        sig = c.ECDSA_SIG_new()
        if not sig:
            raise MemoryError("native: ECDSA_SIG_new failed")
        try:
            br, bs = _bn(c, r), _bn(c, s)
            if c.ECDSA_SIG_set0(sig, br, bs) != 1:
                c.BN_free(br)
                c.BN_free(bs)
                raise RuntimeError("native: ECDSA_SIG_set0 failed")
            ok = c.ECDSA_do_verify(digest, len(digest), sig, key) == 1
        finally:
            c.ECDSA_SIG_free(sig)
        if not ok:
            c.ERR_clear_error()
        return ok


class openssl:
    """OpenSSL's libcrypto (host/ec.py's verifier)."""

    verifier = Secp256k1Verifier

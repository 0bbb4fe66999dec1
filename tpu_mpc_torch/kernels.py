"""Build, load and count the hand-written CUDA kernels (csrc/).

Each source in csrc/ compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/tpu_mpc_torch/lib<name>-<hash>.so csrc/<name>.cu

The build happens at first use (or up front through build_all(), which
starts one nvcc per source in parallel), from the sources in the checkout,
into build/tpu_mpc_torch/ under the repository root.  The file name carries
a hash of the sources, so an edited kernel is rebuilt.  Nothing is built
or imported when this module is imported.

LAUNCHES counts the kernel launches per kernel: each wrapper adds one where
it launches its kernel, and nowhere else.  Under a sessions mesh
(sharding/mesh.py) a wrapper call launches one piece per mesh entry, and
each piece counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "tpu_mpc_torch")

# library name -> (source, headers it includes)
SOURCES = {
    "rns": ("rns_exp.cu", ("rns_field.cuh",)),
    "rns_fixed": ("rns_fixed.cu", ("rns_field.cuh",)),
    "ec": ("ec_kernels.cu", ("ec_field.cuh",)),
}

# -Xptxas -v: the build log reports each kernel's registers, stack and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0}

_LIBS: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit required to build the kernels)")


def _lib_path(name: str) -> str:
    src, hdrs = SOURCES[name]
    h = hashlib.sha256()
    for f in (src,) + tuple(hdrs):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all() -> dict:
    """Compile every source not yet built, one nvcc each, all at once.
    Returns {name: (seconds, compiler output)}; raises on a failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name][0])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    res = {}
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name][0]}:\n{log}")
        os.replace(tmp, out)
        res[name] = (time.perf_counter() - t0, log)
    return res


_VP = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_PU64 = ctypes.POINTER(ctypes.c_uint64)
_PI = ctypes.POINTER(ctypes.c_int)

_SIGNATURES = {
    "rns": {
        # x, e, ctx, ctx_per_lane, cst, planes, B, K, Kp, Lin, Lout, MT, KT,
        # ne2, invMA_r, invMB_r, emit_planes, tab_glob, out_cols, out_res, stream
        "k1_exp": [_VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _I, _I,
                   _I, _U, _U, _I, _VP, _VP, _VP, _VP],
        # B, K, Kp, Lin, Lout, MT, KT -> u32 words of K1's global window table
        "k1_tab_words": [_I, _I, _I, _I, _I, _I, _I],
    },
    "rns_fixed": {
        # e, ne2, grow, ctx, ctx_per_lane, cst, planes, B, K, Kp, Lin, Lout,
        # MT, KT, invMA_r, invMB_r, nbases, tabs (host), nwin (host),
        # woff (host), G, nsplit, partial, ticket, out_cols, stream
        "k2_fixed": [_VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I,
                     _I, _I, _U, _U, _I, _PU64, _PI, _PI, _I, _I, _VP, _VP, _VP, _VP],
    },
    "ec": {
        # pts, digits, neg, B, ns, out, stream
        "k3_glv_ladder": [_VP, _VP, _VP, _I, _I, _VP, _VP],
        # digits, planes (pallas_ec.comb_planes), B, out, stream
        "k4_comb": [_VP, _VP, _I, _VP, _VP],
        # pts, B, out, stream
        "k5_affine": [_VP, _I, _VP, _VP],
    },
}


def lib(name: str):
    """The loaded ctypes library `name`, built first if needed."""
    hit = _LIBS.get(name)
    if hit is not None:
        return hit
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all()
    so = ctypes.CDLL(path)
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(so, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = so
    return so


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream

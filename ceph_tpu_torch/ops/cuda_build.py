"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, into ``ops/build/`` (listed in
``.gitignore``).  The library's name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is loaded from
the build directory as it stands.  Nothing here runs at import.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points of each source: name -> argtypes (every entry returns the
# launch's cudaError_t as an int)
SIGNATURES = {
    "gf_apply": {
        "gf_apply_launch": [_P, _P, _P, _P, _I, _I, _L, _L, _P],
        "gf_apply_variant_launch": [_P, _P, _P, _P, _I, _I, _L, _L, _I, _I,
                                    _I, _P],
    },
    "xor_apply": {
        "xor_apply_launch": [_P, _P, _P, _I, _I, _L, _I, _P],
    },
    "crc32c": {
        "crc32c_rows_launch": [_P, _L, _I, _L, _P, _P, _P, _P, _P],
    },
    "crush_straw2": {
        "crush_straw2_launch": [_P, _L, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                _I, _P, _I, _P, _P, _P, _P, *[_I] * 11, _P],
    },
    "sweep_kernels": {
        "bitplane_apply_launch": [_P, _P, _P, _I, _I, _L, _I, _L, _I, _P],
        "copy_rows_launch": [_P, _P, _I, _I, _L, _L, _P],
    },
}

_libs: dict[str, ctypes.CDLL] = {}
_locks = {name: threading.Lock() for name in SIGNATURES}
# per source: {"seconds": build time (0.0 when loaded from the cache),
# "log": nvcc's output (registers, shared memory, spills)}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def _compile(name: str, out: str) -> dict:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(CSRC, f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)          # atomic: racing builders agree
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return {"seconds": time.perf_counter() - t0,
            "log": (proc.stdout + proc.stderr).strip()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if os.path.exists(path):
            build_info[name] = {"seconds": 0.0, "log": "cached"}
        else:
            build_info[name] = _compile(name, path)
        lib = ctypes.CDLL(path)
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def build_all() -> dict[str, dict]:
    """Build every source at once (one ``nvcc`` each, started together),
    load them, and return ``build_info``; a failed build raises."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES)) as pool:
        for fut in [pool.submit(load, n) for n in SIGNATURES]:
            fut.result()
    return dict(build_info)

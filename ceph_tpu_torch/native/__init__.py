"""ctypes bindings for the native runtime (``native/`` at the repo root).

The port's counterpart of the JAX package's binding of the same C++
sources.  The reference's plugin host is C++ loading plugin .so files via
dlopen (reference: src/erasure-code/ErasureCodePlugin.cc:126-184); the
native registry (native/src/registry.cc) implements that contract and
Python binds it with ctypes.  The same library carries the SIMD host codec
(``ec_apply_matrix``: GFNI/AVX-512, GFNI/AVX2 or AVX2 pshufb) and the
SSE4.2 crc32c (``ec_crc32c``) under ``gf.ref.apply_matrix_fast`` and
``backend.ecutil.crc32c``.  The batch queue (native/src/batch_queue.cc) is
the host side of the sidecar boundary: C++ producer threads coalesce
stripes and a Python callback (:class:`StripesOnDevice`) dispatches each
batch to ``gf_apply.cu``.

The sources build unchanged with ``make -C native BUILD=<dir>`` into this
package's own ``build/`` (gitignored), at first use, under an
inter-process lock: test workers build at once, and a library that one
process rewrites while another dlopens it crashes the second.  The
registry library gets its own SONAME (``LDFLAGS`` on make's command
line, registry target first), so ``libec_cpp_rs.so``'s dependency binds
to this registry even where the JAX package's registry, which has no
SONAME and the same file name, is loaded in the same process.

Without a C++ toolchain the host paths run their plain numpy versions;
:func:`status` says so and :data:`plain_calls` counts each such call.
"""
from __future__ import annotations

import ctypes as C
import fcntl
import os
import subprocess
import threading
import time

import numpy as np
import torch

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
REGISTRY_SONAME = "libec_registry.ceph_tpu_torch.so"
SIMD_NAMES = {0: "scalar", 1: "avx2", 2: "gfni+avx2", 3: "gfni+avx512"}

_lock = threading.Lock()
_built = False
_registry_lib: C.CDLL | None = None
_batch_lib: C.CDLL | None = None
#: the build's wall seconds (None until this process ran make) and the
#: error that kept the library from loading (None while none did)
build_info: dict = {"seconds": None, "error": None}
#: calls that ran a plain numpy version because the library is missing
plain_calls = {"crc32c": 0, "apply_matrix": 0}


def _make(*args: str) -> None:
    subprocess.run(["make", "-C", NATIVE_DIR, f"BUILD={BUILD_DIR}", *args],
                   check=True, capture_output=True, text=True)


def build(force: bool = False) -> str:
    """Run make into :data:`BUILD_DIR`; returns the build dir.

    make is the staleness check (a no-op when up to date), run once per
    process under a ``flock`` on ``BUILD_DIR/.lock``.  The registry is
    made first, alone, with its SONAME; the second make links
    ``libec_cpp_rs.so`` against it and builds the rest."""
    global _built
    with _lock:
        if _built and not force:
            return BUILD_DIR
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            t0 = time.perf_counter()
            _make(f"LDFLAGS=-shared -Wl,-soname,{REGISTRY_SONAME}",
                  os.path.join(BUILD_DIR, "libec_registry.so"))
            _make("-j4")
            build_info["seconds"] = time.perf_counter() - t0
        _built = True
    return BUILD_DIR


def registry_lib() -> C.CDLL:
    """The process-wide handle to this package's libec_registry.so (built
    on demand): the registry, the SIMD apply and the crc32c."""
    global _registry_lib
    if _registry_lib is not None:
        return _registry_lib
    build()
    with _lock:
        if _registry_lib is None:
            lib = C.CDLL(os.path.join(BUILD_DIR, "libec_registry.so"))
            lib.ec_simd_level.restype = C.c_int
            lib.ec_simd_level.argtypes = []
            lib.ec_crc32c.restype = C.c_uint32
            lib.ec_crc32c.argtypes = [C.c_uint32, C.c_void_p, C.c_size_t]
            lib.ec_apply_matrix.restype = C.c_int
            lib.ec_apply_matrix.argtypes = [
                C.c_void_p, C.c_int, C.c_int, C.c_void_p, C.c_void_p,
                C.c_size_t]
            lib.ec_registry_load.restype = C.c_int
            lib.ec_registry_load.argtypes = [C.c_char_p, C.c_char_p,
                                             C.c_char_p, C.c_int]
            lib.ec_registry_preload.restype = C.c_int
            lib.ec_registry_preload.argtypes = [C.c_char_p, C.c_char_p,
                                                C.c_char_p, C.c_int]
            lib.ec_registry_get.restype = C.POINTER(_CodecOps)
            lib.ec_registry_get.argtypes = [C.c_char_p]
            lib.ec_registry_count.restype = C.c_int
            lib.ec_registry_count.argtypes = []
            _registry_lib = lib
    return _registry_lib


def host_lib() -> C.CDLL | None:
    """:func:`registry_lib` for the host fast paths, or None once the
    build or the load has failed (the error is in :data:`build_info` and
    :func:`status`); the caller then runs its plain version and counts it
    with :func:`count_plain`."""
    if _registry_lib is not None:
        return _registry_lib
    if build_info["error"] is not None:
        return None
    try:
        return registry_lib()
    except subprocess.CalledProcessError as e:
        build_info["error"] = f"make failed ({e.returncode}): {e.stderr}"
    except OSError as e:
        build_info["error"] = f"{type(e).__name__}: {e}"
    return None


def count_plain(name: str) -> None:
    with _lock:
        plain_calls[name] += 1


def status() -> dict:
    """What loaded, from where, at which SIMD level (0 scalar, 1 avx2,
    2 gfni+avx2, 3 gfni+avx512), and the plain-path calls so far."""
    lib = host_lib()
    level = lib.ec_simd_level() if lib is not None else None
    return {"loaded": lib is not None,
            "path": (os.path.realpath(lib._name) if lib is not None
                     else None),
            "simd_level": level, "simd": SIMD_NAMES.get(level),
            "build_seconds": build_info["seconds"],
            "error": build_info["error"], "plain_calls": dict(plain_calls)}


class _CodecOps(C.Structure):
    _fields_ = [
        ("create", C.c_void_p),
        ("destroy", C.c_void_p),
        ("get_data_chunk_count", C.c_void_p),
        ("get_chunk_count", C.c_void_p),
        ("get_chunk_size", C.c_void_p),
        ("encode", C.c_void_p),
        ("decode", C.c_void_p),
        ("minimum_to_decode", C.c_void_p),
    ]


_CREATE = C.CFUNCTYPE(C.c_void_p, C.POINTER(C.c_char_p),
                      C.POINTER(C.c_char_p), C.c_int, C.c_char_p, C.c_int)
_DESTROY = C.CFUNCTYPE(None, C.c_void_p)
_GETINT = C.CFUNCTYPE(C.c_int, C.c_void_p)
_CHUNKSZ = C.CFUNCTYPE(C.c_uint, C.c_void_p, C.c_uint)
_ENCODE = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(C.c_ubyte),
                      C.POINTER(C.c_ubyte), C.c_size_t)
_DECODE = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(C.c_void_p), C.c_size_t,
                      C.POINTER(C.c_int), C.c_int)
_MINIMUM = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(C.c_int), C.c_int,
                       C.POINTER(C.c_int), C.c_int, C.POINTER(C.c_int),
                       C.c_int)


class NativeRegistry:
    """Binding for this package's libec_registry.so (the dlopen plugin
    host).  Plugins load from a named directory, else from the context's
    ``erasure_code_dir`` (a startup option, read here), else from
    :data:`BUILD_DIR`."""

    _instance = None
    _instance_lock = threading.Lock()

    def __init__(self, cct=None):
        if cct is None:
            from ..common.context import default_context
            cct = default_context()
        self.lib = registry_lib()
        self.directory = cct.conf.get("erasure_code_dir") or BUILD_DIR

    @classmethod
    def instance(cls) -> "NativeRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def load(self, name: str, directory: str | None = None) -> None:
        err = C.create_string_buffer(512)
        rc = self.lib.ec_registry_load(
            name.encode(), (directory or self.directory).encode(), err, 512)
        if rc != 0:
            raise IOError(rc, err.value.decode() or f"load {name} failed")

    def preload(self, names_csv: str, directory: str | None = None) -> None:
        err = C.create_string_buffer(512)
        rc = self.lib.ec_registry_preload(
            names_csv.encode(), (directory or self.directory).encode(), err,
            512)
        if rc != 0:
            raise IOError(rc, err.value.decode() or "preload failed")

    def count(self) -> int:
        return self.lib.ec_registry_count()

    def factory(self, name: str, profile: dict,
                directory: str | None = None) -> "NativeCodec":
        """registry.factory (ErasureCodePlugin.cc:92-120): load on demand,
        instantiate with the profile."""
        ops = self.lib.ec_registry_get(name.encode())
        if not ops:
            self.load(name, directory)
            ops = self.lib.ec_registry_get(name.encode())
        if not ops:
            raise IOError(f"plugin {name} not registered after load")
        return NativeCodec(ops.contents, profile)


class NativeCodec:
    """One codec instance behind the C vtable."""

    def __init__(self, ops: _CodecOps, profile: dict):
        self._create = _CREATE(ops.create)
        self._destroy = _DESTROY(ops.destroy)
        self._k_fn = _GETINT(ops.get_data_chunk_count)
        self._n_fn = _GETINT(ops.get_chunk_count)
        self._chunk_size = _CHUNKSZ(ops.get_chunk_size)
        self._encode = _ENCODE(ops.encode)
        self._decode = _DECODE(ops.decode)
        self._minimum = _MINIMUM(ops.minimum_to_decode)

        keys = (C.c_char_p * len(profile))(*[k.encode() for k in profile])
        vals = (C.c_char_p * len(profile))(
            *[str(v).encode() for v in profile.values()])
        err = C.create_string_buffer(256)
        self._h = self._create(keys, vals, len(profile), err, 256)
        if not self._h:
            raise ValueError(err.value.decode() or "codec init failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._destroy(h)
            self._h = None

    @property
    def k(self) -> int:
        return self._k_fn(self._h)

    @property
    def n(self) -> int:
        return self._n_fn(self._h)

    def get_chunk_size(self, object_size: int) -> int:
        return self._chunk_size(self._h, object_size)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data [k, chunk] uint8 -> parity [m, chunk]."""
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.ndim != 2 or data.shape[0] != self.k:
            raise ValueError(f"expected [{self.k}, chunk] data, got "
                             f"{list(data.shape)}")
        k, chunk = data.shape
        parity = np.zeros((self.n - k, chunk), dtype=np.uint8)
        rc = self._encode(
            self._h, data.ctypes.data_as(C.POINTER(C.c_ubyte)),
            parity.ctypes.data_as(C.POINTER(C.c_ubyte)), chunk)
        if rc != 0:
            raise IOError(rc, "encode failed")
        return parity

    def decode(self, chunks: dict, erasures: list[int],
               chunk_size: int) -> dict:
        """chunks: available chunk id -> [chunk] uint8; returns the
        reconstructed chunks for ``erasures``."""
        n = self.n
        bufs: list = [None] * n
        ptrs = (C.c_void_p * n)()
        for i, arr in chunks.items():
            arr = np.ascontiguousarray(arr, dtype=np.uint8)
            if arr.nbytes != chunk_size:
                raise ValueError(f"chunk {i} has {arr.nbytes} bytes, not "
                                 f"{chunk_size}")
            bufs[i] = arr
            ptrs[i] = arr.ctypes.data
        out = {}
        for e in erasures:
            buf = np.zeros(chunk_size, dtype=np.uint8)
            bufs[e] = buf
            ptrs[e] = buf.ctypes.data
            out[e] = buf
        er = (C.c_int * len(erasures))(*erasures)
        rc = self._decode(self._h, ptrs, chunk_size, er, len(erasures))
        if rc != 0:
            raise IOError(rc, "decode failed")
        return out

    def minimum_to_decode(self, erasures: list[int],
                          available: list[int]) -> list[int]:
        er = (C.c_int * len(erasures))(*erasures)
        av = (C.c_int * len(available))(*available)
        out = (C.c_int * self.k)()
        got = self._minimum(self._h, er, len(erasures), av, len(available),
                            out, self.k)
        if got < 0:
            raise IOError(got, "cannot decode")
        return list(out[:got])


_BATCH_FN = C.CFUNCTYPE(C.c_int, C.c_void_p, C.POINTER(C.c_ubyte),
                        C.POINTER(C.c_ubyte), C.c_size_t, C.c_size_t)
_DONE_FN = C.CFUNCTYPE(None, C.c_void_p, C.c_int)


def batch_lib() -> C.CDLL:
    """This package's libec_batch.so (built on demand)."""
    global _batch_lib
    build()
    with _lock:
        if _batch_lib is None:
            lib = C.CDLL(os.path.join(BUILD_DIR, "libec_batch.so"))
            lib.ec_batch_queue_create.restype = C.c_void_p
            lib.ec_batch_queue_create.argtypes = [
                C.c_int, C.c_int, C.c_size_t, C.c_size_t, _BATCH_FN,
                C.c_void_p]
            lib.ec_batch_queue_submit.restype = C.c_int
            lib.ec_batch_queue_submit.argtypes = [
                C.c_void_p, C.POINTER(C.c_ubyte), C.POINTER(C.c_ubyte),
                _DONE_FN, C.c_void_p]
            lib.ec_batch_queue_flush.restype = None
            lib.ec_batch_queue_flush.argtypes = [C.c_void_p]
            lib.ec_batch_queue_destroy.restype = None
            lib.ec_batch_queue_destroy.argtypes = [C.c_void_p]
            lib.ec_batch_queue_batches.restype = C.c_size_t
            lib.ec_batch_queue_batches.argtypes = [C.c_void_p]
            lib.ec_batch_queue_stripes.restype = C.c_size_t
            lib.ec_batch_queue_stripes.argtypes = [C.c_void_p]
            _batch_lib = lib
    return _batch_lib


class BatchQueue:
    """Binding for the stripe-batching dispatch queue (batch_queue.cc).

    ``fn(data, n_stripes, chunk) -> parity`` is the batched encode of
    ``data`` [n_stripes, k, chunk] uint8, a view of the queue's C buffer
    that lives only for the call; it returns [n_stripes * m, chunk] (or
    [n_stripes, m, chunk]) uint8.  It runs on the queue's C++ worker
    thread; an exception it raises fails the batch and re-raises at
    :meth:`flush`.  :class:`StripesOnDevice` is the card's callback.
    ``max_batch`` defaults to the option ``ec_batch_max_stripes``.
    """

    def __init__(self, k: int, m: int, chunk_size: int, fn,
                 max_batch: int | None = None):
        if max_batch is None:
            from ..common.context import default_context
            max_batch = default_context().conf.get("ec_batch_max_stripes")
        self.lib = batch_lib()
        self.k, self.m, self.chunk = k, m, chunk_size
        self.max_batch = max_batch
        self._err: list[BaseException] = []

        def trampoline(_ctx, data_p, parity_p, n_stripes, chunk):
            try:
                data = np.ctypeslib.as_array(
                    data_p, shape=(n_stripes, k, chunk))
                parity = np.ascontiguousarray(fn(data, n_stripes, chunk),
                                              dtype=np.uint8)
                if parity.size != n_stripes * m * chunk:
                    raise ValueError(f"callback returned {parity.shape}, "
                                     f"not [{n_stripes * m}, {chunk}]")
                C.memmove(parity_p, parity.ctypes.data, parity.nbytes)
                return 0
            except BaseException as e:      # noqa: BLE001 - crosses C ABI
                self._err.append(e)
                return -1
        self._trampoline = _BATCH_FN(trampoline)   # keep a reference
        self._done_keep: dict[int, tuple] = {}
        self._retired: list[int] = []
        self._q = self.lib.ec_batch_queue_create(
            k, m, chunk_size, max_batch, self._trampoline, None)

    def _reap(self) -> None:
        """Free retired per-stripe callbacks.  Only called where the worker
        is provably outside them (after flush's idle barrier, after
        destroy joins): freeing a CFUNCTYPE thunk from inside its own
        invocation is a use-after-free."""
        while self._retired:
            self._done_keep.pop(self._retired.pop(), None)

    def submit(self, data: np.ndarray, on_done=None) -> np.ndarray:
        """Queue one stripe [k, chunk]; returns the parity buffer [m,
        chunk] that is filled once the batch holding this stripe has run."""
        if not self._q:
            raise IOError("queue closed")
        data = np.ascontiguousarray(data, dtype=np.uint8)
        if data.shape != (self.k, self.chunk):
            raise ValueError(f"stripe {list(data.shape)} != "
                             f"[{self.k}, {self.chunk}]")
        parity = np.zeros((self.m, self.chunk), dtype=np.uint8)
        key = id(parity)

        def done(_ctx, rc):
            # the entry holding this callback's own thunk is NOT freed
            # here: it is marked for _reap at the next safe point
            self._retired.append(key)
            if on_done is not None:
                on_done(rc)
        cb = _DONE_FN(done)
        self._done_keep[key] = (data, parity, cb)
        rc = self.lib.ec_batch_queue_submit(
            self._q, data.ctypes.data_as(C.POINTER(C.c_ubyte)),
            parity.ctypes.data_as(C.POINTER(C.c_ubyte)), cb, None)
        if rc != 0:
            # never queued: its done callback never fires
            self._done_keep.pop(key, None)
            raise IOError("queue stopped")
        return parity

    def flush(self) -> None:
        if not self._q:
            raise IOError("queue closed")
        self.lib.ec_batch_queue_flush(self._q)
        self._reap()                 # idle barrier passed: thunks are quiet
        if self._err:
            errs, self._err = self._err, []
            if len(errs) == 1:
                raise errs[0]
            raise BaseExceptionGroup("batch dispatch failures", errs)

    @property
    def batches(self) -> int:
        return self.lib.ec_batch_queue_batches(self._q)

    @property
    def stripes(self) -> int:
        return self.lib.ec_batch_queue_stripes(self._q)

    def close(self) -> None:
        if getattr(self, "_q", None):
            self.lib.ec_batch_queue_destroy(self._q)   # joins the worker
            self._q = None
            self._reap()

    def __del__(self):
        self.close()


class StripesOnDevice:
    """The :class:`BatchQueue` callback onto a torch device: the batch
    [n, k, chunk] is viewed as the vertical layout [n*k, chunk], copied to
    the device and run through ``rs_kernels.gf_apply_stripes`` (stripes =
    n) against the parity matrix kept on the device; the parity [n*m,
    chunk] comes back to the host before the call returns.

    It runs on the queue's C++ thread, which PyTorch never saw, so the
    device and a stream of its own are named there.  The copy up reads
    the C buffer, which lives only for the call, and completes before the
    kernel is queued (a blocking copy); the copy down is synchronised
    before the trampoline's memmove.  ``device="cpu"`` runs the plain
    version (the CPU tests)."""

    def __init__(self, parity_mat: np.ndarray, device: str = "cuda"):
        from ..ops.codec import torch_device
        self.device = torch_device(device)
        self.mat = torch.from_numpy(np.ascontiguousarray(
            parity_mat, dtype=np.uint8)).to(self.device)
        self.m, self.k = self.mat.shape
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __call__(self, data: np.ndarray, n: int, chunk: int) -> np.ndarray:
        from ..ops import rs_kernels
        host = torch.from_numpy(data).view(n * self.k, chunk)
        if self.stream is None:
            return rs_kernels.gf_apply_stripes(self.mat, host, n).numpy()
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            rows = host.to(self.device)
            parity = rs_kernels.gf_apply_stripes(self.mat, rows, n)
            out = parity.to("cpu")
        self.stream.synchronize()
        return out.numpy()


__all__ = ["build", "registry_lib", "host_lib", "status", "count_plain",
           "plain_calls", "build_info", "NativeRegistry", "NativeCodec",
           "BatchQueue", "StripesOnDevice", "BUILD_DIR", "NATIVE_DIR",
           "SIMD_NAMES", "batch_lib"]

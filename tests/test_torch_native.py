"""The port's native runtime against the JAX package's.

The registry's dlopen contract (every case of tests/test_native.py's
TestRegistry, on the port's own build), the two registries side by side in
one process, the cpp_rs plugin bitwise against the JAX package's cpp_rs
and jax_rs (device=numpy) and the EC corpus, the SIMD apply and the SSE4.2
crc32c bitwise against the JAX package's numpy oracles and the port's
plain versions, the BatchQueue with the port's callback (on the CPU), and
the build under concurrent processes.
"""
import hashlib
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest

from ceph_tpu.backend import ecutil as jecutil
from ceph_tpu.gf import ref as jref
from ceph_tpu.plugins.registry import \
    ErasureCodePluginRegistry as JaxPluginRegistry
from ceph_tpu_torch import native
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.bench import ec_bench
from ceph_tpu_torch.gf import ref
from ceph_tpu_torch.native import BatchQueue, NativeRegistry, StripesOnDevice
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tests", "golden", "ec_corpus.json")
TECHNIQUES = ("reed_sol_van", "cauchy", "vandermonde_isa")
# jax_rs names ISA's Vandermonde "vandermonde"
JAX_RS_TECHNIQUE = {"reed_sol_van": "reed_sol_van", "cauchy": "cauchy",
                    "vandermonde_isa": "vandermonde"}


@pytest.fixture(scope="module")
def registry():
    native.build()
    return NativeRegistry.instance()


def payload(k, chunk, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(k, chunk), dtype=np.uint8)


def _port_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


# -- the build and the registry's dlopen contract ------------------------------

def test_status_names_the_port_build(registry):
    st = native.status()
    assert st["loaded"] and st["error"] is None
    assert st["path"] == os.path.realpath(
        os.path.join(native.BUILD_DIR, "libec_registry.so"))
    assert not st["path"].startswith(os.path.join(native.NATIVE_DIR, "build"))
    with open("/proc/cpuinfo") as f:
        flags = f.read()
    if re.search(r"\bavx2\b", flags):
        assert st["simd_level"] >= 1
    assert st["simd"] == native.SIMD_NAMES[st["simd_level"]]


class TestRegistry:
    def test_load_and_count(self, registry):
        registry.load("cpp_rs")
        assert registry.count() >= 1
        registry.load("cpp_rs")          # idempotent

    def test_factory_unknown_plugin(self, registry):
        with pytest.raises(IOError):
            registry.factory("does_not_exist", {})

    def test_wrong_version_rejected(self, registry):
        with pytest.raises(IOError) as ei:
            registry.load("badver")
        assert "version" in str(ei.value)

    def test_fail_to_initialize(self, registry):
        with pytest.raises(IOError) as ei:
            registry.load("failinit")
        assert "init of failinit failed" in str(ei.value)

    def test_fail_to_register(self, registry):
        with pytest.raises(IOError) as ei:
            registry.load("noreg")
        assert "register" in str(ei.value)

    def test_missing_entry_point(self, registry):
        with pytest.raises(IOError) as ei:
            registry.load("noentry")
        assert "__erasure_code_init" in str(ei.value)

    def test_bad_profile_rejected(self, registry):
        with pytest.raises(ValueError):
            registry.factory("cpp_rs", {"k": 300, "m": 2})
        with pytest.raises(ValueError):
            registry.factory("cpp_rs", {"k": 4, "m": 2,
                                        "technique": "nope"})

    def test_preload(self, registry):
        registry.preload("cpp_rs")


_TWO_REGISTRIES = """
import json, sys
import numpy as np
from ceph_tpu.native import NativeRegistry as JaxRegistry
from ceph_tpu_torch.native import NativeRegistry as PortRegistry
from ceph_tpu_torch import native
regs = {"jax": JaxRegistry(), "port": PortRegistry()}
before = {n: r.count() for n, r in regs.items()}
codecs, after = {}, {}
for name in sys.argv[1].split(","):
    codecs[name] = regs[name].factory("cpp_rs", {"k": 4, "m": 2})
    after[name] = {n: r.count() for n, r in regs.items()}
data = np.random.default_rng(0).integers(0, 256, (4, 4096), dtype=np.uint8)
same = bool(np.array_equal(codecs["jax"].encode(data),
                           codecs["port"].encode(data)))
with open("/proc/self/maps") as f:
    maps = sorted({line.split()[-1] for line in f if "libec_" in line})
print(json.dumps({"before": before, "after": after, "same": same,
                  "maps": maps}))
"""


@pytest.mark.parametrize("order", ["jax,port", "port,jax"])
def test_each_cpp_rs_registers_into_its_own_registry(registry, order):
    """The two packages' registries have the same file name; each
    package's libec_cpp_rs.so must bind to its own, whichever loads first."""
    proc = subprocess.run([sys.executable, "-c", _TWO_REGISTRIES, order],
                          cwd=ROOT, env=_port_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["before"] == {"jax": 0, "port": 0}
    first, second = order.split(",")
    assert out["after"][first] == {first: 1, second: 0}
    assert out["after"][second] == {"jax": 1, "port": 1}
    assert out["same"]
    port_dir = os.path.realpath(native.BUILD_DIR)
    jax_dir = os.path.join(native.NATIVE_DIR, "build")
    libs = {os.path.basename(p): [] for p in out["maps"]}
    for p in out["maps"]:
        libs[os.path.basename(p)].append(os.path.dirname(p))
    assert sorted(libs["libec_cpp_rs.so"]) == sorted([jax_dir, port_dir])
    assert sorted(libs["libec_registry.so"]) == sorted([jax_dir, port_dir])


_BUILD_PROBE = """
import json, sys
from ceph_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
st = native.status()
codec = native.NativeRegistry.instance().factory("cpp_rs", {"k": 2, "m": 1})
st["k"] = codec.k
print(json.dumps(st))
"""


def test_two_processes_build_one_fresh_dir(tmp_path):
    """Both processes build into the same new directory at once (the
    flock): both load the library and the plugin from it."""
    build_dir = str(tmp_path / "build")
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_PROBE,
                               build_dir], cwd=ROOT, env=_port_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    for st in outs:
        assert st["loaded"] and st["k"] == 2
        assert st["path"] == os.path.realpath(
            os.path.join(build_dir, "libec_registry.so"))
    # one of the two ran the build; the other waited and found it made
    assert sorted(os.listdir(build_dir)) == sorted(
        [".lock"] +
        [f"libec_{n}.so" for n in ("badver", "batch", "cpp_rs", "failinit",
                                   "noentry", "noreg", "registry")])


_NO_TOOLCHAIN = """
import json, sys
import numpy as np
from ceph_tpu_torch import native
from ceph_tpu_torch.backend import ecutil
from ceph_tpu_torch.gf import ref
native.BUILD_DIR = sys.argv[1]
crc = ecutil.crc32c(-1, b"123456789")
mat = np.array([[1, 2], [3, 4]], np.uint8)
out = ref.apply_matrix_fast(mat, np.arange(8, dtype=np.uint8).reshape(2, 4))
st = native.status()
st["crc"] = crc
st["apply"] = out.tolist()
st["plain"] = ref.apply_matrix(
    mat, np.arange(8, dtype=np.uint8).reshape(2, 4)).tolist()
print(json.dumps(st))
"""


def test_without_a_toolchain_the_plain_paths_run_and_show(tmp_path):
    """No make on the PATH: no library, and each host call that ran its
    plain version is counted in status()."""
    env = _port_env() | {"PATH": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", _NO_TOOLCHAIN,
                           str(tmp_path / "build")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    st = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not st["loaded"] and st["path"] is None
    assert st["simd_level"] is None and "make" in st["error"]
    assert st["plain_calls"] == {"crc32c": 1, "apply_matrix": 1}
    assert st["crc"] == jecutil.crc32c(-1, b"123456789")
    assert st["apply"] == st["plain"]


# -- cpp_rs through the plugin interface ---------------------------------------

def _plugins(technique, k, m, mapping=None):
    prof = {"k": str(k), "m": str(m), "technique": technique}
    if mapping:
        prof["mapping"] = mapping
    port = ErasureCodePluginRegistry.instance().factory("cpp_rs", "",
                                                        dict(prof))
    jreg = JaxPluginRegistry.instance()
    jcpp = jreg.factory("cpp_rs", "", dict(prof))
    jrs = jreg.factory("jax_rs", "", dict(
        prof, technique=JAX_RS_TECHNIQUE[technique], device="numpy"))
    return port, jcpp, jrs


def _lost_sets(n, m):
    return [(0,), (n - 1,), tuple(range(m)), tuple(range(n - m, n)),
            tuple(range(1, 2 * m, 2))[:m]]


@pytest.mark.parametrize("technique", TECHNIQUES)
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 4), (10, 4)])
def test_cpp_rs_matches_the_jax_package(technique, k, m):
    port, jcpp, jrs = _plugins(technique, k, m)
    n = k + m
    data = payload(1, 1000 * k + 37, seed=k * 31 + m)[0].tobytes()
    enc = port.encode(set(range(n)), data)
    for other in (jcpp, jrs):
        want = other.encode(set(range(n)), data)
        for i in range(n):
            assert np.array_equal(enc[i], np.asarray(want[i])), (other, i)
    for lost in _lost_sets(n, m):
        avail = {i: v for i, v in enc.items() if i not in lost}
        got = port.decode(set(range(n)), avail, enc[0].nbytes)
        want = jcpp.decode(set(range(n)), avail, enc[0].nbytes)
        for i in range(n):
            assert np.array_equal(got[i], enc[i]), (lost, i)
            assert np.array_equal(got[i], want[i]), (lost, i)
        assert bytes(port.decode_concat(avail))[:len(data)] == data
        want_read = set(lost) | {0}
        assert port.minimum_to_decode(want_read, set(avail)) == \
            jcpp.minimum_to_decode(want_read, set(avail))


@pytest.mark.parametrize("technique", TECHNIQUES)
def test_cpp_rs_mapping_matches_the_jax_package(technique):
    """mapping=_DDD_D remaps encode and decode as the JAX plugins do."""
    port, jcpp, jrs = _plugins(technique, 4, 2, mapping="_DDD_D")
    data = payload(1, 8192, seed=12)[0].tobytes()
    enc = port.encode(set(range(6)), data)
    for other in (jcpp, jrs):
        want = other.encode(set(range(6)), data)
        for i in range(6):
            assert np.array_equal(enc[i], np.asarray(want[i])), (other, i)
    for lost in ((0,), (1,), (0, 1), (1, 5), (0, 4)):
        avail = {i: v for i, v in enc.items() if i not in lost}
        assert bytes(port.decode_concat(avail))[:len(data)] == data, lost
        got = port.decode(set(range(6)), avail)
        want = jcpp.decode(set(range(6)), avail)
        for i in range(6):
            assert np.array_equal(got[i], want[i]), (lost, i)


with open(CORPUS) as _f:
    _CORPUS = json.load(_f)
_CPP_ENTRIES = sorted(n for n in _CORPUS["entries"] if n.startswith("cpp_rs/"))


def test_the_corpus_holds_two_cpp_rs_entries():
    assert len(_CPP_ENTRIES) == 2


@pytest.mark.parametrize("name", _CPP_ENTRIES,
                         ids=lambda n: n.replace("/", ":"))
def test_cpp_rs_replays_the_corpus(name):
    entry = _CORPUS["entries"][name]
    ec = ErasureCodePluginRegistry.instance().factory(
        "cpp_rs", "", dict(entry["profile"]))
    data = np.random.default_rng(_CORPUS["payload_seed"]).integers(
        0, 256, size=_CORPUS["payload_size"], dtype=np.uint8).tobytes()
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    enc = ec.encode(set(range(n)), data)
    assert len(enc) == len(entry["chunk_sha256"])
    for i_s, want in entry["chunk_sha256"].items():
        chunk = np.ascontiguousarray(enc[int(i_s)])
        assert chunk.nbytes == entry["chunk_size"]
        assert hashlib.sha256(chunk.tobytes()).hexdigest() == want, i_s
    avail = {i: v for i, v in enc.items() if i >= n - k}
    assert bytes(ec.decode_concat(avail))[:len(data)] == data


def test_threaded_cpp_rs_decodes():
    """Concurrent decodes through the codec's decode-table LRU."""
    ec = ErasureCodePluginRegistry.instance().factory(
        "cpp_rs", "", {"k": "4", "m": "2", "technique": "cauchy"})
    data = payload(1, 4096, seed=10)[0].tobytes()
    enc = ec.encode(set(range(6)), data)
    errors = []

    def worker(drop):
        try:
            for _ in range(50):
                avail = {i: v for i, v in enc.items() if i not in drop}
                dec = ec.decode(set(range(4)), avail, enc[0].nbytes)
                got = b"".join(dec[i].tobytes() for i in range(4))
                assert got[:len(data)] == data
        except BaseException as e:      # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=({a, b},))
               for a in range(3) for b in range(3, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]


@pytest.mark.parametrize("workload,extra", [
    ("encode", []), ("decode", ["--erased", "0", "--erased", "9"])])
def test_ec_bench_runs_cpp_rs(capsys, workload, extra):
    rc = ec_bench.main(["--plugin", "cpp_rs", "-P", "k=8", "-P", "m=4",
                        "--size", "1048576", "--iterations", "3",
                        "--workload", workload, *extra])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    seconds, kib = re.fullmatch(r"(\d+\.\d{6})\t(\d+)", lines[0]).groups()
    assert float(seconds) > 0 and int(kib) == 3 * 1024


# -- the SIMD apply and the SSE4.2 crc32c --------------------------------------

@pytest.mark.parametrize("n", [1, 15, 16, 17, 4095, (1 << 20) + 3])
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("r", [1, 4, 12])
def test_apply_matrix_fast_matches_the_oracle(r, k, n):
    rng = np.random.default_rng(r * 1000 + k * 10 + n % 7)
    mat = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    before = dict(native.plain_calls)
    got = ref.apply_matrix_fast(mat, data)
    assert native.plain_calls == before
    assert got.shape == (r, n) and got.dtype == np.uint8
    assert np.array_equal(got, jref.apply_matrix(mat, data))


@pytest.mark.parametrize("n", [1, 17, 4095, 65536])
def test_apply_matrix_fast_zero_rows(n):
    rng = np.random.default_rng(n)
    mat = rng.integers(0, 256, (6, 8), dtype=np.uint8)
    mat[[1, 4]] = 0
    mat[2, ::2] = 0
    data = rng.integers(0, 256, (8, n), dtype=np.uint8)
    got = ref.apply_matrix_fast(mat, data)
    assert np.array_equal(got, jref.apply_matrix(mat, data))
    assert not got[1].any() and not got[4].any()
    zero = np.zeros((3, 8), np.uint8)
    assert not ref.apply_matrix_fast(zero, data).any()


def test_apply_matrix_fast_refuses_a_mismatch():
    with pytest.raises(ValueError):
        ref.apply_matrix_fast(np.ones((2, 3), np.uint8),
                              np.ones((4, 16), np.uint8))


SEEDS = {"zero": 0, "minus_one": -1, "random": 0x9E3779B9}


@pytest.mark.parametrize("seed", SEEDS.values(), ids=SEEDS.keys())
def test_crc32c_every_length_to_4097(seed):
    buf = np.random.default_rng(seed & 0xFFFF).integers(
        0, 256, 4097, dtype=np.uint8)
    raw = buf.tobytes()
    before = dict(native.plain_calls)
    for n in range(4098):
        got = ecutil.crc32c(seed, raw[:n])
        assert got == jecutil.crc32c(seed, raw[:n]), n
        assert got == ecutil._crc32c_py(seed & 0xFFFFFFFF, raw[:n]), n
        assert got == ecutil.crc32c_plain(seed, buf[:n]), n
        if n % 97 == 1:
            assert got == ecutil.crc32c_zeros(seed, n) ^ \
                ecutil._crc32c_numpy(buf[:n]), n
    assert native.plain_calls == before


@pytest.mark.parametrize("seed", SEEDS.values(), ids=SEEDS.keys())
def test_crc32c_of_one_mib_and_five(seed):
    buf = np.random.default_rng(5).integers(0, 256, (1 << 20) + 5,
                                            dtype=np.uint8)
    got = ecutil.crc32c(seed, buf)
    assert got == jecutil.crc32c(seed, buf)
    assert got == ecutil.crc32c_plain(seed, buf)
    assert got == ecutil.crc32c(seed, buf.tobytes())


def _views():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, 10000, dtype=np.uint8)
    m2 = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    w32 = rng.integers(0, 2**32, 700, dtype=np.uint32)
    return {
        "bytes": a.tobytes(),
        "bytearray": bytearray(a.tobytes()),
        "memoryview": memoryview(a.tobytes())[13:9001],
        "memoryview_u32": memoryview(w32),
        "memoryview_strided": memoryview(a)[::3],
        "ndarray_stride3": a[5::3],
        "ndarray_transposed": m2.T,
        "ndarray_column_slice": m2[:, 7:50],
        "ndarray_u32": w32,
        "ndarray_empty": a[:0],
    }


@pytest.mark.parametrize("kind", list(_views()))
def test_crc32c_of_every_buffer_kind(kind):
    view = _views()[kind]
    flat = (np.ascontiguousarray(view).tobytes()
            if isinstance(view, np.ndarray) else bytes(view)
            if not isinstance(view, memoryview) else view.tobytes())
    for seed in SEEDS.values():
        got = ecutil.crc32c(seed, view)
        assert got == jecutil.crc32c(seed, flat)
        assert got == ecutil.crc32c_plain(
            seed, np.frombuffer(flat, dtype=np.uint8))


# -- the BatchQueue with the port's callback -----------------------------------

def _parity_mat(k, m):
    return RSCodec(k, m, technique="reed_sol_van", device="numpy").parity_mat


def test_batch_queue_parity_equals_the_host_codec_and_coalesces(registry):
    k, m, chunk, total = 4, 2, 256, 200
    pmat = _parity_mat(k, m)
    on_cpu = StripesOnDevice(pmat, "cpu")
    release = threading.Event()

    def held(data, n, c):
        release.wait(timeout=60)     # the first batch waits for the rest
        return on_cpu(data, n, c)

    q = BatchQueue(k, m, chunk, held, max_batch=64)
    stripes = [payload(k, chunk, seed=i) for i in range(total)]
    parities = [q.submit(s) for s in stripes]
    release.set()
    q.flush()
    assert q.stripes == total
    assert q.batches < total and q.batches <= 1 + -(-(total - 1) // 64)
    codec = registry.factory("cpp_rs", {"k": k, "m": m})
    for s, p in zip(stripes, parities):
        assert np.array_equal(p, codec.encode(s))
        assert np.array_equal(p, jref.apply_matrix(pmat, s))
    q.close()


def test_batch_queue_callback_error_reraises_at_flush(registry):
    def boom(data, n, c):
        raise RuntimeError("sidecar died")
    q = BatchQueue(2, 1, 64, boom, max_batch=8)
    q.submit(payload(2, 64))
    with pytest.raises(RuntimeError, match="sidecar died"):
        q.flush()
    q.flush()                        # reported once
    q.close()


def test_batch_queue_ten_thousand_submits_keep_every_thunk(registry):
    """Each stripe's done callback fires once with rc 0, and no thunk is
    freed while the worker may still call it."""
    k, m, chunk, total = 2, 1, 64, 10000
    pmat = _parity_mat(k, m)
    q = BatchQueue(k, m, chunk, StripesOnDevice(pmat, "cpu"), max_batch=256)
    done = []
    data = np.random.default_rng(7).integers(0, 256, (total, k, chunk),
                                             dtype=np.uint8)
    parities = [q.submit(d, on_done=done.append) for d in data]
    q.flush()
    assert done == [0] * total and q._done_keep == {}
    assert q.stripes == total and q.batches < total
    got = np.stack(parities).transpose(1, 0, 2).reshape(m, -1)
    want = jref.apply_matrix(pmat, data.transpose(1, 0, 2).reshape(k, -1))
    assert np.array_equal(got, want)
    q.close()


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def test_batch_queue_close_joins_the_worker(registry):
    before = _threads()
    q = BatchQueue(2, 1, 64, StripesOnDevice(_parity_mat(2, 1), "cpu"))
    assert _threads() == before + 1
    q.close()
    assert _threads() == before
    with pytest.raises(IOError, match="closed"):
        q.submit(payload(2, 64))
    q.close()                        # idempotent


def test_stripes_on_cuda_without_a_card_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        StripesOnDevice(_parity_mat(4, 2), "cuda")


# -- chip_smoke.py's phase native, rehearsed on the CPU ------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase_native_on_the_cpu(registry):
    """(a)-(f) with torch_rs and the queue's callback on the plain
    versions: every check of the phase runs, the ledger's cpu route books
    one gf_apply_stripes call a dispatch, and nothing launches."""
    from ceph_tpu_torch.ops import launch_ledger, rs_kernels
    CS = _chip_smoke()
    out, launches = CS.phase_native(
        rs_kernels, launch_ledger, ecutil, ref, ErasureCodePluginRegistry,
        native, device="cpu", stripes=32)
    assert launches == 0
    assert out["status"]["loaded"] and out["registry"]["count"] >= 1
    assert set(out["registry"]["refused"]) == set(CS.NATIVE_REFUSED)
    assert out["cpp_rs_vs_torch_rs"] == dict.fromkeys(TECHNIQUES, "bitwise")
    ns = out["north_star"]
    for key in ("cpp_rs_encode_MiBps", "cpp_rs_decode_MiBps",
                "torch_rs_encode_MiBps", "torch_rs_decode_MiBps"):
        assert ns[key] > 0, key
    bq = out["batch_queue"]
    assert bq["ledger_launches"] == sum(p["dispatches"] for p in bq["curve"])
    assert bq["curve"][0]["dispatches"] == 33
    assert out["host"]["bitwise"]
    assert out["host"]["plain_calls"] == {"crc32c": 0, "apply_matrix": 0}


def test_chip_smoke_host_cpu_reads_cpuinfo():
    model, avx2 = _chip_smoke().host_cpu()
    with open("/proc/cpuinfo") as f:
        text = f.read()
    assert model in text and avx2 == (" avx2" in text)


@pytest.mark.parametrize("status, message", [
    ({"loaded": False, "error": "make failed (2)"}, "not loaded"),
    ({"loaded": True, "simd_level": 0}, "scalar SIMD level"),
])
def test_chip_smoke_phase_build_fails_on_a_native_fault(
        monkeypatch, status, message):
    """Phase build stops the script when the native library did not load,
    or runs scalar on an avx2 host, before any phase runs over it."""
    CS = _chip_smoke()

    class NoNvcc:
        @staticmethod
        def build_all():
            return {}
    monkeypatch.setattr(native, "host_lib", lambda: None)
    monkeypatch.setattr(native, "status", lambda: status)
    monkeypatch.setattr(CS, "host_cpu", lambda: ("a cpu", True))
    with pytest.raises(AssertionError, match=message):
        CS.phase_build(NoNvcc, native)

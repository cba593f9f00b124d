"""The port's torch_rs plugin, its registry and the ec_bench CLI.

``torch_rs`` with ``device=cpu`` (the plain PyTorch versions) must
reproduce every ``jax_rs/*`` entry of the committed encoding corpus
(tests/golden/ec_corpus.json) byte for byte, decode them back, and agree
with the JAX plugin on routing and chained-repair coefficients.
"""
import hashlib
import io
import json
import os
import re
from contextlib import redirect_stdout

import numpy as np
import pytest

from ceph_tpu.bench import ec_bench as jax_ec_bench
from ceph_tpu.plugins import ErasureCodePluginRegistry as JaxRegistry
from ceph_tpu_torch import __version__
from ceph_tpu_torch.bench import ec_bench
from ceph_tpu_torch.plugins import DEVICE_THRESHOLD_BYTES
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

CORPUS = os.path.join(os.path.dirname(__file__), "golden", "ec_corpus.json")
with open(CORPUS) as f:
    C = json.load(f)
JAX_RS_ENTRIES = sorted(n for n in C["entries"] if n.startswith("jax_rs/"))


@pytest.fixture
def registry():
    return ErasureCodePluginRegistry()      # fresh, not the singleton


def _payload() -> bytes:
    rng = np.random.default_rng(C["payload_seed"])
    return rng.integers(0, 256, size=C["payload_size"],
                        dtype=np.uint8).tobytes()


def _torch_rs(registry, entry, device="cpu"):
    prof = dict(entry["profile"]) | {"device": device}
    return registry.factory("torch_rs", "", prof)


def test_corpus_has_eight_jax_rs_entries():
    assert len(JAX_RS_ENTRIES) == 8
    assert any("mapping=_DDD_D_" in n for n in JAX_RS_ENTRIES)


@pytest.mark.parametrize("name", JAX_RS_ENTRIES,
                         ids=lambda n: n.replace("/", ":"))
def test_corpus_digests_reproduced(registry, name):
    entry = C["entries"][name]
    ec = _torch_rs(registry, entry)
    assert ec.codec.device == "cpu"
    data = _payload()
    encoded = ec.encode(set(range(ec.get_chunk_count())), data)
    assert len(encoded) == len(entry["chunk_sha256"])
    for i_s, want in entry["chunk_sha256"].items():
        chunk = np.ascontiguousarray(encoded[int(i_s)])
        assert chunk.nbytes == entry["chunk_size"]
        assert hashlib.sha256(chunk.tobytes()).hexdigest() == want, \
            f"{name} chunk {i_s}"
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    avail = {i: v for i, v in encoded.items() if i >= n - k}
    assert bytes(ec.decode_concat(avail)[:len(data)]) == data


@pytest.mark.parametrize("technique", ["reed_sol_van", "vandermonde",
                                       "cauchy"])
def test_decode_matches_jax_rs(registry, technique):
    prof = {"k": "4", "m": "2", "technique": technique,
            "mapping": "_DDD_D"}
    ec = registry.factory("torch_rs", "", prof | {"device": "cpu"})
    jec = JaxRegistry().factory("jax_rs", "", prof | {"device": "jax"})
    data = np.random.default_rng(3).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()
    enc = ec.encode(set(range(6)), data)
    jenc = jec.encode(set(range(6)), data)
    for i in range(6):
        assert np.array_equal(enc[i], np.asarray(jenc[i]))
    for lost in ({0, 1}, {2, 5}, {3}):
        avail = {i: v for i, v in enc.items() if i not in lost}
        got = ec.decode(set(range(6)), avail)
        want = jec.decode(set(range(6)), avail)
        for i in range(6):
            assert np.array_equal(got[i], np.asarray(want[i]))
            assert np.array_equal(got[i], enc[i])
    assert ec.partial_sum_coefficients({0, 1}, [2, 3, 4, 5]) == \
        jec.partial_sum_coefficients({0, 1}, [2, 3, 4, 5])


def test_device_routing(registry):
    # cuda is the default: every call, however small, goes to the card
    dflt = registry.factory("torch_rs", "", {"k": "4", "m": "2"})
    assert dflt.device == "cuda" and dflt.codec.device == "cuda"
    assert dflt.device_codec(1) is dflt.codec
    assert dflt.device_codec(DEVICE_THRESHOLD_BYTES) is dflt.codec
    # the size split is only for a profile that asks for auto
    ec = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                           "device": "auto"})
    assert ec.device == "auto" and ec.codec.device == "cuda"
    assert ec.device_threshold == DEVICE_THRESHOLD_BYTES == 8 * 1024 * 1024
    assert ec.device_codec(DEVICE_THRESHOLD_BYTES - 1) is None
    assert ec.device_codec(DEVICE_THRESHOLD_BYTES) is ec.codec
    # small calls under auto go to the numpy host codec without a card
    data = b"\x07" * 4096
    enc = ec.encode(set(range(6)), data)
    ref = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                            "device": "numpy"})
    assert all(np.array_equal(enc[i], v)
               for i, v in ref.encode(set(range(6)), data).items())
    for key in ("device-threshold", "jax-threshold"):
        ec = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                               "device": "auto",
                                               key: "1000"})
        assert ec.device_threshold == 1000
        assert ec.device_codec(999) is None
        assert ec.device_codec(1000) is ec.codec
    cpu = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                            "device": "cpu"})
    assert cpu.device_codec(1) is cpu.codec
    assert ref.device_codec(1 << 30) is None


@pytest.mark.parametrize("profile", [
    {"device": "jax"}, {"w": "16"}, {"technique": "liberation"},
    {"k": "1"}, {"m": "0"}, {"mapping": "DD_"},
])
def test_bad_profiles_rejected(registry, profile):
    with pytest.raises(ValueError):
        registry.factory("torch_rs", "", {"k": "4", "m": "2"} | profile)


# -- registry ------------------------------------------------------------------

def test_registry_is_its_own_singleton():
    a = ErasureCodePluginRegistry.instance()
    assert a is ErasureCodePluginRegistry.instance()
    assert a is not JaxRegistry.instance()


def test_factory_profile(registry):
    ec = registry.factory("torch_rs", "", {"k": "4", "m": "2",
                                           "device": "numpy"})
    assert ec.get_chunk_count() == 6 and ec.get_data_chunk_count() == 4
    assert ec.get_profile()["plugin"] == "torch_rs"
    with pytest.raises(ValueError):
        registry.factory("torch_rs", "", {"plugin": "other"})
    registry.preload(["torch_rs"])
    with pytest.raises(ValueError, match="EEXIST"):
        registry.add("torch_rs", registry.get("torch_rs"))


def test_jax_plugin_names_are_not_the_ports(registry):
    with pytest.raises(FileNotFoundError, match="ENOENT"):
        registry.factory("jax_rs", "", {})
    with pytest.raises(FileNotFoundError, match="ENOENT"):
        registry.load("whatever", "/nonexistent/dir")


_GOOD_VERSION = f"def __erasure_code_version__():\n    return {__version__!r}\n"
BROKEN = {
    "missing_version": ("def __erasure_code_init__(name, directory):\n"
                        "    pass\n", "EXDEV"),
    "wrong_version": ("def __erasure_code_version__():\n"
                      "    return '0.0.0-not-this'\n", "0.0.0"),
    "missing_entry_point": (_GOOD_VERSION, "ENOENT"),
    "fail_to_initialize": (_GOOD_VERSION +
                           "def __erasure_code_init__(name, directory):\n"
                           "    raise RuntimeError('-ESRCH: init failed')\n",
                           "ESRCH"),
    "fail_to_register": (_GOOD_VERSION +
                         "def __erasure_code_init__(name, directory):\n"
                         "    pass\n", "EBADF"),
}


@pytest.mark.parametrize("name", sorted(BROKEN))
def test_broken_plugins(registry, tmp_path, name):
    body, match = BROKEN[name]
    (tmp_path / f"plugin_{name}.py").write_text(body)
    with pytest.raises(RuntimeError, match=match):
        registry.load(name, str(tmp_path))
    assert registry.get(name) is None


def test_directory_plugin_registers_in_loading_registry(registry, tmp_path):
    (tmp_path / "plugin_mine.py").write_text(
        "from ceph_tpu_torch.plugins.plugin_torch_rs import "
        "ErasureCodePluginTorchRS\n"
        "from ceph_tpu_torch.plugins.registry import "
        "ErasureCodePluginRegistry\n" + _GOOD_VERSION +
        "def __erasure_code_init__(name, directory):\n"
        "    ErasureCodePluginRegistry.instance().add(\n"
        "        name, ErasureCodePluginTorchRS())\n")
    ec = registry.factory("mine", str(tmp_path),
                          {"k": "3", "m": "2", "device": "numpy"})
    assert ec.get_chunk_count() == 5
    assert ErasureCodePluginRegistry.instance().get("mine") is None


# -- ec_bench CLI contract -----------------------------------------------------

_LINE = re.compile(r"^(\d+\.\d{6})\t(\d+)$")


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().strip().splitlines()


@pytest.mark.parametrize("extra,stripes", [
    ([], 1),
    (["--workload", "decode", "--erased", "0", "--erased", "5"], 1),
    (["--workload", "decode", "--erasures", "2"], 1),
    (["--workload", "decode", "--erasures", "2", "-E", "exhaustive"], 1),
    (["--batch", "3"], 3),
    (["--batch", "3", "--device-resident"], 3),
    (["--workload", "decode", "--erased", "1", "--erased", "4",
      "--batch", "2", "--device-resident"], 2),
])
def test_ec_bench_output_contract(extra, stripes):
    argv = ["--plugin", "torch_rs", "--size", "8192", "--iterations", "2",
            "-P", "k=4", "-P", "m=2", "-P", "device=cpu"] + extra
    rc, lines = _run(ec_bench.main, argv)
    assert rc == 0 and len(lines) == 1
    m = _LINE.match(lines[0])
    assert m, lines
    assert float(m.group(1)) > 0
    assert int(m.group(2)) == 2 * stripes * 8
    # same KiB column as the JAX package's CLI on the same flags
    jargv = [a.replace("torch_rs", "jax_rs").replace("device=cpu",
                                                     "device=numpy")
             for a in argv]
    jrc, jlines = _run(jax_ec_bench.main, jargv)
    assert jrc == 0 and jlines[0].split("\t")[1] == m.group(2)


def test_ec_bench_errors_exit_nonzero(capsys):
    assert ec_bench.main(["--plugin", "no_such_plugin"]) == 1
    assert ec_bench.main(["--plugin", "torch_rs", "-P", "device=tpu"]) == 1
    assert "ENOENT" in capsys.readouterr().err

"""The port's corpus generator (``ceph_tpu_torch/tools/gen_ec_corpus.py``)
on the CPU against the committed corpus, ``tests/golden/ec_corpus.json``.

With ``--device cpu`` (the plain PyTorch versions) every one of the 19
entries must come out with the committed chunk size and every chunk's
SHA-256.  The JAX package's generator is never run here: it rewrites
the committed file.
"""
import importlib.util
import json
from pathlib import Path

import pytest

from ceph_tpu_torch.tools import gen_ec_corpus

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden" / "ec_corpus.json"
with open(GOLDEN) as f:
    C = json.load(f)
NAMES = sorted(C["entries"])


@pytest.fixture(scope="module")
def root_tool():
    """The JAX package's generator, loaded for its constants only."""
    spec = importlib.util.spec_from_file_location(
        "root_gen_ec_corpus", ROOT / "tools" / "gen_ec_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    out = tmp_path_factory.mktemp("corpus") / "ec_corpus.json"
    assert gen_ec_corpus.main(["--out", str(out), "--device", "cpu"]) == 0
    return out


def test_nineteen_entries_under_the_reference_names(written):
    got = json.loads(written.read_text())
    assert len(NAMES) == 19
    assert sorted(got["entries"]) == NAMES
    assert (got["payload_seed"], got["payload_size"]) == \
        (C["payload_seed"], C["payload_size"])


@pytest.mark.parametrize("name", NAMES, ids=lambda n: n.replace("/", ":"))
def test_entry_reproduced(written, name):
    got = json.loads(written.read_text())["entries"][name]
    want = C["entries"][name]
    assert got["chunk_size"] == want["chunk_size"]
    assert got["chunk_sha256"] == want["chunk_sha256"], name
    assert (got["plugin"], got["profile"]) == \
        (want["plugin"], want["profile"])


def test_written_file_is_the_committed_file(written):
    assert written.read_bytes() == GOLDEN.read_bytes()


def test_profiles_payload_and_names_are_the_reference(root_tool):
    assert gen_ec_corpus.PROFILES == root_tool.PROFILES
    assert (gen_ec_corpus.PAYLOAD_SIZE, gen_ec_corpus.PAYLOAD_SEED) == \
        (root_tool.PAYLOAD_SIZE, root_tool.PAYLOAD_SEED)
    assert gen_ec_corpus.payload() == root_tool.payload()
    for plugin, profile in gen_ec_corpus.PROFILES:
        assert gen_ec_corpus.entry_name(plugin, profile) == \
            root_tool.entry_name(plugin, profile)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_port_profiles(device):
    """jax_rs runs as torch_rs, clay's scalar_mds likewise, and every
    plugin that takes a device key gets the device."""
    ported = [gen_ec_corpus.port_profile(p, prof, device)
              for p, prof in gen_ec_corpus.PROFILES]
    names = {name for name, _ in ported}
    assert names == {"torch_rs", "jerasure", "cpp_rs", "xor", "shec",
                     "lrc", "clay"}
    for name, prof in ported:
        assert (prof.get("device") == device) == \
            (name in gen_ec_corpus.DEVICE_PLUGINS)
        assert "jax_rs" not in prof.values()
    clay = dict(ported)["clay"]
    assert clay["scalar_mds"] == "torch_rs"


def test_out_is_required(capsys):
    with pytest.raises(SystemExit):
        gen_ec_corpus.main(["--device", "cpu"])
    assert "--out" in capsys.readouterr().err


def test_generate_keys_compare_with_the_committed_file():
    corpus = gen_ec_corpus.generate("cpu")
    assert corpus == C

"""The plain reference: against the golden corpus, against the port's
plain CPU path, and importing nothing of the program."""
import hashlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import gf256

CORPUS = harness.ROOT / "tests" / "golden" / "ec_corpus.json"


def test_reed_sol_van_chunks_match_the_golden_corpus():
    corpus = json.loads(CORPUS.read_text())
    entry = corpus["entries"]["jax_rs/k=8_m=4_technique=reed_sol_van"]
    k, m = 8, 4
    size = entry["chunk_size"]
    payload = np.random.default_rng(corpus["payload_seed"]).integers(
        0, 256, size=corpus["payload_size"], dtype=np.uint8)
    data = np.zeros(k * size, dtype=np.uint8)
    data[:payload.size] = payload
    data = data.reshape(k, size)
    parity = gf256.apply(gf256.reed_sol_van(k, m), data).numpy()
    chunks = list(data) + list(parity)
    got = {str(i): hashlib.sha256(c.tobytes()).hexdigest()
           for i, c in enumerate(chunks)}
    assert got == entry["chunk_sha256"]


@pytest.mark.parametrize("k,m,lost", [(8, 4, [0, 9]), (8, 4, [1, 9]),
                                      (8, 4, [3, 5, 8, 11]), (4, 2, [2])])
def test_reference_matches_the_ports_plain_path(k, m, lost):
    from ceph_tpu_torch.ops.codec import RSCodec
    codec = RSCodec(k, m, device="cpu")
    gen = torch.Generator().manual_seed(k * 100 + len(lost))
    stripes, chunk = 3, 512
    data = torch.randint(0, 256, (k, stripes * chunk), dtype=torch.uint8,
                         generator=gen)
    parity = gf256.reed_sol_van(k, m)
    assert torch.equal(codec.encode_device(data), gf256.apply(parity, data))
    survivors = [c for c in range(k + m) if c not in lost][:k]
    surv = torch.randint(0, 256, (stripes, k, chunk), dtype=torch.uint8,
                         generator=gen)
    got = codec.decode_batch_device(surv, survivors, lost)
    want = gf256.apply(gf256.recovery_matrix(parity, survivors, lost),
                       surv.transpose(0, 1).reshape(k, -1))
    assert torch.equal(got, want.view(len(lost), stripes, chunk)
                       .transpose(0, 1))


def test_recovery_restores_a_codeword():
    k, m = 8, 4
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (k, 1000), dtype=np.uint8)
    parity = gf256.reed_sol_van(k, m)
    chunks = np.concatenate([data, gf256.apply(parity, data).numpy()])
    lost = [0, 9]
    survivors = [c for c in range(k + m) if c not in lost][:k]
    rec = gf256.apply(gf256.recovery_matrix(parity, survivors, lost),
                      chunks[survivors]).numpy()
    assert np.array_equal(rec, chunks[lost])


def test_another_polynomial_gives_another_field():
    assert not np.array_equal(gf256.mul_table(0x11B), gf256.mul_table())
    table = gf256.mul_table()
    assert all(table[a, gf256.inverse(a)] == 1 for a in range(1, 256))


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.gf256; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    top = set(json.loads(out.stdout.replace("'", '"')))
    assert not top & {"ceph_tpu_torch", "ceph_tpu", "jax", "jaxlib"}

"""The sweep_stripes and path_shapes tools on the CPU: argument handling,
the variant list against the kernel source, and the launch shapes against
the JAX package's matrices.  Neither tool times anything without a card."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ceph_tpu.ops.codec import RSCodec as JRSCodec
from ceph_tpu_torch.tools import path_shapes, sweep_stripes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GF_SOURCE = os.path.join(ROOT, "ceph_tpu_torch", "ops", "csrc",
                         "gf_apply.cu")
SMEM_PER_SM = 228 * 1024          # H100: 227 KB a block, 228 KB an SM


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_sweep_stripes_needs_a_card(no_card, capsys):
    assert sweep_stripes.main(["--quick"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "cuda" in out.err


@pytest.mark.parametrize("argv", [["--stripes", "0"],
                                  ["--stripe-bytes", "12"],
                                  ["--stripe-bytes", "0"],
                                  ["--groups", "4"]])
def test_sweep_stripes_rejects_bad_arguments(no_card, argv):
    with pytest.raises(SystemExit) as exc:
        sweep_stripes.main(argv)
    assert exc.value.code == 2


def test_sweep_stripes_variants_are_built_and_fit():
    with open(GF_SOURCE) as f:
        built = {(int(s), int(u)) for s, u in
                 re.findall(r"GF_CASE\((\d+), (\d+)\)", f.read())}
    assert built
    for stages, runs, blocks in sweep_stripes.VARIANTS:
        assert (stages, runs) in built
        ring = stages * 4 * runs * 256 * 16     # KD rows x THREADS x 16 B
        tables = 8 * 4096                       # r <= 4, k = 8
        assert blocks * (ring + tables) <= SMEM_PER_SM
    assert set(sweep_stripes.QUICK_VARIANTS) <= set(sweep_stripes.VARIANTS)


def test_apply_variant_takes_only_cuda_tensors():
    mat = torch.ones((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="cuda"):
        sweep_stripes.apply_variant(mat, torch.zeros((8, 64), dtype=torch.uint8),
                                    1, 2, 1, 1)
    assert sweep_stripes.launches["gf_apply_variant"] == 0


def test_sweep_stripes_cli_without_a_card_prints_nothing():
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.sweep_stripes",
         "--quick", "--stripes", "2"], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""


def test_path_shapes_cli_without_a_card_exits_2():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "ceph_tpu_torch", "tools",
                                      "path_shapes.py")],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "cuda" in proc.stderr


def test_path_shapes_launch_shapes_match_the_jax_package():
    shapes = path_shapes.launch_shapes(path_shapes.load_package())
    assert [s["kernel"] for s in shapes] == (["gf_apply"] * 5
                                             + ["gf_apply_stripes"] * 2
                                             + ["xor_apply"] * 6
                                             + ["gf_apply"] * 14
                                             + ["crc32c_rows"] * 4
                                             + ["gf_apply"] * 3
                                             + ["crc32c_rows"]
                                             + ["gf_apply"] * 15
                                             + ["crc32c_rows"]
                                             + ["gf_apply"] * 6
                                             + ["crc32c_rows"]
                                             + ["gf_apply"] * 3
                                             + ["crc32c_rows"] * 2)
    ecutil, serving, headline = shapes[:3], shapes[3:5], shapes[5:7]
    jvan = JRSCodec(8, 4, technique="reed_sol_van", device="numpy")
    assert np.array_equal(ecutil[0]["mat"], jvan.parity_mat)
    assert np.array_equal(ecutil[1]["mat"], jvan.decode_matrix([0, 9])[0])
    assert np.array_equal(serving[0]["mat"], jvan.parity_mat)
    assert np.array_equal(serving[1]["mat"],
                          jvan.decode_matrix([0], list(range(1, 9)))[0])
    assert serving[0]["cols"] * 8 == 16 * 4 * 2**20
    jcau = JRSCodec(8, 4, technique="cauchy", device="numpy")
    assert np.array_equal(headline[0]["mat"], jcau.parity_mat)
    assert np.array_equal(headline[1]["mat"], jcau.decode_matrix([0, 9])[0])
    assert headline[0]["rows"] == 64 * 8 and headline[0]["stripes"] == 64
    xor = {(s["path"], s["label"]): s for s in shapes[7:13]}
    w16 = xor[("jerasure reed_sol_van_w16", "encode")]
    assert w16["mat"].shape == (64, 128) and int(w16["mat"].sum()) == 3928
    assert w16["rows"] * w16["cols"] == 64 * 4 * 2**20
    lib = xor[("jerasure liber8tion", "decode [3, 5]")]
    assert lib["mat"].shape == (16, 64) and lib["cols"] == 4 * 2**20
    repair = {s["label"]: s for s in shapes[13:27]}
    assert {s["path"] for s in repair.values()} == {"repair"}
    # recovery waves rebuild every missing row: {3} from 0-2, 4-8 and
    # {0, 9} from 1-8, each with 9-11
    assert np.array_equal(repair["wave want [3]"]["mat"], jvan.decode_matrix(
        [3, 9, 10, 11], [0, 1, 2, 4, 5, 6, 7, 8])[0])
    assert np.array_equal(repair["wave want [0, 9]"]["mat"],
                          jvan.decode_matrix([0, 9, 10, 11],
                                             list(range(1, 9)))[0])
    for label, r in (("chain hop [3]", 1), ("chain hop [0, 9]", 2)):
        assert repair[label]["mat"].shape == (r, 1)
        assert repair[label]["rows"] * repair[label]["cols"] == 32 * 2**20
    assert repair["pm_regen mbr encode"]["mat"].shape == (20, 9)
    assert repair["pm_regen mbr project"]["mat"].shape == (1, 4)
    assert repair["pm_regen mbr combine"]["mat"].shape == (4, 4)
    assert repair["pm_regen msr combine"]["mat"].shape == (2, 4)
    crc = shapes[27:31]
    assert [(s["rows"], s["cols"]) for s in crc] == [
        (12, 2**19), (8, 2**25), (4, 2**25), (2, 2**19)]
    # the OSD backend's: an op's encode and crc; a degraded read with 1
    # and 9 down rebuilds 1, 9, 10 and 11 from 0 and 2-8; a wave of the
    # 64 objects rebuilds 3 alone
    backend = {s["label"]: s for s in shapes[31:35]}
    assert {s["path"] for s in backend.values()} == {"backend"}
    assert np.array_equal(backend["op encode"]["mat"], jvan.parity_mat)
    assert np.array_equal(
        backend["degraded read [1, 9] down"]["mat"],
        jvan.decode_matrix([1, 9, 10, 11], [0, 2, 3, 4, 5, 6, 7, 8])[0])
    assert np.array_equal(backend["wave want [3]"]["mat"], jvan.decode_matrix(
        [3], [0, 1, 2, 4, 5, 6, 7, 8])[0])
    assert [(s["rows"], s["cols"]) for s in backend.values()] == [
        (8, 2**19), (8, 2**19), (8, 2**25), (12, 2**19)]
    # the MiniCluster's: the backend's per PG, so a repair wave holds one
    # to three objects of 512 Ki a chunk
    cluster = {s["label"]: s for s in shapes[35:51]}
    assert {s["path"] for s in cluster.values()} == {"cluster"}
    survivors = [0, 1, 2, 4, 5, 6, 7, 8]
    for label, want in (
            ("op encode", jvan.parity_mat),
            ("serving degraded get [1, 9] down",
             jvan.decode_matrix([1], [0, 2, 3, 4, 5, 6, 7, 8])[0]),
            ("wave of one object", jvan.decode_matrix([3], survivors)[0]),
            ("source check",
             jvan.decode_matrix([0, 3], [1, 2, 4, 5, 6, 7, 8, 9])[0]),
            ("wave of 3 objects", jvan.decode_matrix([3], survivors)[0]),
            ("spare equations, 2 objects",
             jvan.decode_matrix([3, 9, 10, 11], survivors)[0])):
        assert np.array_equal(cluster[label]["mat"], want), label
    assert [cluster[f"chain hop, {n} objects"]["cols"] for n in (2, 3)] \
        == [2**20, 3 * 2**19]
    assert sum(s["launches"] for s in cluster.values()
               if s["kernel"] == "gf_apply") == 906
    # the durable path's: the same cluster on durable stores; its repair
    # is one of the cluster path's chain cycles
    durable = {s["label"]: s for s in shapes[51:58]}
    assert {s["path"] for s in durable.values()} == {"durable"}
    for label, want in (
            ("op encode", jvan.parity_mat),
            ("degraded get [1, 9] down, store faults",
             jvan.decode_matrix([1, 9, 10, 11], [0, 2, 3, 4, 5, 6, 7, 8])[0]),
            ("wave of one object", jvan.decode_matrix([3], survivors)[0]),
            ("source check",
             jvan.decode_matrix([0, 3], [1, 2, 4, 5, 6, 7, 8, 9])[0])):
        assert np.array_equal(durable[label]["mat"], want), label
    for n in (2, 3):
        hop = durable[f"chain hop, {n} objects"]
        assert np.array_equal(hop["mat"],
                              cluster[f"chain hop, {n} objects"]["mat"])
        assert hop["launches"] == cluster[f"chain hop, {n} objects"][
            "launches"]
    assert [(s["rows"], s["cols"]) for s in durable.values()][-1] == \
        (12, 2**19)
    assert sum(s["launches"] for s in durable.values()
               if s["kernel"] == "gf_apply") == 160 + 60 + 15 + 165 + 152
    # the networked path's: the served cluster's puts (a, b, d), the
    # wire-mode bus's writes (e), the mux client's 64 KiB puts (c) and
    # the degraded gets (a)
    net = {s["label"]: s for s in shapes[58:]}
    assert {s["path"] for s in net.values()} == {"net"}
    assert np.array_equal(net["op encode"]["mat"], jvan.parity_mat)
    assert np.array_equal(net["mux put encode"]["mat"], jvan.parity_mat)
    assert np.array_equal(
        net["degraded get [1, 9] down"]["mat"],
        jvan.decode_matrix([1, 9, 10, 11], [0, 2, 3, 4, 5, 6, 7, 8])[0])
    assert [(s["rows"], s["cols"]) for s in net.values()] == [
        (8, 2**19), (8, 2**13), (8, 2**19), (12, 2**19), (12, 2**13)]
    assert [s["launches"] for s in net.values()] == [
        64 + 2 * 16 + 32 + 3 * 16 + 1, 256, 64, 177, 256]
    json.dumps([{k: v for k, v in s.items() if k != "mat"} for s in shapes])

"""The comparison that decides ``correct`` fails the control and each
fault a cell can have (``faults.py``), with the rest of the run as it
is: on the CPU at the tiny sizes, and on a card at the cell's own."""
import time

import pytest
import torch

from benchmark import faults, harness
from benchmark.reference import gf256
from benchmark.tests.common import TINY, rehearse


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", sorted(TINY))
def test_fault_is_not_correct(cell, fault):
    result = rehearse(cell, fault=fault, seed=2**31 + 21)
    assert not result["correct"], (fault, result["checks"])


def test_faults_are_removed_after_the_run():
    from ceph_tpu_torch.ops import rs_kernels
    real = rs_kernels.gf_apply
    rehearse("ec84_1m_resident", fault="control")
    assert rs_kernels.gf_apply is real


def test_faults_replace_both_wrappers_of_the_kernel():
    from ceph_tpu_torch.ops import rs_kernels
    real = {w: getattr(rs_kernels, w) for w in faults.WRAPPERS}
    mat = torch.from_numpy(gf256.reed_sol_van(4, 2))
    data = torch.randint(0, 256, (3 * 4, 40), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(5))
    undo = faults.install("control", 2**31 + 3)
    try:
        got = rs_kernels.gf_apply_stripes(mat, data, 3)
        assert rs_kernels.gf_apply is not real["gf_apply"]
    finally:
        undo()
    for s in range(3):
        want = gf256.apply(mat.numpy(), data[4 * s:4 * s + 4],
                           poly=faults.CONTROL_POLY)
        assert torch.equal(got[2 * s:2 * s + 2], want)
    assert torch.equal(rs_kernels.gf_apply_stripes(mat, data, 3)[:2],
                       gf256.apply(mat.numpy(), data[:4]))
    assert all(getattr(rs_kernels, w) is fn for w, fn in real.items())


def test_a_result_kept_from_a_call_before_is_not_correct(monkeypatch):
    """A product that hands back the output of an earlier call of the
    same shapes (a shared buffer, a memo) fails the resident cell's
    check, whose calls go round distinct input sets."""
    from ceph_tpu_torch.ops import rs_kernels
    real, memo = rs_kernels.gf_apply, {}

    def stale(mat, data):
        key = (tuple(mat.shape), tuple(data.shape))
        if key not in memo:
            memo[key] = real(mat, data)
        return memo[key]

    monkeypatch.setattr(rs_kernels, "gf_apply", stale)
    result = rehearse("ec84_1m_resident", seed=2**31 + 23)
    assert not result["correct"], result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_on_the_card_at_the_cells_size(card, cell, seed):
    result = harness.run(cell, seed, 5.0, False, time.monotonic(),
                         device=card, fault="control")
    assert not result["correct"], result["checks"]

"""RSCodec.decode_batch_device on the card, at the resident cell's shape.

The survivors [B, k', N] go to ``gf_apply_stripes`` as they lie, the
caller's order in the decode matrix's columns: one launch and no copy.
Held against the formulation that folded them first (a gather into the
matrix's order, [k, B*N], one ``gf_apply``, the unfold) and, at 16
stripes, against the plain version.

No JAX here: the tests marked ``card`` run on the card's machine, which
has no JAX, without the suite's ``conftest.py`` (it imports JAX):

    python -m pytest --noconftest tests/test_torch_decode_layout.py -m card
"""
from __future__ import annotations

import pytest
import torch

from ceph_tpu_torch.ops import rs_kernels
from ceph_tpu_torch.ops.codec import RSCodec

K, M, STRIPES, CHUNK = 8, 4, 256, 128 << 10
ERASURES = [0, 9]
ORDERS = {
    "cell": [1, 2, 3, 4, 5, 6, 7, 8],
    "permuted": [8, 3, 1, 7, 2, 6, 4, 5],
    "extras": [11, 1, 2, 3, 4, 5, 6, 7, 8, 10],
}


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _in_matrix_order(codec, stack, src):
    """``stack``'s rows gathered into the decode matrix's order, and the
    matrix (on the codec's device)."""
    D, src_expected = codec.decode_matrix_device(ERASURES, available=src)
    pos = {s: i for i, s in enumerate(src)}
    idx = torch.tensor([pos[s] for s in src_expected], device=stack.device)
    return D, torch.index_select(stack, 1, idx)


def _folded(codec, stack, src):
    """The formulation with the fold: gather, [k, B*N], gf_apply, unfold."""
    D, gathered = _in_matrix_order(codec, stack, src)
    b, k, n = gathered.shape
    rec = rs_kernels.gf_apply(
        D, gathered.transpose(0, 1).reshape(k, b * n).contiguous())
    return rec.reshape(len(ERASURES), b, n).transpose(0, 1)


def _device_kernels(fn):
    """Names of the device kernels and copies ``fn`` runs, as the
    profiler sees them after its primer."""
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.common import profiler_capture as pcm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler can drop the first device records of a window
        pcm.TorchProfiler().prime()
        fn()
        torch.cuda.synchronize()
    events, primer_end = [], 0
    for e in prof.profiler.kineto_results.events():
        on_card = str(e.device_type()).endswith("CUDA")
        start = int(e.start_ns())
        if e.name() == pcm.PRIMER_SPAN and not on_card:
            primer_end = max(primer_end, start + int(e.duration_ns()))
        elif on_card and not e.is_user_annotation():
            events.append((start, e.name()))
    return [name for start, name in events if start >= primer_end
            and "Sync" not in name and "Wait" not in name]


@pytest.mark.card
@pytest.mark.parametrize("order", sorted(ORDERS))
def test_decode_batch_device_matches_the_fold_at_the_cells_shape(card,
                                                                 order):
    src = ORDERS[order]
    codec = RSCodec(K, M, device=card)
    gen = torch.Generator(device=card).manual_seed(23)
    stack = torch.randint(0, 256, (STRIPES, len(src), CHUNK),
                          dtype=torch.uint8, device=card, generator=gen)
    before = dict(rs_kernels.launches)
    got = codec.decode_batch_device(stack, src, ERASURES)
    assert rs_kernels.launches["gf_apply_stripes"] == \
        before.get("gf_apply_stripes", 0) + 1
    assert rs_kernels.launches["gf_apply"] == before.get("gf_apply", 0)
    assert got.shape == (STRIPES, len(ERASURES), CHUNK)
    assert got.is_contiguous()
    assert torch.equal(got, _folded(codec, stack, src))
    names = _device_kernels(
        lambda: codec.decode_batch_device(stack, src, ERASURES))
    print(order, names)
    assert any("gf_apply_kernel" in n for n in names), names
    assert not [n for n in names if "copy" in n.lower()
                or n.startswith("Memcpy DtoD")], names

    few = stack[:16]
    got16 = codec.decode_batch_device(few, src, ERASURES)
    D, gathered = _in_matrix_order(codec, few.cpu(), src)
    want16 = rs_kernels.gf_apply_stripes_plain(
        D.cpu(), gathered.reshape(16 * K, CHUNK), 16)
    assert torch.equal(got16.cpu(), want16.view(16, len(ERASURES), CHUNK))
    assert codec.decode_relayouts == 0

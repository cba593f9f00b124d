"""The control and the faults, put in the program's place to show that
the comparison which decides ``correct`` fails them.

Each replaces both wrappers of ``gf_apply.cu``'s kernel in
``ceph_tpu_torch.ops.rs_kernels``, ``gf_apply`` and ``gf_apply_stripes``
(the vertical layout, S stripes a launch): the GF(2^8) product under
every encode and decode of both cells (``RSCodec``'s device calls and
the codec pipeline's dispatches look them up there at call time):

- ``control``: the plain reference computes the product in GF(2)[x] mod
  0x11B (AES's field) instead of the configuration's 0x11D, which breaks
  the profile's stated field;
- ``unchanged``: the step returns its output buffer unwritten (zeros);
- ``half_batch``: only the first half of the batch's columns is
  computed, the rest left zero;
- ``altered``: one byte of each product, at a place drawn from the seed,
  is flipped where it is produced.

The benchmark's own runs never install one; ``run.py --fault`` and the
tests do.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from .reference import gf256

FAULTS = ("control", "unchanged", "half_batch", "altered")
CONTROL_POLY = 0x11B
#: the wrappers of ``rs_kernels`` that launch ``gf_apply_kernel``
WRAPPERS = ("gf_apply", "gf_apply_stripes")


def _control(mat, data, stripes: int = 1) -> torch.Tensor:
    """The reference's product mod :data:`CONTROL_POLY`, in the
    wrappers' layout: data [S*k, N] -> [S*r, N]."""
    mat = np.asarray(mat.cpu() if isinstance(mat, torch.Tensor) else mat)
    data = torch.as_tensor(np.asarray(data)) \
        if not isinstance(data, torch.Tensor) else data
    (r, k), n = mat.shape, int(data.shape[1])
    folded = data.reshape(stripes, k, n).transpose(0, 1).reshape(k, -1)
    out = gf256.apply(mat, folded, poly=CONTROL_POLY)
    return out.reshape(r, stripes, n).transpose(0, 1).reshape(-1, n)


def install(name: str, seed: int):
    """Put fault ``name`` in place of the wrappers; returns the undo."""
    from ceph_tpu_torch.ops import rs_kernels
    if name not in FAULTS:
        raise ValueError(f"fault {name!r} is not one of {FAULTS}")
    real = {w: getattr(rs_kernels, w) for w in WRAPPERS}
    rng = random.Random(seed)

    def unchanged(out):
        return torch.zeros_like(out)

    def half_batch(out):
        out[:, out.shape[1] // 2:] = 0
        return out

    def altered(out):
        r = rng.randrange(out.shape[0])
        c = rng.randrange(out.shape[1])
        out[r, c] ^= 1
        return out

    spoil = {"unchanged": unchanged, "half_batch": half_batch,
             "altered": altered}.get(name)

    def wrap(wrapper: str):
        def fault(mat, data, *stripes):
            if spoil is None:
                return _control(mat, data, *stripes)
            return spoil(real[wrapper](mat, data, *stripes))
        return fault

    for w in WRAPPERS:
        setattr(rs_kernels, w, wrap(w))

    def undo():
        for w, fn in real.items():
            setattr(rs_kernels, w, fn)
    return undo

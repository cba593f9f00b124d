"""The kernel sweep's kernels on the card: a GF(2^8) apply through a
bit-plane product on the tensor cores, and a pure-stream copy.

- :func:`bitplane_apply`: out[r, N] = mat ·GF(2^8) data[k, N], given the
  plane-major bit-matrix ``bmat`` [8r, 8k] of ``mat``
  (:func:`.rs_kernels.expand_bits_plane_major`);
- :func:`bitplane_apply_bd`: the same apply with ``groups`` column tiles
  of ``tile_n`` columns stacked against the block-diagonal operand
  [G*8r, G*8k] (``torch.block_diag`` of G copies), one product for all
  G tiles;
- :func:`copy_rows`: out[r, N] = data[:r] while reading all k rows, the
  bandwidth ceiling for a GF apply's (k + r) * N bytes.

On a CUDA tensor each wrapper launches the hand-written kernel of
``csrc/sweep_kernels.cu`` (built at first use by :mod:`.cuda_build`) and
adds one to its count in ``launches``; it never falls back.  On a CPU
tensor it runs the plain PyTorch version kept beside it.  ``acc``
("int8" or "bf16") picks the tensor-core type, which changes how the
kernel computes, never what: the plain versions ignore it.
"""
from __future__ import annotations

import torch

from . import cuda_build
from .rs_kernels import _as_bits, _as_u8

launches = {"bitplane_apply": 0, "bitplane_apply_bd": 0, "copy_rows": 0}

ACCS = {"int8": 0, "bf16": 1}
TILE_QUANTUM = 256      # tile_n must be a multiple of the kernel's sub-tile
MAX_ROWS = 32           # groups * r: output rows of one stacked product
MAX_ROW_BYTES = 64      # groups * round_up(k, 4): data bytes of one column


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


# -- plain PyTorch versions ---------------------------------------------------

def unpack_plane_major(data: torch.Tensor) -> torch.Tensor:
    """uint8 [k, N] -> bit-planes [8k, N] (row b*k + j = bit b of row j)."""
    k, n = data.shape
    b = torch.arange(8, dtype=torch.uint8, device=data.device)
    return ((data[None, :, :] >> b[:, None, None]) & 1).reshape(8 * k, n)


def pack_plane_major(bits: torch.Tensor, r: int) -> torch.Tensor:
    """0/1 planes [8r, N] (row b*r + i = bit b of row i) -> uint8 [r, N]."""
    w = torch.tensor([1 << b for b in range(8)], dtype=torch.int32,
                     device=bits.device)
    return (bits.reshape(8, r, -1).to(torch.int32)
            * w[:, None, None]).sum(dim=0).to(torch.uint8)


def _gf2_product(bmat: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(bmat @ bits) & 1 as one float32 matmul: exact, the terms are 0/1
    and far under 2^24 of them.  No TF32 for the call; the caller's
    setting is put back after it."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = (bmat & 1).to(torch.float32) @ bits.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc.to(torch.int32) & 1


def bitplane_apply_plain(bmat: torch.Tensor, data: torch.Tensor, r: int,
                         k: int) -> torch.Tensor:
    """Plain version: unpack plane-major, one float32 matmul, & 1, pack."""
    return pack_plane_major(_gf2_product(bmat, unpack_plane_major(data)), r)


def bitplane_apply_bd_plain(bmat_bd: torch.Tensor, data: torch.Tensor,
                            r: int, k: int, groups: int,
                            tile_n: int) -> torch.Tensor:
    """Plain version of the stacked apply: each span of groups*tile_n
    columns (the last one zero-padded) splits into G tiles, whose planes
    stack to [G*8k, tile_n]; one product with the block-diagonal operand
    gives [G*8r, tile_n], and group g's rows pack to tile g's output."""
    n = data.shape[1]
    span = groups * tile_n
    steps = -(-n // span)
    padded = torch.zeros((k, steps * span), dtype=torch.uint8,
                         device=data.device)
    padded[:, :n] = data
    tiles = padded.view(k, steps, groups, tile_n).permute(2, 0, 1, 3)
    bits = torch.cat([unpack_plane_major(t.reshape(k, steps * tile_n))
                      for t in tiles])                   # [G*8k, S*T]
    acc = _gf2_product(bmat_bd, bits)                    # [G*8r, S*T]
    outs = torch.stack([pack_plane_major(acc[g * 8 * r:(g + 1) * 8 * r], r)
                        for g in range(groups)])         # [G, r, S*T]
    return (outs.view(groups, r, steps, tile_n).permute(1, 2, 0, 3)
            .reshape(r, steps * span)[:, :n].contiguous())


def copy_rows_plain(data: torch.Tensor, r: int) -> torch.Tensor:
    """Plain version: the first r rows."""
    return data[:r].clone()


# -- the kernel wrappers ------------------------------------------------------

def _check_tile(tile_n: int) -> int:
    tile_n = int(tile_n)
    if tile_n < TILE_QUANTUM or tile_n % TILE_QUANTUM:
        raise ValueError(f"tile_n must be a positive multiple of "
                         f"{TILE_QUANTUM}, got {tile_n}")
    return tile_n


def _cuda_ready(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[-1].device
    if not tensors[-1].is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _launch(name: str, entry: str, out: torch.Tensor, *args) -> None:
    lib = cuda_build.load("sweep_kernels")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
    launches[name] += 1


def _bitplane(name: str, bmat, data, r: int, k: int, groups: int, acc: str,
              tile_n: int) -> torch.Tensor:
    bmat, data = _as_bits(bmat), _as_u8(data)
    r, k, groups, tile_n = int(r), int(k), int(groups), _check_tile(tile_n)
    if acc not in ACCS:
        raise ValueError(f"acc must be one of {sorted(ACCS)}, got {acc!r}")
    if min(r, k, groups) < 1:
        raise ValueError(f"r, k and groups must be positive: {r}, {k}, "
                         f"{groups}")
    if groups * r > MAX_ROWS or groups * (-(-k // 4) * 4) > MAX_ROW_BYTES:
        raise ValueError(f"(r={r}, k={k}, groups={groups}) does not fit the "
                         f"kernel: needs groups*r <= {MAX_ROWS} and "
                         f"groups*round_up(k, 4) <= {MAX_ROW_BYTES}")
    if tuple(bmat.shape) != (groups * 8 * r, groups * 8 * k):
        raise ValueError(f"bmat {tuple(bmat.shape)} != "
                         f"({groups * 8 * r}, {groups * 8 * k})")
    if data.dim() != 2 or data.shape[0] != k:
        raise ValueError(f"data {tuple(data.shape)} is not [{k}, N]")
    if data.device.type == "cpu":
        bmat = bmat.cpu()
        if groups == 1:
            return bitplane_apply_plain(bmat, data, r, k)
        return bitplane_apply_bd_plain(bmat, data, r, k, groups, tile_n)
    _cuda_ready(name, bmat, data)
    n = int(data.shape[1])
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    if n:
        _launch(name, "bitplane_apply_launch", out, bmat.data_ptr(),
                data.data_ptr(), out.data_ptr(), r, k, n, groups, tile_n,
                ACCS[acc])
    return out


def bitplane_apply(bmat, data, r: int, k: int, acc: str = "int8",
                   tile_n: int = 8192) -> torch.Tensor:
    """out[r, N] = mat ·GF(2^8) data[k, N] from the plane-major bit-matrix
    ``bmat`` [8r, 8k] (0/1; bit 0 is read); ``tile_n`` (a multiple of
    256) is the column tile of the stacked form and changes nothing at
    groups = 1.  A CUDA tensor launches the tensor-core kernel; a CPU
    tensor runs :func:`bitplane_apply_plain`."""
    return _bitplane("bitplane_apply", bmat, data, r, k, 1, acc, tile_n)


def bitplane_apply_bd(bmat_bd, data, r: int, k: int, groups: int,
                      acc: str = "int8", tile_n: int = 8192) -> torch.Tensor:
    """The same apply with ``groups`` column tiles of ``tile_n`` columns
    stacked against the block-diagonal ``bmat_bd`` [G*8r, G*8k]; every
    column of the one output [r, N] is written.  A CUDA tensor launches
    the kernel; a CPU tensor runs :func:`bitplane_apply_bd_plain`."""
    return _bitplane("bitplane_apply_bd", bmat_bd, data, r, k, groups, acc,
                     tile_n)


def copy_rows(data, r: int, tile_n: int = 8192) -> torch.Tensor:
    """out[r, N] = data[:r] of data [k, N], reading every byte of all k
    rows, a block owning ``tile_n`` columns.  A CUDA tensor launches the
    copy kernel; a CPU tensor runs :func:`copy_rows_plain`."""
    data = _as_u8(data)
    r, tile_n = int(r), _check_tile(tile_n)
    if data.dim() != 2:
        raise ValueError(f"data must be 2-D, got {tuple(data.shape)}")
    k = int(data.shape[0])
    if not 1 <= r <= k:
        raise ValueError(f"r={r} must be in [1, {k}]")
    if data.device.type == "cpu":
        return copy_rows_plain(data, r)
    _cuda_ready("copy_rows", data)
    n = int(data.shape[1])
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    if n:
        _launch("copy_rows", "copy_rows_launch", out, data.data_ptr(),
                out.data_ptr(), r, k, n, tile_n)
    return out

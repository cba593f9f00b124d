"""Plain reference of an EC pool's write path: what a whole-object write
must leave on the OSDs.

Built from first principles and from nothing of the program under test
(``gf256`` gives the field and the code):

- :func:`chunks`: a payload's ``k + m`` chunks.  The data chunks are the
  payload's stripe-unit relayout (stripe ``s``, unit ``j`` of it is bytes
  ``[s * unit, (s + 1) * unit)`` of data chunk ``j``), the parity chunks
  its ``reed_sol_van`` codeword over GF(2^8), polynomial 0x11D;
- :func:`crc32c`: the Castagnoli CRC (reflected polynomial 0x82F63B78)
  as ``ceph_crc32c`` computes it, from a given seed and with no pre- or
  post-inversion, its byte table built bit by bit; a HashInfo's chunk
  hash is ``crc32c(0xFFFFFFFF, chunk)``, the chain from seed -1.  Long
  rows go a block at a time, all blocks at once, and the block CRCs
  chain by the CRC's linearity (:func:`crc32c_blocks`);
- :func:`distinct_hosts`: the placement property of a rule ``chooseleaf
  indep n type host``: every chunk of a PG on a host of its own.

Plain PyTorch on the device given (NumPy for the small matrices).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference import gf256

#: the reflected Castagnoli polynomial
CASTAGNOLI = 0x82F63B78
#: the seed a HashInfo's chunk hashes chain from (-1 as uint32)
HINFO_SEED = 0xFFFFFFFF
#: bytes a block of :func:`crc32c_blocks`
BLOCK = 8192


def data_chunks(payload: np.ndarray, k: int, unit: int) -> np.ndarray:
    """[k, len / k]: the payload's stripe-unit relayout."""
    payload = np.asarray(payload, dtype=np.uint8)
    if payload.size % (k * unit):
        raise ValueError(f"{payload.size} bytes are not whole stripes of "
                         f"{k} x {unit}")
    stripes = payload.size // (k * unit)
    return payload.reshape(stripes, k, unit).transpose(1, 0, 2) \
        .reshape(k, -1)


def chunks(payload: np.ndarray, k: int, m: int, unit: int,
           device: str = "cpu") -> list[np.ndarray]:
    """The ``k + m`` chunks of one whole-object write of ``payload``."""
    data = data_chunks(payload, k, unit)
    parity = gf256.apply(gf256.reed_sol_van(k, m),
                         torch.from_numpy(np.ascontiguousarray(data))
                         .to(device)).cpu().numpy()
    return list(data) + list(parity)


@functools.lru_cache(maxsize=1)
def crc_table() -> np.ndarray:
    """[256] uint32: the CRC of each byte value, eight shifts a byte."""
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ (CASTAGNOLI if crc & 1 else 0)
        table[byte] = crc
    return table


def crc32c_bytewise(seed, rows: torch.Tensor) -> torch.Tensor:
    """``ceph_crc32c(seed, row)`` of each row of ``rows`` ([R, N] uint8,
    on any device), a byte at a time, all rows at once; ``seed`` one
    value or a tensor of one a row; [R] int64 holding 32-bit values."""
    table = torch.from_numpy(crc_table().astype(np.int64)).to(rows.device)
    crc = torch.as_tensor(seed, dtype=torch.int64, device=rows.device) \
        .expand(rows.shape[0]).clone()
    cols = rows.t().contiguous()        # each step reads one column
    for j in range(rows.shape[1]):
        crc = table[(crc ^ cols[j]) & 0xFF] ^ (crc >> 8)
    return crc


@functools.lru_cache(maxsize=4)
def zeros_tables(n: int) -> np.ndarray:
    """[4, 256]: ``T[k][v]`` is the CRC register ``v << 8k`` after ``n``
    zero bytes.  The register's update is linear over GF(2), so the
    register ``c`` after ``n`` zeros is ``XOR_k T[k][byte k of c]``."""
    basis = (torch.arange(256, dtype=torch.int64)[None, :]
             << (8 * torch.arange(4, dtype=torch.int64))[:, None]).reshape(-1)
    return crc32c_bytewise(basis, torch.zeros((basis.numel(), n),
                                              dtype=torch.uint8)) \
        .reshape(4, 256).numpy()


def crc32c_blocks(seed: int, rows: torch.Tensor) -> torch.Tensor:
    """:func:`crc32c_bytewise` of rows whose length is whole blocks: every
    block's CRC from seed 0 at once, then, block by block, ``crc(s, A +
    B) = crc(s, A) after len(B) zeros ^ crc(0, B)``."""
    r, n = rows.shape
    blocks = crc32c_bytewise(0, rows.reshape(-1, BLOCK)).reshape(r, -1)
    shift = torch.from_numpy(zeros_tables(BLOCK)).to(rows.device)
    crc = torch.full((r,), seed, dtype=torch.int64, device=rows.device)
    for b in range(n // BLOCK):
        crc = (shift[0][crc & 0xFF] ^ shift[1][(crc >> 8) & 0xFF] ^
               shift[2][(crc >> 16) & 0xFF] ^ shift[3][crc >> 24]) \
            ^ blocks[:, b]
    return crc


def crc32c(seed: int, rows, device: str = "cpu") -> np.ndarray:
    """``ceph_crc32c(seed, row)`` of each row of ``rows`` ([R, N] uint8,
    or one row [N]), computed on ``device``; [R] uint32."""
    rows = torch.as_tensor(np.asarray(rows, dtype=np.uint8)).to(device)
    if rows.dim() == 1:
        rows = rows[None]
    if rows.shape[1] >= 2 * BLOCK and rows.shape[1] % BLOCK == 0:
        crc = crc32c_blocks(seed, rows)
    else:
        crc = crc32c_bytewise(seed, rows)
    return crc.cpu().numpy().astype(np.uint32)


def distinct_hosts(acting: list[int], host_of) -> bool:
    """Does every OSD of the acting set sit on a host of its own?"""
    hosts = [host_of(osd) for osd in acting]
    return len(set(hosts)) == len(hosts)

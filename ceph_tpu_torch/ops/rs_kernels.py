"""GF(2^8) matrix application on the card: the RS encode/decode primitive

    out[i, :] = XOR_j  mat[i, j] * data[j, :]     (GF(2^8))

with ``mat`` tiny ([m, k] for encode, [n_lost, k] for decode) and ``data``
huge ([k, N] bytes, or [S*k, N] in the vertical stripe layout).

On a CUDA tensor, :func:`gf_apply` and :func:`gf_apply_stripes` launch the
hand-written kernel of ``csrc/gf_apply.cu`` (built at first use by
:mod:`.cuda_build`); they never fall back to anything else.  On a CPU
tensor they run the plain PyTorch versions kept beside them:

- :func:`gf_apply_bitslice`: expand the matrix to its GF(2) bit-matrix
  [8r, 8k], unpack the data to bit-planes, one float32 matmul (exact: 0/1
  terms, at most 8*255 of them, far under 2^24), mod 2, repack;
- :func:`gf_apply_lookup`: per-coefficient 256-entry product tables
  gathered by the data bytes and XOR-reduced over j.

Data layout everywhere: uint8 tensors [chunks, chunk_bytes]; a batch of
stripes folds into the byte axis (the matrix is the same for every
stripe, so [k, B*N] == B stripes of [k, N]).

:func:`xor_apply` is the GF(2) bitmatrix apply of the jerasure bitmatrix
and wide-word codes, ``out[r] = XOR of packets[i] where W[r, i] = 1``: on a
CUDA tensor it launches the kernel of ``csrc/xor_apply.cu``, on a CPU
tensor it runs :func:`xor_apply_plain`.

:func:`crc32c_rows` is crc32c(0, row) of each row, the HashInfo checksum
of the EC write path: on a CUDA tensor it launches the kernel of
``csrc/crc32c.cu``, on a CPU tensor it runs :func:`crc32c_rows_plain`.
:func:`gf_encode_with_crc` is the fused encode + checksum over both
kernels.

The kernels' host-visible pieces are plain functions here, for the tests:
:func:`packed_nibble_tables` (the lookup tables ``gf_apply.cu`` builds in
shared memory), :func:`xor_nibble_index` and :func:`xor_form` (the W
nibbles that select ``xor_apply.cu``'s XOR combinations, and the density
rule that picks its form).

``launches`` counts kernel launches per wrapper; only a launch adds to it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..backend.ecutil import _CRC_TABLES, _gf2_square, crc32c_zeros_op
from ..gf.tables import MUL_TABLE
from . import cuda_build

launches = {"gf_apply": 0, "gf_apply_stripes": 0, "xor_apply": 0,
            "crc32c_rows": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@functools.lru_cache(maxsize=None)
def _mul_table(device: torch.device) -> torch.Tensor:
    """The 256x256 GF(2^8) product table on ``device`` (64 KiB)."""
    return torch.from_numpy(MUL_TABLE).to(device)


def _as_u8(x) -> torch.Tensor:
    """A numpy array becomes a CPU tensor; a tensor must already be uint8."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint8))
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or numpy array, got "
                        f"{type(x).__name__}")
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8, got {x.dtype}")
    return x


# -- plain PyTorch versions ---------------------------------------------------

def expand_bits_raw(mat: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix [r, k] -> GF(2) bits [r, bi, k, bj] (uint8 0/1):
    bit bi of (mat[i,j] * 2^bj)."""
    mul = _mul_table(mat.device)
    powers = torch.tensor([1 << j for j in range(8)], device=mat.device)
    mv = mul[mat.long()[:, :, None], powers[None, None, :]]   # [r, k, bj]
    bi = torch.arange(8, dtype=torch.uint8, device=mat.device)
    return (mv[:, None, :, :] >> bi[None, :, None, None]) & 1


def expand_bits_plane_major(mat: torch.Tensor) -> torch.Tensor:
    """GF(2^8) matrix [r, k] -> GF(2) bit-matrix [8r, 8k] (uint8 0/1),
    plane-major: B[bi*r + i, bj*k + j] = bit bi of (mat[i, j] * 2^bj).
    A data bit's row is bj*k + j here, not the chunk-major 8j + bj of
    :func:`_unpack_bits`."""
    r, k = mat.shape
    return expand_bits_raw(mat).permute(1, 0, 3, 2).reshape(8 * r, 8 * k)


def _unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """uint8 [k, N] -> bit-planes [8k, N] (row 8j+bj = bit bj of chunk j)."""
    k, n = data.shape
    bj = torch.arange(8, dtype=torch.uint8, device=data.device)
    return ((data[:, None, :] >> bj[None, :, None]) & 1).reshape(8 * k, n)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """0/1 bit-planes [8r, N] -> uint8 [r, N]."""
    rr, n = bits.shape
    w = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                     device=bits.device)
    return (bits.reshape(rr // 8, 8, n).to(torch.int32)
            * w[None, :, None]).sum(dim=1).to(torch.uint8)


def gf_apply_bitslice(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version: out = mat @GF data as a GF(2) float32 matmul."""
    r, k = mat.shape
    B = expand_bits_raw(mat).reshape(8 * r, 8 * k).to(torch.float32)
    x = _unpack_bits(data).to(torch.float32)                 # [8k, N]
    # the sums must be exact integers: no TF32 on the card for this matmul,
    # and the caller's setting is put back after it
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        acc = B @ x
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return _pack_bits(acc.to(torch.int32) & 1)


def gf_apply_lookup(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version: product-table gathers, XOR-reduced over j."""
    tables = _mul_table(data.device)[mat.long()]             # [r, k, 256]
    out = torch.zeros((mat.shape[0], data.shape[1]), dtype=torch.uint8,
                      device=data.device)
    for j in range(mat.shape[1]):
        out ^= tables[:, j, :][:, data[j].long()]
    return out


def xor_reduce(data: torch.Tensor) -> torch.Tensor:
    """XOR of all chunk rows: [k, N] -> [1, N] (the parity row of ones)."""
    out = data[0].clone()
    for j in range(1, data.shape[0]):
        out ^= data[j]
    return out[None, :]


def gf_apply_plain(mat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version :func:`gf_apply` takes for a CPU tensor:
    'lookup' for tiny matrices (as the reference's auto choice), else
    'bitslice'.  The two are bitwise equal."""
    if mat.shape[0] * mat.shape[1] < 8:
        return gf_apply_lookup(mat, data)
    return gf_apply_bitslice(mat, data)


def packed_nibble_tables(mat) -> torch.Tensor:
    """The kernel's lookup tables for ``mat`` [r, k], without the per-lane
    copies: 32-bit words [ceil(r/4), k, 2, 16], where [g, j, 0, e] packs
    mat[4g+q, j] * e and [g, j, 1, e] packs mat[4g+q, j] * (e << 4) into
    byte q (rows past r are zero).  For a data byte b of row j,
    ``T[g, j, 0, b & 15] ^ T[g, j, 1, b >> 4]`` holds in byte q the product
    of b with output row 4g+q's coefficient.  The words are held in int64
    (values below 2^32).  ``csrc/gf_apply.cu`` builds the same words in
    shared memory, each repeated for the 32 lanes of a warp."""
    mat = _as_u8(mat)
    r, k = mat.shape
    groups = -(-r // 4)
    padded = torch.zeros((groups * 4, k), dtype=torch.int64,
                         device=mat.device)
    padded[:r] = mat.long()
    e = torch.arange(16, device=mat.device)
    rows = _mul_table(mat.device).long()[padded]     # [4G, k, 256]
    prods = torch.stack([rows[..., e], rows[..., e << 4]], dim=2)
    shifts = torch.tensor([0, 8, 16, 24], device=mat.device)
    return (prods.view(groups, 4, k, 2, 16)
            << shifts[None, :, None, None, None]).sum(dim=1)


def _fold(data: torch.Tensor, k: int, stripes: int) -> torch.Tensor:
    """[S*k, N] vertical layout -> [k, S*N] horizontal."""
    n = data.shape[1]
    return data.reshape(stripes, k, n).transpose(0, 1).reshape(k, stripes * n)


def _unfold(out: torch.Tensor, stripes: int) -> torch.Tensor:
    """[r, S*N] horizontal -> [S*r, N] vertical layout."""
    r = out.shape[0]
    n = out.shape[1] // stripes
    return out.reshape(r, stripes, n).transpose(0, 1).reshape(stripes * r, n)


def gf_apply_stripes_plain(mat: torch.Tensor, data: torch.Tensor,
                           stripes: int) -> torch.Tensor:
    """Plain version of the vertical-layout apply: fold to [k, S*N], apply,
    unfold to [S*r, N]."""
    folded = _fold(data, mat.shape[1], stripes)
    return _unfold(gf_apply_plain(mat, folded), stripes)


# -- the kernel wrappers ------------------------------------------------------

def _apply(name: str, mat, data, stripes: int) -> torch.Tensor:
    """The one body behind both wrappers: data [S*k, N] -> [S*r, N].  A CPU
    tensor runs the plain version; a CUDA tensor is checked, launches the
    kernel and adds one to ``launches[name]``; anything else raises."""
    mat, data = _as_u8(mat), _as_u8(data)
    if mat.dim() != 2 or data.dim() != 2:
        raise ValueError(f"mat and data must be 2-D, got {tuple(mat.shape)} "
                         f"and {tuple(data.shape)}")
    r, k = mat.shape
    if data.shape[0] != stripes * k:
        raise ValueError(f"{data.shape[0]} rows != {stripes} stripes x {k}")
    if data.device.type == "cpu":
        return gf_apply_stripes_plain(mat.cpu(), data, stripes)
    if not data.is_cuda:
        raise ValueError(f"{name} runs on cuda or cpu, not {data.device}")
    if mat.device != data.device:
        raise ValueError(f"mat on {mat.device} but data on {data.device}")
    if not (mat.is_contiguous() and data.is_contiguous()):
        raise ValueError("mat and data must be contiguous")
    n = int(data.shape[1])
    out = torch.empty((stripes * r, n), dtype=torch.uint8, device=data.device)
    if n == 0 or stripes == 0:
        return out
    lib = cuda_build.load("gf_apply")
    mul = _mul_table(data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.gf_apply_launch(
            mat.data_ptr(), mul.data_ptr(), data.data_ptr(), out.data_ptr(),
            int(r), int(k), n, int(stripes), stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")
    launches[name] += 1
    return out


def gf_apply(mat, data) -> torch.Tensor:
    """out[r, N] = mat[r, k] @GF data[k, N], uint8.  A CUDA tensor launches
    the hand kernel; a CPU tensor (or numpy array) runs
    :func:`gf_apply_plain`."""
    return _apply("gf_apply", mat, data, 1)


def gf_apply_stripes(mat, data, stripes: int) -> torch.Tensor:
    """Vertical layout: data [S*k, Nc] -> [S*r, Nc], stripe s's rows
    [s*k, (s+1)*k) to parity rows [s*r, (s+1)*r).  A CUDA tensor launches
    the hand kernel; a CPU tensor runs :func:`gf_apply_stripes_plain`."""
    return _apply("gf_apply_stripes", mat, data, int(stripes))


# -- GF(2) bitmatrix apply ------------------------------------------------------

def _as_bits(W) -> torch.Tensor:
    """A 0/1 matrix (numpy or tensor; bool, int8 or uint8) as a uint8
    tensor on its device.  Bit 0 is what counts, as in the mod-2 matmul
    of the JAX package's device path."""
    if isinstance(W, np.ndarray):
        W = torch.from_numpy(np.ascontiguousarray(W))
    if not isinstance(W, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor or numpy array, got "
                        f"{type(W).__name__}")
    if W.dtype not in (torch.bool, torch.int8, torch.uint8):
        raise TypeError(f"W must be bool, int8 or uint8, got {W.dtype}")
    return W.to(torch.uint8)


def _xor_rows(rows: torch.Tensor) -> torch.Tensor:
    """XOR of the rows of [n >= 1, P] -> [P], folded in halves."""
    while rows.shape[0] > 1:
        half = rows.shape[0] // 2
        folded = rows[:half] ^ rows[half:2 * half]
        rows = torch.cat([folded, rows[2 * half:]]) if rows.shape[0] % 2 \
            else folded
    return rows[0]


def xor_apply_plain(W: torch.Tensor, packets: torch.Tensor) -> torch.Tensor:
    """Plain version: ``out[r]`` = XOR of the ``packets`` rows where
    ``W[r] & 1``, a reduce over the selected rows (the bit-plane matmul of
    the JAX package would need float planes 8x the packets' size)."""
    sel = (_as_bits(W).to(packets.device) & 1).bool()
    out = torch.zeros((sel.shape[0], packets.shape[1]), dtype=torch.uint8,
                      device=packets.device)
    for r in range(sel.shape[0]):
        rows = packets[sel[r]]
        if rows.shape[0]:
            out[r] = _xor_rows(rows)
    return out


XOR_FORMS = {"auto": 0, "direct": 1, "tables": 2}
XOR_GROUP = 4              # input rows per XOR-combination group
XOR_BUILD_COST = 8         # the rule's price of building one group


def xor_nibble_index(W) -> torch.Tensor:
    """uint8 [R, ceil(K/4)]: entry [r, g] = sum_b (W[r, 4g+b] & 1) << b,
    the selector of output row r's XOR combination of input group g (zero
    past K), with torch ops on W's device."""
    bits = _as_bits(W) & 1
    r, k = bits.shape
    groups = -(-k // XOR_GROUP)
    padded = torch.zeros((r, groups * XOR_GROUP), dtype=torch.uint8,
                         device=bits.device)
    padded[:, :k] = bits
    weights = torch.tensor([1 << b for b in range(XOR_GROUP)],
                           dtype=torch.uint8, device=bits.device)
    return (padded.view(r, groups, XOR_GROUP) * weights).sum(
        dim=2, dtype=torch.uint8)


def xor_form(W) -> str:
    """The density rule ``csrc/xor_apply.cu`` applies on the card:
    "tables" when nnz(W) > nonzero nibbles + 8 * ceil(K/4) (the loads and
    XORs the combinations save pay for building 16 of them per group; the
    price 8 was fitted on the H100), else "direct".  Past R*K = 256 Ki the
    kernel keeps no index of W in shared memory and runs direct."""
    bits = _as_bits(W) & 1
    nibbles = xor_nibble_index(bits)
    nnz = int(bits.sum())
    cost = int((nibbles != 0).sum()) + XOR_BUILD_COST * nibbles.shape[1]
    return "tables" if nnz > cost else "direct"


def xor_apply(W, packets) -> torch.Tensor:
    """out[R, P] = W[R, K] ·GF(2) packets[K, P]: each output row is the
    bytewise XOR of the packet rows its W row selects.  A CUDA tensor
    launches the hand kernel and adds one to ``launches["xor_apply"]``; a
    CPU tensor (or numpy array) runs :func:`xor_apply_plain`."""
    return xor_apply_form(W, packets, "auto")


def xor_apply_form(W, packets, form: str) -> torch.Tensor:
    """:func:`xor_apply` with the kernel's form named: "auto" (the rule of
    :func:`xor_form`, what :func:`xor_apply` runs), "direct" or "tables".
    The form changes how the kernel computes, never what: a CPU tensor
    runs :func:`xor_apply_plain` whatever the form."""
    if form not in XOR_FORMS:
        raise ValueError(f"form must be one of {sorted(XOR_FORMS)}, got "
                         f"{form!r}")
    W, packets = _as_bits(W), _as_u8(packets)
    if W.dim() != 2 or packets.dim() != 2:
        raise ValueError(f"W and packets must be 2-D, got {tuple(W.shape)} "
                         f"and {tuple(packets.shape)}")
    r, k = W.shape
    if packets.shape[0] != k:
        raise ValueError(f"W has {k} columns but packets has "
                         f"{packets.shape[0]} rows")
    if packets.device.type == "cpu":
        return xor_apply_plain(W.cpu(), packets)
    if not packets.is_cuda:
        raise ValueError(f"xor_apply runs on cuda or cpu, not "
                         f"{packets.device}")
    if W.device != packets.device:
        raise ValueError(f"W on {W.device} but packets on {packets.device}")
    if not (W.is_contiguous() and packets.is_contiguous()):
        raise ValueError("W and packets must be contiguous")
    p = int(packets.shape[1])
    out = torch.empty((r, p), dtype=torch.uint8, device=packets.device)
    if r == 0 or p == 0:
        return out
    lib = cuda_build.load("xor_apply")
    with torch.cuda.device(packets.device):
        stream = torch.cuda.current_stream(packets.device).cuda_stream
        err = lib.xor_apply_launch(W.data_ptr(), packets.data_ptr(),
                                   out.data_ptr(), int(r), int(k), p,
                                   XOR_FORMS[form], stream)
    if err != 0:
        raise RuntimeError(f"xor_apply failed: cudaError_t {err}")
    launches["xor_apply"] += 1
    return out


# -- crc32c of rows (on the EC write path via hinfo_append) -------------------
#
# crc32c is GF(2)-linear in the data bits once the seed is factored out
# (backend/ecutil.crc32c_zeros), so a row's crc32c(0, row) folds like a
# reduction: adjacent blocks combine as Z_len(right)(left) ^ right, Z_L
# the 32x32 GF(2) operator advancing a register through L zero bytes.
# Zeros on the LEFT of a row are free for a zero-seeded register, so both
# versions pad there.  On a CUDA tensor :func:`crc32c_rows` launches the
# kernel of ``csrc/crc32c.cu``; on a CPU tensor it runs
# :func:`crc32c_rows_plain`.  CRCs come back in int64 (values < 2^32).

CRC_ZPOW = 48            # the kernel's Z_{2^j} operators, j < 48
CRC_RUN = 128            # bytes of a row one lane of the kernel folds
CRC_SPAN = 32 * CRC_RUN  # bytes of one warp's work unit


@functools.lru_cache(maxsize=None)
def _crc_t0(device: torch.device) -> torch.Tensor:
    return torch.tensor(_CRC_TABLES[0], dtype=torch.int64, device=device)


def _crc_apply_op(crcs: torch.Tensor, op: tuple) -> torch.Tensor:
    """Apply a 32x32 GF(2) operator (``op[i]`` = image of register bit i)
    to int64 crcs by masked XOR."""
    out = torch.zeros_like(crcs)
    for i in range(32):
        out ^= ((crcs >> i) & 1) * op[i]
    return out


def crc32c_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version: crc32c(0, row) of each row of a uint8 [r, n] tensor
    -> int64 [r] on its device.  A per-byte table gather, zero padding on
    the left to a power of two, then one fold level per halving."""
    r, n = rows.shape
    c = _crc_t0(rows.device)[rows.long()]
    pad = 1 if n <= 1 else 1 << (n - 1).bit_length()
    if pad > n:
        c = torch.cat([torch.zeros((r, pad - n), dtype=torch.int64,
                                   device=rows.device), c], dim=1)
    level = 0
    while c.shape[1] > 1:
        c = _crc_apply_op(c[:, 0::2], crc32c_zeros_op(1 << level)) ^ c[:, 1::2]
        level += 1
    return c[:, 0]


def crc_zpow_words() -> np.ndarray:
    """The operators Z_{2^j}, j < :data:`CRC_ZPOW`, as uint32 [CRC_ZPOW, 32]
    (word i of row j = the image of register bit i): what the kernel
    advances a warp's partial crc through the units after it with."""
    ops = [list(crc32c_zeros_op(1))]
    for _ in range(CRC_ZPOW - 1):
        ops.append(_gf2_square(ops[-1]))
    return np.array(ops, dtype=np.uint32)


def crc_nibble_tables() -> np.ndarray:
    """The kernel's split-nibble tables, uint32 [16, 16]: for the 8-byte
    step c' = crc32c(c ^ lo, hi) with c 0, nibble t of the 64 bits lo | hi
    << 32 contributes entry t, e = T_{7 - t//2}[e << 4 (t % 2)], so c' is
    the XOR of 16 lookups (the kernel keeps one copy per lane)."""
    t = np.array(_CRC_TABLES[:8], dtype=np.uint32)
    e = np.arange(16)
    return np.stack([t[7 - q // 2][e << (4 * (q % 2))] for q in range(16)])


def _nibble_images(op) -> np.ndarray:
    """A 32x32 GF(2) operator (``op[i]`` = image of bit i) as 8 nibble
    tables [8, 16]: entry (i, e) is the image of e << 4i."""
    op = np.array(op, dtype=np.uint32).reshape(8, 4)
    e = np.arange(16)
    bits = (e[:, None] >> np.arange(4)) & 1                 # [16, 4]
    out = np.zeros((8, 16), np.uint32)
    for b in range(4):
        out ^= np.where(bits[None, :, b] == 1, op[:, b, None], 0).astype(
            np.uint32)
    return out


def crc_lane_tables() -> np.ndarray:
    """The kernel's lane fold tables, uint32 [8, 16, 32]: lane l's run
    crc is advanced through the (31 - l) runs after it in its warp's unit,
    Z_{(31-l)*CRC_RUN}, applied as 8 nibble lookups; entry (i, e, l) is the
    image of e << 4i (lane l reads only column l)."""
    return np.stack([_nibble_images(crc32c_zeros_op((31 - l) * CRC_RUN))
                     for l in range(32)], axis=-1)


@functools.lru_cache(maxsize=None)
def _crc_kernel_tables(device: torch.device) -> tuple:
    """:func:`crc_nibble_tables`, :func:`crc_lane_tables` and
    :func:`crc_zpow_words` as 32-bit words on ``device``, uploaded once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(w).view(np.int32))
                 .to(device) for w in (crc_nibble_tables(), crc_lane_tables(),
                                       crc_zpow_words()))


def crc32c_rows_into(rows: torch.Tensor, out: torch.Tensor) -> None:
    """Write crc32c(0, row) of each row of the CUDA tensor ``rows`` into
    the contiguous int64 ``out`` [r] on the current stream: one launch,
    counted.  Raises on any failure."""
    r, n = rows.shape
    if n > 1 and rows.stride(1) != 1:
        raise ValueError("crc32c_rows needs rows of contiguous bytes")
    if out.dtype != torch.int64 or tuple(out.shape) != (r,) \
            or not out.is_contiguous() or out.device != rows.device:
        raise ValueError(f"crc32c_rows: out must be contiguous int64 [{r}] "
                         f"on {rows.device}")
    if r == 0:
        return
    if n == 0:
        out.zero_()
        return
    if n >= 1 << (CRC_ZPOW - 1):
        raise ValueError(f"crc32c_rows: rows of {n} bytes are too long")
    stride = int(rows.stride(0)) if r > 1 else n
    nib, lane, zpow = _crc_kernel_tables(rows.device)
    lib = cuda_build.load("crc32c")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.crc32c_rows_launch(rows.data_ptr(), stride, int(r), int(n),
                                     nib.data_ptr(), lane.data_ptr(),
                                     zpow.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crc32c_rows failed: cudaError_t {err}")
    launches["crc32c_rows"] += 1


def _as_rows(rows) -> torch.Tensor:
    rows = _as_u8(rows)
    if rows.dim() != 2:
        raise ValueError(f"rows must be 2-D, got {tuple(rows.shape)}")
    if rows.device.type == "cpu" or rows.is_cuda:
        return rows
    raise ValueError(f"crc32c_rows runs on cuda or cpu, not {rows.device}")


def crc32c_rows(rows) -> torch.Tensor:
    """crc32c(seed=0) of each row of a uint8 [r, n] tensor -> int64 [r],
    on the rows' device.  A CUDA tensor (rows of contiguous bytes, any row
    stride or alignment) launches the hand kernel and adds one to
    ``launches["crc32c_rows"]``; a CPU tensor (or numpy array) runs
    :func:`crc32c_rows_plain`.  Seed-chained ceph semantics are the
    caller's host combine: ``crc32c(seed, row) == crc32c_zeros(seed, n) ^
    crc32c_rows(rows)[i]``."""
    rows = _as_rows(rows)
    if rows.device.type == "cpu":
        return crc32c_rows_plain(rows)
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    crc32c_rows_into(rows, out)
    return out


def gf_encode_with_crc(mat, data) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused encode + checksum: parity = mat @GF data [m, N] and the
    crc32c(0, .) of every row of concat(data, parity) as int64 [k + m].
    On a CUDA tensor: the gf_apply kernel, then the crc kernel over the
    data rows into ``crcs[:k]`` and over the parity rows the apply just
    wrote into ``crcs[k:]``, all on the current stream and with no copy of
    the rows.  On a CPU tensor the plain versions of both."""
    mat, data = _as_u8(mat), _as_rows(data)
    parity = gf_apply(mat, data)
    if data.device.type == "cpu":
        return parity, torch.cat([crc32c_rows_plain(data),
                                  crc32c_rows_plain(parity)])
    k = data.shape[0]
    crcs = torch.empty(k + parity.shape[0], dtype=torch.int64,
                       device=data.device)
    crc32c_rows_into(data, crcs[:k])
    crc32c_rows_into(parity, crcs[k:])
    return parity, crcs

"""Stripe offset algebra, per-shard hashes, and batched stripe codecs.

The port's copy of the reference package's ECUtil layer (reference:
src/osd/ECUtil.{h,cc}): :func:`encode`/:func:`decode` make ONE plugin call
for a whole multi-stripe buffer by laying stripes out as contiguous
per-shard chunk streams, and :func:`encode_many`/:func:`decode_many` make
one call for many buffers.  RS parity is positionwise, so batching across
stripes is a pure relayout: bit-identical output, large device launches.
:func:`encode_many_pipelined`/:func:`decode_many_pipelined` submit the
same relayouts to ``ops.pipeline.CodecPipeline`` (async, on a CUDA
stream) with bit-identical results.  Every pipelined apply packs into one
pinned block of chunk rows, the data rows [0, k) in logical order and
then only the parity rows it reads or writes, and the card's result lands
in that block's rows: the encode's parity in rows [k, n), a decode's
erased rows in their slots (:func:`_submit_slot_group`, shared by the
serving reads and recovery), a repair leg's in the rows after its data.
Each crosses host memory once each way.  :func:`hinfo_append` checksums
appended shards with the ``crc32c`` kernel when the plugin routes the call
to the card.

The repair path: :func:`decode_shards_many` (recovery waves, one decode
per survivor and want signature), :func:`partial_sum_accumulate` (one hop
of a chain repair) and :func:`regen_project`/:func:`regen_combine` (the
regenerating-repair legs), each through the pipeline when given one.
The legs run on the card unless the caller names ``device="cpu"`` or
``"numpy"``.

Host crc32c is the native runtime's SSE4.2 ``ec_crc32c`` (the reference
package's host checksum, ``ceph_tpu_torch.native``), zero-copy over any
contiguous buffer.  Its plain version, :func:`crc32c_plain`, is pure
Python for short buffers and a vectorised numpy form (lanes of bytes,
then a log-depth combine) for long ones; it runs only where the native
library could not be built, and each such call is counted in
``native.plain_calls``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import native

# -- crc32c (Castagnoli), seed-chained like ceph_crc32c ----------------------
# HashInfo chains bufferlist::crc32c(seed) per shard with initial seed -1
# (reference: src/osd/ECUtil.h:110-112, ECUtil.cc:161-177).

_CRC32C_POLY = 0x82F63B78


def _make_crc_tables(n_tables: int = 16) -> list[list[int]]:
    """Slice-by-N tables: T[j][b] advances byte b through j+1 zero bytes."""
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for _ in range(n_tables - 1):
        prev = tables[-1]
        tables.append([(prev[b] >> 8) ^ t0[prev[b] & 0xFF] for b in range(256)])
    return tables


_CRC_TABLES = _make_crc_tables()
_CRC_T0_NP = np.array(_CRC_TABLES[0], dtype=np.uint32)

# buffers at least this long take the vectorised numpy path
_CRC_NUMPY_MIN = 4096
_CRC_LANE = 256           # bytes per lane of the numpy path


def _crc32c_py(crc: int, buf: bytes) -> int:
    """Pure-Python slice-by-16 (one iteration consumes 16 bytes)."""
    t = _CRC_TABLES
    (t15, t14, t13, t12, t11, t10, t9, t8,
     t7, t6, t5, t4, t3, t2, t1, t0) = t[15], t[14], t[13], t[12], t[11], \
        t[10], t[9], t[8], t[7], t[6], t[5], t[4], t[3], t[2], t[1], t[0]
    n16 = len(buf) & ~15
    for i in range(0, n16, 16):
        b = buf[i:i + 16]
        crc ^= b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
        crc = (t15[crc & 0xFF] ^ t14[(crc >> 8) & 0xFF] ^
               t13[(crc >> 16) & 0xFF] ^ t12[crc >> 24] ^
               t11[b[4]] ^ t10[b[5]] ^ t9[b[6]] ^ t8[b[7]] ^
               t7[b[8]] ^ t6[b[9]] ^ t5[b[10]] ^ t4[b[11]] ^
               t3[b[12]] ^ t2[b[13]] ^ t1[b[14]] ^ t0[b[15]])
    for i in range(n16, len(buf)):
        crc = t0[(crc ^ buf[i]) & 0xFF] ^ (crc >> 8)
    return crc


@functools.lru_cache(maxsize=None)
def _zeros_op_byte_tables(nbytes: int) -> np.ndarray:
    """[4, 256] uint32: row q maps byte q of a register to its image under
    :func:`crc32c_zeros_op`, so the operator is four gathers and XORs."""
    op = np.array(crc32c_zeros_op(nbytes), dtype=np.uint32)
    b = np.arange(256, dtype=np.uint32)
    tabs = np.zeros((4, 256), dtype=np.uint32)
    for q in range(4):
        for i in range(8):
            tabs[q] ^= ((b >> i) & 1) * op[8 * q + i]
    return tabs


def _crc32c_numpy(buf: np.ndarray) -> int:
    """crc32c(0, buf) for a long uint8 buffer: left-pad with zeros (free
    for a zero seed) to a power-of-two count of lanes, run the byte table
    down every lane at once, then combine adjacent lanes level by level as
    Z_len(left) ^ right."""
    lanes = -(-len(buf) // _CRC_LANE)
    lanes = 1 << (lanes - 1).bit_length()
    padded = np.zeros(lanes * _CRC_LANE, dtype=np.uint8)
    padded[len(padded) - len(buf):] = buf
    cols = np.ascontiguousarray(padded.reshape(lanes, _CRC_LANE).T)
    c = np.zeros(lanes, dtype=np.uint32)
    for col in cols:
        c = _CRC_T0_NP[(c ^ col) & 0xFF] ^ (c >> 8)
    width = _CRC_LANE
    while len(c) > 1:
        t = _zeros_op_byte_tables(width)
        left = c[0::2]
        c = (t[0][left & 0xFF] ^ t[1][(left >> 8) & 0xFF] ^
             t[2][(left >> 16) & 0xFF] ^ t[3][left >> 24]) ^ c[1::2]
        width *= 2
    return int(c[0])


def crc32c_plain(seed: int, arr: np.ndarray) -> int:
    """Plain version of :func:`crc32c` over a contiguous uint8 array:
    pure Python under 4 KiB, the numpy lanes above."""
    if len(arr) >= _CRC_NUMPY_MIN:
        return crc32c_zeros(seed, len(arr)) ^ _crc32c_numpy(arr)
    return _crc32c_py(seed & 0xFFFFFFFF, arr.tobytes())


def crc32c(seed: int, data) -> int:
    """ceph_crc32c semantics: raw reflected CRC-32C update, no final xor —
    the caller chains seeds (standard crc32c(x) = crc32c(0xffffffff, x) ^ 0xffffffff).

    ``data``: an ndarray (any dtype; a non-contiguous one is copied), or
    bytes, bytearray or a memoryview, read in place when contiguous."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        try:
            arr = np.frombuffer(data, dtype=np.uint8)
        except (TypeError, ValueError, BufferError):
            arr = np.frombuffer(bytes(data), dtype=np.uint8)
    lib = native.host_lib()
    if lib is not None:
        return lib.ec_crc32c(seed & 0xFFFFFFFF, arr.ctypes.data, arr.nbytes)
    native.count_plain("crc32c")
    return crc32c_plain(seed, arr)


# -- crc32c combine algebra (the device checksum's host half) ---------------
#
# The crc32c register update is GF(2)-linear in (seed, data bits), so
#     crc32c(seed, D) == crc32c(seed, zeros(len(D))) ^ crc32c(0, D)
# (zlib's crc32_combine identity).  That factorization is what lets the
# device compute seed-FREE per-row crcs (ops/rs_kernels.crc32c_rows) while
# HashInfo's seed-chained ceph semantics are restored exactly on the host
# with one 32x32 GF(2) matrix application per append: advance the previous
# cumulative crc through n zero bytes, then xor the device's crc32c(0, chunk).

def _gf2_times(op: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= op[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(op: list[int]) -> list[int]:
    return [_gf2_times(op, op[i]) for i in range(32)]


@functools.lru_cache(maxsize=None)
def crc32c_zeros_op(nbytes: int) -> tuple:
    """The 32x32 GF(2) operator advancing a crc32c register through
    ``nbytes`` zero bytes, as bit-image columns (entry i = image of
    register bit i).  Square-and-multiply over the one-zero-byte
    operator: O(log n) squarings, lru-cached per length."""
    assert nbytes >= 0
    t0 = _CRC_TABLES[0]
    # one zero byte: crc' = (crc >> 8) ^ T0[crc & 0xFF]
    byte_op = [t0[1 << i] if i < 8 else (1 << (i - 8)) for i in range(32)]
    result = [1 << i for i in range(32)]          # identity
    while nbytes:
        if nbytes & 1:
            result = [_gf2_times(byte_op, result[i]) for i in range(32)]
        byte_op = _gf2_square(byte_op)
        nbytes >>= 1
    return tuple(result)


def crc32c_zeros(crc: int, nbytes: int) -> int:
    """``crc32c(crc, b"\\x00" * nbytes)`` in O(log n) (no zero buffer)."""
    return _gf2_times(list(crc32c_zeros_op(nbytes)), crc & 0xFFFFFFFF)


class StripeInfo:
    """stripe_info_t: logical<->chunk offset algebra (ECUtil.h:27-80).

    ``stripe_width = k * chunk_size``; logical offsets live in object space,
    chunk offsets in per-shard space.
    """

    def __init__(self, k: int, chunk_size: int,
                 stored_chunk_size: int | None = None):
        self.k = k
        self.chunk_size = chunk_size
        self.stripe_width = k * chunk_size
        # On-disk bytes per chunk_size logical share bytes.  Equal for
        # every classic code; regenerating MBR chunks expand (plugin
        # get_stored_chunk_size), so shard extents, hinfo sizes and
        # transaction offsets all live in STORED units while logical
        # offset algebra stays in share units.
        self.stored_chunk_size = (chunk_size if stored_chunk_size is None
                                  else stored_chunk_size)

    def chunk_to_stored(self, chunk_off: int) -> int:
        """Share-space chunk offset/length -> stored (on-disk) units."""
        if self.stored_chunk_size == self.chunk_size:
            return chunk_off
        scaled = chunk_off * self.stored_chunk_size
        assert scaled % self.chunk_size == 0, \
            f"chunk offset {chunk_off} not stored-convertible"
        return scaled // self.chunk_size

    def stored_to_chunk(self, stored_off: int) -> int:
        """Stored (on-disk) offset/length -> share-space chunk units."""
        if self.stored_chunk_size == self.chunk_size:
            return stored_off
        scaled = stored_off * self.chunk_size
        assert scaled % self.stored_chunk_size == 0, \
            f"stored offset {stored_off} not share-convertible"
        return scaled // self.stored_chunk_size

    def logical_offset_is_stripe_aligned(self, logical: int) -> bool:
        return logical % self.stripe_width == 0

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return ((offset + self.stripe_width - 1) // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        rem = offset % self.stripe_width
        return offset + (self.stripe_width - rem) if rem else offset

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def aligned_offset_len_to_chunk(self, off: int, length: int) -> tuple[int, int]:
        return (self.aligned_logical_offset_to_chunk_offset(off),
                self.aligned_logical_offset_to_chunk_offset(length))

    def offset_len_to_stripe_bounds(self, off: int, length: int) -> tuple[int, int]:
        start = self.logical_to_prev_stripe_offset(off)
        end_len = self.logical_to_next_stripe_offset((off - start) + length)
        return start, end_len


HINFO_KEY = "hinfo_key"  # xattr name (ECUtil.cc:235, get_hinfo_key)


class HashInfo:
    """Per-shard cumulative crc32c of appended chunk bytes (ECUtil.h:101-168).

    Appends must be contiguous with the current size; out-of-order appends
    clear the hashes the way the reference asserts them away.
    """

    def __init__(self, num_chunks: int):
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * num_chunks
        self.projected_total_chunk_size = 0
        # per-object write version, bumped on every committed transaction
        # and persisted with each shard: a shard that missed writes while
        # down is detectably stale even after overwrites cleared the chunk
        # hashes (the role the reference's PG log versions play,
        # src/osd/PGLog.cc divergence detection)
        self.version = 0

    def append(self, old_size: int, to_append: dict[int, np.ndarray]) -> None:
        assert old_size == self.total_chunk_size
        if not to_append:
            return
        sizes = {len(v) for v in to_append.values()}
        assert len(sizes) == 1, "uneven shard appends"
        if self.has_chunk_hash():
            for shard, buf in to_append.items():
                self.cumulative_shard_hashes[shard] = crc32c(
                    self.cumulative_shard_hashes[shard], buf)
        self.total_chunk_size += sizes.pop()

    def append_crcs(self, old_size: int, crc0s: dict[int, int],
                    nbytes: int) -> None:
        """Append with PRE-computed seed-free crcs — the fused device
        checksum path.  ``crc0s[shard] = crc32c(0, chunk_bytes)`` (what
        ``ops.rs_kernels.crc32c_rows`` returns); each running hash
        advances by the crc32_combine identity

            crc32c(seed, D) == crc32c_zeros(seed, len(D)) ^ crc32c(0, D)

        so the device never needs the host's running seed.  Bitwise
        identical to :meth:`append` on the same bytes."""
        assert old_size == self.total_chunk_size
        if not crc0s:
            return
        if self.has_chunk_hash():
            for shard, c0 in crc0s.items():
                self.cumulative_shard_hashes[shard] = crc32c_zeros(
                    self.cumulative_shard_hashes[shard], nbytes) ^ c0
        self.total_chunk_size += nbytes

    def clear(self) -> None:
        self.total_chunk_size = 0
        self.cumulative_shard_hashes = [0xFFFFFFFF] * len(self.cumulative_shard_hashes)

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def get_projected_total_chunk_size(self) -> int:
        return self.projected_total_chunk_size

    def get_total_logical_size(self, sinfo: StripeInfo) -> int:
        # chunk sizes are STORED units; convert back to share space
        # before multiplying out to logical bytes
        return sinfo.stored_to_chunk(self.total_chunk_size) * \
            (sinfo.stripe_width // sinfo.chunk_size)

    def get_projected_total_logical_size(self, sinfo: StripeInfo) -> int:
        return sinfo.stored_to_chunk(self.projected_total_chunk_size) * \
            (sinfo.stripe_width // sinfo.chunk_size)

    def set_projected_total_logical_size(self, sinfo: StripeInfo, logical: int) -> None:
        assert sinfo.logical_offset_is_stripe_aligned(logical)
        self.projected_total_chunk_size = sinfo.chunk_to_stored(
            sinfo.aligned_logical_offset_to_chunk_offset(logical))

    def set_total_chunk_size_clear_hash(self, new_chunk_size: int) -> None:
        self.cumulative_shard_hashes = []
        self.total_chunk_size = new_chunk_size

    def has_chunk_hash(self) -> bool:
        return bool(self.cumulative_shard_hashes)

    def to_dict(self) -> dict:
        return {"total_chunk_size": self.total_chunk_size,
                "cumulative_shard_hashes": list(self.cumulative_shard_hashes),
                "version": self.version}

    @classmethod
    def from_dict(cls, d: dict) -> "HashInfo":
        """Inverse of :meth:`to_dict`."""
        h = cls(0)
        h.total_chunk_size = int(d["total_chunk_size"])
        h.cumulative_shard_hashes = [int(x) & 0xFFFFFFFF
                                     for x in d["cumulative_shard_hashes"]]
        h.version = int(d.get("version", 0))
        return h


# -- batched stripe codec ----------------------------------------------------

def _to_shard_major(buf: np.ndarray, k: int, chunk_size: int) -> np.ndarray:
    """[S * stripe_width] logical bytes -> [k, S * chunk_size] shard streams.

    Stripe s contributes bytes [s*W + i*c, s*W + (i+1)*c) to shard i at chunk
    offset s*c (doc/dev/osd_internals/erasure_coding.rst:55-75 layout).
    """
    stripes = buf.reshape(-1, k, chunk_size)          # [S, k, c]
    return np.ascontiguousarray(stripes.transpose(1, 0, 2)).reshape(k, -1)


def _from_shard_major(shards: np.ndarray, chunk_size: int) -> np.ndarray:
    """[k, S * chunk_size] shard streams -> [S * stripe_width] logical bytes."""
    k = shards.shape[0]
    stripes = shards.reshape(k, -1, chunk_size).transpose(1, 0, 2)  # [S, k, c]
    return np.ascontiguousarray(stripes).reshape(-1)


def _pack_shard_major(arrs: list[np.ndarray], k: int,
                      chunk_size: int, out: np.ndarray | None = None
                      ) -> np.ndarray:
    """Single-copy shard-major pack of MANY logical buffers: each
    buffer's [S, k, c] stripe view lands transposed DIRECTLY into one
    contiguous [k, total] output, one strided ``copyto`` per buffer.
    ``out`` (for example pinned memory) receives the pack when given."""
    total = sum(len(b) for b in arrs) // k
    if out is None:
        out = np.empty((k, total), dtype=np.uint8)
    off = 0
    for b in arrs:
        ln = len(b) // k
        s = ln // chunk_size
        np.copyto(out[:, off:off + ln].reshape(k, s, chunk_size),
                  b.reshape(s, k, chunk_size).swapaxes(0, 1))
        off += ln
    return out


def _as_u8(v) -> np.ndarray:
    if isinstance(v, (bytes, bytearray, memoryview)):
        return np.frombuffer(v, dtype=np.uint8)
    return np.asarray(v, dtype=np.uint8)


def _stripe_aligned(sinfo: StripeInfo, data) -> np.ndarray:
    buf = _as_u8(data)
    if len(buf) % sinfo.stripe_width:
        raise ValueError(f"len {len(buf)} not stripe aligned "
                         f"({sinfo.stripe_width})")
    return buf


def encode(sinfo: StripeInfo, ec_impl, data: bytes | np.ndarray,
           want: set | None = None) -> dict[int, np.ndarray]:
    """Encode a stripe-aligned logical buffer into per-shard chunk buffers:
    one ``encode_chunks`` call for ALL stripes (vs the reference's
    per-stripe loop at ECUtil.cc:136-148); returns {shard: chunk bytes}."""
    buf = _stripe_aligned(sinfo, data)
    k = ec_impl.get_data_chunk_count()
    n = ec_impl.get_chunk_count()
    assert k == sinfo.k
    if want is None:
        want = set(range(n))
    shard_len = (len(buf) // sinfo.stripe_width) * sinfo.chunk_size
    data_shards = _to_shard_major(buf, k, sinfo.chunk_size)
    encoded = {ec_impl.chunk_index(i): data_shards[i].copy() for i in range(k)}
    for i in range(k, n):
        encoded[ec_impl.chunk_index(i)] = np.zeros(shard_len, dtype=np.uint8)
    ec_impl.encode_chunks(set(range(n)), encoded)
    return {i: encoded[i] for i in want}


def encode_many(sinfo: StripeInfo, ec_impl,
                bufs: list[bytes | np.ndarray]) -> list[dict[int, np.ndarray]]:
    """Encode MANY stripe-aligned buffers (different objects, different
    PGs) in ONE ``encode_chunks`` call: their shard streams concatenate
    along the byte axis, one device launch covers the lot, and results
    split back per buffer.

    Returns one ``{chunk: bytes}`` dict per input buffer, identical to
    calling :func:`encode` per buffer.  An empty batch is a no-op."""
    if not bufs:
        return []
    k = ec_impl.get_data_chunk_count()
    n = ec_impl.get_chunk_count()
    arrs = [_stripe_aligned(sinfo, data) for data in bufs]
    shard_lens = [(len(b) // sinfo.stripe_width) * sinfo.chunk_size
                  for b in arrs]
    data_shards = _pack_shard_major(arrs, k, sinfo.chunk_size)
    total = data_shards.shape[1]
    encoded = {ec_impl.chunk_index(i): data_shards[i].copy()
               for i in range(k)}
    for i in range(k, n):
        encoded[ec_impl.chunk_index(i)] = np.zeros(total, dtype=np.uint8)
    ec_impl.encode_chunks(set(range(n)), encoded)
    out: list[dict[int, np.ndarray]] = []
    off = 0
    for ln in shard_lens:
        out.append({c: encoded[c][off:off + ln] for c in range(n)})
        off += ln
    return out


def _device_codec(ec_impl, nbytes: int):
    probe = getattr(ec_impl, "device_codec", None)
    if probe is None or ec_impl.get_sub_chunk_count() != 1:
        return None
    return probe(int(nbytes))


def _crc_rows_on(codec, rows: list[np.ndarray]) -> np.ndarray:
    """crc32c(0, row) of equal-length host ``rows`` on ``codec``'s device:
    the rows stack straight into pinned memory, go to the card in one
    ``non_blocking`` copy, the ``crc32c`` kernel runs, and the [r] crcs
    come back into pinned memory; the one wait is on their event."""
    from ..ops import rs_kernels
    from ..ops.pipeline import CodecPipeline, launch, settle
    dev = codec.torch_device
    block = CodecPipeline.host_block(dev, (len(rows), len(rows[0])))
    for i, row in enumerate(rows):
        block[i] = row
    return settle(launch(dev, block, rs_kernels.crc32c_rows,
                         range(len(rows)), None))


def hinfo_append(hinfo: HashInfo, old_size: int,
                 chunks: dict[int, np.ndarray], ec_impl=None) -> None:
    """HashInfo maintenance with the checksums computed on the codec's
    device: when the plugin routes a call of this size to a device codec
    and the hashes are live, the appended chunk rows go through ONE
    ``crc32c_rows`` call (:func:`_crc_rows_on`) and the seed-free results
    chain through :meth:`HashInfo.append_crcs`.  Everything else (numpy
    routing, hash-less objects, uneven appends) takes the
    bitwise-identical :meth:`HashInfo.append`.  A failure on the card
    raises: nothing is checksummed on the host instead."""
    if not chunks:
        return
    if hinfo.has_chunk_hash() and ec_impl is not None:
        lens = {len(v) for v in chunks.values()}
        if len(lens) == 1:
            nbytes = lens.pop()
            codec = _device_codec(ec_impl, nbytes * len(chunks)) \
                if nbytes else None
            if codec is not None:
                shards = sorted(chunks)
                crc0 = _crc_rows_on(codec, [_as_u8(chunks[s])
                                            for s in shards])
                hinfo.append_crcs(old_size,
                                  {s: int(c)
                                   for s, c in zip(shards, crc0)}, nbytes)
                return
    hinfo.append(old_size, chunks)


# -- pipelined forms (ops/pipeline.py) ----------------------------------------
# The SAME batched relayouts routed through ops.pipeline.CodecPipeline: the
# host pack runs while earlier batches are in flight on the card, and the
# wait happens only at the pipeline's completion boundary.  They engage
# only when the plugin exposes a tensor codec (``device_codec``) for a call
# of this size; when the profile routes the call to the numpy host codec
# they return None and the caller keeps the synchronous path.  A failure
# on the card fails the future: no batch is served on the host instead.

def encode_many_pipelined(sinfo: StripeInfo, ec_impl,
                          bufs: list[bytes | np.ndarray], pipeline,
                          owner: str | None = None):
    """Async :func:`encode_many`: returns a ``PipelineFuture`` resolving
    to the identical per-buffer ``{chunk: bytes}`` list, or None when the
    codec has no device path.  The pack (shard-major relayout) goes
    straight into rows [0, k) of the batch's pinned [n, total] block and
    overlaps in-flight card work; the parity lands in its rows [k, n),
    and every chunk handed out is a view of that block."""
    if not bufs:
        return None
    k = ec_impl.get_data_chunk_count()
    n = ec_impl.get_chunk_count()
    arrs = [_stripe_aligned(sinfo, data) for data in bufs]
    codec = _device_codec(ec_impl, sum(len(b) for b in arrs))
    if codec is None:
        return None
    shard_lens = [(len(b) // sinfo.stripe_width) * sinfo.chunk_size
                  for b in arrs]

    def pack():
        block = pipeline.host_block(codec.torch_device,
                                    (n, sum(shard_lens)))
        _pack_shard_major(arrs, k, sinfo.chunk_size, out=block[:k])
        return block

    def dispatch(block):
        return pipeline.dispatch_encode(codec, block, sinfo.chunk_size)

    def unpack(block, _settled):
        out: list[dict[int, np.ndarray]] = []
        off = 0
        for ln in shard_lens:
            out.append({ec_impl.chunk_index(i): block[i, off:off + ln]
                        for i in range(n)})
            off += ln
        return out

    return pipeline.submit(pack, dispatch, unpack, kind="encode",
                           owner=owner, ops=len(bufs))


def _groups(keys) -> list[tuple[object, list[int]]]:
    """``(key, indices)`` of each distinct key, in order of first
    appearance: the batches that share a decode signature."""
    by_sig: dict[object, list[int]] = {}
    for i, key in enumerate(keys):
        by_sig.setdefault(key, []).append(i)
    return list(by_sig.items())


def _submit_slot_group(ec_impl, codec, chunk_dicts, sig, recovered: int,
                       pipeline, take, kind: str, owner: str | None):
    """One decode group submitted in the slot layout, the batch layout of
    every pipelined apply (``ops/pipeline.py``).  The group's block
    [k + p, total] holds the k logical data rows in order, then, in
    logical id order, the p parity rows the decode reads or recovers.
    It recovers the missing rows among logical ids [0, ``recovered``): k
    for a read, n for recovery.  The pack copies each op's survivors once
    into their rows; the survivors go to the card as the block's runs of
    rows and the recovered rows land in theirs (``dispatch_decode``'s
    ``rows`` and ``land``).  ``take(block, slot, off, ln)`` gives each op's result
    from its columns, ``slot`` mapping a logical id to its row."""
    k = ec_impl.get_data_chunk_count()

    def pack():
        # wire ids are PHYSICAL; the codec's rows are LOGICAL
        phys, _ = ec_impl.remap_for_decode({c: c for c in sig}, [])
        erasures = [i for i in range(recovered) if i not in phys]
        src = codec.decode_matrix(erasures, available=list(phys))[1] \
            if erasures else list(range(k))
        parity = sorted({i for i in (*src, *erasures) if i >= k})
        slot = {i: i for i in range(k)}
        slot.update((p, k + j) for j, p in enumerate(parity))
        ops, lens = [], []
        for chunks in chunk_dicts:
            chunks = {c: _as_u8(v) for c, v in chunks.items()}
            sizes = {len(v) for v in chunks.values()}
            if len(sizes) != 1:
                raise ValueError("uneven shard buffers")
            ops.append(chunks)
            lens.append(sizes.pop())
        block = pipeline.host_block(codec.torch_device,
                                    (k + len(parity), sum(lens)))
        off = 0
        for chunks, ln in zip(ops, lens):
            for s in src:
                block[slot[s], off:off + ln] = chunks[phys[s]]
            off += ln
        return block, slot, [slot[s] for s in src], erasures, list(phys), lens

    def dispatch(packed):
        block, slot, rows, erasures, avail, _lens = packed
        if not erasures:
            return None                  # all data rows survived: host-only
        return pipeline.dispatch_decode(codec, block, rows,
                                        [slot[e] for e in erasures],
                                        erasures, avail)

    def unpack(packed, _settled):
        block, slot, _rows, _erasures, _avail, lens = packed
        out = []
        off = 0
        for ln in lens:
            out.append(take(block, slot, off, ln))
            off += ln
        return out

    return pipeline.submit(pack, dispatch, unpack, kind=kind, owner=owner,
                           ops=len(chunk_dicts))


def decode_many_pipelined(sinfo: StripeInfo, ec_impl,
                          batches: list[dict[int, np.ndarray]],
                          pipeline, owner: str | None = None):
    """Async :func:`decode_many`: one pipeline item per distinct
    available-chunk signature, in the slot layout
    (:func:`_submit_slot_group`); each op's bytes come out of its columns
    in one strided copy (:func:`_stripes_bytes`).  Returns
    ``[(idxs, future), ...]`` where each future resolves to the logical
    bytes for those batch indices, or None when the codec has no device
    path."""
    if not batches:
        return None
    total_bytes = sum(sum(_as_u8(v).nbytes for v in chunks.values())
                      for chunks in batches)
    codec = _device_codec(ec_impl, total_bytes)
    if codec is None:
        return None
    k = ec_impl.get_data_chunk_count()

    def take(block, _slot, off, ln):
        return _stripes_bytes(block[:k, off:off + ln], sinfo.chunk_size)
    return [(idxs, _submit_slot_group(ec_impl, codec,
                                      [batches[i] for i in idxs], sig, k,
                                      pipeline, take, "decode", owner))
            for sig, idxs in _groups(frozenset(b) for b in batches)]


def _stripes_bytes(shards: np.ndarray, chunk_size: int) -> bytes:
    """:func:`_from_shard_major` straight into ``bytes``: the [k, S * c]
    shard columns (a view into a larger block) read as [S, k, c], the
    stripe axis first, and copied once, ``memoryview.tobytes`` moving c
    contiguous bytes at a time."""
    k, ln = shards.shape
    return memoryview(shards.reshape(k, ln // chunk_size, chunk_size)
                      .transpose(1, 0, 2)).tobytes()


def decode(sinfo: StripeInfo, ec_impl,
           to_decode: dict[int, np.ndarray]) -> bytes:
    """Reconstruct the logical buffer from >=k shard chunk streams
    (ECUtil.cc:9-45), batched across all stripes in one decode call."""
    chunks = {i: _as_u8(v) for i, v in to_decode.items()}
    if len({len(v) for v in chunks.values()}) != 1:
        raise ValueError("uneven shard buffers")
    decoded = ec_impl.decode_concat(chunks)
    k = ec_impl.get_data_chunk_count()
    logical = _from_shard_major(
        np.frombuffer(decoded, dtype=np.uint8).reshape(k, -1),
        sinfo.chunk_size)
    return logical.tobytes()


def _group_streams(chunk_dicts: list[dict], sig
                   ) -> tuple[dict[int, np.ndarray], list[int]]:
    """Assemble one signature group's per-op shard streams into
    ``({chunk: concatenated [total] bytes}, per-op lens)``: the host
    paths' input to one plugin call."""
    streams: dict[int, list[np.ndarray]] = {c: [] for c in sig}
    lens: list[int] = []
    for chunks in chunk_dicts:
        chunks = {c: _as_u8(v) for c, v in chunks.items()}
        sizes = {len(v) for v in chunks.values()}
        if len(sizes) != 1:
            raise ValueError("uneven shard buffers")
        lens.append(sizes.pop())
        for c in sig:
            streams[c].append(chunks[c])
    return ({c: (np.concatenate(v) if len(v) > 1 else v[0])
             for c, v in streams.items()}, lens)


def decode_many(sinfo: StripeInfo, ec_impl,
                batches: list[dict[int, np.ndarray]]) -> list[bytes]:
    """Decode MANY ops' shard chunk-dicts with ONE ``decode_concat`` per
    distinct available-chunk signature — the decode-side sibling of
    :func:`encode_many`.  Results split back per op, bit-identical to
    calling :func:`decode` per dict."""
    results: list[bytes | None] = [None] * len(batches)
    k = ec_impl.get_data_chunk_count()
    for sig, idxs in _groups(frozenset(b) for b in batches):
        concat, lens = _group_streams([batches[i] for i in idxs], sig)
        decoded = np.frombuffer(
            ec_impl.decode_concat(concat), dtype=np.uint8).reshape(k, -1)
        off = 0
        for i, ln in zip(idxs, lens):
            results[i] = _stripes_bytes(decoded[:, off:off + ln],
                                        sinfo.chunk_size)
            off += ln
    return results


# -- the repair path ------------------------------------------------------------
# Recovery waves (decode_shards_many), the chain-repair hop
# (partial_sum_accumulate) and the regenerating-repair legs (regen_project,
# regen_combine).  With a pipeline they dispatch through
# ops.pipeline.CodecPipeline on its CUDA stream, each in the batch layout
# (a block of chunk rows the result lands in); a failure on the card
# fails the future and raises here, and nothing is served on the host
# instead.  The chain hop and the regen legs run where ``device`` says:
# "cuda" by default, "cpu" (the plain versions) or "numpy" (the exact host
# GF math) when the caller asks; a pipeline only makes the dispatch
# asynchronous.

def decode_shards_many(sinfo: StripeInfo, ec_impl,
                       batches: list[tuple[dict[int, np.ndarray], set]],
                       pipeline=None, owner: str | None = "recovery"
                       ) -> list[dict[int, np.ndarray]]:
    """Reconstruct specific shards for MANY objects with ONE
    ``ec_impl.decode`` per distinct (survivor signature, want set) — the
    recovery-side sibling of :func:`decode_many`.  Parity is positionwise,
    so objects sharing both signatures share a decode matrix and their
    chunk streams concatenate along the byte axis into one device
    dispatch; results split back per object, bit-identical to calling
    :func:`decode_shards` per object.

    ``batches`` is ``[(available {chunk: bytes}, want set), ...]``.  Only
    valid for whole-chunk codes (``get_sub_chunk_count() == 1``); clay's
    fractional repair reads are not positionwise across objects.

    With a ``pipeline`` and a plugin that routes the call to a tensor
    codec, each (signature, want) group dispatches through the pipeline
    in the slot layout (:func:`_submit_slot_group`): each object's
    survivors are packed once into their rows, the erased chunks land in
    theirs, and each wanted chunk is handed out as a view of its row.
    Group i+1's host pack overlaps group i's reconstruct on the card, and
    results are fetched after the last dispatch."""
    results: list[dict[int, np.ndarray] | None] = [None] * len(batches)
    groups = _groups((frozenset(avail), frozenset(want))
                     for avail, want in batches)
    codec = None if pipeline is None or not batches else _device_codec(
        ec_impl, sum(sum(_as_u8(v).nbytes for v in avail.values())
                     for avail, _want in batches))
    if codec is not None:
        n = ec_impl.get_chunk_count()
        pending = []
        for (sig, want_sig), idxs in groups:
            _, want_l = ec_impl.remap_for_decode({}, sorted(want_sig))

            def take(block, slot, off, ln, want_l=want_l):
                return {ec_impl.chunk_index(w): block[slot[w], off:off + ln]
                        for w in want_l}
            pending.append((idxs, _submit_slot_group(
                ec_impl, codec, [batches[i][0] for i in idxs], sig, n,
                pipeline, take, "recover", owner)))
        for idxs, fut in pending:
            for i, rec in zip(idxs, fut.result()):
                results[i] = rec
        return results
    for (sig, want_sig), idxs in groups:
        want = set(want_sig)
        concat, lens = _group_streams([batches[i][0] for i in idxs], sig)
        decoded = ec_impl.decode(want, concat, 0)
        off = 0
        for i, ln in zip(idxs, lens):
            results[i] = {c: np.asarray(decoded[c], dtype=np.uint8)
                          [off:off + ln] for c in want}
            off += ln
    return results


def decode_shards(sinfo: StripeInfo, ec_impl, available: dict[int, np.ndarray],
                  want: set, chunk_size: int = 0) -> dict[int, np.ndarray]:
    """Reconstruct specific shards (recovery path, ECUtil.cc:47-118 shape).

    ``chunk_size`` is the full per-shard size; when the available buffers are
    smaller, sub-chunk-aware codes (clay) route through their fractional
    repair path (ErasureCodeClay.cc:107-122)."""
    chunks = {i: _as_u8(v) for i, v in available.items()}
    return ec_impl.decode(set(want), chunks, chunk_size)


def _gf_apply_routed(mat: np.ndarray, rows, k: int, device: str,
                     pipeline, owner: str | None, kind: str) -> np.ndarray:
    """``mat`` [r, k] times ``rows[:k]``, XORed into ``rows[k:]`` when
    there are more rows (a hop's running sums) -> uint8 [r, N]: the one
    engine under the repair legs.  ``device`` "cuda" (the default of
    every leg) or "cpu" packs one (pinned) block [k + r, N], the data
    rows and then the running sums or r empty rows, and runs
    :func:`ops.pipeline.apply_rows` there, the result landing in the
    block's last r rows: through ``pipeline`` when one is given (its
    stream, breaker and attribution; a failure fails the future and
    raises here), synchronously on the current stream otherwise.
    "numpy" runs the exact host GF math."""
    from ..ops import codec as _codec
    from ..ops.pipeline import CodecPipeline, apply_rows, settle
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if device == "numpy":
        stack = np.stack(rows)
        acc = stack[k:] if len(stack) > k else None
        return _codec.scale_accumulate_host(mat, stack[:k], acc)
    dev = _codec.torch_device(device)
    sums = len(rows) > k

    def pack():
        block = CodecPipeline.host_block(dev, (k + len(mat), len(rows[0])))
        for i, row in enumerate(rows):
            block[i] = row
        return block

    if pipeline is None:
        return settle(apply_rows(mat, pack(), k, sums, dev))[k:]
    fut = pipeline.submit(
        pack, lambda block: pipeline.dispatch_apply(mat, block, k, sums, dev),
        lambda block, _settled: block[k:], kind=kind, owner=owner, ops=1)
    return fut.result()


def partial_sum_accumulate(coeffs, stream, acc, pipeline=None,
                           owner: str | None = "recovery",
                           device: str = "cuda") -> list[bytes]:
    """One streaming-repair hop's partial-sum update: scale the hop's
    local chunk ``stream`` (every plan object concatenated) by its
    per-erased-row decode ``coeffs`` and XOR into ``acc``.

    ``acc`` is ``None`` on the first hop, else one running buffer per
    erased row.  Returns one bytes buffer per row.  On ``device`` (see
    :func:`_gf_apply_routed`) the stream and the running sums go to the
    card as one block: one copy, the ``gf_apply`` kernel, the XOR
    there."""
    mat = np.asarray([[int(c) & 0xFF] for c in coeffs], dtype=np.uint8)
    rows = [_as_u8(stream).reshape(-1)]
    rows += [] if acc is None else [_as_u8(a) for a in acc]
    out = _gf_apply_routed(mat, rows, 1, device, pipeline, owner,
                           "partial_sum")
    return [out[i].tobytes() for i in range(out.shape[0])]


def regen_project(coeffs: bytes | np.ndarray, stream, sub_count: int,
                  pipeline=None, owner: str | None = "recovery",
                  device: str = "cuda") -> bytes:
    """One helper's regenerating-repair leg: project the stored chunk's
    ``sub_count`` symbol rows down to the single beta-stream
    ``psi_f . chunk`` it ships to the newcomer (len(stream)/sub_count
    bytes — the d-fold wire saving the product-matrix code exists
    for).  ``device`` and ``pipeline`` as in :func:`_gf_apply_routed`."""
    data = _as_u8(stream)
    if data.size % sub_count:
        raise ValueError(f"chunk of {data.size} bytes is not a whole "
                         f"number of {sub_count} sub-chunks")
    mat = np.frombuffer(bytes(coeffs), dtype=np.uint8).reshape(1, sub_count)
    out = _gf_apply_routed(mat, data.reshape(sub_count, -1), sub_count,
                           device, pipeline, owner, "regen")
    return out.reshape(-1).tobytes()


def regen_combine(mat: bytes | np.ndarray, streams: list, sub_count: int,
                  pipeline=None, owner: str | None = "recovery",
                  device: str = "cuda") -> bytes:
    """The newcomer's regenerating-repair leg: combine the d stacked
    helper beta-streams into the lost chunk's ``sub_count`` symbol rows
    (bitwise-exact repair).  ``device`` and ``pipeline`` as in
    :func:`_gf_apply_routed`."""
    m = np.frombuffer(bytes(mat), dtype=np.uint8).reshape(sub_count,
                                                          len(streams))
    out = _gf_apply_routed(m, [_as_u8(s) for s in streams], len(streams),
                           device, pipeline, owner, "regen")
    return out.reshape(-1).tobytes()

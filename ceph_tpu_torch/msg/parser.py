"""Zero-copy incremental frame parsing for the async messenger.

Bitwise-compatible with ``backend/wire.py``'s v2 framing (same preamble
struct, crc32c epilogue in crc mode, truncated HMAC-SHA256 in secure
mode) but built for a readiness-driven receive path:

- bytes accumulate in ONE growable buffer consumed by an offset head
  pointer, so a frame spanning many ``recv`` chunks is never re-copied
  per feed (``FrameParser`` re-slices its bytearray on every parse);
- segments come back as ``memoryview`` slices into that buffer —
  valid until the next :meth:`feed` — so decode paths (``bytes.decode``
  on the type-name segment, ``pickle.loads`` on the payload) read the
  receive buffer in place;
- the connection banner is part of the stream state (state machine
  step 0), not a caller-side special case.

The buffer compacts only when the consumed head outgrows half the
buffer — amortized O(bytes), no per-frame copies.
"""
from __future__ import annotations

import hmac
from hashlib import sha256

import numpy as np

from ..backend.ecutil import crc32c
from ..backend.wire import (BANNER, MAX_SEGMENTS, WireError, _CRC,
                            _MAC_LEN, _PREAMBLE)
from ..common import copy_ledger

_COMPACT_MIN = 1 << 16


def _crc(data) -> int:
    # np.frombuffer is a zero-copy view of the receive buffer — the
    # segment checksum never materializes payload bytes (the native
    # crc kernel reads pointer+length in place)
    return crc32c(0xFFFFFFFF,
                  np.frombuffer(data, dtype=np.uint8)) ^ 0xFFFFFFFF


class StreamParser:
    """Incremental v2-frame parser with an offset-consumed buffer.

    ``feed(data)`` returns ``[(tag, [memoryview, ...]), ...]``; the
    memoryviews alias the internal buffer and must be consumed before
    the next ``feed``.  ``frame_sizes`` mirrors ``FrameParser``'s
    ``track_sizes`` contract: real on-wire length per parsed frame, in
    order, drained by the caller.
    """

    def __init__(self, secret: bytes | None = None, *,
                 expect_banner: bool = False):
        self.secret = secret
        self._buf = bytearray()
        self._pos = 0
        self._banner_pending = expect_banner
        self.frame_sizes: list[int] = []

    def set_secret(self, key: bytes | None) -> None:
        """Switch crc mode <-> secure mode mid-stream (the post-auth
        handoff).  Buffered-but-unparsed bytes are KEPT — the strictly
        request/response handshake leaves the buffer empty here, but a
        pipelined peer's first secure frame must not be dropped."""
        self.secret = key

    def pending(self) -> int:
        return len(self._buf) - self._pos

    def feed(self, data) -> list:
        # compact BEFORE handing out new views: last feed's memoryviews
        # are dead by now, so the resize is safe — and if a caller
        # retained one anyway, fall back to a fresh buffer rather than
        # surfacing BufferError on the hot path
        self._maybe_compact()
        try:
            self._buf += data
        except BufferError:
            # retained views pin the buffer: rebuild.  This copies the
            # unconsumed tail AND the new bytes — report both to the
            # copy ledger so bytes_copied_per_byte_served cannot
            # undercount the parser's own copies
            copy_ledger.count_copy(
                "fallback", (len(self._buf) - self._pos) + len(data))
            self._buf = self._buf[self._pos:] + bytes(data)
            self._pos = 0
        frames = []
        while True:
            f = self._try_parse()
            if f is None:
                break
            frames.append(f)
        return frames

    def _maybe_compact(self) -> None:
        if self._pos > _COMPACT_MIN and self._pos * 2 > len(self._buf):
            try:
                moved = len(self._buf) - self._pos
                del self._buf[:self._pos]
                self._pos = 0
                # amortized head-trim moves the unconsumed tail down —
                # the parser's only steady-state copy; count it so the
                # ledger's ratio carries the true parser overhead
                copy_ledger.count_copy("compaction", moved)
            except BufferError:
                pass                     # retained views pin the buffer

    def _try_parse(self):
        if self._banner_pending:
            if len(self._buf) - self._pos < len(BANNER):
                return None
            view = memoryview(self._buf)
            if view[self._pos:self._pos + len(BANNER)] != BANNER:
                raise WireError("banner mismatch")
            self._pos += len(BANNER)
            self._banner_pending = False
        head = _PREAMBLE.size + _CRC.size
        avail = len(self._buf) - self._pos
        if avail < head:
            return None
        view = memoryview(self._buf)
        pre = view[self._pos:self._pos + _PREAMBLE.size]
        (want_crc,) = _CRC.unpack_from(view, self._pos + _PREAMBLE.size)
        if _crc(pre) != want_crc:
            raise WireError("preamble crc mismatch")
        tag, nseg, _flags, *lens = _PREAMBLE.unpack(pre)
        if not 1 <= nseg <= MAX_SEGMENTS:
            raise WireError(f"bad segment count {nseg}")
        seg_lens = lens[:nseg]
        body = sum(seg_lens)
        tail = _MAC_LEN if self.secret is not None else _CRC.size * nseg
        total = head + body + tail
        if avail < total:
            return None
        segs, off = [], self._pos + head
        for ln in seg_lens:
            segs.append(view[off:off + ln])
            off += ln
        if self.secret is None:
            for i, s in enumerate(segs):
                (want,) = _CRC.unpack_from(view, off + i * _CRC.size)
                if _crc(s) != want:
                    raise WireError(f"segment {i} crc mismatch")
        else:
            want = bytes(view[off:off + _MAC_LEN])
            h = hmac.new(self.secret, pre, sha256)
            for s in segs:               # incremental: no segment join
                h.update(s)
            if not hmac.compare_digest(want, h.digest()[:_MAC_LEN]):
                raise WireError("frame MAC mismatch")
        self._pos += total
        self.frame_sizes.append(total)
        return tag, segs

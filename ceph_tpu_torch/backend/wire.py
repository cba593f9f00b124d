"""Wire protocol: v2-style framing with CRC and secure modes.

Analog of the reference messenger's on-wire layer (reference:
src/msg/async/ProtocolV2.cc, 2905 LoC; frame layout in
src/msg/async/frames_v2.h; AEAD in src/msg/async/crypto_onwire.cc):
banner exchange, a hello handshake, then length-prefixed frames of up to
4 segments, each integrity-protected — crc32c per segment in ``crc``
mode, HMAC-SHA256 with a session key (e.g. a cephx session key,
ceph_tpu_torch/auth) in ``secure`` mode.

The deterministic in-process MessageBus stays the DELIVERY substrate
(the card carries the math; the bus carries control) — this module makes
the bus's payloads REAL bytes:
``MessageBus(wire=...)`` serializes every message through a frame on
send and parses it back on delivery, so type registration, segment
integrity, and codec roundtripping are exercised on every message, and
corruption faults become *detected* frame errors instead of silent
state divergence.

Frame layout (little-endian):

    preamble:  tag u8 | num_segments u8 | flags u16 | seg_len u32 x4 |
               crc32c(preamble) u32
    segments:  bytes  (per segment)
    epilogue:  crc mode: crc32c u32 per segment
               secure mode: HMAC-SHA256[:16] over preamble+segments

Like frames_v2.h, the preamble CRC covers lengths before any payload is
trusted, and a parser never yields a partially-validated frame.

The port's copy of ``ceph_tpu.backend.wire``, byte for byte on the wire
(the banner included, so the two packages' peers interoperate).  The
frame crc is the host crc32c of ``ecutil``, as in the reference: the
frames' bytes are the reference's, so it stays on the host.  A message
frame's payload segment pickles the port's own message classes.
"""
from __future__ import annotations

import hmac
import pickle
import struct
from dataclasses import dataclass
from hashlib import sha256

import numpy as np

from .ecutil import crc32c

BANNER = b"ceph_tpu msgr v2\n"
MAX_SEGMENTS = 4                        # frames_v2.h MAX_NUM_SEGMENTS
_PREAMBLE = struct.Struct("<BBH4I")
_CRC = struct.Struct("<I")
_MAC_LEN = 16                           # truncated HMAC-SHA256

# frame tags (ProtocolV2 Tag enum shape)
TAG_HELLO = 1
TAG_AUTH = 2
TAG_MESSAGE = 17


class WireError(Exception):
    """Framing/integrity violation (the reference drops the connection)."""


def _crc(data: bytes) -> int:
    return crc32c(0xFFFFFFFF, data) ^ 0xFFFFFFFF


def frame_encode(tag: int, segments: list[bytes], *,
                 secret: bytes | None = None) -> bytes:
    """One frame; ``secret`` switches crc mode -> secure (HMAC) mode."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise WireError(f"{len(segments)} segments (1..{MAX_SEGMENTS})")
    lens = [len(s) for s in segments] + [0] * (MAX_SEGMENTS - len(segments))
    pre = _PREAMBLE.pack(tag, len(segments), 0, *lens)
    out = [pre, _CRC.pack(_crc(pre))]
    out += segments
    if secret is None:
        out += [_CRC.pack(_crc(s)) for s in segments]
    else:
        mac = hmac.new(secret, pre + b"".join(segments), sha256).digest()
        out.append(mac[:_MAC_LEN])
    return b"".join(out)


def frame_encode_parts(tag: int, segments: list, *,
                       secret: bytes | None = None) -> list:
    """:func:`frame_encode` without the payload join: returns the frame
    as an ordered list of buffers for a gather-write path (the async
    connection splices them into its write queue unjoined).

    Each entry of ``segments`` is either a bytes-like segment or a LIST
    of bytes-like pieces forming one scattered segment (the sideband's
    length table + spliced payload views).  Byte-for-byte identical on
    the wire to ``frame_encode(tag, [b"".join(...), ...])``: the
    preamble lengths sum the pieces, the HMAC updates incrementally in
    piece order (exactly how :class:`~ceph_tpu_torch.msg.parser.StreamParser`
    verifies), and the crc-mode epilogue seed-chains across pieces.
    Small control pieces coalesce into the head/tail buffers; only the
    large scattered pieces stay unjoined, so queue entries stay O(payloads).
    """
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise WireError(f"{len(segments)} segments (1..{MAX_SEGMENTS})")
    flat = [s if isinstance(s, list) else [s] for s in segments]
    lens = [sum(len(p) for p in seg) for seg in flat]
    pre = _PREAMBLE.pack(tag, len(segments), 0,
                         *(lens + [0] * (MAX_SEGMENTS - len(segments))))
    parts: list = []
    head = [pre, _CRC.pack(_crc(pre))]

    def _flush_head():
        if head:
            parts.append(b"".join(head) if len(head) > 1 else head[0])
            head.clear()

    if secret is not None:
        h = hmac.new(secret, pre, sha256)
        for seg in flat:
            for p in seg:
                h.update(p)
                if isinstance(p, memoryview) and len(p) >= 1024:
                    _flush_head()
                    parts.append(p)
                else:
                    head.append(bytes(p) if isinstance(p, memoryview)
                                else p)
        head.append(h.digest()[:_MAC_LEN])
    else:
        tail = []
        for seg in flat:
            c = 0xFFFFFFFF
            for p in seg:
                c = crc32c(c, p if isinstance(p, bytes)
                           else np.frombuffer(p, dtype=np.uint8))
                if isinstance(p, memoryview) and len(p) >= 1024:
                    _flush_head()
                    parts.append(p)
                else:
                    head.append(bytes(p) if isinstance(p, memoryview)
                                else p)
            tail.append(_CRC.pack(c ^ 0xFFFFFFFF))
        head.extend(tail)
    _flush_head()
    return parts


class FrameParser:
    """Incremental parser: feed bytes, yields (tag, segments) frames.
    Partial input yields nothing until the full frame (and its
    integrity data) arrives — no partially-validated output."""

    def __init__(self, secret: bytes | None = None):
        self.secret = secret
        self._buf = bytearray()
        # opt-in (wire accounting): when True, each parsed frame's REAL
        # on-wire length (preamble + crcs/mac + body) is appended here in
        # frame order; the consumer drains the list after every feed()
        self.track_sizes = False
        self.frame_sizes: list[int] = []

    def feed(self, data: bytes) -> list[tuple[int, list[bytes]]]:
        self._buf += data
        frames = []
        while True:
            f = self._try_parse()
            if f is None:
                return frames
            frames.append(f)

    def _try_parse(self):
        head = _PREAMBLE.size + _CRC.size
        if len(self._buf) < head:
            return None
        pre = bytes(self._buf[:_PREAMBLE.size])
        (want_crc,) = _CRC.unpack_from(self._buf, _PREAMBLE.size)
        if _crc(pre) != want_crc:
            raise WireError("preamble crc mismatch")
        tag, nseg, flags, *lens = _PREAMBLE.unpack(pre)
        if not 1 <= nseg <= MAX_SEGMENTS:
            raise WireError(f"bad segment count {nseg}")
        seg_lens = lens[:nseg]
        body = sum(seg_lens)
        tail = (_MAC_LEN if self.secret is not None
                else _CRC.size * nseg)
        total = head + body + tail
        if len(self._buf) < total:
            return None
        segs, off = [], head
        for ln in seg_lens:
            segs.append(bytes(self._buf[off:off + ln]))
            off += ln
        if self.secret is None:
            for i, s in enumerate(segs):
                (want,) = _CRC.unpack_from(self._buf, off + i * _CRC.size)
                if _crc(s) != want:
                    raise WireError(f"segment {i} crc mismatch")
        else:
            want = bytes(self._buf[off:off + _MAC_LEN])
            mac = hmac.new(self.secret, pre + b"".join(segs),
                           sha256).digest()[:_MAC_LEN]
            if not hmac.compare_digest(want, mac):
                raise WireError("frame MAC mismatch")
        del self._buf[:total]
        if self.track_sizes:
            self.frame_sizes.append(total)
        return tag, segs


# -- message codec ----------------------------------------------------------

def message_encode(msg, *, secret: bytes | None = None) -> bytes:
    """A bus message as one MESSAGE frame: segment 0 = type name,
    segment 1 = payload (the reference's header/payload segment split)."""
    return frame_encode(
        TAG_MESSAGE,
        [type(msg).__name__.encode(), pickle.dumps(msg)],
        secret=secret)


def message_decode(tag: int, segs: list[bytes]):
    if tag != TAG_MESSAGE or len(segs) != 2:
        raise WireError(f"not a message frame: tag {tag}")
    from . import messages as m
    name = segs[0].decode()
    klass = getattr(m, name, None)
    if klass is None or not hasattr(klass, "__dataclass_fields__"):
        raise WireError(f"unknown message type {name!r}")
    msg = pickle.loads(segs[1])
    if type(msg).__name__ != name:
        raise WireError("segment type name mismatch")
    return msg


# -- connection handshake ---------------------------------------------------

@dataclass
class Hello:
    """TAG_HELLO payload (ProtocolV2 HelloFrame shape)."""
    entity: str
    features: int = 1


class FramedConnection:
    """One endpoint of a framed byte stream.  Deterministic and
    in-process: ``out`` accumulates bytes for the peer; ``receive``
    consumes peer bytes, returning decoded messages after the handshake
    completes.  Banner first, then HELLO frames, then messages."""

    def __init__(self, entity: str, secret: bytes | None = None):
        self.entity = entity
        self.secret = secret
        self.parser = FrameParser(secret)
        self.out = bytearray()
        self.peer_hello: Hello | None = None
        self._banner_buf = bytearray()
        self._banner_seen = False
        self.out += BANNER
        self.out += frame_encode(
            TAG_HELLO, [pickle.dumps(Hello(entity))], secret=secret)

    @property
    def ready(self) -> bool:
        return self.peer_hello is not None

    def send(self, msg) -> None:
        if not self.ready:
            raise WireError("handshake incomplete")
        self.out += message_encode(msg, secret=self.secret)

    def receive(self, data: bytes) -> list:
        msgs = []
        if not self._banner_seen:
            # buffer like the frame parser: a banner split across reads
            # is normal stream behavior, not an error
            self._banner_buf += data
            if len(self._banner_buf) < len(BANNER):
                return msgs
            if self._banner_buf[:len(BANNER)] != BANNER:
                raise WireError(
                    f"banner mismatch: "
                    f"{bytes(self._banner_buf[:len(BANNER)])!r}")
            self._banner_seen = True
            data = bytes(self._banner_buf[len(BANNER):])
            self._banner_buf.clear()
        for tag, segs in self.parser.feed(data):
            if tag == TAG_HELLO:
                self.peer_hello = pickle.loads(segs[0])
            else:
                msgs.append(message_decode(tag, segs))
        return msgs

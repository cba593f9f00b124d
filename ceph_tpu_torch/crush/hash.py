"""CRUSH rjenkins1 hash, bit-exact to the reference
(reference: src/crush/hash.c:12-90, seed 1315423911 at :24).

Three implementations sharing one algorithm:
- scalar Python ints (used by the exact rule interpreter),
- vectorized numpy uint32,
- torch int64 tensors holding uint32 values (the plain version of the bulk
  straw2 mapper; csrc/crush_straw2.cu has the same mix in uint32_t).

All arithmetic is uint32 with C wraparound; shifts are logical.  Torch has
no full uint32 arithmetic, so the torch version keeps each value in the low
32 bits of an int64 and masks after every subtraction and left shift; a
right shift of a non-negative value is then logical.
"""
from __future__ import annotations

import numpy as np

CRUSH_HASH_SEED = 1315423911
_M = 0xFFFFFFFF


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 13
    b = (b - c) & _M; b = (b - a) & _M; b ^= (a << 8) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 13
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 12
    b = (b - c) & _M; b = (b - a) & _M; b ^= (a << 16) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 5
    a = (a - b) & _M; a = (a - c) & _M; a ^= c >> 3
    b = (b - c) & _M; b = (b - a) & _M; b ^= (a << 10) & _M
    c = (c - a) & _M; c = (c - b) & _M; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= _M
    h = (CRUSH_HASH_SEED ^ a) & _M
    b, x, y = a, 231232, 1232
    b, x, h = _mix(b, x, h)
    y, a, h = _mix(y, a, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= _M; b &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= _M; b &= _M; c &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def crush_hash32_4(a: int, b: int, c: int, d: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


def crush_hash32_5(a: int, b: int, c: int, d: int, e: int) -> int:
    a &= _M; b &= _M; c &= _M; d &= _M; e &= _M
    h = (CRUSH_HASH_SEED ^ a ^ b ^ c ^ d ^ e) & _M
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    e, x, h = _mix(e, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    d, x, h = _mix(d, x, h)
    y, e, h = _mix(y, e, h)
    return h


# -- numpy vectorized -------------------------------------------------------

def _mix_np(a, b, c):
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def crush_hash32_3_np(a, b, c):
    """Vectorized 3-arg hash over numpy uint32 arrays (broadcasting)."""
    a = np.asarray(a).astype(np.uint32)
    b = np.asarray(b).astype(np.uint32)
    c = np.asarray(c).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b ^ c
        x = np.uint32(231232) + np.zeros_like(h)
        y = np.uint32(1232) + np.zeros_like(h)
        a, b, h = _mix_np(a, b, h)
        c, x, h = _mix_np(c, x, h)
        y, a, h = _mix_np(y, a, h)
        b, x, h = _mix_np(b, x, h)
        y, c, h = _mix_np(y, c, h)
    return h


def crush_hash32_2_np(a, b):
    a = np.asarray(a).astype(np.uint32)
    b = np.asarray(b).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(CRUSH_HASH_SEED) ^ a ^ b
        x = np.uint32(231232) + np.zeros_like(h)
        y = np.uint32(1232) + np.zeros_like(h)
        a, b, h = _mix_np(a, b, h)
        x, a, h = _mix_np(x, a, h)
        b, y, h = _mix_np(b, y, h)
    return h


# -- torch ------------------------------------------------------------------

def _mix_torch(a, b, c):
    M = _M
    a = (a - b) & M; a = (a - c) & M; a = a ^ (c >> 13)
    b = (b - c) & M; b = (b - a) & M; b = b ^ ((a << 8) & M)
    c = (c - a) & M; c = (c - b) & M; c = c ^ (b >> 13)
    a = (a - b) & M; a = (a - c) & M; a = a ^ (c >> 12)
    b = (b - c) & M; b = (b - a) & M; b = b ^ ((a << 16) & M)
    c = (c - a) & M; c = (c - b) & M; c = c ^ (b >> 5)
    a = (a - b) & M; a = (a - c) & M; a = a ^ (c >> 3)
    b = (b - c) & M; b = (b - a) & M; b = b ^ ((a << 10) & M)
    c = (c - a) & M; c = (c - b) & M; c = c ^ (b >> 15)
    return a, b, c


def _u32_torch(*vals):
    """Broadcast int tensors to one shape as int64 holding uint32."""
    import torch
    vals = torch.broadcast_tensors(*[v.to(torch.int64) for v in vals])
    return [v & _M for v in vals]


def crush_hash32_3_torch(a, b, c):
    """3-arg hash on torch integer tensors (broadcasting) -> int64 holding
    the uint32 result: the straw2 draw hash."""
    a, b, c = _u32_torch(a, b, c)
    h = CRUSH_HASH_SEED ^ a ^ b ^ c
    x = a.new_full(h.shape, 231232)
    y = a.new_full(h.shape, 1232)
    a, b, h = _mix_torch(a, b, h)
    c, x, h = _mix_torch(c, x, h)
    y, a, h = _mix_torch(y, a, h)
    b, x, h = _mix_torch(b, x, h)
    y, c, h = _mix_torch(y, c, h)
    return h


def crush_hash32_2_torch(a, b):
    """2-arg hash on torch integer tensors (broadcasting) -> int64 holding
    the uint32 result: is_out and pps hashing."""
    a, b = _u32_torch(a, b)
    h = CRUSH_HASH_SEED ^ a ^ b
    x = a.new_full(h.shape, 231232)
    y = a.new_full(h.shape, 1232)
    a, b, h = _mix_torch(a, b, h)
    x, a, h = _mix_torch(x, a, h)
    b, y, h = _mix_torch(b, y, h)
    return h

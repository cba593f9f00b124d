"""Object-name hashing: ceph_str_hash_rjenkins.

Bit-exact mirror of the reference's string hash (reference:
src/common/ceph_hash.cc:21-78 — Robert Jenkins' evahash over 12-byte
blocks), the function librados uses to place an object name into a pool's
PG space (object_locator -> pg via ceph_str_hash + ceph_stable_mod).
"""
from __future__ import annotations

from ..crush.hash import _mix     # same Jenkins mix as crush_hash32_*

M = 0xFFFFFFFF


def ceph_str_hash_rjenkins(data: bytes | str) -> int:
    if isinstance(data, str):
        data = data.encode()
    length = len(data)
    a = b = 0x9E3779B9
    c = 0
    i = 0
    rem = length
    while rem >= 12:
        k = data[i:i + 12]
        a = (a + int.from_bytes(k[0:4], "little")) & M
        b = (b + int.from_bytes(k[4:8], "little")) & M
        c = (c + int.from_bytes(k[8:12], "little")) & M
        a, b, c = _mix(a, b, c)
        i += 12
        rem -= 12
    c = (c + length) & M
    k = data[i:]
    # the last 11 bytes; first byte of c is reserved for the length
    if rem >= 11: c = (c + (k[10] << 24)) & M
    if rem >= 10: c = (c + (k[9] << 16)) & M
    if rem >= 9:  c = (c + (k[8] << 8)) & M
    if rem >= 8:  b = (b + (k[7] << 24)) & M
    if rem >= 7:  b = (b + (k[6] << 16)) & M
    if rem >= 6:  b = (b + (k[5] << 8)) & M
    if rem >= 5:  b = (b + k[4]) & M
    if rem >= 4:  a = (a + (k[3] << 24)) & M
    if rem >= 3:  a = (a + (k[2] << 16)) & M
    if rem >= 2:  a = (a + (k[1] << 8)) & M
    if rem >= 1:  a = (a + k[0]) & M
    a, b, c = _mix(a, b, c)
    return c

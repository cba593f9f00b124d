"""jerasure: the reference jerasure plugin's profiles on the card.

The port's counterpart of the JAX package's ``jerasure`` plugin; it takes
the reference jerasure plugin's profile shape
(reference: src/erasure-code/jerasure/ErasureCodeJerasure.h:81-252):

- reed_sol_van (default, k=7 m=3), reed_sol_r6_op (m forced to 2, parity
  rows P=XOR / Q=sum 2^j d_j — exactly the geometric Vandermonde rows),
  cauchy_orig/cauchy_good (Cauchy matrices) at w=8: mapped onto the
  GF(2^8) byte codec of ``torch_rs`` (the ``gf_apply`` kernel).
- liberation, blaum_roth, liber8tion, and reed_sol_van/reed_sol_r6_op/
  cauchy_orig/cauchy_good at w=16 or 32: GF(2) bitmatrix codes with
  jerasure's packet layout (gf/bitmatrix.py, gf/gfw.py), applied by
  ``ops.rs_kernels.xor_apply`` (the ``xor_apply`` kernel).  The reference
  compiles these into word-XOR schedules (ErasureCodeJerasure.cc:453-509);
  the kernel XORs the packets each bitmatrix row selects, so no
  scheduling pass exists.

Parameter envelopes follow the reference exactly: liberation needs prime
w > 2, k <= w, packetsize set and a multiple of 4
(ErasureCodeJerasure.cc:368-414); blaum_roth needs w+1 prime with w=7
tolerated for backward compat (:461-471); liber8tion forces w=8, m=2,
k <= 8 (:484-505).

``device`` is routed by :class:`DeviceRouting`: cuda (the hand kernels) |
cpu (their plain PyTorch versions) | numpy (host) | auto (numpy under the
threshold, cuda at or above it).  A profile with no ``device`` key runs on
cuda, as ``torch_rs`` does; the JAX package's default is auto.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .. import __version__
from ..gf import bitmatrix as bm
from ..ops import rs_kernels
from .base import DeviceRouting, ErasureCode
from .interface import ErasureCodeProfile
from .plugin_torch_rs import ErasureCodeTorchRS
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

_TECHNIQUE_MAP = {
    "reed_sol_van": "reed_sol_van",
    "reed_sol_r6_op": "vandermonde",
    "cauchy_orig": "cauchy",
    "cauchy_good": "cauchy",
}
_BITMATRIX = ("liberation", "blaum_roth", "liber8tion")
# scalar techniques that run the wide (w=16/32) bitmatrix path
_WIDE = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good")
DEFAULT_PACKETSIZE = "2048"     # ErasureCodeJerasure.h:139


class ErasureCodeJerasureCompat(ErasureCodeTorchRS):
    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique") or "reed_sol_van"
        if technique not in _TECHNIQUE_MAP:
            raise ValueError(
                f"unknown jerasure technique {technique}; bitmatrix "
                f"techniques {_BITMATRIX} use ErasureCodeJerasureBitmatrix")
        if technique == "reed_sol_r6_op":
            # RAID6: m is always 2 (ErasureCodeJerasure.h:111-140)
            profile["m"] = "2"
        profile = dict(profile)
        profile["technique"] = _TECHNIQUE_MAP[technique]
        super().init(profile)
        # report the jerasure-visible technique name in the profile
        self._profile["technique"] = technique


class ErasureCodeJerasureBitmatrix(DeviceRouting, ErasureCode):
    """Packet-layout GF(2) bitmatrix codes on the ``xor_apply`` kernel.

    Two families share this machinery:
    - the RAID-6 bitmatrix techniques (liberation/blaum_roth/liber8tion,
      m forced to 2, their own w envelopes);
    - the WIDE-word scalar techniques (reed_sol_van/cauchy at w in
      {16, 32}): the GF(2^w) coding matrix expands to a [w*m, w*k]
      GF(2) bitmatrix (gf/gfw.py) and the data path is identical —
      word size only changes how many packets a chunk splits into,
      the kernel never sees it.
    """

    DEFAULT_K = "2"             # ErasureCodeJerasure.h:202-204
    # The reference's blaum_roth inherits DEFAULT_W="7" from Liberation and
    # tolerates it (ErasureCodeJerasure.cc:461-471) — but w=7 makes
    # 1+x+...+x^7 = (1+x)^7 reducible, so double-DATA erasures are
    # UNDECODABLE.  Defaulting a RAID-6 pool to a non-MDS profile loses
    # data; here the default is the nearest valid w (w+1=7 prime) and w=7
    # stays accept-on-explicit-request for profile compat only.
    DEFAULT_W = {"liberation": "7", "blaum_roth": "6", "liber8tion": "8",
                 "reed_sol_van": "16", "reed_sol_r6_op": "16",
                 "cauchy_orig": "16", "cauchy_good": "16"}

    def __init__(self, technique: str):
        super().__init__()
        self.technique = technique
        self.k = 0
        self.m = 2
        self.w = 0
        self.packetsize = 0
        self.coding: np.ndarray | None = None
        self.device = "cuda"
        self._coding_dev: dict[torch.device, torch.Tensor] = {}

    def init(self, profile: ErasureCodeProfile) -> None:
        super().init(profile)
        self.parse_mapping(profile)
        technique = self.technique
        if technique == "liber8tion":
            # w and m are not parameters (ErasureCodeJerasure.cc:484-495)
            profile.pop("w", None)
            profile.pop("m", None)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, "2")
        self.w = self.to_int("w", profile, self.DEFAULT_W[technique])
        self.packetsize = self.to_int("packetsize", profile,
                                      DEFAULT_PACKETSIZE)
        self.parse_device_routing(profile)
        self.sanity_check_k_m(self.k, self.m)
        if self.packetsize <= 0:
            raise ValueError("packetsize must be set")
        if self.packetsize % 4:
            raise ValueError(
                f"packetsize={self.packetsize} must be a multiple of 4")
        if technique in _WIDE:
            from ..gf.gfw import gfw
            if self.w not in (16, 32):
                raise ValueError(f"w={self.w} must be 16 or 32 here "
                                 f"(w=8 {technique} runs the byte codec)")
            if technique == "reed_sol_r6_op":
                self.m = 2          # RAID6 (ErasureCodeJerasure.h:111-140)
            gf = gfw(self.w)
            mat = (gf.vandermonde(self.k, self.m)
                   if technique.startswith("reed_sol")
                   else gf.cauchy(self.k, self.m))
            self.coding = gf.expand_bitmatrix(mat)
        else:
            if self.m != 2:
                raise ValueError(f"m={self.m}: {technique} is a RAID-6 "
                                 f"code, m must be 2")
            if technique == "liberation":
                self.coding = bm.liberation_bitmatrix(self.k, self.w)
            elif technique == "blaum_roth":
                self.coding = bm.blaum_roth_bitmatrix(self.k, self.w)
            else:
                self.coding = bm.liber8tion_bitmatrix(self.k)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            raise ValueError(
                f"mapping maps {len(self.chunk_mapping)} chunks "
                f"instead of {self.k + self.m}")
        self._profile = dict(profile)
        self._profile["technique"] = technique

    # -- sizing ------------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        # chunks must split into whole groups of w packets
        # (cf. ErasureCodeJerasureLiberation::get_alignment,
        # ErasureCodeJerasure.cc:367-373)
        return self.w * self.packetsize

    # -- encode/decode -----------------------------------------------------

    def _apply(self, W: np.ndarray, packets: np.ndarray) -> np.ndarray:
        """W ·GF(2) packets: on the routed torch device through
        ``rs_kernels.xor_apply``, or on the host in numpy.  The coding
        matrix is uploaded once per device; a decode matrix per call."""
        if not self.use_device(packets.nbytes):
            return bm.xor_apply_host(W, packets)
        dev = self.tensor_device()
        if W is not self.coding:
            W_dev = torch.from_numpy(W).to(dev)
        elif (W_dev := self._coding_dev.get(dev)) is None:
            W_dev = self._coding_dev[dev] = torch.from_numpy(W).to(dev)
        out = rs_kernels.xor_apply(W_dev, torch.from_numpy(packets).to(dev))
        return out.cpu().numpy()

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        data = np.stack([encoded[self.chunk_index(i)] for i in range(self.k)])
        packets = bm.to_packets(data, self.w, self.packetsize)
        out = self._apply(self.coding, packets)
        parity = bm.from_packets(out, self.w, self.packetsize)
        for i in range(self.m):
            encoded[self.chunk_index(self.k + i)][:] = parity[i]

    def decode_chunks(self, want_to_read: set,
                      chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        erasures = [i for i in range(self.k + self.m) if i not in chunks]
        if not erasures:
            return
        avail, erasures_l = self.remap_for_decode(
            {i: decoded[i] for i in chunks}, erasures)
        D, src = bm.decode_bitmatrix(
            self.coding, self.k, self.w, erasures_l, available=list(avail))
        stack = np.stack([np.asarray(avail[c], dtype=np.uint8) for c in src])
        packets = bm.to_packets(stack, self.w, self.packetsize)
        rec = bm.from_packets(self._apply(D, packets), self.w,
                              self.packetsize)
        for row, e in enumerate(sorted(erasures_l)):
            decoded[self.chunk_index(e)][:] = rec[row]


class ErasureCodePluginJerasure(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCode:
        technique = profile.get("technique") or "reed_sol_van"
        w = int(profile.get("w", "8") or "8")
        if technique in _BITMATRIX or (technique in _WIDE and w != 8):
            instance: ErasureCode = ErasureCodeJerasureBitmatrix(technique)
        else:
            instance = ErasureCodeJerasureCompat()
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginJerasure())

"""lrc: Locally Repairable (layered) erasure code plugin — a meta-code.

Behavioural mirror of the reference lrc plugin
(reference: src/erasure-code/lrc/ErasureCodeLrc.{h,cc}): a stack of layers,
each a full erasure code over a subset of the chunk positions, so that a
small local layer can repair common single failures while the global layer
guards against correlated loss.

Profile (ErasureCodeLrc.h:47-76, parse at ErasureCodeLrc.cc:293-498):
  layers        JSON array of [chunks_map, config] pairs; chunks_map is a
                string over positions with 'D' (data in this layer),
                'c' (coding in this layer), '_' (not in this layer); config
                is a JSON object (or JSON-object string) completing the
                sub-plugin profile (defaults: plugin=jerasure,
                technique=reed_sol_van, k=#D, m=#c)
  mapping       global DDD_D_-style string defining which positions hold
                object data ('D') vs coding ('_'); its length is the chunk
                count
  k, m, l       shorthand (parse_kml, ErasureCodeLrc.cc:293-415): generates
                mapping + a global layer + (k+m)/l local layers; requires
                l | (k+m), ((k+m)/l) | k and ((k+m)/l) | m
  crush-steps / crush-locality / crush-failure-domain
                multi-step CRUSH rule description (rule_steps)

Decode walks layers from the last (local) to the first (global), repairing
whatever each layer can, re-using chunks recovered by earlier layers
(ErasureCodeLrc.cc:777-860).

The port's copy of the JAX package's lrc plugin, with one departure: a
top-level ``device`` is set on every layer whose config names none (as
clay forwards it to its sub-codecs), because a layer's plugin defaults to
the card here.  Without a top-level ``device`` nothing changes.
``create_rule`` is duck-typed on the ``crush`` map it is given; the rule
step opcodes are copied below.
"""
from __future__ import annotations

import json
from typing import Mapping

import numpy as np

from .. import __version__
from .base import ErasureCode
from .interface import ErasureCodeProfile
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

DEFAULT_KML = "-1"

# CRUSH rule step opcodes (crush.h:52-70)
CRUSH_RULE_TAKE = 1
CRUSH_RULE_CHOOSE_INDEP = 3
CRUSH_RULE_EMIT = 4
CRUSH_RULE_CHOOSELEAF_INDEP = 7


class Layer:
    """One code layer over a subset of positions (ErasureCodeLrc.h:47-60)."""

    def __init__(self, chunks_map: str):
        self.chunks_map = chunks_map
        self.erasure_code: ErasureCode | None = None
        self.data: list[int] = []
        self.coding: list[int] = []
        self.chunks: list[int] = []
        self.chunks_as_set: set[int] = set()
        self.profile: ErasureCodeProfile = {}


class ErasureCodeLrc(ErasureCode):
    def __init__(self, directory: str = ""):
        super().__init__()
        self.directory = directory
        self.layers: list[Layer] = []
        self._chunk_count = 0
        self._data_chunk_count = 0
        # default rule: one chooseleaf step over hosts (ErasureCodeLrc.h:76-81)
        self.rule_steps: list[tuple[str, str, int]] = [("chooseleaf", "host", 0)]

    def get_chunk_count(self) -> int:
        return self._chunk_count

    def get_data_chunk_count(self) -> int:
        return self._data_chunk_count

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].erasure_code.get_chunk_size(object_size)

    # -- kml shorthand (parse_kml, ErasureCodeLrc.cc:293-415) ---------------

    def parse_kml(self, profile: ErasureCodeProfile) -> None:
        k = int(self.to_string("k", profile, DEFAULT_KML))
        m = int(self.to_string("m", profile, DEFAULT_KML))
        l = int(self.to_string("l", profile, DEFAULT_KML))
        if k == -1 and m == -1 and l == -1:
            return
        if k == -1 or m == -1 or l == -1:
            raise ValueError("all of k, m, l must be set or none of them")
        for generated in ("mapping", "layers", "crush-steps"):
            if generated in profile:
                raise ValueError(
                    f"the {generated} parameter cannot be set "
                    f"when k, m, l are set")
        if l == 0 or (k + m) % l:
            raise ValueError(f"k + m must be a multiple of l (k={k} m={m} l={l})")
        groups = (k + m) // l
        if k % groups:
            raise ValueError(f"k must be a multiple of (k + m) / l = {groups}")
        if m % groups:
            raise ValueError(f"m must be a multiple of (k + m) / l = {groups}")

        profile["mapping"] = "".join(
            "D" * (k // groups) + "_" * (m // groups) + "_"
            for _ in range(groups))

        layers = [["".join("D" * (k // groups) + "c" * (m // groups) + "_"
                           for _ in range(groups)), ""]]
        for i in range(groups):
            layers.append(["".join(("D" * l + "c") if i == j else "_" * (l + 1)
                                   for j in range(groups)), ""])
        profile["layers"] = json.dumps(layers)

        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host") or "host"
        if locality:
            self.rule_steps = [("choose", locality, groups),
                               ("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    # -- rule description (parse_rule, ErasureCodeLrc.cc:400-490) -----------

    def parse_rule(self, profile: ErasureCodeProfile) -> None:
        self.rule_root = self.to_string("crush-root", profile, "default")
        self.rule_device_class = self.to_string("crush-device-class", profile, "")
        if "crush-steps" in profile:
            try:
                description = json.loads(profile["crush-steps"])
            except json.JSONDecodeError as e:
                raise ValueError(f"failed to parse crush-steps: {e}") from e
            if not isinstance(description, list):
                raise ValueError("crush-steps must be a JSON array")
            self.rule_steps = []
            for step in description:
                if not isinstance(step, list) or len(step) != 3:
                    raise ValueError(f"crush-steps element {step!r} must be "
                                     f"an [op, type, n] array")
                op, type_, n = step
                if not isinstance(op, str) or not isinstance(type_, str):
                    raise ValueError(f"crush-steps op/type in {step!r} must "
                                     f"be strings")
                if not isinstance(n, int):
                    raise ValueError(f"crush-steps n in {step!r} must be int")
                self.rule_steps.append((op, type_, n))

    def create_rule(self, name: str, crush) -> int:
        """Multi-step rule from rule_steps (ErasureCodeLrc.cc:60-112)."""
        if name in crush.rule_names:
            raise ValueError(f"rule {name!r} already exists")
        # crush-device-class routes the take through the per-class shadow
        # tree (ErasureCodeLrc.cc create_rule -> CrushWrapper class take)
        root = crush.take_with_class(self.rule_root,
                                     self.rule_device_class)
        steps = [(CRUSH_RULE_TAKE, root, 0)]
        for op, type_, n in self.rule_steps:
            if op == "choose":
                opcode = CRUSH_RULE_CHOOSE_INDEP
            elif op == "chooseleaf":
                opcode = CRUSH_RULE_CHOOSELEAF_INDEP
            else:
                raise ValueError(f"unknown crush rule op {op!r}")
            steps.append((opcode, n, crush.type_id(type_)))
        steps.append((CRUSH_RULE_EMIT, 0, 0))
        ruleno = crush.add_rule(steps)
        crush.rule_names[name] = ruleno
        return ruleno

    # -- layers (layers_parse/layers_init, ErasureCodeLrc.cc:143-251) -------

    def layers_parse(self, description) -> None:
        for position, entry in enumerate(description):
            if not isinstance(entry, list) or not entry:
                raise ValueError(
                    f"layers element at position {position} must be a "
                    f"non-empty JSON array, got {entry!r}")
            chunks_map = entry[0]
            if not isinstance(chunks_map, str):
                raise ValueError(
                    f"first element of layer {position} must be a string")
            layer = Layer(chunks_map)
            if len(entry) > 1:
                config = entry[1]
                if isinstance(config, str):
                    layer.profile = json.loads(config) if config.strip() else {}
                elif isinstance(config, dict):
                    layer.profile = {key: str(v) for key, v in config.items()}
                else:
                    raise ValueError(
                        f"second element of layer {position} must be a "
                        f"string or object")
            self.layers.append(layer)

    def layers_init(self, device: str = "") -> None:
        registry = ErasureCodePluginRegistry.instance()
        for layer in self.layers:
            for position, ch in enumerate(layer.chunks_map):
                if ch == "D":
                    layer.data.append(position)
                if ch == "c":
                    layer.coding.append(position)
                if ch in ("c", "D"):
                    layer.chunks_as_set.add(position)
            layer.chunks = layer.data + layer.coding
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", "jerasure")
            layer.profile.setdefault("technique", "reed_sol_van")
            if device:
                layer.profile.setdefault("device", device)
            layer.erasure_code = registry.factory(
                layer.profile["plugin"], self.directory, layer.profile)

    def layers_sanity_checks(self) -> None:
        if len(self.layers) < 1:
            raise ValueError("layers parameter must list at least one layer")
        for layer in self.layers:
            if len(layer.chunks_map) != self._chunk_count:
                raise ValueError(
                    f"layer map {layer.chunks_map!r} is "
                    f"{len(layer.chunks_map)} characters long, expected "
                    f"{self._chunk_count} (the mapping length)")

    # -- init (ErasureCodeLrc.cc:493-547) -----------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        self.parse_kml(profile)
        super().init(profile)          # crush-root/failure-domain defaults
        self.parse_rule(profile)
        if "layers" not in profile:
            raise ValueError(f"could not find 'layers' in {profile}")
        description = json.loads(profile["layers"])
        if not isinstance(description, list):
            raise ValueError("layers must be a JSON array")
        self.layers_parse(description)
        self.layers_init(profile.get("device", ""))
        if "mapping" not in profile:
            raise ValueError("the 'mapping' profile is missing")
        mapping = profile["mapping"]
        self._data_chunk_count = mapping.count("D")
        self._chunk_count = len(mapping)
        self.parse_mapping(profile)
        self.layers_sanity_checks()
        # kml-generated parameters are not exposed (ErasureCodeLrc.cc:536-545)
        if profile.get("l") and profile["l"] != DEFAULT_KML:
            profile.pop("mapping", None)
            profile.pop("layers", None)
        profile["plugin"] = profile.get("plugin", "lrc")
        self._profile = profile

    # -- minimum_to_decode (ErasureCodeLrc.cc:566-733) ----------------------

    def _minimum_to_decode(self, want_to_read: set, available: set) -> set:
        want_to_read = set(want_to_read)
        available = set(available)
        n = self.get_chunk_count()
        erasures_total = {i for i in range(n) if i not in available}
        erasures_not_recovered = set(erasures_total)
        erasures_want = erasures_total & want_to_read

        # Case 1: nothing wanted is missing
        if not erasures_want:
            return set(want_to_read)

        # Case 2: repair wanted erasures with as few chunks as possible,
        # preferring later (local) layers
        minimum: set[int] = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                minimum |= layer_want
                continue
            erasures = layer.chunks_as_set & erasures_not_recovered
            if len(erasures) > layer.erasure_code.get_coding_chunk_count():
                continue    # too many for this layer; hope an upper one helps
            minimum |= layer.chunks_as_set - erasures_not_recovered
            erasures_not_recovered -= erasures
            erasures_want -= erasures
        if not erasures_want:
            minimum |= want_to_read
            minimum -= erasures_total
            return minimum

        # Case 3: cascade — repair anything any layer can, in the hope it
        # unlocks the upper layers; then read everything available
        erasures_total = {i for i in range(n) if i not in available}
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures_total
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.erasure_code.get_coding_chunk_count():
                erasures_total -= layer_erasures
        if not erasures_total:
            return set(available)

        raise IOError(
            f"not enough chunks in {sorted(available)} to read "
            f"{sorted(want_to_read)}")

    # -- encode/decode (ErasureCodeLrc.cc:737-860) --------------------------

    def encode_chunks(self, want_to_encode: set,
                      encoded: dict[int, np.ndarray]) -> None:
        # find the last layer covering everything wanted; apply it and all
        # the layers after it, each over its own chunk subset
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if set(want_to_encode) <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            layer_encoded = {j: encoded[c] for j, c in enumerate(layer.chunks)}
            layer_want = {j for j, c in enumerate(layer.chunks)
                          if c in want_to_encode}
            layer.erasure_code.encode_chunks(layer_want, layer_encoded)
            for j, c in enumerate(layer.chunks):
                encoded[c] = layer_encoded[j]

    def decode_chunks(self, want_to_read: set, chunks: Mapping[int, np.ndarray],
                      decoded: dict[int, np.ndarray]) -> None:
        n = self.get_chunk_count()
        available = {i for i in range(n) if i in chunks}
        erasures = {i for i in range(n) if i not in chunks}
        want_to_read_erasures = erasures & set(want_to_read)

        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > layer.erasure_code.get_coding_chunk_count():
                continue    # too many erasures for this layer
            if not layer_erasures:
                continue    # nothing to do here
            layer_chunks = {}
            layer_decoded = {}
            layer_want = set()
            for j, c in enumerate(layer.chunks):
                # read repaired values from ``decoded`` so chunks recovered
                # by previous (more local) layers are reused
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want_to_read:
                    layer_want.add(j)
                layer_decoded[j] = decoded[c]
            layer.erasure_code.decode_chunks(layer_want, layer_chunks,
                                             layer_decoded)
            for j, c in enumerate(layer.chunks):
                decoded[c] = layer_decoded[j]
                erasures.discard(c)
            want_to_read_erasures = erasures & set(want_to_read)
            if not want_to_read_erasures:
                break

        if want_to_read_erasures:
            raise IOError(
                f"want to read {sorted(want_to_read)} with available "
                f"{sorted(available)}: unable to read "
                f"{sorted(want_to_read_erasures)}")


class ErasureCodePluginLrc(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeLrc:
        instance = ErasureCodeLrc(directory)
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginLrc())

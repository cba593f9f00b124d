"""isa: the reference isa plugin's profiles on the card.

The port's counterpart of the JAX package's ``isa`` plugin; it takes the
reference isa plugin's profile shape
(reference: src/erasure-code/isa/ErasureCodeIsa.h:36-38): k=7 m=3 defaults,
technique reed_sol_van (ISA's geometric Vandermonde, gf_gen_rs_matrix) or
cauchy (gf_gen_cauchy1_matrix), with the Vandermonde parameter envelope
k<=32, m<=4, m=4 => k<=21 (ErasureCodeIsa.cc:323-364) enforced by the codec.
Encode and decode run through ``torch_rs`` (the ``gf_apply`` kernel), with
its device routing: a profile with no ``device`` key runs on cuda.
"""
from __future__ import annotations

from .. import __version__
from .interface import ErasureCodeProfile
from .plugin_torch_rs import ErasureCodeTorchRS
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry

_TECHNIQUE_MAP = {
    "reed_sol_van": "vandermonde",
    "cauchy": "cauchy",
}


class ErasureCodeIsaCompat(ErasureCodeTorchRS):
    def init(self, profile: ErasureCodeProfile) -> None:
        technique = profile.get("technique") or "reed_sol_van"
        if technique not in _TECHNIQUE_MAP:
            raise ValueError(
                f"technique={technique} must be one of {sorted(_TECHNIQUE_MAP)}")
        profile = dict(profile)
        profile["technique"] = _TECHNIQUE_MAP[technique]
        super().init(profile)
        self._profile["technique"] = technique


class ErasureCodePluginIsa(ErasureCodePlugin):
    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeIsaCompat:
        instance = ErasureCodeIsaCompat()
        instance.init(dict(profile))
        return instance


def __erasure_code_version__() -> str:
    return __version__


def __erasure_code_init__(name: str, directory: str) -> None:
    ErasureCodePluginRegistry.instance().add(name, ErasureCodePluginIsa())

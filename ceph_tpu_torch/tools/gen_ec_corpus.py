"""gen_ec_corpus: the erasure-code non-regression corpus, from the port.

The port's copy of the JAX package's ``tools/gen_ec_corpus.py`` (the
reference's corpus scheme: src/test/erasure-code/
ceph_erasure_code_non_regression.cc writes chunk files for a fixed
pseudo-random payload per (plugin, profile) and
qa/workunits/erasure-code/encode-decode-non-regression.sh:19-40 re-checks
them across versions).  The corpus records the SHA-256 digest of every
chunk.

The profiles, payload and entry names are the reference's, so the
corpus this tool writes compares key for key with the committed
``tests/golden/ec_corpus.json``.  Where it differs:

- **The port's registry runs each profile.**  ``jax_rs`` runs as
  ``torch_rs``, and clay's ``scalar_mds=jax_rs`` as
  ``scalar_mds=torch_rs``; the entry keeps the reference's plugin,
  profile and name.  Every plugin that takes a device key (torch_rs,
  jerasure, shec, lrc, clay) gets ``device`` (``cuda`` by default): on
  the card torch_rs, shec, lrc and clay launch ``gf_apply.cu`` and
  jerasure's bitmatrix and w=16/32 techniques launch ``xor_apply.cu``.
  ``cpu`` runs the plain PyTorch versions (the tests).
- **``--out`` is required.**  The tool never writes the committed
  corpus.

Usage:
    python -m ceph_tpu_torch.tools.gen_ec_corpus --out FILE
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

PAYLOAD_SIZE = 31116      # deliberately unaligned (forces padding paths)
PAYLOAD_SEED = 0xEC

PROFILES = [
    ("jax_rs", {"k": "2", "m": "1", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "8", "m": "4", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "10", "m": "4", "technique": "reed_sol_van"}),
    ("jax_rs", {"k": "4", "m": "2", "technique": "cauchy"}),
    ("jax_rs", {"k": "8", "m": "4", "technique": "cauchy"}),
    ("jax_rs", {"k": "6", "m": "3", "technique": "vandermonde"}),
    ("jax_rs", {"k": "4", "m": "2", "technique": "reed_sol_van",
                "mapping": "_DDD_D"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "liberation",
                  "w": "7", "packetsize": "8"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "blaum_roth",
                  "w": "6", "packetsize": "8"}),
    ("jerasure", {"k": "6", "m": "2", "technique": "liber8tion",
                  "packetsize": "8"}),
    ("jerasure", {"k": "4", "m": "3", "technique": "reed_sol_van",
                  "w": "16", "packetsize": "8"}),
    ("jerasure", {"k": "4", "m": "2", "technique": "cauchy_good",
                  "w": "32", "packetsize": "4"}),
    ("cpp_rs", {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("cpp_rs", {"k": "8", "m": "4", "technique": "cauchy"}),
    ("xor", {"k": "3", "m": "1"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2", "d": "5",
              "scalar_mds": "jax_rs"}),
]

#: the reference's plugin names that the port runs under another name
PORT_PLUGIN = {"jax_rs": "torch_rs"}
#: the port's plugins whose profiles take a ``device`` key
DEVICE_PLUGINS = ("torch_rs", "jerasure", "shec", "lrc", "clay")


def payload() -> bytes:
    rng = np.random.default_rng(PAYLOAD_SEED)
    return rng.integers(0, 256, size=PAYLOAD_SIZE, dtype=np.uint8).tobytes()


def entry_name(plugin: str, profile: dict) -> str:
    parts = "_".join(f"{k}={v}" for k, v in sorted(profile.items())
                     if k != "plugin")
    return f"{plugin}/{parts}"


def port_profile(plugin: str, profile: dict, device: str
                 ) -> tuple[str, dict]:
    """The port's plugin name and profile for one reference entry."""
    name = PORT_PLUGIN.get(plugin, plugin)
    prof = dict(profile)
    if "scalar_mds" in prof:
        prof["scalar_mds"] = PORT_PLUGIN.get(prof["scalar_mds"],
                                             prof["scalar_mds"])
    if name in DEVICE_PLUGINS:
        prof["device"] = device
    return name, prof


def generate(device: str = "cuda", verbose: bool = False) -> dict:
    """The corpus document: every entry of :data:`PROFILES` encoded by
    the port on ``device``, keyed by the reference's entry name."""
    from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry
    reg = ErasureCodePluginRegistry.instance()
    data = payload()
    corpus = {"payload_seed": PAYLOAD_SEED, "payload_size": PAYLOAD_SIZE,
              "entries": {}}
    for plugin, profile in PROFILES:
        name, prof = port_profile(plugin, profile, device)
        ec = reg.factory(name, "", prof)
        n = ec.get_chunk_count()
        encoded = ec.encode(set(range(n)), data)
        digests = {str(i): hashlib.sha256(
            np.ascontiguousarray(encoded[i]).tobytes()).hexdigest()
            for i in sorted(encoded)}
        corpus["entries"][entry_name(plugin, profile)] = {
            "plugin": plugin,
            "profile": profile,
            "chunk_size": int(encoded[0].nbytes),
            "chunk_sha256": digests,
        }
        if verbose:
            print(f"{entry_name(plugin, profile)}: {n} chunks x "
                  f"{encoded[0].nbytes}")
    return corpus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True,
                    help="where to write the corpus JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the codecs run (cpu: the plain PyTorch "
                         "versions)")
    args = ap.parse_args(argv)
    corpus = generate(args.device, verbose=True)
    with open(args.out, "w") as f:
        json.dump(corpus, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}: {len(corpus['entries'])} entries")
    return 0


if __name__ == "__main__":
    sys.exit(main())

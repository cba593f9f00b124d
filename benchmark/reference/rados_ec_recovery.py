"""Plain reference of an OSD replacement in an EC pool: what the
recreated OSD must hold once its backfill is done.

An OSD destroyed and recreated empty under its own id keeps its CRUSH
position, so every PG maps to the same acting set, and the new OSD must
end up holding exactly the chunks the old one held.
:func:`held_chunks` gives that set from the acting sets taken before the
replacement: for each object whose acting set names the OSD, the chunk
at the OSD's position in it.  Each such chunk must equal the reference
codeword's chunk (:func:`chunks`), and its HashInfo hash the chunk's
:func:`crc32c` chained from :data:`HINFO_SEED`.

The field, the code, the CRC and the placement property are
``rados_ec``'s, re-exported here; nothing of the program under test is
imported.
"""
from __future__ import annotations

from benchmark.reference.rados_ec import (HINFO_SEED, chunks, crc32c,
                                          distinct_hosts)

__all__ = ["HINFO_SEED", "chunks", "crc32c", "distinct_hosts",
           "held_chunks"]


def held_chunks(osd: int, acting_sets: dict[str, list[int]]
                ) -> dict[str, int]:
    """``{object: chunk index}`` of every chunk ``osd`` holds, from the
    objects' acting sets: the chunk at the OSD's position."""
    return {name: list(acting).index(osd)
            for name, acting in acting_sets.items() if osd in acting}

"""pipeline_pack_ms: the codec pipeline's host pack (the relayout into
pinned memory) per batch, from its ``pack_time`` counter over the
window."""


def read(run):
    w = run.window
    if not w.get("packs"):
        return None
    return w["pack_s"] / w["packs"] * 1e3

"""engine_ops_per_batch: ops the ServingEngine's coalescer fused into one
device batch, from its ``ops_coalesced`` and ``batches`` counters over
the window."""


def read(run):
    w = run.window
    if not w.get("batches"):
        return None
    return w["ops_coalesced"] / w["batches"]

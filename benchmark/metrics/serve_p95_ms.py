"""serve_p95_ms: the 95th percentile (nearest rank, ``stats.py``) of
``t_done - t_submit`` over every op completed inside the window, as the
engine stamps them on each op's future."""


def read(run):
    w = run.window
    if not w.get("latencies"):
        return None
    return w["latency_p95_s"] * 1e3

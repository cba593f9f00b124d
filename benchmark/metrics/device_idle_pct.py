"""device_idle_pct: the share of the profiled window in which no kernel,
copy or fill runs on the card (``trace.py``)."""


def read(run):
    t = run.trace
    if t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

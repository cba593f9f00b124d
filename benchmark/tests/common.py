"""Small sizes at which each cell runs on the CPU in a second or two."""
import time

from benchmark import harness

#: traffic overrides per cell for a CPU rehearsal
TINY = {
    "ec84_1m_resident": {"stripes": 2, "warmup_calls": 1},
    "rbd84_write_c16": {"op_bytes": 1 << 18, "clients": 4,
                        "distinct_payloads": 4, "warmup_seconds": 0.2,
                        "sample_every": 1},
}
WINDOW_S = 0.3


def rehearse(cell: str, seed: int = 2**31 + 5, trace: bool = False,
             fault: str | None = None, bench_dir=harness.BENCH_DIR,
             overrides: dict | None = None) -> dict:
    """One run of ``cell`` on the CPU at its tiny size."""
    return harness.run(cell, seed, WINDOW_S, trace, time.monotonic(),
                       device="cpu", fault=fault,
                       overrides=overrides or TINY[cell],
                       bench_dir=bench_dir)

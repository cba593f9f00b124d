"""The benchmark's core: one cell, one seed, one run.

Everything is found by name, so that a later change adds a cell, a
configuration, a traffic mix or a metric as files and entries without
editing a file that is here:

- ``BENCHMARK.json`` (the repo root) names each cell's configuration and
  traffic, and each metric;
- ``configs/<config>.json`` is the deployment: the plugin profile, the
  stripe geometry, the engine's settings and its guarantees;
- ``traffic/<traffic>.json`` is the mix, read by the general generator it
  names, ``generators/<generator>.py``;
- ``metrics/<metric>.py`` reads one metric from the run (a name with a
  dot, ``quantity.split``, falls back to ``metrics/<quantity>.py``).

A run builds the cell's generator, which makes its inputs from the seed and
warms up the shapes its traffic uses (set-up), measures one window, and,
with ``trace``, a second, profiled window (``trace.Probe``).  Then the
program's state is freed and the generator compares what the timed path
produced with the plain reference (``reference/``).
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level module names a run may not load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
#: the profiled window of a ``--trace 1`` run, in seconds
PROFILE_SECONDS = 2.0


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _load_module(path: Path, label: str):
    if not path.is_file():
        raise FileNotFoundError(f"{label}: no file {path}")
    mod_name = "benchmark._found." + "".join(
        c if c.isalnum() else "_" for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, bench_dir: Path = BENCH_DIR) -> dict:
    """Every file one cell needs, found by name: its configuration,
    traffic, generator and metric readers."""
    cell = _by_name(spec["workloads"], workload, "workload")
    conf_entry = _by_name(spec["configs"], cell["config"], "config")
    root = bench_dir.parent
    config = _load_json(root / conf_entry["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    out = {"cell": cell, "config": config, "traffic": traffic,
           "generator": bench_dir / "generators" / f"{traffic['generator']}.py",
           "reference": bench_dir / "reference" / f"{config['reference']}.py",
           "end_to_end": [], "per_layer": []}
    for kind in ("end_to_end", "per_layer"):
        for metric in spec[kind]:
            if workload in metric.get("workloads", [workload]):
                out[kind].append((metric, metric_file(metric["name"],
                                                      bench_dir)))
    for path in [out["generator"], out["reference"]] + \
            [p for kind in ("end_to_end", "per_layer") for _m, p in out[kind]]:
        if not path.is_file():
            raise FileNotFoundError(f"{workload}: no file {path}")
    return out


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """``metrics/<name>.py``, else ``metrics/<name before the dot>.py``."""
    whole = bench_dir / "metrics" / f"{name}.py"
    if whole.is_file():
        return whole
    return bench_dir / "metrics" / f"{name.split('.')[0]}.py"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`,
    compared whole (``ceph_tpu_torch`` is not ``ceph_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Run:
    """What the metric readers read: the cell, the set-up time, the
    measured window, and with a trace the profiled window's summary."""

    def __init__(self, cell: dict, config: dict, traffic: dict):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.setup_s = None
        self.window = None
        self.trace = None


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", fault: str | None = None,
        overrides: dict | None = None, bench_dir: Path = BENCH_DIR) -> dict:
    """One run of one cell; returns the result line's object.  ``device``
    "cpu" and ``overrides`` (traffic keys) are for the CPU rehearsals of
    the tests; ``fault`` puts a control or a fault in the program's place
    (``faults.py``)."""
    spec = load_spec(bench_dir.parent)
    found = resolve(spec, workload, bench_dir)
    traffic = dict(found["traffic"], **(overrides or {}))
    rec = Run(found["cell"], found["config"], traffic)
    reference = _load_module(found["reference"], "reference")
    gen_mod = _load_module(found["generator"], "generator")
    readers = {kind: [(m, _load_module(p, m["name"])) for m, p in found[kind]]
               for kind in ("end_to_end", "per_layer")}

    import torch
    from . import faults, trace as tracing

    cards = int(found["cell"]["chips"]) if device == "cuda" else 0
    undo = faults.install(fault, seed) if fault else None
    try:
        gen = gen_mod.Generator(found["config"], traffic, seed, device,
                                reference)
        gen.setup()
        rec.setup_s = time.monotonic() - t_start
        rec.window = gen.window(seconds)
        if trace:
            probe = tracing.Probe(device)
            gen.window(PROFILE_SECONDS, probe=probe)
            rec.trace = probe.summary
        gen.stop()
        # the peak since the process started, on the fullest card
        peak = max((torch.cuda.max_memory_allocated(i)
                    for i in range(cards)), default=0)
        checks = gen.check()
    finally:
        if undo is not None:
            undo()

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for metric, reader in readers[kind]:
        value = reader.read(rec)
        if value is None:
            print(f"metric {metric['name']}: nothing to read",
                  file=sys.stderr)
            continue
        metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu", "count": max(cards, 1),
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": rec.window["attempted"],
              "failed": rec.window["failed"],
              "metrics": metrics, "device": dev}
    if rec.trace is not None:
        dev["busy_s"] = rec.trace["busy_s"]
        dev["window_s"] = rec.trace["window_s"]
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, (v, lim) in checks.items()}
    return result

"""Typed option schema + runtime config store with live observers.

A copy of ``ceph_tpu.common.options`` cut to the options the port reads,
under the JAX package's names and defaults, so one config serves both
packages (reference: src/common/options.cc's typed Option table and
src/common/config.cc's ``md_config_t`` with its observers).  The
``jax_rs_*`` names are kept for that reason; in the port they set the
CUDA codec pipeline.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable

# Option levels (options.h Option::LEVEL_*)
LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

# Option types (options.h Option::TYPE_*)
TYPE_STR = "str"
TYPE_INT = "int"
TYPE_UINT = "uint"
TYPE_FLOAT = "float"
TYPE_BOOL = "bool"
TYPE_SIZE = "size"          # accepts 4K/1M/2G suffixes

_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_size(v) -> int:
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().lower()
    if s and s[-1] in _SIZE_SUFFIX:
        return int(float(s[:-1]) * _SIZE_SUFFIX[s[-1]])
    return int(s, 0)


_CASTS: dict[str, Callable[[Any], Any]] = {
    TYPE_STR: str,
    TYPE_INT: lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    TYPE_UINT: lambda v: int(str(v), 0) if isinstance(v, str) else int(v),
    TYPE_FLOAT: float,
    TYPE_BOOL: lambda v: (v if isinstance(v, bool)
                          else str(v).lower() in ("1", "true", "yes", "on")),
    TYPE_SIZE: parse_size,
}


@dataclass
class Option:
    name: str
    type: str = TYPE_STR
    level: str = LEVEL_ADVANCED
    default: Any = None
    description: str = ""
    long_description: str = ""
    see_also: list[str] = field(default_factory=list)
    min: Any = None
    max: Any = None
    enum_allowed: list[str] = field(default_factory=list)
    startup: bool = False       # FLAG_STARTUP: no runtime updates

    def cast(self, value):
        v = _CASTS[self.type](value)
        if self.type in (TYPE_UINT, TYPE_SIZE) and v < 0:
            raise ValueError(f"{self.name}: negative value {v}")
        if self.min is not None and v < self.min:
            raise ValueError(f"{self.name}: {v} < min {self.min}")
        if self.max is not None and v > self.max:
            raise ValueError(f"{self.name}: {v} > max {self.max}")
        if self.enum_allowed and v not in self.enum_allowed:
            raise ValueError(
                f"{self.name}: {v!r} not in {self.enum_allowed}")
        return v


# The framework's option table (the subset of the reference's ~2000 options
# this codebase consumes; same names where the concept matches).
OPTIONS: list[Option] = [
    Option("pipeline_breaker_threshold", TYPE_UINT, LEVEL_ADVANCED,
           default=3,
           description="consecutive device-side codec failures before "
                       "the pipeline's circuit breaker opens and its "
                       "submits fail fast without touching the card "
                       "(0 disables the breaker)",
           see_also=["pipeline_breaker_cooldown"]),
    Option("pipeline_breaker_cooldown", TYPE_FLOAT, LEVEL_ADVANCED,
           default=5.0, min=0.0,
           description="seconds an open pipeline breaker waits before "
                       "admitting one half-open probe dispatch back to "
                       "the device (success re-closes, failure re-opens)",
           see_also=["pipeline_breaker_threshold"]),
    Option("jax_rs_pipeline_depth", TYPE_UINT, LEVEL_ADVANCED,
           default=4,
           description="max dispatched device batches in flight before "
                       "the codec pipeline forces completion of the "
                       "oldest; batch N+1's host pack overlaps batch N's "
                       "device compute (0 = synchronous dispatch)",
           see_also=["jax_rs_mesh_devices"]),
    Option("jax_rs_mesh_devices", TYPE_UINT, LEVEL_ADVANCED,
           default=0,
           description="split coalesced codec batches across the dp axis "
                       "of a device mesh over this many devices "
                       "(parallel/mesh sharded encode/decode steps); "
                       "0 or 1 = single-chip dispatch, and the option is "
                       "ignored when fewer devices are present",
           see_also=["jax_rs_pipeline_depth"]),
    Option("osd_serving_throttle_bytes", TYPE_SIZE, LEVEL_ADVANCED,
           default=64 << 20,
           description="serving admission throttle: max payload bytes "
                       "queued or in flight (backpressure past this)",
           see_also=["osd_serving_throttle_ops", "osd_serving_fail_fast"]),
    Option("osd_serving_throttle_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=1024, min=1,
           description="serving admission throttle: max ops queued or in "
                       "flight",
           see_also=["osd_serving_throttle_bytes"]),
    Option("osd_serving_fail_fast", TYPE_BOOL, LEVEL_ADVANCED,
           default=False,
           description="when a serving throttle is full, refuse the op "
                       "(ThrottleFull) instead of blocking the submitter"),
    Option("osd_batch_max_delay_ms", TYPE_FLOAT, LEVEL_ADVANCED,
           default=2.0, min=0.0,
           description="op coalescer deadline: max milliseconds an op "
                       "waits for batch companions before dispatch",
           see_also=["osd_batch_max_ops"]),
    Option("osd_batch_max_ops", TYPE_UINT, LEVEL_ADVANCED,
           default=64, min=1,
           description="op coalescer: max ops fused into one device "
                       "dispatch",
           see_also=["osd_batch_max_delay_ms"]),
]

SCHEMA: dict[str, Option] = {o.name: o for o in OPTIONS}


class ConfigProxy:
    """md_config_t analog: typed values + observers (config.cc)."""

    def __init__(self, overrides: dict | None = None,
                 schema: dict[str, Option] | None = None):
        self.schema = dict(schema or SCHEMA)
        self._values: dict[str, Any] = {}
        self._observers: dict[str, list[Callable[[str, Any], None]]] = {}
        self._lock = threading.Lock()
        if overrides:
            for k, v in overrides.items():
                self.set(k, v, _startup=True)

    def get(self, name: str):
        opt = self.schema[name]
        with self._lock:
            if name in self._values:
                return self._values[name]
        return opt.cast(opt.default) if opt.default is not None else None

    def __getitem__(self, name: str):
        return self.get(name)

    def set(self, name: str, value, _startup: bool = False) -> None:
        opt = self.schema.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        if opt.startup and not _startup:
            raise ValueError(f"option {name} can only be set at startup")
        v = opt.cast(value)
        with self._lock:
            self._values[name] = v
            observers = list(self._observers.get(name, ()))
        for fn in observers:        # outside the lock, like the reference
            fn(name, v)

    def add_observer(self, name: str, fn: Callable[[str, Any], None]) -> None:
        """Live-update hook (md_config_obs_t analog)."""
        if name not in self.schema:
            raise KeyError(f"unknown option {name!r}")
        with self._lock:
            self._observers.setdefault(name, []).append(fn)

    def show_config(self) -> dict[str, Any]:
        return {name: self.get(name) for name in sorted(self.schema)}

    def diff(self) -> dict[str, Any]:
        """Only non-default values (`ceph config diff`)."""
        with self._lock:
            return dict(self._values)

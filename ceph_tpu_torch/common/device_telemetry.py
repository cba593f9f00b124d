"""Device telemetry: the card's inventory and memory as a perf collection.

Every number a process reports is meaningless without knowing WHAT
hardware produced it, and a serving process needs live device-memory
pressure the way the reference watches BlueStore utilization.  This is
the port's counterpart of ``ceph_tpu.common.device_telemetry``, written
over ``torch.cuda`` instead of the JAX backend:

- :func:`device_inventory` — platform (``gpu`` with a card, else
  ``cpu``), the card's name (``torch.cuda.get_device_name``, "unknown"
  until CUDA is initialised in the process) and count, and the torch and
  CUDA versions.
- :func:`memory_stats` / :func:`live_buffer_bytes` — per card, the
  caching allocator's bytes in use and peak (``torch.cuda.memory_stats``)
  beside the card's capacity (``torch.cuda.mem_get_info``), and the bytes
  held by live tensors (``torch.cuda.memory_allocated``).  Without a card
  both are empty, as the reference's are on JAX-CPU.
- :func:`hbm_watermarks` — the session high-water mark per card, which
  the HBM_PRESSURE health check reads.
- :func:`compile_cache_stats` — the hand kernels built in this process
  (``ops/cuda_build.build_info``).
- :func:`refresh` — pushes all of the above into a ``device``
  PerfCounters collection on a Context.

Memory is read only where CUDA is already initialized in this process:
a telemetry scrape never creates a CUDA context of its own.
"""
from __future__ import annotations

import torch

DEVICE_COLLECTION = "device"


def backend_ready() -> bool:
    """True when a card is present and CUDA has initialized in this
    process (a scrape then adds no context of its own)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_inventory() -> dict:
    """Platform/device summary; a CUDA error degrades to an ``error``
    field rather than raising (telemetry must not take the process
    down)."""
    info: dict = {"torch_version": torch.__version__,
                  "cuda_version": torch.version.cuda, "platform": "cpu",
                  "device_kind": "cpu", "num_devices": 0}
    try:
        if not torch.cuda.is_available():
            return info
        n = torch.cuda.device_count()
        if not torch.cuda.is_initialized():
            # reading a name would initialise CUDA: a telemetry read (a
            # scrape thread) names the card once the process's own work
            # has done that
            info.update(platform="gpu", device_kind="unknown",
                        num_devices=n)
            return info
        kinds = [torch.cuda.get_device_name(i) for i in range(n)]
    except RuntimeError as e:
        info["error"] = repr(e)[:200]
        return info
    info.update(platform="gpu", device_kind=kinds[0], num_devices=n)
    info["devices"] = [{"id": i, "platform": "gpu", "kind": k}
                       for i, k in enumerate(kinds)]
    return info


def memory_stats() -> dict[str, dict]:
    """Per-card memory: ``bytes_in_use`` and ``peak_bytes_in_use`` of the
    caching allocator, ``bytes_reserved`` (what it holds from CUDA),
    and ``bytes_limit`` / ``bytes_free`` of the whole card.
    Empty without a card, or before CUDA initializes."""
    if not backend_ready():
        return {}
    out: dict[str, dict] = {}
    for i in range(torch.cuda.device_count()):
        try:
            st = torch.cuda.memory_stats(i)
            free, total = torch.cuda.mem_get_info(i)
        except RuntimeError:
            continue                     # that card is absent from the view
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(st.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(st.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": int(st.get("reserved_bytes.all.current", 0)),
            "bytes_limit": int(total), "bytes_free": int(free)}
    return out


# session high-water marks per card: the allocator's peak resets with
# torch.cuda.reset_peak_memory_stats; the module keeps the max ever
# observed in THIS process so HBM_PRESSURE sees the true watermark
_hbm_high_water: dict[str, int] = {}


def hbm_watermarks() -> dict[str, dict]:
    """Per-card HBM watermark sample: bytes in use, allocator peak,
    capacity, and the session high-water mark (max observed across
    samples).  Without a card nothing appears, and the HBM_PRESSURE
    health check stays silent."""
    out: dict[str, dict] = {}
    for dev, st in memory_stats().items():
        in_use = st["bytes_in_use"]
        peak = st["peak_bytes_in_use"]
        limit = st["bytes_limit"]
        hw = max(_hbm_high_water.get(dev, 0), peak, in_use)
        _hbm_high_water[dev] = hw
        rec = {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
               "bytes_limit": limit, "high_water_bytes": hw}
        if limit > 0:
            rec["high_water_ratio"] = round(hw / limit, 4)
        out[dev] = rec
    return out


def live_buffer_bytes() -> int:
    """Bytes held by live tensors on every card
    (``torch.cuda.memory_allocated``); 0 without a card."""
    if not backend_ready():
        return 0
    return int(sum(torch.cuda.memory_allocated(i)
                   for i in range(torch.cuda.device_count())))


def compile_cache_stats() -> dict:
    """The hand kernels built (or loaded from the build cache) in this
    process, and the seconds their builds took."""
    from ..ops import cuda_build
    info = dict(cuda_build.build_info)
    return {"keys": len(info),
            "build_seconds": round(sum(float(v.get("seconds", 0.0))
                                       for v in info.values()), 6)}


def _device_perf(cct):
    """The Context's ``device`` collection, built lazily on first
    refresh."""
    pc = cct.perf.get(DEVICE_COLLECTION)
    if pc is None:
        from .perf_counters import PerfCountersBuilder
        pc = (PerfCountersBuilder(DEVICE_COLLECTION)
              .add_u64("num_devices", "cards visible to torch.cuda")
              .add_u64("live_buffer_bytes",
                       "bytes held by live tensors on the cards")
              .add_u64("mem_bytes_in_use",
                       "caching-allocator bytes in use, summed over cards")
              .add_u64("mem_peak_bytes_in_use",
                       "caching-allocator peak bytes in use, summed over "
                       "cards")
              .add_u64("mem_bytes_limit",
                       "card memory capacity, summed over cards (0 "
                       "without a card)")
              .add_u64("hbm_high_water_bytes",
                       "session high-water device-memory mark, summed "
                       "over cards (feeds HBM_PRESSURE)")
              .add_u64("compile_cache_keys",
                       "hand kernels built or loaded in this process")
              .create_perf_counters())
        cct.perf.add(pc)
    return pc


def refresh(cct) -> dict:
    """Take one telemetry snapshot and push it into the Context's
    ``device`` perf collection.  Returns the full snapshot (the flight
    recorder's ``device`` source)."""
    inv = device_inventory()
    mem = memory_stats()
    marks = hbm_watermarks()
    live = live_buffer_bytes()
    cache = compile_cache_stats()
    pc = _device_perf(cct)
    pc.set("num_devices", inv["num_devices"])
    pc.set("live_buffer_bytes", live)
    pc.set("mem_bytes_in_use", sum(s["bytes_in_use"] for s in mem.values()))
    pc.set("mem_peak_bytes_in_use",
           sum(s["peak_bytes_in_use"] for s in mem.values()))
    pc.set("mem_bytes_limit", sum(m["bytes_limit"] for m in marks.values()))
    pc.set("hbm_high_water_bytes",
           sum(m["high_water_bytes"] for m in marks.values()))
    pc.set("compile_cache_keys", cache["keys"])
    return {"inventory": inv, "memory": mem, "watermarks": marks,
            "live_buffer_bytes": live, "compile_cache": cache}

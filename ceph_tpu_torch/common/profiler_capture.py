"""Profiler capture windows over ``torch.profiler``: bounded, on demand,
auto-triggered.

The port's copy of ``ceph_tpu.common.profiler_capture``.  The roofline
ledger (common/roofline.py) says WHICH kernel launch shape runs far from
its bound; a profiler trace says WHY (launch gaps, copies, the host
between kernels).  Profiling is expensive and process-global, so it must
be a deliberate WINDOW — never an always-on tax on the hot path — and
every capture must land in a BOUNDED on-disk directory.  This module and
the measuring tool ``tools/path_shapes.py`` are the only places in the
package that touch ``torch.profiler``
(``tests/test_torch_profiler_capture.py`` guards it):

- ``device profile start|stop|status`` admin commands open/close a
  capture window on demand (a Chrome trace-event JSON,
  ``export_chrome_trace``, under ``<out_dir>/capture-*``);
- :meth:`ProfilerCapture.auto_capture` takes a rate-limited one-shot
  capture on any WARN/ERR health transition (wired next to the flight
  recorder dump in ``cluster._on_health_transition``): cooldown-gated so
  a flapping check cannot churn the profiler, window-bounded by
  ``mgr_profiler_auto_window`` (0 = start+stop immediately — the
  zero-risk default: the artifact marks the moment, the operator opens
  a real window to investigate);
- the capture directory is bounded by ``mgr_profiler_max_captures``
  (oldest captures removed, the flight recorder's disk discipline).

The real backend is ``torch.profiler.profile(activities=[CPU, CUDA],
record_shapes=False, with_stack=False)``, started and stopped around the
window.  Its CUDA activity (kernels, copies) is the device's, for every
thread of the process; its CPU op events are per thread, so counts of
kernels come from the device events.  As measured on an H100, the
profiler drops the first device records of a session from about the
third session in a process on, more as the process ages, so a window
opens with :meth:`TorchProfiler.prime`, device work that takes the
loss in place of the window's own.  The backend is injectable
(``profiler=``, any object with ``start_trace(path)`` / ``stop_trace()``)
so tests exercise every path without a card; the real one loads lazily
and only when CUDA is already initialised in the process
(device_telemetry's rule: a capture request never creates a CUDA
context).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

# the profiler's state is process-global: two capture owners in one
# process must not interleave start/stop windows
_ACTIVE_OWNER: "ProfilerCapture | None" = None
_GLOBAL_LOCK = threading.Lock()

#: the file a window's trace is exported to, inside its capture directory
TRACE_FILE = "trace.json"


#: the span around a window's primer (:meth:`TorchProfiler.prime`) in its
#: trace: the runtime calls inside it, and their device records, are the
#: primer's
PRIMER_SPAN = "ceph_tpu_torch.profiler_primer"


class TorchProfiler:
    """The real backend: one ``torch.profiler.profile`` per window,
    CPU and CUDA activity, no shapes and no stacks, exported as Chrome
    trace-event JSON into the window's directory on stop.  Where CUDA is
    initialised, a window opens with :meth:`prime`."""

    #: one-byte fills and copies up that open a window on the card
    PRIMER_LAUNCHES = 256
    PRIMER_COPIES = 16

    def __init__(self):
        self._prof = None
        self._path = None

    def start_trace(self, path: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=False, with_stack=False)
        prof.start()
        self._prof, self._path = prof, path
        if torch.cuda.is_initialized():
            self.prime()

    def prime(self, device: str = "cuda") -> None:
        """Fill one byte :data:`PRIMER_LAUNCHES` times and copy one up
        :data:`PRIMER_COPIES` times on the current stream, then wait for
        the card (``device="cpu"``: the same operators on the host).  On an H100 the profiler drops a session's first device
        records from about its third session in a process on (PERF.md
        §7); these take the loss in place of the window's own work.  They
        run inside a :data:`PRIMER_SPAN` span."""
        import torch
        from torch.profiler import record_function
        with record_function(PRIMER_SPAN):
            flag = torch.empty(self.PRIMER_LAUNCHES, dtype=torch.uint8,
                               device=device)
            for i in range(self.PRIMER_LAUNCHES):
                flag[i:i + 1].fill_(1)
            one = torch.ones(1, dtype=torch.uint8)
            for _ in range(self.PRIMER_COPIES):
                flag[:1].copy_(one)
            if flag.is_cuda:
                torch.cuda.synchronize()

    def stop_trace(self) -> None:
        prof, path = self._prof, self._path
        self._prof = self._path = None
        if prof is None:
            raise RuntimeError("no profiler window is open")
        prof.stop()
        prof.export_chrome_trace(os.path.join(path, TRACE_FILE))


def _sanitize(reason: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "-_" else "_"
                   for ch in reason)[:60]


class ProfilerCapture:
    """Bounded on-disk profiler capture windows + auto-capture."""

    ADMIN_COMMANDS = ("device profile start", "device profile stop",
                      "device profile status")

    def __init__(self, cct=None, out_dir=None, max_captures: int | None = None,
                 cooldown_s: float | None = None,
                 auto_window_s: float | None = None, profiler=None):
        from .context import default_context
        self.cct = cct if cct is not None else default_context()
        conf = self.cct.conf
        self.out_dir = Path(out_dir) if out_dir is not None else None
        self.max_captures = int(conf.get("mgr_profiler_max_captures")
                                if max_captures is None else max_captures)
        self.cooldown_s = float(conf.get("mgr_profiler_cooldown")
                                if cooldown_s is None else cooldown_s)
        self.auto_window_s = float(conf.get("mgr_profiler_auto_window")
                                   if auto_window_s is None
                                   else auto_window_s)
        self._profiler = profiler
        self._lock = threading.Lock()
        self._active: dict | None = None
        self._last_auto = 0.0
        self._auto_timer: threading.Timer | None = None
        self._owns_admin = False
        self.auto_captures = 0
        self.auto_skipped = 0

    # -- backend -----------------------------------------------------------

    def _load_profiler(self):
        """The real backend (:class:`TorchProfiler`), lazily — and only
        when CUDA is ALREADY initialised in this process (a capture
        request must never be the thing that creates a CUDA context)."""
        if self._profiler is not None:
            return self._profiler
        from . import device_telemetry
        if not device_telemetry.backend_ready():
            raise RuntimeError(
                "ProfilerUnavailable: CUDA is not initialised in this "
                "process (run device work first)")
        self._profiler = TorchProfiler()
        return self._profiler

    # -- windows -----------------------------------------------------------

    def start(self, reason: str = "manual") -> dict:
        """Open a capture window.  Returns ``{path, reason, ...}`` or
        ``{error}`` — admin/auto callers must never crash the process
        over a profiler problem."""
        global _ACTIVE_OWNER
        if self.out_dir is None:
            return {"error": "profiler captures disabled "
                             "(no capture directory: run durable)"}
        with _GLOBAL_LOCK:
            if _ACTIVE_OWNER is not None:
                return {"error": "a profiler capture is already active "
                                 "in this process"}
            _ACTIVE_OWNER = self
        path = self.out_dir / (f"capture-{int(time.time())}-"
                               f"{os.getpid()}-{_sanitize(reason)}")
        try:
            profiler = self._load_profiler()
            path.mkdir(parents=True, exist_ok=True)
            profiler.start_trace(str(path))
        except Exception as e:
            with _GLOBAL_LOCK:
                _ACTIVE_OWNER = None
            # don't leave an empty capture dir behind a failed start
            shutil.rmtree(path, ignore_errors=True)
            return {"error": repr(e)[:200]}
        with self._lock:
            self._active = {"path": str(path), "reason": reason,
                            "started": time.time()}
            return dict(self._active)

    def stop(self) -> dict:
        """Close the active window, stamp ``capture.json`` metadata into
        it, and bound the capture directory.  Any pending auto-stop
        timer is cancelled: once THIS stop closes the window, a stale
        timer firing later must not kill an unrelated window the
        operator opened in the meantime."""
        global _ACTIVE_OWNER
        with self._lock:
            active, self._active = self._active, None
            timer, self._auto_timer = self._auto_timer, None
        if timer is not None:
            timer.cancel()
        if active is None:
            return {"error": "no active profiler capture"}
        err = None
        try:
            self._load_profiler().stop_trace()
        except Exception as e:       # the window state must clear anyway
            err = repr(e)[:200]
        with _GLOBAL_LOCK:
            if _ACTIVE_OWNER is self:
                _ACTIVE_OWNER = None
        active["stopped"] = time.time()
        active["duration_s"] = round(active["stopped"] - active["started"],
                                     6)
        if err is not None:
            active["error"] = err
        try:
            with open(Path(active["path"]) / "capture.json", "w") as f:
                json.dump(active, f)
        except Exception:
            pass
        self._bound_disk()
        return active

    def status(self) -> dict:
        with self._lock:
            active = dict(self._active) if self._active else None
        return {"active": active,
                "out_dir": str(self.out_dir) if self.out_dir else None,
                "captures": self.captures(),
                "auto_captures": self.auto_captures,
                "auto_skipped": self.auto_skipped,
                "cooldown_s": self.cooldown_s}

    def captures(self) -> list[str]:
        """On-disk capture directories, oldest first."""
        if self.out_dir is None:
            return []
        try:
            return sorted((str(p) for p in self.out_dir.glob("capture-*")
                           if p.is_dir()),
                          key=lambda p: os.path.getmtime(p))
        except OSError:
            return []

    def _bound_disk(self) -> None:
        caps = self.captures()
        for stale in caps[:max(0, len(caps) - self.max_captures)]:
            shutil.rmtree(stale, ignore_errors=True)

    # -- auto-capture (health-transition hook) ------------------------------

    def auto_capture(self, reason: str = "health") -> dict | None:
        """One rate-limited capture around an anomaly: called from the
        health engine's WARN/ERR transition hook, next to the flight
        recorder dump.  Never raises; returns the capture info or None
        (disabled / already active / inside the cooldown / profiler
        unavailable).  The window is ``auto_window_s`` long — 0 stops
        immediately (marker capture), >0 stops on a daemon timer."""
        try:
            now = time.monotonic()
            with self._lock:
                if self.out_dir is None or self._active is not None or \
                        (self._last_auto and
                         now - self._last_auto < self.cooldown_s):
                    self.auto_skipped += 1
                    return None
                self._last_auto = now
            info = self.start(reason=f"auto-{reason}")
            if "error" in info:
                self.auto_skipped += 1
                return None
            self.auto_captures += 1
            if self.auto_window_s <= 0:
                return self.stop()
            t = threading.Timer(self.auto_window_s, self._auto_stop)
            t.daemon = True
            with self._lock:
                self._auto_timer = t
            t.start()
            return info
        except Exception:            # incident-time: degrade, don't die
            return None

    def _auto_stop(self) -> None:
        try:
            self.stop()
        except Exception:
            pass

    # -- admin-socket surface ----------------------------------------------

    def register_admin(self, admin_socket=None) -> None:
        """Takeover-register the three window commands (the flight
        recorder's idiom: newest owner wins; close() unregisters only
        while still the owner)."""
        sock = admin_socket if admin_socket is not None \
            else self.cct.admin_socket
        self._admin_sock = sock
        self._admin_fns = {
            "device profile start":
                lambda reason="admin", **kw: self.start(reason=reason),
            "device profile stop": lambda **kw: self.stop(),
            "device profile status": lambda **kw: self.status(),
        }
        help_text = {
            "device profile start": "open a torch.profiler capture "
                                    "window (Chrome trace under the "
                                    "capture directory)",
            "device profile stop": "close the active profiler capture "
                                   "window and bound the capture dir",
            "device profile status": "active window + on-disk captures "
                                     "+ auto-capture counters",
        }
        for name, fn in self._admin_fns.items():
            sock.unregister(name)
            sock.register(name, fn, help_text[name])
        self._owns_admin = True

    def close(self) -> None:
        with self._lock:
            t, self._auto_timer = self._auto_timer, None
        if t is not None:
            t.cancel()
        if self._active is not None:
            self.stop()
        if self._owns_admin:
            for name, fn in self._admin_fns.items():
                if self._admin_sock.get(name) is fn:
                    self._admin_sock.unregister(name)
            self._owns_admin = False

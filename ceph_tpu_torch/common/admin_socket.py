"""Admin socket: named command registry answering JSON.

Mirror of the reference's admin socket (reference:
src/common/admin_socket.cc — per-daemon unix socket answering registered
commands such as ``perf dump``, ``config show``, ``dump_ops_in_flight``).
In-process here (tests and tools call it directly); the wire is ancillary,
the command surface is the contract.
"""
from __future__ import annotations

import json
import threading
from typing import Callable


class AdminSocket:
    def __init__(self):
        self._hooks: dict[str, tuple[Callable, str]] = {}
        self._lock = threading.Lock()
        self.register("help", self._help, "list available commands")

    def _help(self, **kwargs):
        with self._lock:                    # snapshot under the lock
            return {cmd: desc
                    for cmd, (_, desc) in sorted(self._hooks.items())}

    def register(self, command: str, fn: Callable[..., object],
                 description: str = "") -> None:
        with self._lock:
            if command in self._hooks:
                raise ValueError(f"command {command!r} already registered")
            self._hooks[command] = (fn, description)

    def unregister(self, command: str) -> None:
        with self._lock:
            self._hooks.pop(command, None)

    def get(self, command: str):
        """The registered hook fn, or None — lets a takeover-registered
        command's owner check it still holds the name before removing."""
        with self._lock:
            hook = self._hooks.get(command)
        return hook[0] if hook else None

    def call(self, command: str, **kwargs):
        with self._lock:
            hook = self._hooks.get(command)
        if hook is None:
            raise KeyError(f"unknown command {command!r}")
        return hook[0](**kwargs)

    def call_json(self, command: str, **kwargs) -> str:
        return json.dumps(self.call(command, **kwargs), default=str)

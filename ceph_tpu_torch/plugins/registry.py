"""Erasure-code plugin registry.

Python mirror of ``ErasureCodePluginRegistry``
(reference: src/erasure-code/ErasureCodePlugin.{h,cc}): a process-wide
singleton mapping plugin name -> plugin object.  Where the reference
``dlopen``s ``libec_<name>.so`` and calls the C entry points
``__erasure_code_version()`` / ``__erasure_code_init(name, dir)``
(ErasureCodePlugin.cc:126-184), we import a Python module
``ceph_tpu_torch.plugins.plugin_<name>`` (or ``<directory>/plugin_<name>.py``)
and call the same-named module hooks:

    __erasure_code_version__() -> str   must equal ceph_tpu_torch.__version__
    __erasure_code_init__(name, directory) -> None   must self-register

The failure paths match the reference's registry tests (missing entry
point, version mismatch, init failure, init-without-register; cf.
src/test/erasure-code/TestErasureCodePlugin*.cc).  The singleton is this
package's own, separate from the JAX package's registry.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import threading

from .. import __version__
from .interface import ErasureCodeInterface, ErasureCodeProfile


class ErasureCodePlugin:
    """Base plugin: a named factory of codec instances
    (reference: src/erasure-code/ErasureCodePlugin.h:33-43)."""

    def factory(self, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeInterface:
        raise NotImplementedError


class ErasureCodePluginRegistry:
    _instance = None
    _instance_lock = threading.Lock()
    # While load() runs a plugin's __erasure_code_init__, instance() resolves
    # to the loading registry, so self-registration lands in the registry
    # that initiated the load (keeps non-singleton registries testable).
    _loading = threading.local()

    def __init__(self):
        self._plugins: dict[str, ErasureCodePlugin] = {}
        self._lock = threading.Lock()
        self.disable_dlclose = True  # parity knob; module unload never happens

    @classmethod
    def instance(cls) -> "ErasureCodePluginRegistry":
        current = getattr(cls._loading, "registry", None)
        if current is not None:
            return current
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    # -- add/get (ErasureCodePlugin.cc:51-90) ------------------------------

    def add(self, name: str, plugin: ErasureCodePlugin) -> None:
        with self._lock:
            if name in self._plugins:
                raise ValueError(f"plugin {name} already registered (-EEXIST)")
            self._plugins[name] = plugin

    def get(self, name: str) -> ErasureCodePlugin | None:
        with self._lock:
            return self._plugins.get(name)

    def remove(self, name: str) -> None:
        with self._lock:
            self._plugins.pop(name, None)

    # -- load (ErasureCodePlugin.cc:126-184) -------------------------------

    def load(self, plugin_name: str, directory: str = "") -> ErasureCodePlugin:
        if directory:
            path = os.path.join(directory, f"plugin_{plugin_name}.py")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"load dlopen({path}): no such plugin (-ENOENT)")
            spec = importlib.util.spec_from_file_location(
                f"ceph_tpu_torch_ext_plugin_{plugin_name}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
        else:
            try:
                module = importlib.import_module(
                    f"ceph_tpu_torch.plugins.plugin_{plugin_name}")
            except ImportError as e:
                raise FileNotFoundError(
                    f"load dlopen(libec_{plugin_name}): {e} (-ENOENT)") from e

        version_fn = getattr(module, "__erasure_code_version__", None)
        if version_fn is None:
            raise RuntimeError(
                f"{plugin_name} plugin has no __erasure_code_version__ (-EXDEV)")
        version = version_fn()
        if version != __version__:
            raise RuntimeError(
                f"{plugin_name} plugin version {version} != expected "
                f"{__version__} (-EXDEV)")

        init_fn = getattr(module, "__erasure_code_init__", None)
        if init_fn is None:
            raise RuntimeError(
                f"{plugin_name} plugin has no __erasure_code_init__ (-ENOENT)")
        type(self)._loading.registry = self
        try:
            init_fn(plugin_name, directory)
        finally:
            type(self)._loading.registry = None

        plugin = self.get(plugin_name)
        if plugin is None:
            raise RuntimeError(
                f"{plugin_name} plugin init did not register itself (-EBADF)")
        return plugin

    # -- factory (ErasureCodePlugin.cc:92-120) -----------------------------

    def factory(self, plugin_name: str, directory: str,
                profile: ErasureCodeProfile) -> ErasureCodeInterface:
        with self._lock:
            plugin = self._plugins.get(plugin_name)
        if plugin is None:
            plugin = self.load(plugin_name, directory)
        profile = dict(profile)
        profile.setdefault("plugin", plugin_name)
        if profile["plugin"] != plugin_name:
            raise ValueError(
                f"profile plugin={profile['plugin']} != factory({plugin_name})")
        return plugin.factory(directory, profile)

    # -- preload (ErasureCodePlugin.cc:186-202) ----------------------------

    def preload(self, plugins: list[str], directory: str = "") -> None:
        """Load a list of plugins at startup, like the daemons do from the
        osd_erasure_code_plugins option (reference: src/common/options.cc:2519,
        called from global_init.cc:577)."""
        for name in plugins:
            if self.get(name) is None:
                self.load(name, directory)


def default_registry() -> ErasureCodePluginRegistry:
    return ErasureCodePluginRegistry.instance()

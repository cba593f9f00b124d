"""The port's option table against the JAX package's, and the plugin
layer's options where the port reads them."""
import re

import numpy as np
import pytest

from ceph_tpu.common import options as joptions
from ceph_tpu_torch import native
from ceph_tpu_torch.cluster import MiniCluster
from ceph_tpu_torch.common import options
from ceph_tpu_torch.common.context import Context, default_context
from ceph_tpu_torch.native import BatchQueue, NativeRegistry, StripesOnDevice
from ceph_tpu_torch.ops.codec import RSCodec
from ceph_tpu_torch.plugins import DEVICE_THRESHOLD_BYTES
from ceph_tpu_torch.plugins.registry import ErasureCodePluginRegistry

# JAX-package options the port's table lacks: none
STILL_MISSING: set[str] = set()

# the options the port's table gained last, with the config wiring
WIRED = ["debug_crush", "debug_ec", "instruments_enabled", "log_file",
         "osd_pool_default_erasure_code_profile", "osd_pool_default_pg_num",
         "osd_pool_default_size", "osd_recovery_max_chunk",
         "tracer_sample_rate"]


def _port_default(jax_default):
    """The JAX package's default as the port states it: a default that
    names the ``jax_rs`` plugin names ``torch_rs``."""
    if isinstance(jax_default, str):
        return jax_default.replace("jax_rs", "torch_rs")
    return jax_default


def _same_option(name):
    port, jax = options.SCHEMA[name], joptions.SCHEMA[name]
    assert (port.type, port.level, port.startup, port.min, port.max,
            port.enum_allowed) == (jax.type, jax.level, jax.startup,
                                   jax.min, jax.max, jax.enum_allowed)
    assert port.default == _port_default(jax.default)


def test_option_names_are_the_jax_packages_less_the_missing():
    assert not STILL_MISSING
    assert set(options.SCHEMA) == set(joptions.SCHEMA) - STILL_MISSING


def test_every_option_matches_the_jax_packages():
    for name in sorted(joptions.SCHEMA):
        _same_option(name)


@pytest.mark.parametrize("name", WIRED)
def test_wired_option_matches_the_jax_packages(name):
    _same_option(name)
    conf, jconf = Context().conf, joptions.ConfigProxy()
    assert conf.get(name) == _port_default(jconf.get(name))


@pytest.mark.parametrize("name", ["erasure_code_dir",
                                  "osd_erasure_code_plugins",
                                  "ec_batch_max_stripes",
                                  "ec_device_threshold_bytes"])
def test_plugin_layer_options(name):
    port, jax = options.SCHEMA[name], joptions.SCHEMA[name]
    assert (port.type, port.level, port.startup) == \
        (jax.type, jax.level, jax.startup)
    want = ("torch_rs cpp_rs" if name == "osd_erasure_code_plugins"
            else jax.default)
    assert port.default == want


def test_device_routing_reads_the_threshold_live():
    reg = ErasureCodePluginRegistry()
    live = reg.factory("torch_rs", "", {"k": "4", "m": "2",
                                        "device": "auto"})
    pinned = reg.factory("torch_rs", "", {"k": "4", "m": "2",
                                          "device": "auto",
                                          "device-threshold": "5000"})
    conf = default_context().conf
    assert live.device_threshold == DEVICE_THRESHOLD_BYTES
    try:
        conf.set("ec_device_threshold_bytes", 1000)
        assert live.device_threshold == 1000
        assert live.device_codec(999) is None
        assert live.device_codec(1000) is live.codec
        assert pinned.device_threshold == 5000
        assert pinned.device_codec(4999) is None
    finally:
        conf.set("ec_device_threshold_bytes", DEVICE_THRESHOLD_BYTES)
    assert live.device_threshold == DEVICE_THRESHOLD_BYTES


def test_erasure_code_dir_is_where_the_native_registry_loads(tmp_path):
    native.build()
    assert NativeRegistry(Context()).directory == native.BUILD_DIR
    reg = NativeRegistry(Context({"erasure_code_dir": str(tmp_path)}))
    assert reg.directory == str(tmp_path)
    with pytest.raises(IOError, match=re.escape(
            f"dlopen({tmp_path}/libec_badver.so)")):
        reg.load("badver")


def test_ec_batch_max_stripes_is_the_batch_queues_default():
    k, m, chunk = 2, 1, 64
    cb = StripesOnDevice(RSCodec(k, m, device="numpy").parity_mat, "cpu")
    q = BatchQueue(k, m, chunk, cb)
    assert q.max_batch == 256
    q.close()
    conf = default_context().conf
    try:
        conf.set("ec_batch_max_stripes", 4)
        q = BatchQueue(k, m, chunk, cb)
    finally:
        conf.set("ec_batch_max_stripes", 256)
    data = np.random.default_rng(4).integers(0, 256, (16, k, chunk),
                                             dtype=np.uint8)
    for stripe in data:
        q.submit(stripe)
    q.flush()
    assert q.max_batch == 4 and q.stripes == 16 and q.batches >= 4
    q.close()


def test_a_cluster_preloads_osd_erasure_code_plugins():
    reg = ErasureCodePluginRegistry.instance()
    MiniCluster(n_osds=3, osds_per_host=1, cct=Context(
        {"osd_erasure_code_plugins": "torch_rs cpp_rs isa"}))
    assert all(reg.get(name) is not None
               for name in ("torch_rs", "cpp_rs", "isa"))
    with pytest.raises(FileNotFoundError, match="nosuch"):
        MiniCluster(n_osds=3, osds_per_host=1, cct=Context(
            {"osd_erasure_code_plugins": "torch_rs nosuch"}))

"""The port's Context wires its config into the process-wide instrument
switch, the default tracer and the log, as the JAX package's does.

Each case builds one Context per package from the same override, then
applies the same live ``conf.set``; after each step the switch, the
default tracer's ``sample_rate`` and ``slow_threshold_s`` and the log
levels of ``ec`` and ``crush`` must be exactly equal between the
packages.  Both targets are process-wide, so a fixture restores them
after every case.
"""
import time

import pytest

from ceph_tpu.common import instruments as jinstruments
from ceph_tpu.common import tracer as jtracer
from ceph_tpu.common.context import Context as JContext
from ceph_tpu_torch.common import instruments, tracer
from ceph_tpu_torch.common.context import Context


@pytest.fixture(autouse=True)
def _restore_process_state():
    saved = [(mod.default_tracer(), mod.default_tracer().sample_rate,
              mod.default_tracer().slow_threshold_s)
             for mod in (tracer, jtracer)]
    switches = (instruments.enabled(), jinstruments.enabled())
    yield
    for tr, rate, slow in saved:
        tr.sample_rate, tr.slow_threshold_s = rate, slow
    instruments.set_enabled(switches[0])
    jinstruments.set_enabled(switches[1])


def _state(inst_mod, tracer_mod, cct):
    tr = tracer_mod.default_tracer()
    return (inst_mod.enabled(), tr.sample_rate, tr.slow_threshold_s,
            cct.log.level("ec"), cct.log.level("crush"))


# (option, value at construction, value of the live conf.set)
CASES = [
    ("instruments_enabled", True, False),
    ("instruments_enabled", False, True),
    ("tracer_sample_rate", 0.0, 0.5),
    ("tracer_sample_rate", 0.25, 1.0),
    ("tracer_sample_rate", 1.0, 0.0),
    ("osd_op_complaint_time", 0.5, 12.0),
    ("osd_op_complaint_time", 5.0, 0.5),
    ("debug_ec", 0, 7),
    ("debug_ec", 5, 0),
    ("debug_ec", 20, 5),
    ("debug_crush", 0, 7),
    ("debug_crush", 5, 0),
    ("debug_crush", 20, 5),
]


@pytest.mark.parametrize("name,first,second", CASES,
                         ids=[f"{n}={a}->{b}" for n, a, b in CASES])
def test_context_follows_its_config_like_the_jax_package(name, first,
                                                         second):
    cct, jcct = Context({name: first}), JContext({name: first})
    port, ref = _state(instruments, tracer, cct), \
        _state(jinstruments, jtracer, jcct)
    assert port == ref
    assert first in port
    cct.conf.set(name, second)
    jcct.conf.set(name, second)
    port, ref = _state(instruments, tracer, cct), \
        _state(jinstruments, jtracer, jcct)
    assert port == ref
    assert second in port


@pytest.mark.parametrize("prior", [True, False])
def test_disabled_restores_the_prior_state(prior):
    for mod in (instruments, jinstruments):
        mod.set_enabled(prior)
        with mod.disabled():
            assert mod.enabled() is False
        assert mod.enabled() is prior
        with pytest.raises(RuntimeError):
            with mod.disabled():
                raise RuntimeError("inside the block")
        assert mod.enabled() is prior


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_slow_span_under_head_sampling_is_promoted(pkg):
    """A 6 s op under ``osd_op_complaint_time`` 5.0 and sample rate 0 is
    promoted into the ring; a 4 s one is dropped.  Before the port's
    Context was wired, its tracer kept a 30 s threshold and dropped the
    6 s op that the JAX package promotes."""
    ctx_cls, tracer_mod = (Context, tracer) if pkg == "port" else \
        (JContext, jtracer)
    ctx_cls({"osd_op_complaint_time": 5.0, "tracer_sample_rate": 0.0})
    tr = tracer_mod.default_tracer()
    assert (tr.slow_threshold_s, tr.sample_rate) == (5.0, 0.0)
    slow, fast = f"wiring.slow.{pkg}", f"wiring.fast.{pkg}"
    for name, dur in ((slow, 6.0), (fast, 4.0)):
        op = tr.new_trace("client")
        assert not op.sampled
        tr.complete(name, time.time() - dur, dur, ctx=op)
    events = {e["name"]: e for e in tr.dump()["traceEvents"]}
    assert events[slow]["args"]["promoted"] is True
    assert fast not in events

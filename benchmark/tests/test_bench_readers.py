"""The per-layer readers over made-up trace summaries: what each counts,
and what it leaves out."""
import pytest

from benchmark import harness, roofline, trace
from benchmark.metrics import codec_copy_share_pct, gf_apply_roofline_pct

SPEC = harness.load_spec()
GF = "void (anonymous namespace)::gf_apply_kernel<true, 3, 2>(...)"
TORCH_COPY = ("void at::native::elementwise_kernel<128, 4, "
              "at::native::gpu_kernel_impl_nocast<at::native::"
              "direct_copy_kernel_cuda(at::TensorIteratorBase&)>")
TORCH_FILL = ("void at::native::vectorized_elementwise_kernel<4, "
              "at::native::FillFunctor<unsigned char>>")
HAND_COPY = "copy_rows_ring_kernel(unsigned char const*, ...)"


class _Run:
    def __init__(self, trace_summary):
        self.trace = trace_summary


def test_gf_apply_roofline_counts_both_ledger_names():
    one = ("gf_apply", (4, 8), 8, 1 << 20)
    vertical = ("gf_apply_stripes", (2, 8), 64 * 8, 1 << 17)
    launches = {one: 1, vertical: 2, ("xor_apply", (4, 8), 8, 99): 5}
    nbytes = roofline.gf_apply_bytes(one) + 2 * roofline.gf_apply_bytes(
        vertical)
    run = _Run({"gf_apply": {"count": 3, "seconds": 1e-3},
                "launches": launches})
    want = 100.0 * nbytes / roofline.HBM_BYTES_S / 1e-3
    assert gf_apply_roofline_pct.read(run) == pytest.approx(want)
    assert roofline.gf_apply_bytes(vertical) == 64 * 10 * (1 << 17)


def test_copy_share_is_pytorch_copies_and_device_copies():
    run = _Run({"kernels": {TORCH_COPY: 1.0, GF: 1.0, HAND_COPY: 1.0,
                            TORCH_FILL: 0.5},
                "memcpy": {"Memcpy DtoD (Device -> Device)": 0.5,
                           "Memcpy HtoD (Pinned -> Device)": 9.0}})
    assert codec_copy_share_pct.read(run) == pytest.approx(
        100.0 * 1.5 / 4.0)


def test_copy_share_reads_nothing_without_device_work():
    assert codec_copy_share_pct.read(_Run(None)) is None
    assert codec_copy_share_pct.read(_Run({"kernels": {}, "memcpy": {
        "Memcpy HtoD (Pinned -> Device)": 1.0}})) is None


def test_reduce_splits_kernels_from_copies_inside_the_window():
    ms = 1_000_000
    events = [(False, trace.WINDOW_SPAN, 0, 10 * ms),
              (True, GF, 1 * ms, 3 * ms),
              (True, "Memcpy DtoD (Device -> Device)", 4 * ms, 5 * ms),
              (True, TORCH_COPY, 9 * ms, 12 * ms),
              (True, "cudaDeviceSynchronize Sync", 5 * ms, 9 * ms)]
    got = trace.reduce(events, {})
    assert got["kernels"] == pytest.approx({GF: 2e-3, TORCH_COPY: 1e-3})
    assert got["memcpy"] == pytest.approx(
        {"Memcpy DtoD (Device -> Device)": 1e-3})
    assert got["busy_s"] == pytest.approx(4e-3)
    assert got["gf_apply"]["count"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]
                                    if m["source"] == "device_trace"])
def test_device_readers_read_nothing_without_a_trace(metric):
    reader = harness._load_module(harness.metric_file(metric), metric)
    assert reader.read(_Run(None)) is None

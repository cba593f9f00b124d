"""codec_copy_share_pct: the card's time in on-device copies, PyTorch's
copy kernels (what ``.contiguous()``, ``copy_`` and ``torch.cat`` launch:
a kernel of the ``at::native`` namespace with ``copy`` in its name) and
device-to-device memcpys, as a share of its time in kernels and
device-to-device memcpys in the profiled window: what the codec's layout
copies cost beside its arithmetic."""

#: the profiler's name of a copy from one place in device memory to another
DTOD = "Memcpy DtoD"


def is_copy_kernel(name: str) -> bool:
    return "at::native::" in name and "copy" in name.lower()


def read(run):
    t = run.trace
    if t is None:
        return None
    dtod = sum(s for name, s in t["memcpy"].items() if name.startswith(DTOD))
    total = sum(t["kernels"].values()) + dtod
    if total <= 0:
        return None
    copies = dtod + sum(s for name, s in t["kernels"].items()
                        if is_copy_kernel(name))
    return 100.0 * copies / total

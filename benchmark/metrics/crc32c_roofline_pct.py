"""crc32c_roofline_pct: the time the launches of ``crc32c.cu``'s kernel in
the profiled window would take at the card's HBM bandwidth over the time
their kernels took.  A launch's bytes come from its launch-ledger key
``("crc32c_rows", (), rows, cols)``: the rows read once and a 4-byte crc
written a row (:func:`crc32c_bytes`); the rate is ``roofline.
HBM_BYTES_S``.  The kernels' time is the traced ``crc32c_rows_kernel``
seconds inside the window, which must hold the same launches as the
ledger: the cluster cell's window closes after its loop has drained."""
from benchmark import roofline

#: the launch-ledger name of ``crc32c_rows_kernel``'s launches
LEDGER_NAME = "crc32c_rows"
#: the kernel's name in the trace
KERNEL = "crc32c_rows_kernel"


def crc32c_bytes(key) -> int:
    """Bytes one launch must move: rows x cols read, 4 bytes a row
    written."""
    _kernel, _mat, rows, cols = key
    return rows * cols + 4 * rows


def read(run):
    t = run.trace
    if t is None:
        return None
    seconds = sum(s for name, s in t["kernels"].items() if KERNEL in name)
    keys = {k: n for k, n in t["launches"].items() if k[0] == LEDGER_NAME}
    if seconds <= 0 or not keys:
        return None
    nbytes = sum(crc32c_bytes(k) * n for k, n in keys.items())
    return 100.0 * nbytes / roofline.HBM_BYTES_S / seconds

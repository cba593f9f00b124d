"""EC backend: stripe algebra, object store, write pipeline, recovery.

The port's copy of ``ceph_tpu.backend`` (reference: src/osd/ECUtil.*,
ECTransaction.*, ECBackend.*, ECMsgTypes.*, ExtentCache.*,
src/os/memstore/): ``ecutil`` (stripe algebra, HashInfo, batched
encode/decode and the repair legs), ``ExtentSet``/``ExtentCache``,
``MemStore`` with its ``Transaction``, the PG transaction and write
planner, the sub-op messages on the in-process ``MessageBus``, and the
primary-side ``ECBackend`` over ``OSDShard``s (``make_cluster``).  The
JAX package's replicated backend, FileStore and BlueStore are still to
port.
"""
from .ecutil import (HINFO_KEY, HashInfo, StripeInfo, crc32c, decode,
                     decode_shards, encode)
from .extent import ExtentSet
from .extent_cache import ExtentCache
from .ec_backend import ECBackend, make_cluster
from .pg_backend import OSDShard, PGBackend, RecoveryState
from .memstore import GObject, MemStore, Transaction
from .messages import (ECSubRead, ECSubReadReply, ECSubWrite, ECSubWriteReply,
                       MessageBus, PushOp, PushReply)
from .transaction import (ObjectOperation, PGTransaction, WritePlan,
                          get_write_plan)

__all__ = [
    "HINFO_KEY", "HashInfo", "StripeInfo", "crc32c", "decode",
    "decode_shards", "encode", "ExtentSet", "ExtentCache", "ECBackend",
    "PGBackend", "OSDShard", "RecoveryState", "make_cluster", "GObject",
    "MemStore", "Transaction", "ECSubRead", "ECSubReadReply", "ECSubWrite",
    "ECSubWriteReply", "MessageBus", "PushOp", "PushReply",
    "ObjectOperation", "PGTransaction", "WritePlan", "get_write_plan",
]

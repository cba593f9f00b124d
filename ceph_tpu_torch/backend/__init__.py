"""EC backend: stripe algebra, object store, write pipeline, recovery.

The port's copy of ``ceph_tpu.backend`` (reference: src/osd/ECUtil.*,
ECTransaction.*, ECBackend.*, ECMsgTypes.*, ExtentCache.*,
src/os/memstore/): ``ecutil`` (stripe algebra, HashInfo, batched
encode/decode and the repair legs), ``ExtentSet``/``ExtentCache``,
``MemStore`` with its ``Transaction``, the PG transaction and write
planner, the sub-op messages on the in-process ``MessageBus``, and the
primary-side ``ECBackend`` over ``OSDShard``s (``make_cluster``), the
full-copy ``ReplicatedBackend`` (``make_replicated_cluster``) and
``Collection``, a PG shard's store inside its OSD's one store.  The JAX
package's FileStore and BlueStore (durable mode) are still to port.
"""
from .ecutil import (HINFO_KEY, HashInfo, StripeInfo, crc32c, decode,
                     decode_shards, encode)
from .extent import ExtentSet
from .extent_cache import ExtentCache
from .ec_backend import ECBackend, make_cluster
from .pg_backend import OSDShard, PGBackend, RecoveryState
from .replicated import ReplicatedBackend, make_replicated_cluster
from .collection import Collection
from .memstore import GObject, MemStore, Transaction
from .messages import (ECSubRead, ECSubReadReply, ECSubWrite, ECSubWriteReply,
                       MessageBus, PushOp, PushReply)
from .transaction import (ObjectOperation, PGTransaction, WritePlan,
                          get_write_plan)

__all__ = [
    "HINFO_KEY", "HashInfo", "StripeInfo", "crc32c", "decode",
    "decode_shards", "encode", "ExtentSet", "ExtentCache", "ECBackend",
    "PGBackend", "ReplicatedBackend", "make_replicated_cluster",
    "Collection", "OSDShard", "RecoveryState", "make_cluster", "GObject",
    "MemStore", "Transaction", "ECSubRead", "ECSubReadReply", "ECSubWrite",
    "ECSubWriteReply", "MessageBus", "PushOp", "PushReply",
    "ObjectOperation", "PGTransaction", "WritePlan", "get_write_plan",
]

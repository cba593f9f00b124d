"""ec_sub_write_ms: the shards applying a write's sub-writes to their
stores (the ``ec.sub_write`` spans, one a shard: rollback capture, log
entries, the store transaction), summed over the profiled window per
client op (``op_spans.py``)."""
from benchmark import op_spans


def read(run):
    return op_spans.per_op_ms(run, "ec.sub_write")

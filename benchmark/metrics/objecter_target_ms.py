"""objecter_target_ms: the client's CRUSH target for each op, from the
object name to its PG's primary and acting set (the Objecter's
``objecter.calc_target`` spans), summed over the profiled window per
client op (``op_spans.py``)."""
from benchmark import op_spans


def read(run):
    return op_spans.per_op_ms(run, "objecter.calc_target")

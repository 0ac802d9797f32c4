"""The film's gather over the mesh: the seconds of the program's spans
``parallel.sharding.all_reduce`` on rank 0 (each film ``all_reduce``,
from its call to the sum on the device, so the wait for the group's
slowest rank is inside it) over the traced window's seconds, in %
(host clock; ``benchmark/spans.py``). Rank 0 renders the top tile, so
the span holds most of the tile imbalance as well as NCCL's copy."""

from benchmark import spans


def read(run):
    found = spans.seconds(run, "parallel.sharding.all_reduce")
    if not found or run.trace.window_s <= 0:
        return None
    return 100.0 * sum(found) / run.trace.window_s

"""The pool's host launch path: the mean, over the window's iterations of
``run_pool``, of the program's span ``integrator.pool.iteration`` less
its child ``integrator.pool.sync`` (the read of the queue's counters
that waits for the device), in us (host clock; ``benchmark/spans.py``).
During it the host launches the iteration's kernels after the device has
drained. Read in the traced run, under a torch.profiler that records
every aten op: a profiled host time, which the profiler's own cost
inflates (PERF.md gives the traced-minus-untraced overhead beside it)."""

from benchmark import spans


def read(run):
    found = spans.self_seconds(run, "integrator.pool.iteration", "integrator.pool.sync")
    if not found:
        return None
    return 1e6 * sum(found) / len(found)

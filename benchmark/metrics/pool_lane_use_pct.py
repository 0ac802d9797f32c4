"""The pool's useful lanes over the lanes it launches: the program's
counter ``pool.live_lanes`` (at each iteration's sync, the queue's taken
samples not yet finished: lanes carrying a live path after the spawn
rounds) over ``pool.lane_slots`` (the pool's M each iteration), summed
over the window's iterations, in % (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    live, slots = spans.counter(run, "pool.live_lanes"), spans.counter(run, "pool.lane_slots")
    if live is None or not slots:
        return None
    return 100.0 * live / slots

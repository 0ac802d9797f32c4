"""How far the slowest tile sets the image's pace: 100 x (the slowest
rank's window x ranks / every rank's windows - 1), summed over the
window's images, from rank 0's counters ``parallel.tile_us_max``,
``parallel.tile_us_sum`` and ``parallel.tile_windows`` (ranks x images;
each rank's render of its tile window, device us, carried to rank 0 in
the stats' all_reduce; ``benchmark/spans.py``). 0 when every tile takes
the same time; 300 for four ranks of which one does all the work."""

from benchmark import spans


def read(run):
    slowest = spans.counter(run, "parallel.tile_us_max")
    total = spans.counter(run, "parallel.tile_us_sum")
    windows = spans.counter(run, "parallel.tile_windows")
    images = len(run.window.ends)
    if not slowest or not total or not windows or not images:
        return None
    return 100.0 * (slowest * (windows / images) / total - 1.0)

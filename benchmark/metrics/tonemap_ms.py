"""The host tone map: the mean duration, over the window's images, of the
program's span ``post.tonemap.finalize`` (NumPy ACES or Reinhard, gamma
and quantise of the film's mean on the host), in ms (host clock;
``benchmark/spans.py``). The cells name it by the end-to-end metric it
moves: ``tonemap_ms`` in the megakernel's 1024^2 cell, ``.pool`` in the
pool's. Read in the traced run, under a torch.profiler that records
every aten op: a profiled host time, which the profiler's own cost
inflates (PERF.md gives the traced-minus-untraced overhead beside it)."""

from benchmark import spans


def read(run):
    found = spans.seconds(run, "post.tonemap.finalize")
    if not found:
        return None
    return 1e3 * sum(found) / len(found)

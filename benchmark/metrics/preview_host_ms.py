"""The preview's per-frame host path: the 95th percentile, over the
window's frames, of the duration of the program's span
``integrator.render.render_film_preview`` (the host camera, the preview
kernel's arguments and launch, the postfx launch), in ms (host clock,
``benchmark/spans.py``; NumPy's linear percentile). Read in the traced
run, under a torch.profiler that records every aten op: a profiled host
time, which the profiler's own cost inflates (PERF.md gives the
traced-minus-untraced overhead beside it)."""

import numpy as np

from benchmark import spans


def read(run):
    found = spans.seconds(run, "integrator.render.render_film_preview")
    if not found:
        return None
    return float(np.percentile(found, 95)) * 1e3

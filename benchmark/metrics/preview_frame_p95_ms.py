"""The 95th percentile, over every frame of the window, of the interval
between successive frames' arrival on the host (the preview CLI's FPS
line interval), in ms (host clock; NumPy's linear percentile)."""

import numpy as np


def read(run):
    w = run.window
    if not w.ends:
        return None
    gaps = np.asarray(w.ends) - np.asarray(w.starts)
    return float(np.percentile(gaps, 95)) * 1e3
